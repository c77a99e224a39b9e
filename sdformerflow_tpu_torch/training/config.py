"""YAML config parsing, a copy of ``sdformerflow_tpu/training/config.py``
(whose import of ``models/common.py`` pulls in jax), building the port's
config dataclasses.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import yaml

from ..models.common import SpikingConfig, SwinConfig

_DEFAULTS = {
    "experiment": "Default",
    "data": {"mode": "events", "window": 5000, "num_chunks": 1,
             "spike_th": None, "preprocessed": True, "num_frames": 10,
             "path": "data/DSEC"},
    "loader": {"resolution": [180, 240], "batch_size": 1, "augment": [],
               "augment_prob": [], "gpu": 0, "seed": 0, "n_epochs": 60,
               "polarity": True, "crop": None, "n_workers": 0},
    "hot_filter": {"enabled": True, "max_px": 100, "min_obvs": 5,
                   "max_rate": 0.8},
    "model": {},
    "spiking_neuron": {},
    "swin_transformer": {},
    "loss": {"lambda_mod": 1.0, "lambda_ang": 0.0, "gamma": None,
             "clip_grad": None},
    "optimizer": {"name": "AdamW", "lr": 1e-4, "wd": 0.01,
                  "scheduler": "multistep",
                  "milestones": [10, 20, 30, 40, 50, 70, 90, 120],
                  "num_acc": 1, "use_amp": True},
    "metrics": {"name": ["AEE"], "flow_scaling": 1.0, "mask_events": False},
    "vis": {"bars": False, "enabled": False, "store": False,
            "store_grads": False},
    "test": {"sample": 40, "n_valid": 5},
}


def _merge(dst: dict, src: dict) -> dict:
    for key, val in src.items():
        if isinstance(val, dict):
            dst.setdefault(key, {})
            _merge(dst[key], val)
        else:
            dst[key] = val
    return dst


def load_config(path: str) -> dict:
    """Load a YAML config over the defaults (reference-compatible schema)."""
    with open(path) as f:
        user = yaml.safe_load(f) or {}
    cfg = copy.deepcopy(_DEFAULTS)
    _merge(cfg, user)
    return combine_entries(cfg)


def merge_eval_config(train_cfg: dict, eval_cfg: dict) -> dict:
    """Overlay an eval-protocol config onto a train config: eval keys win,
    scalar top-level keys (``experiment:``) too."""
    merged = copy.deepcopy(train_cfg)
    _merge(merged, eval_cfg)
    return merged


def combine_entries(config: dict) -> dict:
    """Fold the top-level spiking_neuron section into model."""
    sn = config.pop("spiking_neuron", None)
    if sn:
        config.setdefault("model", {})["spiking_neuron"] = sn
    return config


def _surrogate_name(s: Optional[str]) -> Tuple[str, float]:
    if not s:
        return "atan", 2.0
    if "sigmoid" in str(s).lower():
        return "sigmoid", 4.0
    return "atan", 2.0


def build_configs(config: dict):
    """(model_cfg: dict, SwinConfig, SpikingConfig) from a parsed config."""
    model = dict(config.get("model", {}))
    sn = model.get("spiking_neuron") or config.get("spiking_neuron") or {}
    surrogate, alpha = _surrogate_name(sn.get("surrogate_fun"))
    spiking = SpikingConfig(
        num_steps=int(sn.get("num_steps", 10)),
        v_th=float(sn.get("v_th", 1.0)),
        v_reset=(None if sn.get("v_reset") is None
                 else float(sn.get("v_reset"))),
        neuron_type=str(sn.get("neuron_type", "lif")),
        surrogate=surrogate,
        surrogate_alpha=alpha,
        tau=float(sn.get("tau", 2.0)),
        detach_reset=bool(sn.get("detach_reset", True)),
        spike_norm=sn.get("spike_norm", "BN"),
        s2d_train=bool(model.get("s2d_train", False)),
    )

    st = config.get("swin_transformer", {}) or {}
    use_arc = st.get("use_arc", ["swinv1", "MS_PED_Spiking_PatchEmbed_Conv_sfn"])
    crop = config.get("loader", {}).get("crop")
    input_size = tuple(st.get("input_size", crop or (288, 384)))
    swin = SwinConfig(
        arc_type=use_arc[0],
        patch_embed_type=use_arc[1],
        input_size=tuple(int(v) for v in input_size),
        patch_size=tuple(int(v) for v in st.get("swin_patch_size",
                                                (1, 1, 2, 2))),
        depths=tuple(int(v) for v in st.get("swin_depths", (2, 2, 6, 2))),
        num_heads=tuple(int(v) for v in st.get("swin_num_heads",
                                               (3, 6, 12, 24))),
        out_indices=tuple(int(v) for v in st.get("swin_out_indices",
                                                 (0, 1, 2, 3))),
        window_size=tuple(int(v) for v in st.get("window_size", (2, 9, 9))),
        pretrained_window_size=tuple(
            int(v) for v in st.get("pretrained_window_size", (0, 0, 0))),
        mlp_ratio=float(st.get("mlp_ratio", 4.0)),
        qk_scale=st.get("qk_scale", 0.125),
        drop_path_rate=float(st.get("drop_path_rate", 0.2)),
    )
    return model, swin, spiking


def chunk_bins(config: dict) -> int:
    """The bins of a data chunk: ``data.num_frames`` per chunk times
    ``data.num_chunks`` (an STTFlowNet's input path follows from it)."""
    data = config.get("data", {})
    return int(data.get("num_frames", 10)) * int(data.get("num_chunks", 1))
