"""Model export: the inference step as ``torch.export`` programs, a port of
``sdformerflow_tpu/training/export.py``.

JAX serializes the jitted eval step to StableHLO with the weights baked in.
The port's deployment unit is the ``torch.export`` program of the same step
(:class:`training.train_step.EvalStep`), weights included, saved as
``.pt2``. Its kernels are custom ops (``sdformerflow_torch::qk_attn_interior``
K1, ``::fused_affine_psn`` K2, ``::voxelize_batch`` K3, registered by
``ops/hopper_{attn,psn,voxel}.py``), so a program carries one op node per
kernel launch, and a process that loads it needs those three modules and
torch, and no model code.

Artifacts written by :func:`export_flow_model` into ``out_dir``:

- ``voxel.pt2``: flow from a preprocessed voxel chunk ``[B, bins, H, W]``
  float32 (crop size; ``bins`` the chunk's, ``data.num_frames *
  data.num_chunks``, which an STT config doubles), the eval-protocol step;
- ``events_<N>.pt2``, one per requested event bucket: flow from raw padded
  event buffers ``{x, y, t, p: [B, N] float32, valid: [B, N] bool}``,
  voxelized on the device (K3 on the card) and center-cropped, the serving
  step;
- ``export_meta.json``: shapes, dtypes, the device, the bucket list.

Both return the finest flow ``[B, 2, H, W]`` float32. Deviation from JAX:
an exported program is tied to the device it was traced on (its weights
live there and its op nodes dispatch by device), so the meta records
``device`` where JAX records ``platforms``, and there is no multi-platform
artifact. JAX traces the voxel step at ``data.num_frames`` bins, which
an STT model built for two chunks refuses; the port traces it at the
chunk's bins, and refuses event buckets for such a config up front (the
server's ``ValueError``: the events are voxelized into ``num_frames``
bins).
"""

from __future__ import annotations

import copy
import json
import os
import warnings
from typing import Optional, Sequence

import torch
import torch.nn as nn

# the kernels' op registrations: torch.export.load resolves the op nodes
from ..ops import hopper_attn, hopper_psn, hopper_voxel  # noqa: F401

META_NAME = "export_meta.json"


def build_inference_state(config: dict, ckpt: Optional[str] = None,
                          s2d: bool = False, *, device,
                          state_dict: Optional[dict] = None) -> nn.Module:
    """The model of a merged config on ``device``, for inference: built,
    with ``state_dict`` or ``ckpt`` loaded (not both), and with ``s2d`` the
    exact space-to-depth embed re-expression applied after the restore
    (``training/s2d_embed.py``). ``ckpt`` is a checkpoint directory of the
    port's trainer (the newest epoch) or a ``.pt`` file under the
    reference's state_dict names. ``FlowServer`` and the exporter build
    through here, so that serving and export share one construction.

    JAX's ``fused_attn`` flag has no counterpart: the port's eval attention
    runs K1 at every even window count on the card."""
    from ..models.registry import get_model
    from .checkpoints import restore_checkpoint
    from .config import build_configs, chunk_bins
    from .s2d_embed import s2d_embed_state_dict
    from .torch_interop import load_reference_state_dict, load_torch_checkpoint

    if state_dict is not None and ckpt is not None:
        raise ValueError("give state_dict or ckpt, not both")
    model_cfg, swin_cfg, spiking_cfg = build_configs(config)
    name = config["model"]["name"]
    model = get_model(name, model_cfg, swin_cfg, spiking_cfg,
                      input_bins=chunk_bins(config))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if ckpt is not None and os.path.isdir(ckpt):
        restore_checkpoint(ckpt, model)
    elif ckpt is not None:
        state, unmatched = load_reference_state_dict(
            load_torch_checkpoint(ckpt), model)
        if unmatched:
            warnings.warn(f"{len(unmatched)} reference keys of {ckpt} "
                          f"unmatched, e.g. {unmatched[:5]}")
        model.load_state_dict(state)
    if s2d:
        s2d_state = s2d_embed_state_dict(model.state_dict())
        model = get_model(name, model_cfg, swin_cfg,
                          spiking_cfg.replace(s2d_embed=True))
        model.load_state_dict(s2d_state)
    return model.to(device)


def step_kwargs(config: dict, *, bf16: bool, events: bool) -> dict:
    """``make_eval_step``'s keywords for a config's served step: the voxel
    step, or with ``events`` the raw-events step (voxelize at sensor
    resolution, then center crop)."""
    kw = dict(encoding=config["model"].get("encoding", "voxel"),
              polarity=config["loader"].get("polarity", True)
              and "Spiking" in config["model"]["name"],
              norm_input=config["model"].get("norm_input"),
              spike_th=config["data"].get("spike_th"),
              compute_dtype=torch.bfloat16 if bf16 else None)
    if events:
        res = tuple(config["loader"].get("resolution", (480, 640)))
        crop = config["loader"].get("crop")
        kw.update(voxelize=dict(num_bins=config["data"].get("num_frames", 10),
                                height=res[0], width=res[1]),
                  crop=tuple(crop) if crop else None)
    return kw


class _Finest(nn.Module):
    """An eval step's finest flow [B, 2, H, W] float32."""

    def __init__(self, step: nn.Module):
        super().__init__()
        self.step = step

    def forward(self, chunk):
        return self.step(chunk)[-1]


def _eval_fn(config: dict, model: nn.Module, *, bf16: bool,
             events: bool) -> nn.Module:
    """The inference step as a module (not under ``inference_mode``, so
    that ``torch.export`` can trace it): the voxel step, or the events
    step, returning the finest flow. bf16 casts a copy of ``model``
    unless its parameters are bfloat16 already (:func:`cast_for`)."""
    from .train_step import make_eval_step

    step = make_eval_step(model, **step_kwargs(config, bf16=bf16,
                                               events=events))
    return _Finest(step.module).eval()


def cast_for(model: nn.Module, bf16: bool) -> nn.Module:
    """``model``, or with ``bf16`` one copy cast as the eval step casts it,
    which every :func:`_eval_fn` of it then shares."""
    from .train_step import cast_params

    return cast_params(copy.deepcopy(model), torch.bfloat16) if bf16 \
        else model


def export_flow_model(config: dict, model: nn.Module, out_dir: str, *,
                      bf16: bool = True, batch: int = 1, device="cuda",
                      event_buckets: Sequence[int] = ()) -> dict:
    """Export the voxel-input eval step (and the raw-events steps, one per
    padded bucket size) of ``model``, which lies on ``device``, as
    ``torch.export`` programs under ``out_dir``, traced under
    ``torch.no_grad()``. Returns the metadata dict (also written to
    ``export_meta.json``)."""
    from .config import chunk_bins

    num_bins, in_bins = config["data"].get("num_frames", 10), \
        chunk_bins(config)
    if event_buckets and in_bins != num_bins:
        raise ValueError(
            f"events are voxelized into data.num_frames = {num_bins} bins "
            f"but the model takes {in_bins}-bin chunks (data.num_chunks = "
            f"{in_bins // num_bins}): export the voxel program only")
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device(device)
    model = cast_for(model, bf16)
    res = tuple(config["loader"].get("resolution", (480, 640)))
    crop = config["loader"].get("crop")
    h, w = tuple(crop) if crop else res
    meta = {"device": device.type, "bf16": bf16, "batch": batch,
            "model": config["model"]["name"], "num_bins": num_bins,
            "resolution": list(res), "crop": list(crop) if crop else None,
            "artifacts": {}}

    def _export(fn, example, name):
        with torch.no_grad():
            program = torch.export.export(fn, (example,))
        torch.export.save(program, os.path.join(out_dir, name + ".pt2"))

    voxel_shape = (batch, in_bins, h, w)
    _export(_eval_fn(config, model, bf16=bf16, events=False),
            torch.zeros(voxel_shape, device=device), "voxel")
    meta["artifacts"]["voxel"] = {"input": list(voxel_shape),
                                  "dtype": "float32"}
    for n in event_buckets:
        n = int(n)
        example = {k: torch.zeros((batch, n), device=device)
                   for k in ("x", "y", "t", "p")}
        example["valid"] = torch.ones((batch, n), dtype=torch.bool,
                                      device=device)
        _export(_eval_fn(config, model, bf16=bf16, events=True), example,
                f"events_{n}")
        meta["artifacts"][f"events_{n}"] = {
            "input": {"x/y/t/p": [batch, n], "valid": [batch, n]}}

    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _in_inference_mode(program):
    module = program.module()

    def run(inputs):
        # the lifted parameters come back requiring grad; K1 and K2 are
        # forward-only
        with torch.inference_mode():
            return module(inputs)
    run.program = program
    return run


def load_exported(out_dir: str):
    """Load an exported directory; returns ``(meta, {name: callable})``.

    Needs only torch and the kernels' op registrations: no model code,
    checkpoint or config. Each callable runs its program under
    ``torch.inference_mode()`` on the inputs recorded in
    ``export_meta.json`` (on the device it was exported on) and returns the
    flow ``[B, 2, H, W]`` float32; its ``program`` is the loaded
    ``ExportedProgram``.
    """
    with open(os.path.join(out_dir, META_NAME)) as f:
        meta = json.load(f)
    fns = {}
    for name in meta["artifacts"]:
        program = torch.export.load(os.path.join(out_dir, name + ".pt2"))
        fns[name] = _in_inference_mode(program)
    return meta, fns
