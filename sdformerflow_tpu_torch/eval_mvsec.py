"""MVSEC evaluation on one card (dt1/dt4 cross-dataset transfer), the
port's counterpart of ``scripts/eval_mvsec.py``: the 256x256 center crop,
AEE / AAE on the ``|flow| < 1000`` validity mask (``outdoor_day1`` masks
the car's hood rows) and, with ``metrics.mask_events``, the encoded
chunk's footprint. Run from the repository root:

    python -m sdformerflow_tpu_torch.eval_mvsec \\
        --train_config configs/train_mdr_sdformerflow.yaml \\
        --eval_config configs/eval_mvsec.yaml --ckpt runs/mdr/ckpt \\
        --path <root> [--sequence indoor_flying1] [--max_batches N] \\
        [--device cpu]

The protocol is JAX's: BN on its running statistics; the event mask is
the footprint of the encoded chunk, not the dataset's ``event_valid``
histogram; per-sample metric sums over the sample count; the whole
sequence unless ``--max_batches``. The metrics are computed in float64
(``eval_dsec.evaluate``). The sequence is ``data.test_sequence``
(``--sequence``) at ``data.event_interval`` (dt1 or dt4, set by the eval
config). Weights come from a port checkpoint directory (``--ckpt``) or a
``.pt`` under the reference's state_dict names (``--torch_ckpt``).
``results.json`` in the run directory holds the metrics and the sequence.

It runs on the CUDA card unless ``--device cpu`` is given, and fails when
there is no card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import eval_dsec
from .data.adapters import MvsecChunkAdapter
from .data.dsec import SyntheticEventFlowDataset
from .data.mvsec import MvsecEventFlow, MvsecEventFlow_dt4
from .models.registry import get_model
from .training.config import (build_configs, chunk_bins, load_config,
                              merge_eval_config)
from .utils.logging import RunLogger


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train_config", required=True)
    ap.add_argument("--eval_config", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory of the port's trainer")
    ap.add_argument("--torch_ckpt", default=None,
                    help=".pt/.pth under the reference's state_dict names")
    ap.add_argument("--run_dir", default="runs/eval_mvsec")
    ap.add_argument("--path", default=None, help="override data.path")
    ap.add_argument("--sequence", default=None,
                    help="override data.test_sequence")
    ap.add_argument("--synthetic", action="store_true",
                    help="evaluate on 8 seeded synthetic windows")
    ap.add_argument("--max_batches", type=int, default=None,
                    help="stop after this many batches (the protocol runs "
                         "the whole sequence)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_dataset(config: dict, synthetic=False):
    """``data.test_sequence`` at ``data.event_interval`` as (chunk, mask,
    label) items, or 8 seeded synthetic windows at the crop."""
    num_chunks = config["data"].get("num_chunks", 1)
    if synthetic:
        crop = config["loader"]["crop"]
        bins = config["data"]["num_frames"] * num_chunks
        return SyntheticEventFlowDataset(8, bins, crop[0], crop[1], seed=3)
    cls = (MvsecEventFlow if config["data"].get("event_interval", "dt1")
           == "dt1" else MvsecEventFlow_dt4)
    return MvsecChunkAdapter(cls(config, train=False), num_chunks)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("eval_mvsec: no CUDA device; pass --device cpu to "
                         "evaluate on the CPU")
    if args.ckpt and args.torch_ckpt:
        raise SystemExit("eval_mvsec: give --ckpt or --torch_ckpt, not both")
    config = load_config(args.train_config)
    if args.eval_config:
        config = merge_eval_config(config, load_config(args.eval_config))
    if args.path:
        config["data"]["path"] = args.path
    if args.sequence:
        config["data"]["test_sequence"] = args.sequence
    dataset = build_dataset(config, synthetic=args.synthetic)

    crop = tuple(config["loader"].get("crop", (256, 256)))
    model_cfg, swin_cfg, spiking_cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg,
                      swin_cfg.replace(input_size=crop), spiking_cfg,
                      input_bins=chunk_bins(config))
    eval_dsec.load_weights(model, ckpt=args.ckpt, torch_ckpt=args.torch_ckpt)
    model.to(args.device)
    results = eval_dsec.evaluate(config, model, dataset, device=args.device,
                                 max_batches=args.max_batches)
    results["sequence"] = config["data"].get("test_sequence")
    logger = RunLogger(args.run_dir, config)
    logger.log_artifact_dict("results.json", results)
    logger.close()
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
