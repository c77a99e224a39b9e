"""Supervised DSEC training on one card or data-parallel over several,
the port's counterpart of ``scripts/train_dsec.py``. Run from the
repository root:

    python -m sdformerflow_tpu_torch.train_dsec \\
        --config configs/train_dsec_sdformerflow_en4.yaml --run_dir runs/en4 \\
        [--synthetic] [--max_steps N] [--resume] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given, and fails when
there is no card. It reads the DSEC tree at ``data.path`` (``--path``) with
the ``train`` and ``valid`` splits: raw event lists when the config sets
``data.events_input: list`` or ``data.preprocessed: false``, else voxel
tensors (``data/dsec.py``). ``--synthetic`` trains on seeded synthetic
samples at the config's ``loader.resolution`` instead.

Data-parallel over several cards, one process each, ``loader.batch_size``
the global batch (``training/train_loop.py``):

    python -m torch.distributed.run --nproc_per_node 8 \
        -m sdformerflow_tpu_torch.train_dsec --config <yaml> [...]

Under ``torchrun`` (``WORLD_SIZE`` in the environment) each process joins
the group (NCCL; gloo with ``--device cpu``) and trains on
``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .data.dsec import (DSECDatasetLite, DSECEventListDataset,
                        SyntheticEventFlowDataset, SyntheticEventListDataset)
from .parallel import multihost
from .training.config import load_config
from .training.train_loop import train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--run_dir", default="runs/dsec")
    ap.add_argument("--path", default=None, help="override data.path")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None,
                    help="override optimizer.lr")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic data (runs without DSEC)")
    ap.add_argument("--structured", action="store_true",
                    help="learnable synthetic task (moving bar)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("train_dsec: no CUDA device; pass --device cpu to "
                         "train on the CPU")
    config = load_config(args.config)
    if args.lr is not None:
        config["optimizer"]["lr"] = args.lr
    if args.path:
        config["data"]["path"] = args.path
    events_mode = (config["data"].get("events_input") == "list"
                   or not config["data"].get("preprocessed", True))
    if args.synthetic:
        res = config["loader"]["resolution"]
        kw = dict(num_bins=config["model"]["num_bins"], height=res[0],
                  width=res[1], structured=args.structured)
        cls = SyntheticEventListDataset if events_mode else \
            SyntheticEventFlowDataset
        train_ds = cls(num_samples=32, **kw)
        valid_ds = cls(num_samples=8, seed=999, **kw)
    else:
        cls = DSECEventListDataset if events_mode else DSECDatasetLite
        train_ds, valid_ds = cls(config, "train"), cls(config, "valid")
    joined = multihost.join_launcher_group(args.device)
    try:
        return train(config, train_ds, valid_ds, run_dir=args.run_dir,
                     resume=args.resume, max_steps=args.max_steps,
                     device=args.device)
    finally:
        if joined:
            multihost.leave()


if __name__ == "__main__":
    main(sys.argv[1:])
