"""Supervised MDR training on one card or data-parallel over several,
validated on MVSEC, the port's counterpart of ``scripts/train_mdr.py``
(ANN or SNN by config). Run from the repository root:

    python -m sdformerflow_tpu_torch.train_mdr \\
        --config configs/train_mdr_sdformerflow.yaml --run_dir runs/mdr \\
        [--path <root>] [--synthetic] [--max_steps N] [--resume] \\
        [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given, and fails when
there is no card. ``data.path`` (``--path``) holds the MDR train split
(``dt1/train``: ``events1``, ``events2``, ``best_density_events1/2``
``.npz`` and ``flow`` ``.flo``) and the MVSEC sequences
(``<sequence>/event/NNNNNN.h5``, ``<sequence>/flowgt_dt1|dt4/N.npy``);
the train items are voxelized and augmented (scale, stretch, flips, crop)
on the host (``data/mdr.py``), the validation reads ``data.test_sequence``
at ``data.event_interval`` (``data/mvsec.py``). The datasets crop, so the
loop's own augmentation and crop are turned off and the model is built at
the crop. ``--synthetic`` trains on seeded synthetic chunks at the crop.
Under ``torchrun`` it trains data-parallel, as ``train_dsec`` does.
"""

from __future__ import annotations

import argparse
import copy
import sys

import torch

from .data.adapters import MDRChunkAdapter, MvsecChunkAdapter
from .data.dsec import SyntheticEventFlowDataset
from .data.mdr import MDREventFlow
from .data.mvsec import MvsecEventFlow, MvsecEventFlow_dt4
from .parallel import multihost
from .training.config import load_config
from .training.train_loop import train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--run_dir", default="runs/mdr")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--path", default=None, help="override data.path")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic data (runs without MDR/MVSEC)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_datasets(config: dict, synthetic=False):
    """(train, valid): the MDR train split with the augmentor and the
    MVSEC ``data.test_sequence`` at ``data.event_interval``, as
    (chunk, mask, label) adapters, or seeded synthetic chunks at the
    crop."""
    num_chunks = config["data"].get("num_chunks", 1)
    crop = config["loader"].get("crop")
    if synthetic:
        bins = config["data"]["num_frames"] * num_chunks
        return (SyntheticEventFlowDataset(32, bins, crop[0], crop[1]),
                SyntheticEventFlowDataset(8, bins, crop[0], crop[1],
                                          seed=99))
    train_ds = MDRChunkAdapter(MDREventFlow(config, train=True, aug=True),
                               num_chunks, train=True)
    cls = (MvsecEventFlow if config["data"].get("event_interval", "dt1")
           == "dt1" else MvsecEventFlow_dt4)
    return train_ds, MvsecChunkAdapter(cls(config, train=False), num_chunks)


def loop_config(config: dict) -> dict:
    """The config the loop gets: the datasets augment and crop, so no
    augmentation and no crop there, and the resolution is the crop."""
    out = copy.deepcopy(config)
    out["loader"]["augment"] = []
    out["loader"]["resolution"] = list(out["loader"]["crop"])
    out["loader"]["crop"] = None
    return out


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("train_mdr: no CUDA device; pass --device cpu to "
                         "train on the CPU")
    config = load_config(args.config)
    if args.path:
        config["data"]["path"] = args.path
    train_ds, valid_ds = build_datasets(config, synthetic=args.synthetic)
    joined = multihost.join_launcher_group(args.device)
    try:
        return train(loop_config(config), train_ds, valid_ds,
                     run_dir=args.run_dir, resume=args.resume,
                     max_steps=args.max_steps, device=args.device)
    finally:
        if joined:
            multihost.leave()


if __name__ == "__main__":
    main(sys.argv[1:])
