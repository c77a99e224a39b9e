"""Checkpoints, a mirror of ``sdformerflow_tpu/training/checkpoints.py`` with
``torch.save``: one file per epoch under a directory, the newest three
kept. A checkpoint holds the model's state (parameters and BN running
statistics), the optimizer's state, the step and the epoch.

Under data parallelism (a ``group``) every rank holds the same state: rank
0 writes and every rank waits for it at a barrier; every rank reads the
file, then takes rank 0's tensors (JAX's multi-process orbax save and
restore are collective in the same way).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..parallel.multihost import barrier, broadcast_state, rank_of

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch:06d}.pt")


def _epochs(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(ckpt_dir)) if m)


def save_checkpoint(ckpt_dir: str, model, optimizer, epoch: int, step: int,
                    *, metrics: Optional[dict] = None, max_to_keep: int = 3,
                    group=None):
    """Write the checkpoint of ``epoch`` (atomically) and delete all but
    the ``max_to_keep`` newest; with a ``group``, rank 0 writes and every
    rank returns once it has."""
    if rank_of(group) != 0:
        barrier(group)
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"model": model.state_dict(),
               "optimizer": optimizer.state_dict(),
               "step": int(step), "epoch": int(epoch),
               "metrics": dict(metrics or {})}
    path = _path(ckpt_dir, epoch)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _epochs(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))
    barrier(group)


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    epochs = _epochs(ckpt_dir)
    return epochs[-1] if epochs else None


def restore_checkpoint(ckpt_dir: str, model, optimizer=None,
                       epoch: Optional[int] = None, group=None):
    """Load a checkpoint (the newest by default) into ``model`` and, unless
    it is None (evaluation, serving), ``optimizer``; returns (step,
    restored epoch). With a ``group`` every rank loads it, then takes rank
    0's tensors."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    dev = next(model.parameters()).device
    payload = torch.load(_path(ckpt_dir, epoch), map_location=dev,
                         weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    broadcast_state(model, optimizer, group)
    return payload["step"], payload["epoch"]
