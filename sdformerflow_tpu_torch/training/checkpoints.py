"""Checkpoints, a mirror of ``sdformerflow_tpu/training/checkpoints.py`` with
``torch.save``: one file per epoch under a directory, the newest three
kept. A checkpoint holds the model's state (parameters and BN running
statistics), the optimizer's state, the step and the epoch.

Under data parallelism (a ``group``) every rank holds the same state: rank
0 writes and every rank waits for it at a barrier; every rank reads the
file, then takes rank 0's tensors (JAX's multi-process orbax save and
restore are collective in the same way). A model sharded over a model
group (``parallel/sharding_rules.py``) is saved whole, under the
one-process names (its model ranks gather each slice, the first of them
writes, every rank of the world waits), and a whole checkpoint is loaded
into either layout: a tensor-parallel checkpoint loads in one process and
the other way round.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.multihost import barrier, broadcast_state, rank_of
from ..parallel.sharding_rules import load_whole_state, tp_layout, whole_state

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
    rank returns once it has. A sharded model is gathered whole first (a
    collective over its model group)."""
    layout = tp_layout(model)
    model_sd, opt_sd = whole_state(model, optimizer)

    def wait():
        if layout is None:
            barrier(group)
        else:
            dist.barrier()

    if rank_of(group) != 0 or rank_of(layout and layout.group) != 0:
        wait()
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"model": model_sd, "optimizer": opt_sd,
               "step": int(step), "epoch": int(epoch),
               "metrics": dict(metrics or {})}
    path = _path(ckpt_dir, epoch)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _epochs(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))
    wait()


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    epochs = _epochs(ckpt_dir)
    return epochs[-1] if epochs else None


def restore_checkpoint(ckpt_dir: str, model, optimizer=None,
                       epoch: Optional[int] = None, group=None):
    """Load a checkpoint (the newest by default) into ``model`` and, unless
    it is None (evaluation, serving), ``optimizer``; returns (step,
    restored epoch). With a ``group`` every rank loads it, then takes rank
    0's tensors; a sharded model takes its slices of the whole tensors."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    dev = next(model.parameters()).device
    payload = torch.load(_path(ckpt_dir, epoch), map_location=dev,
                         weights_only=True)
    load_whole_state(model, payload["model"], optimizer,
                     None if optimizer is None else payload["optimizer"])
    broadcast_state(model, optimizer, group)
    return payload["step"], payload["epoch"]
