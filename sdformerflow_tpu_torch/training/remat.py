"""Rematerialization of the train step's forward, the port of JAX's
``make_train_step(remat=...)`` (``jax.checkpoint`` with a policy).

The policies keep, for the backward, the outputs of these aten ops and
recompute everything else:

- ``"dots"``: every matmul and convolution (JAX's ``checkpoint_dots``);
- ``"dots_no_batch"``: the matmuls without batch dimensions, ``mm`` and
  ``addmm`` (``dots_with_no_batch_dims_saveable``);
- ``"all"``: nothing (``nothing_saveable``).

JAX checkpoints the whole loss function and XLA schedules the recompute
inside the backward. ``torch.utils.checkpoint`` recomputes a region all at
once when the backward first needs it, so one region over the whole forward
would bring every activation back at the same time and save no memory.
:class:`Remat` therefore checkpoints each block of the model (a Swin block,
a patch merge, a residual block, a conv layer of the decoder or a U-Net
encoder; the outermost such module) on its own, under a selective policy:
the backward recomputes one block at a time. The gradients are the plain
step's.

Two states that ``torch.utils.checkpoint`` does not restore are kept right:
the model's explicit drop-path generator is set back, for a block's
recompute, to its state at that block's forward (the same masks), and BN
running statistics are not updated by a recompute.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn as nn
import torch.utils.checkpoint as ckpt

from ..models.ann_layers import (ConvLayer, ResidualBlock, TransposedConvLayer,
                                 UpsampleConvLayer)
from ..models.ann_swin import PatchMerging, SwinBlock3D
from ..models.spiking_layers import TorchBatchNorm

_MATMULS = ("mm", "addmm")
_BATCHED = ("bmm", "baddbmm")
_CONVS = ("convolution",)
REMAT_SAVED = {"dots": _MATMULS + _BATCHED + _CONVS,
               "dots_no_batch": _MATMULS, "all": ()}
# the blocks checkpointed one by one (the ANN family's)
REMAT_BLOCKS = (SwinBlock3D, PatchMerging, ResidualBlock, ConvLayer,
                UpsampleConvLayer, TransposedConvLayer)


def _policy_context(policy: str):
    saved = {getattr(torch.ops.aten, name) for name in REMAT_SAVED[policy]}

    def policy_fn(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return (ckpt.CheckpointPolicy.MUST_SAVE
                if op.overloadpacket in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return ckpt.create_selective_checkpoint_contexts(policy_fn)


@contextlib.contextmanager
def _frozen_bn_stats(module: nn.Module):
    """BN running statistics of ``module`` left as they are."""
    bns = [m for m in module.modules() if isinstance(m, TorchBatchNorm)]
    flags = [m.update_running_stats for m in bns]
    for m in bns:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m, flag in zip(bns, flags):
            m.update_running_stats = flag


def remat_blocks(model: nn.Module) -> list:
    """The outermost modules of ``model`` of a ``REMAT_BLOCKS`` class."""
    blocks, names = [], []
    for name, m in model.named_modules():
        if isinstance(m, REMAT_BLOCKS) and not any(
                name.startswith(n + ".") for n in names):
            blocks.append(m)
            names.append(name)
    return blocks


class Remat:
    """``with remat: forward`` runs every block of ``model`` under its own
    selective checkpoint; call :meth:`done` after the backward, which
    leaves ``generator`` where the forward left it (a recompute sets it
    back). Raises ``NotImplementedError`` for a model with no such block
    (the SNN: remat is ported for the ANN family)."""

    def __init__(self, model: nn.Module, policy: str, generator=None):
        if policy not in REMAT_SAVED:
            raise ValueError(f"remat policy {policy!r}: one of "
                             f"{sorted(REMAT_SAVED)}")
        self.blocks = remat_blocks(model)
        if not self.blocks:
            raise NotImplementedError(
                f"remat: {type(model).__name__} has no block to "
                "rematerialize (remat is ported for the ANN family)")
        self.policy, self.generator = policy, generator
        self._after = None

    def __enter__(self):
        for m in self.blocks:
            m.forward = functools.partial(self._forward, m)
        return self

    def __exit__(self, *exc):
        for m in self.blocks:
            del m.forward
        if self.generator is not None:
            self._after = self.generator.get_state()

    def done(self):
        if self._after is not None:
            self.generator.set_state(self._after)
            self._after = None

    def _forward(self, module, *args):
        # the parameters the forward sees (a compute-dtype cast inside
        # functional_call), for the recompute after that call has returned
        params = dict(module.named_parameters())
        gen = self.generator
        start = None if gen is None else gen.get_state()
        runs = []

        def body(*a):
            if not runs:
                runs.append(1)
                return type(module).forward(module, *a)
            if gen is not None:
                gen.set_state(start)
            with _frozen_bn_stats(module):
                return torch.func.functional_call(module, params, a)

        return ckpt.checkpoint(
            body, *args, use_reentrant=False,
            context_fn=functools.partial(_policy_context, self.policy))
