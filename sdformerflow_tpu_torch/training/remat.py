"""Rematerialization of the train step's forward, the port of JAX's
``make_train_step(remat=...)`` (``jax.checkpoint`` with a policy), for the
ANN family and every SNN of the zoo.

The policies keep, for the backward, the outputs of these aten ops and
recompute everything else:

- ``"dots"``: every matmul and convolution (JAX's ``checkpoint_dots``);
- ``"dots_no_batch"``: the matmuls without batch dimensions, ``mm`` and
  ``addmm`` (``dots_with_no_batch_dims_saveable``);
- ``"all"``: nothing (``nothing_saveable``).

K2 (the fused PSN site, ``ops/hopper_psn.py``) is one op, not a dot, so it
is recomputed under every policy: an SNN step under remat launches K2 twice
at each site of a checkpointed block (the forward and the recompute) and
K2b once. JAX's XLA path, which has no fused PSN op, keeps the T x T mix of
each site under ``checkpoint_dots``: that changes what is kept, not the
values.

JAX checkpoints the whole loss function and XLA schedules the recompute
inside the backward. ``torch.utils.checkpoint`` recomputes a region all at
once when the backward first needs it, so one region over the whole forward
would bring every activation back at the same time and save no memory.
:class:`Remat` therefore checkpoints each block of the model on its own,
the outermost first (a block inside another is not checkpointed again),
under a selective policy: the backward recomputes one block at a time. The
blocks (``REMAT_BLOCKS``): a Swin block, a patch merge, a residual block,
a conv layer of an encoder, a decoder or a prediction head, an embedding
or PED layer, in both families; an embed's full-resolution band
(``REMAT_BANDS``: the head and the stride-2 conv of the en4's MS_PED embed,
the largest activations at T = 10) is one region, so that none of it is
kept, and the embeds whose stride-1 head feeds residual blocks at full
resolution are one region whole. The gradients are the plain step's.

Three states that ``torch.utils.checkpoint`` does not restore are kept
right: the model's explicit drop-path generator is set back, for a block's
recompute, to its state at that block's forward (the same masks); the
running statistics of every norm that keeps them are not updated by a
recompute; and a neuron site that the telemetry collected
(``spiking_layers.collect_sites``) at the forward takes the same form in
the recompute (the MS attention fires ``attn_sn`` while collected), which
the backward may run after the collection has ended, but records
nothing. The recompute re-issues a data-parallel step's collectives (the
batch statistics' all-reduces, the swin blocks' row gathers) and a
tensor-parallel layer's gather, in the forward's order, on every rank.

A recompute runs the forward's ops on the forward's inputs, so it fires the
forward's spikes where each op is deterministic (``chip_smoke.py`` phase 21
counts the spikes that differ between a site's forward and its recompute on
the card).
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
from ..models.spiking_layers import (MSSpikingConvEncoderLayer,
                                     MSSpikingDecoderLayer,
                                     MSSpikingPredLayer,
                                     MSSpikingTransposeDecoderLayer,
                                     SpikingConvEncoderLayer,
                                     SpikingDecoderLayer,
                                     SpikingEmbeddingLayer, SpikingNeuron,
                                     SpikingPEDLayer, SpikingPredLayer,
                                     SpikingTransposeDecoderLayer, _ResBlock,
                                     _Site)
from ..models.spiking_patch_embed import (MSPEDSpikingPatchEmbedConvSfn,
                                          MSSpikingPatchEmbedConvLocal,
                                          SpikingPatchEmbedConv,
                                          SpikingPatchEmbedConvSfn,
                                          SpikingPatchEmbedLocal,
                                          SpikingPatchEmbedSfn,
                                          _S2DTrainExitLayer,
                                          _S2DTrainHeadLayer)
from ..models.spiking_swin import SpikingPatchMerging, SpikingSwinBlock3D

_MATMULS = ("mm", "addmm")
_BATCHED = ("bmm", "baddbmm")
_CONVS = ("convolution",)
REMAT_SAVED = {"dots": _MATMULS + _BATCHED + _CONVS,
               "dots_no_batch": _MATMULS, "all": ()}
# the blocks checkpointed one by one, each around its forward
REMAT_BLOCKS = (
    # the ANN family
    SwinBlock3D, PatchMerging, ResidualBlock, ConvLayer, UpsampleConvLayer,
    TransposedConvLayer,
    # the SNN zoo: swin blocks and merges, residual blocks (SEW and MS),
    # encoder / decoder / prediction layers, the embeds' layers
    SpikingSwinBlock3D, SpikingPatchMerging, _ResBlock,
    SpikingConvEncoderLayer, MSSpikingConvEncoderLayer, SpikingDecoderLayer,
    MSSpikingDecoderLayer, SpikingTransposeDecoderLayer,
    MSSpikingTransposeDecoderLayer, SpikingPredLayer, MSSpikingPredLayer,
    SpikingEmbeddingLayer, SpikingPEDLayer, _S2DTrainHeadLayer,
    _S2DTrainExitLayer,
    # embeds that stay at full resolution until their last layer: whole
    SpikingPatchEmbedSfn, SpikingPatchEmbedLocal,
    MSSpikingPatchEmbedConvLocal)
# embeds whose full-resolution band (their ``band`` method, over these
# children) is one region; their other children are blocks of their own
REMAT_BANDS = {MSPEDSpikingPatchEmbedConvSfn: ("head", "conv"),
               SpikingPatchEmbedConvSfn: ("head", "conv"),
               SpikingPatchEmbedConv: ("head", "conv")}


def _policy_context(policy: str):
    saved = {getattr(torch.ops.aten, name) for name in REMAT_SAVED[policy]}

    def policy_fn(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return (ckpt.CheckpointPolicy.MUST_SAVE
                if op.overloadpacket in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return ckpt.create_selective_checkpoint_contexts(policy_fn)


def running_stat_norms(module: nn.Module) -> list:
    """The modules of ``module`` that keep running statistics (a
    ``running_*`` buffer): every one must have ``update_running_stats``
    (``TorchBatchNorm``: BN, TDBN, BNTT's per-step BNs, the s2d block BN,
    the ANN's BN; BN_notrack and the group norms keep none)."""
    norms = []
    for name, m in module.named_modules():
        if any(b.startswith("running_")
               for b, _ in m.named_buffers(recurse=False)):
            if not hasattr(m, "update_running_stats"):
                raise TypeError(f"{name or type(m).__name__} keeps running "
                                "statistics but has no update_running_stats")
            norms.append(m)
    return norms


def _collected(module: nn.Module) -> set:
    """The neuron sites of ``module`` that the telemetry collects now."""
    return {m for m in module.modules()
            if isinstance(m, SpikingNeuron) and m.telemetry is not None}


_MUTED = _Site("", {})
_MUTED.muted = True


@contextlib.contextmanager
def _recomputing(module: nn.Module, collected: set):
    """A recompute of ``module``: its norms' running statistics left as
    they are, and its neuron sites collected as at the forward
    (``collected``; the forms they take depend on it) but muted."""
    norms = running_stat_norms(module)
    flags = [m.update_running_stats for m in norms]
    neurons = [m for m in module.modules() if isinstance(m, SpikingNeuron)]
    sites = [m.telemetry for m in neurons]
    for m in norms:
        m.update_running_stats = False
    for m in neurons:
        m.telemetry = _MUTED if m in collected else None
    try:
        yield
    finally:
        for m, flag in zip(norms, flags):
            m.update_running_stats = flag
        for m, site in zip(neurons, sites):
            m.telemetry = site


def remat_blocks(model: nn.Module) -> list:
    """``(module, method)`` of every region of ``model``: the outermost
    modules of a ``REMAT_BLOCKS`` class (``"forward"``) and the bands of
    the ``REMAT_BANDS`` embeds (``"band"``), a module inside a region left
    out."""
    blocks, inside = [], []
    for name, m in model.named_modules():
        if any(name == n or name.startswith(n + ".") for n in inside):
            continue
        band = REMAT_BANDS.get(type(m))
        if band is not None:
            blocks.append((m, "band"))
            inside += [f"{name}.{c}" if name else c for c in band]
        elif isinstance(m, REMAT_BLOCKS):
            blocks.append((m, "forward"))
            inside.append(name)
    return blocks


class _Method(nn.Module):
    """``module.<method>`` as a module's forward, so that a recompute can
    run it through ``torch.func.functional_call``."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module, self.method = module, method

    def forward(self, *args, **kwargs):
        return getattr(type(self.module), self.method)(self.module, *args,
                                                       **kwargs)


class Remat:
    """``with remat: forward`` runs every region of ``model``
    (:func:`remat_blocks`) under its own selective checkpoint; call
    :meth:`done` after the backward, which leaves ``generator`` where the
    forward left it (a recompute sets it back). Keyword arguments reach the
    region (``SpikingSwinBlock3D(x, return_attention=...)``). A model with
    no region raises ``ValueError``."""

    def __init__(self, model: nn.Module, policy: str, generator=None):
        if policy not in REMAT_SAVED:
            raise ValueError(f"remat policy {policy!r}: one of "
                             f"{sorted(REMAT_SAVED)}")
        self.blocks = remat_blocks(model)
        if not self.blocks:
            raise ValueError(f"remat: {type(model).__name__} has no block "
                             "to rematerialize")
        self.policy, self.generator = policy, generator
        self._after = None

    def __enter__(self):
        for m, method in self.blocks:
            setattr(m, method, functools.partial(self._forward, m, method))
        return self

    def __exit__(self, *exc):
        for m, method in self.blocks:
            delattr(m, method)
        if self.generator is not None:
            self._after = self.generator.get_state()

    def done(self):
        if self._after is not None:
            self.generator.set_state(self._after)
            self._after = None

    def _forward(self, module, method, *args, **kwargs):
        # the parameters the forward sees (a compute-dtype cast inside
        # functional_call), for the recompute after that call has returned
        params = {f"module.{n}": p for n, p in module.named_parameters()}
        collected = _collected(module)
        gen = self.generator
        start = None if gen is None else gen.get_state()
        runs = []

        def body(*a, **kw):
            if not runs:
                runs.append(1)
                return getattr(type(module), method)(module, *a, **kw)
            if gen is not None:
                gen.set_state(start)
            with _recomputing(module, collected):
                return torch.func.functional_call(_Method(module, method),
                                                  params, a, kw)

        return ckpt.checkpoint(
            body, *args, use_reentrant=False,
            context_fn=functools.partial(_policy_context, self.policy),
            **kwargs)
