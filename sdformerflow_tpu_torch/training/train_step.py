"""The train and eval steps, a mirror of
``sdformerflow_tpu/training/train_step.py``: ``make_train_step`` and
``make_eval_step`` over voxel chunks or raw events, and ``voxelize_batch``.

A step works on the model and the optimizer in place (JAX threads a
TrainState through); it returns device scalars and never waits for the
device.
"""

from __future__ import annotations

import contextlib
import copy

import torch
import torch.nn as nn

from ..losses import flow_loss_supervised
from ..models.spiking_layers import TorchBatchNorm, collect_sites
from ..ops.hopper_embed import fused_embed_forward
from ..ops.hopper_voxel import voxel_batch_signed
from ..ops.normalization import encode_input
from ..parallel.multihost import all_reduce_sum
from ..utils import tracing
from .evaluate import event_footprint_mask
from .remat import Remat


def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter to ``dtype`` in place; buffers (the BN running
    statistics) keep their float32, as ``make_eval_step`` keeps
    ``batch_stats``."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model


def voxelize_batch(events, *, num_bins, height, width, presorted=False):
    """Padded event buffers -> signed voxel chunks on the events' device:
    dict(x, y, t, p, valid) of [B, N] tensors (x/y/t/p float32, valid
    bool) -> [B, num_bins, H, W] float32, through K3 on the card: one
    launch a row, which finds its row's span itself and writes straight
    into its row of the output (``hopper_voxel.voxel_batch_signed``, one
    op call when traced).

    Each row's ``t_range`` is the span of its valid events, so padding
    slots never stretch it. ``presorted`` is accepted for the JAX signature;
    K3 sorts on the card and ignores it.
    """
    del presorted
    return voxel_batch_signed(*(events[k] for k in ("x", "y", "t", "p",
                                                    "valid")),
                              num_bins=num_bins, height=height, width=width)


def center_crop(chunk: torch.Tensor, crop) -> torch.Tensor:
    """The DSEC eval protocol's center crop of the last two axes (a view)."""
    ch, cw = crop
    H, W = chunk.shape[-2:]
    y0, x0 = (H - ch) // 2, (W - cw) // 2
    return chunk[..., y0:y0 + ch, x0:x0 + cw]


def _set_mode(model: nn.Module, *, train: bool, update_bn_stats: bool = True,
              generator=None, group=None):
    """Train or eval mode; in train mode whether BN updates its running
    statistics, the generator drop-path draws from, and the data-parallel
    group of every module that takes one (the batch statistics, the
    drop-path draws, the swin blocks' gathered rows)."""
    model.train(train)
    for m in model.modules():
        if isinstance(m, TorchBatchNorm):
            m.update_running_stats = update_bn_stats
        if hasattr(m, "group"):
            m.group = group
        if hasattr(m, "drop_path_generator"):
            m.drop_path_generator = generator


def _model_input(chunk, batch_crop, voxelize, crop, *, encoding, polarity,
                 norm_input, spike_th, group=None, per_row=False, windows=1):
    """Voxelize raw events (``voxelize``; a dict ``{"windows": [events,
    ...]}`` each window over its own time span, their bins concatenated)
    and crop, then encode (over the rows of every rank of ``group``; each
    row on its own with ``per_row``; each of ``windows`` windows on its
    own): the model's [B, bins, 2, H, W] input."""
    if voxelize is not None and isinstance(chunk, dict):
        if "windows" in chunk:
            chunk = torch.cat([voxelize_batch(w, **voxelize)
                               for w in chunk["windows"]], dim=1)
        else:
            chunk = voxelize_batch(chunk, **voxelize)
        if batch_crop is not None:
            chunk = center_crop(chunk, batch_crop)
    if crop is not None:
        chunk = center_crop(chunk, crop)
    if chunk.dim() == 4 or encoding == "voxel":
        return encode_input(chunk, encoding=encoding, polarity=polarity,
                            norm_input=norm_input, spike_th=spike_th,
                            group=group, per_row=per_row, windows=windows)
    return chunk


def make_train_step(model: nn.Module, optimizer, *, encoding="voxel",
                    polarity=True, norm_input="minmax", spike_th=None,
                    flow_scaling=1.0, gamma=None, mask_events=False,
                    voxelize=None, compute_dtype=None, remat=None, crop=None,
                    generator=None, group=None):
    """Return ``train_step(batch) -> {"loss", "grad_norm"}`` (device
    scalars): forward in train mode (batch-statistics BN, running statistics
    updated, drop-path from ``generator``), the supervised flow loss over
    every prediction, backward, and one ``optimizer`` step
    (``training.optim``: clip, skip, schedule; with ``num_acc > 1`` the
    gradient is accumulated and the update made every ``num_acc`` steps).

    ``batch`` is a dict on the model's device: ``chunk`` [B, bins, H, W]
    signed voxels (or [B, bins, 2, H, W]), ``label`` [B, 2, H, W], ``mask``
    [B, 1, H, W]. With ``voxelize=dict(num_bins, height, width)`` it may
    carry ``events`` (x/y/t/p/valid, [B, N]) instead of ``chunk``; they are
    voxelized on the device (K3 on the card) and, with ``crop=(h, w)``,
    center-cropped, the labels arriving cropped.

    ``compute_dtype`` (e.g. bf16) runs forward and backward on parameters
    and activations cast to it, the master parameters staying in their
    dtype and the BN statistics in >= float32; the flows and the loss are
    computed in >= float32.

    ``remat`` ("dots", "dots_no_batch", "all") runs the forward under
    :class:`training.remat.Remat`: the backward recomputes each block but
    for what the policy keeps, with the forward's drop-path masks, so the
    gradients are those of the plain step (every model of the zoo; K2 is
    recomputed at each PSN site under every policy).

    ``group`` (a ``torch.distributed`` process group, or None) makes the
    step one rank's share of the global batch's step, as JAX's step over a
    data-sharded batch: ``batch`` holds this rank's rows (raw events are
    voxelized here, K3 on this rank's rows only); the batch statistics of
    every norm and the drop-path draws span every rank's rows, the loss is
    this rank's share of the global loss, the optimizer all-reduces the
    flat gradient, and the returned loss is the global one. A group of one
    is the one-process step.

    A model that ``parallel/sharding_rules.py:shard_model`` sharded
    (tensor parallelism; ``group`` is then the data group) gathers its
    layers' channels over its model group, and the optimizer's norm sums
    the sharded slices over it (``shard_model`` gives both the group).

    Each call is one ``train.step`` span (``utils/tracing.py``): the host's
    issue of the step.
    """
    params = dict(model.named_parameters())
    param_dtype = next(iter(params.values())).dtype
    kw = dict(encoding=encoding, polarity=polarity, norm_input=norm_input,
              spike_th=spike_th, group=group)

    def forward(x):
        if compute_dtype is None:
            return model(x.to(param_dtype))["flow"]
        cast = {n: p.to(compute_dtype) for n, p in params.items()}
        return torch.func.functional_call(model, cast,
                                          (x.to(compute_dtype),))["flow"]

    rematerialized = (contextlib.nullcontext() if remat is None
                      else Remat(model, remat, generator))

    def train_step(batch):
        with tracing.span("train.step"):
            _set_mode(model, train=True, generator=generator, group=group)
            chunk = batch["events"] if "events" in batch else batch["chunk"]
            x = _model_input(chunk, crop, voxelize, None, **kw)
            mask = batch["mask"]
            if mask_events:
                mask = event_footprint_mask(mask, x)
            optimizer.zero_grad()
            with rematerialized:
                flows = [f.to(torch.promote_types(f.dtype, torch.float32))
                         for f in forward(x)]
            loss = flow_loss_supervised(flows, batch["label"], mask,
                                        flow_scaling=flow_scaling,
                                        gamma=gamma, group=group)
            loss.backward()
            if remat is not None:
                rematerialized.done()
            grad_norm = optimizer.step(group=group)
            return {"loss": all_reduce_sum(loss.detach(), group),
                    "grad_norm": grad_norm}

    train_step.model = model
    return train_step


class EvalStep(nn.Module):
    """The eval step's forward, ``chunk -> [flow]`` (coarse -> fine,
    float32), as a module that ``torch.export`` can trace: it sets no mode
    and enters no ``inference_mode`` (:func:`make_eval_step` does both
    around it). The encoded input is cast to ``compute_dtype`` if given,
    else to the model's parameter dtype, as JAX promotes it."""

    def __init__(self, model: nn.Module, *, encoding, polarity, norm_input,
                 spike_th, compute_dtype, voxelize, crop, fused_embed,
                 num_steps, group=None, per_row=False):
        super().__init__()
        self.model = model
        self.input_kw = dict(encoding=encoding, polarity=polarity,
                             norm_input=norm_input, spike_th=spike_th,
                             group=group, per_row=per_row,
                             windows=getattr(model, "event_windows", 1))
        self.compute_dtype, self.voxelize, self.crop = (compute_dtype,
                                                        voxelize, crop)
        self.fused_embed, self.num_steps = fused_embed, num_steps

    def forward(self, chunk):
        x = _model_input(chunk, None, self.voxelize, self.crop,
                         **self.input_kw)
        x = x.to(self.compute_dtype
                 or next(self.model.parameters()).dtype)
        if not self.fused_embed:
            out = self.model(x)
        else:
            out = self.model(x, fused_embed_forward(
                self.model.sttmultires_unet.encoders.patch_embed, x,
                num_steps=self.num_steps))
        return [f.float() for f in out["flow"]]


def make_eval_step(model: nn.Module, *, encoding="voxel", polarity=True,
                   norm_input="minmax", spike_th=None, compute_dtype=None,
                   voxelize=None, crop=None, use_batch_stats=False,
                   fused_embed=False, num_steps=None,
                   collect_spike_rates=False, group=None, per_row=False):
    """Return ``eval_step(chunk) -> [flow]`` (coarse -> fine, float32).

    ``chunk``: [B, bins, H, W] signed voxels (or [B, bins, 2, H, W]) on the
    model's device. The input is encoded in its own dtype, then params and
    activations run in ``compute_dtype`` (bf16 is the serving path), BN
    statistics in float32. The params are cast on a copy of ``model``,
    unless they have that dtype already.

    With ``voxelize=dict(num_bins, height, width[, presorted])`` the step
    also takes a dict of padded event buffers (x/y/t/p/valid, [B, N]) and
    voxelizes them on their device (:func:`voxelize_batch`); a dict
    ``{"windows": [events, ...]}`` holds consecutive windows (E-RAFT's two),
    each voxelized over its own time span into ``num_bins`` bins, the
    windows' bins concatenated in order. With ``crop=(h, w)`` every chunk
    is center-cropped before encoding: raw events arrive at sensor
    resolution, the model runs on the crop (``crop=None``: at sensor
    resolution). A model of consecutive event windows (its
    ``event_windows``, E-RAFT's 2) has each window of the chunk's bins
    normalized on its own (``ops/normalization.py:encode_input``).

    ``use_batch_stats=True`` validates as the reference does at batch 1:
    train mode (batch statistics, drop-path drawn from a generator seeded 0
    at every call, as JAX passes ``PRNGKey(0)``) without updating the
    running statistics; with a data-parallel ``group`` the statistics (and
    the input's normalization) are those of every rank's rows, as JAX's
    over its sharded batch.

    ``per_row=True`` makes each row's flow its batch-1 flow, whatever rows
    it is batched with (the batched server's requests): each row of the
    input is normalized on its own (``ops/normalization.py``) and the
    model's spiking swin blocks refold each row on its own (their
    ``rows_apart``, set here on the model the step runs).

    ``fused_embed=True`` computes the MS_PED patch embed with the
    channels-second kernels K4 and K4a (``ops/hopper_embed.py``) over
    ``num_steps`` time steps and feeds the network through its
    ``pre_embedded`` input. It needs running-statistics BN and
    ``num_steps``, and the base embed (not ``cfg.s2d_embed`` nor
    ``cfg.s2d_train``, whose block-space head the composition does not
    take); else it raises. A model that ``training/bn_folding.py:fold_model``
    folded runs here as any other (K1 and K2 on the folded weights).

    ``collect_spike_rates=True`` returns ``(flows, sites)``: ``sites`` the
    neuron telemetry of the forward (``models/spiking_layers.py:
    collect_sites``), keyed as ``scripts/eval_dsec.py`` writes it
    (``".../<site>/spike_rate/[i]"`` and, with ``cfg.store_v_seq``,
    ``".../<site>/membrane/[i]"``) in JAX's order, the values device
    tensors. The MS attention then runs its module form and fires
    ``attn_sn``, so no K1 is launched. With ``fused_embed`` it raises: K4 and
    K4a record no site (JAX's Pallas embed sows none either, and its energy
    join then raises on the missing embed sites).

    The step runs :class:`EvalStep` (``eval_step.module``) under
    ``torch.inference_mode()``; ``eval_step.model`` is the (cast) model.
    """
    if fused_embed and collect_spike_rates:
        raise ValueError("fused_embed collects no telemetry: K4 and K4a "
                         "record no neuron site; collect on the module "
                         "embed (fused_embed=False)")
    if fused_embed:
        if use_batch_stats or num_steps is None:
            raise ValueError("fused_embed needs running-statistics BN "
                             "(use_batch_stats=False) and num_steps")
        embed = model.sttmultires_unet.encoders.patch_embed
        if embed.s2d or embed.s2d_train:
            raise ValueError("fused_embed takes the base MS_PED embed, not "
                             "an s2d re-expression (cfg.s2d_embed, "
                             "cfg.s2d_train)")
    if compute_dtype is not None and any(
            p.dtype != compute_dtype for p in model.parameters()):
        model = cast_params(copy.deepcopy(model), compute_dtype)
    module = EvalStep(model, encoding=encoding, polarity=polarity,
                      norm_input=norm_input, spike_th=spike_th,
                      compute_dtype=compute_dtype, voxelize=voxelize,
                      crop=crop, fused_embed=fused_embed,
                      num_steps=num_steps, group=group,
                      per_row=per_row).eval()
    if per_row:
        for m in model.modules():
            if hasattr(m, "rows_apart"):
                m.rows_apart = True

    def eval_step(chunk):
        with torch.inference_mode():
            if use_batch_stats:
                dev = next(model.parameters()).device
                _set_mode(model, train=True, update_bn_stats=False,
                          generator=torch.Generator(dev).manual_seed(0),
                          group=group)
            elif group is not None:
                _set_mode(model, train=False, group=group)
            elif model.training:
                model.eval()
            if not collect_spike_rates:
                return module(chunk)
            with collect_sites(model) as sites:
                flows = module(chunk)
            return flows, sites

    eval_step.model = model
    eval_step.module = module
    return eval_step
