"""Tensor parallelism over a ``model`` axis, the port of
``sdformerflow_tpu/parallel/sharding_rules.py``.

JAX shards a large kernel over its output channels on the mesh's ``model``
axis, lets GSPMD propagate the activations' shardings and insert the
collectives, and keeps every leaf under an ``attn`` scope replicated (the
spiking attention's raw refolds defeat a channel-sharded layout). The port
runs one process a rank (``parallel/multihost.py:make_multihost_mesh``) and
writes the collectives out:

- :func:`infer_param_shardings` picks JAX's leaves, leaf for leaf: a
  parameter with 2 or more dims, ``min_size`` or more elements, an output
  channel extent divisible by ``n_model`` and no ``attn`` in its module
  path. Its output channels are flax's trailing axis, found in the port's
  layout by ``training/from_jax.py:trailing_dim`` (a conv's and a linear's
  dim 0, a transposed conv's dim 1);
- :func:`shard_model` keeps this rank's slice of each such weight (the
  optimizer's flat state then covers only what the rank holds) and makes
  its layer column-parallel (:class:`ColumnParallel`): the input taken
  whole (identity forward, all-reduce over the model group backward), the
  local conv or linear on the shard, an all-gather of the output channels
  (the last axis: activations are channels-last; the gradient split back
  to the rank's channels), then the bias, which is 1-D and so replicated,
  added whole. The collectives are ``torch.autograd.Function``s over
  ``torch.distributed``, as the data-parallel ones: the fused PSN sites
  (K2 / K2b) take plain whole tensors;
- BN statistics and every replicated leaf stay whole, and their gradients,
  equal on every model rank, are never summed over the model group (the
  optimizer takes them from the group's first rank, so that a
  nondeterministic kernel's rounding cannot set the replicas apart).

Every activation is therefore whole on every model rank at every block
entry, the attention's input included: it is already batch-only, and
JAX's ``constrain_data_parallel`` (the attention entry's sharding
constraint) has no counterpart. The model ranks of one data slice take the
same rows and must draw the same random numbers (drop path,
``multihost.global_rows`` over the data group): seed their generators by
data rank, not by global rank. The data-parallel ``group`` of the steps is
the data group; the optimizer's global norm adds the sharded leaves'
squares over the model group (``training/optim.py``). Checkpoints hold
whole tensors under the one-process names (:func:`whole_state`,
:func:`load_whole_state`), so a checkpoint loads in either layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.spiking_layers import Conv2d, TorchConvTranspose
from ..training.from_jax import trailing_dim
from .multihost import active

# module scopes whose parameters stay replicated (JAX's _REPLICATED_SCOPES)
_REPLICATED_SCOPES = ("attn",)
# the layers a sharded weight may belong to (its module's column-parallel
# forward); their output channels are gathered on the last axis
_PARALLEL_LAYERS = (Conv2d, TorchConvTranspose, nn.Linear)


def infer_param_shardings(model: nn.Module, n_model: int,
                          min_size: int = 1 << 14) -> dict:
    """``{parameter name: the dim sharded over the model axis, or None}``
    for every parameter of ``model``, by JAX's rule (module docstring)."""
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        dim = trailing_dim(modules[mod_name], leaf, p.dim())
        scoped = set(mod_name.split(".")) & set(_REPLICATED_SCOPES)
        out[name] = (dim if n_model > 1 and p.dim() >= 2
                     and p.numel() >= min_size
                     and p.shape[dim] % n_model == 0 and not scoped
                     else None)
    return out


class TPLayout(NamedTuple):
    """A sharded model's layout: the sharded dim of each sharded
    parameter, the model group, its size and this rank's index."""
    dims: dict
    group: object
    n_model: int
    rank: int


def tp_layout(model: nn.Module) -> Optional[TPLayout]:
    """The layout :func:`shard_model` gave ``model``, or None."""
    return getattr(model, "tp_layout", None)


class _CopyToModel(torch.autograd.Function):
    """The input of a column-parallel layer: identity forward; the backward
    sums the gradient over the model group (each rank's local layer gave
    the share of its output channels)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather of the last axis over the model group, each rank's
    channels in ``blocks`` groups (``(block, c)`` order, the s2d head's
    block space) put back in that order; the backward keeps this rank's
    channels of the gradient (every rank computes the same downstream)."""

    @staticmethod
    def forward(ctx, y, group, blocks):
        n = dist.get_world_size(group)
        ctx.group, ctx.blocks, ctx.rank, ctx.n = (group, blocks,
                                                  dist.get_rank(group), n)
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        *lead, c = y.shape
        out = torch.stack([p.reshape(*lead, blocks, c // blocks)
                           for p in parts], dim=-2)   # [..., blocks, n, c/b]
        return out.reshape(*lead, n * c)

    @staticmethod
    def backward(ctx, grad):
        *lead, c = grad.shape
        g = grad.reshape(*lead, ctx.blocks, ctx.n, c // (ctx.blocks * ctx.n))
        return g[..., ctx.rank, :].reshape(*lead, c // ctx.n), None, None


class ColumnParallel:
    """The forward of a layer whose weight holds this rank's output
    channels (a base of the layer's class, set by :func:`shard_model`):
    whole input, local conv / linear with no bias, gathered channels, the
    whole bias added."""

    tp_group = None

    def forward(self, x):
        x = _CopyToModel.apply(x, self.tp_group)
        if isinstance(self, nn.Linear):
            y = F.linear(x, self.weight)
        else:
            y = self.conv(x, self.weight, None)
        blocks = getattr(self, "out_blocks", 1)
        y = _GatherChannels.apply(y, self.tp_group, blocks)
        return y if self.bias is None else y + self.bias.repeat(blocks)


_CLASSES: dict = {}


def _column_parallel(cls: type) -> type:
    if cls not in _CLASSES:
        _CLASSES[cls] = type(f"ColumnParallel{cls.__name__}",
                             (ColumnParallel, cls), {})
    return _CLASSES[cls]


def _local(t: torch.Tensor, dim: int, n: int, rank: int) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` (a copy)."""
    k = t.shape[dim] // n
    return t.narrow(dim, rank * k, k).clone()


def shard_model(model: nn.Module, optimizer, mesh,
                min_size: int = 1 << 14) -> dict:
    """Shard ``model`` in place over ``mesh``'s model group
    (``multihost.make_multihost_mesh``): each parameter that
    :func:`infer_param_shardings` picks keeps this rank's slice and its
    layer turns column-parallel; ``optimizer`` (or None) learns which
    parameters are sharded, and a flat state it already holds is cut to
    this rank's slices. Returns the shardings. With one model rank nothing
    changes."""
    dims = infer_param_shardings(model, mesh.n_model, min_size)
    if mesh.n_model == 1:
        return dims
    if tp_layout(model) is not None:
        raise ValueError("the model is sharded already")
    sharded = {n: d for n, d in dims.items() if d is not None}
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    for name in sharded:
        mod_name, _, leaf = name.rpartition(".")
        module = modules[mod_name]
        if leaf != "weight" or not isinstance(module, _PARALLEL_LAYERS):
            raise NotImplementedError(
                f"{name}: JAX shards it, but the port's column-parallel "
                f"form covers conv / linear weights, not {type(module)}")
    layout = TPLayout(sharded, mesh.model, mesh.n_model, mesh.model_rank)
    if optimizer is not None and optimizer.names is not None:
        state = optimizer.state_dict()
        whole = {n: p.shape for n, p in params.items()}
    for name, dim in sharded.items():
        p = params[name]
        p.data = _local(p.data, dim, layout.n_model, layout.rank)
        module = modules[name.rpartition(".")[0]]
        module.__class__ = _column_parallel(type(module))
        module.tp_group = mesh.model
    model.tp_layout = layout
    if optimizer is not None:
        optimizer.sharded = frozenset(sharded)
        optimizer.model_group = mesh.model
        if optimizer.names is not None:
            optimizer.load_state_dict(_cut_flat(state, whole, layout))
    return dims


def _segments(vec: torch.Tensor, names, shapes: dict) -> dict:
    """A flat vector over ``names`` -> {name: its segment in ``shapes``}."""
    out, at = {}, 0
    for n in names:
        k = shapes[n].numel()
        out[n] = vec[at:at + k].view(shapes[n])
        at += k
    return out


def _flat_keys(state: dict) -> list:
    return [k for k, v in state.items()
            if isinstance(v, torch.Tensor) and v.dim() == 1]


def _cut_flat(state: dict, whole: dict, layout: TPLayout) -> dict:
    """An optimizer state over whole parameters -> over this rank's
    slices."""
    state = dict(state)
    names = state["names"]
    for key in _flat_keys(state):
        seg = _segments(state[key], names, whole)
        state[key] = torch.cat([
            (_local(seg[n], layout.dims[n], layout.n_model, layout.rank)
             if n in layout.dims else seg[n]).reshape(-1) for n in names])
    return state


def _gather(t: torch.Tensor, dim: int, layout: TPLayout) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(layout.n_model)]
    dist.all_gather(parts, t, group=layout.group)
    return torch.cat(parts, dim)


def whole_state(model: nn.Module, optimizer=None):
    """``(state_dict, optimizer state or None)`` with every sharded tensor
    gathered whole, under the one-process names and layout: what a
    checkpoint holds. A collective over the model group of a sharded
    model (every model rank calls it); else the model's own state."""
    layout = tp_layout(model)
    model_sd = model.state_dict()
    opt_sd = None if optimizer is None else optimizer.state_dict()
    if layout is None or not active(layout.group):
        return model_sd, opt_sd
    model_sd = dict(model_sd)
    for name, dim in layout.dims.items():
        model_sd[name] = _gather(model_sd[name], dim, layout)
    if opt_sd is not None and opt_sd["names"] is not None:
        shapes = {n: p.shape for n, p in model.named_parameters()}
        names = opt_sd["names"]
        for key in _flat_keys(opt_sd):
            seg = _segments(opt_sd[key], names, shapes)
            opt_sd[key] = torch.cat([
                (_gather(seg[n], layout.dims[n], layout)
                 if n in layout.dims else seg[n]).reshape(-1)
                for n in names])
    return model_sd, opt_sd


def load_whole_state(model: nn.Module, model_sd: dict, optimizer=None,
                     opt_sd: Optional[dict] = None):
    """Load a whole (one-process) state into ``model`` and, if given,
    ``optimizer``: each sharded tensor takes this rank's slice."""
    layout = tp_layout(model)
    if layout is not None:
        whole = {n: t.shape for n, t in model_sd.items()}
        model_sd = {n: (_local(t, layout.dims[n], layout.n_model,
                               layout.rank) if n in layout.dims else t)
                    for n, t in model_sd.items()}
        if opt_sd is not None and opt_sd["names"] is not None:
            opt_sd = _cut_flat(opt_sd, whole, layout)
    model.load_state_dict(model_sd)
    if optimizer is not None and opt_sd is not None:
        optimizer.load_state_dict(opt_sd)
