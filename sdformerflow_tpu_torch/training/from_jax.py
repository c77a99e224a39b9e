"""JAX variables -> the port's ``state_dict``.

The port's module tree has the flax tree's names, so a flax leaf at
``a/b/c/<leaf>`` becomes ``a.b.c.<name>`` with the rules of
``sdformerflow_tpu/training/torch_interop.py`` run in reverse:

- Dense kernel ``[in, out]`` -> Linear weight ``[out, in]``;
- Conv kernel HWIO -> OIHW;
- transposed-conv kernel ``(kh, kw, I, O)`` -> ``(I, O, kh, kw)``;
- BN scale/bias/mean/var -> weight/bias/running_mean/running_var;
- LayerNorm and GroupNorm (the ANN's instance norm, the SNN's GN / IN /
  LN ``GroupNorm_0``) scale/bias -> weight/bias;
- PSN weight [T, T] / bias [T, 1], PLIF ``w``, positional encodings,
  relative-position-bias tables, ``logit_scale``, BN_notrack's
  ``scale`` / ``bias`` and BNTT's ``bn_t{i}`` (BNs) pass through, and the
  GLIF ``glif`` leaf, a ``GLIFParams`` named tuple, becomes one entry per
  field (``glif.alpha``, ...).

Input: ``{"params": ..., "batch_stats": ...}`` as nested mappings of numpy
arrays (``jax.tree_util.tree_map(np.asarray, variables)``). Any leaf with
no counterpart, and any model entry left unfilled, raises ``KeyError``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

from ..models.ann_layers import InstanceNorm
from ..models.spiking_layers import (Conv2d, GroupNorm, TorchBatchNorm,
                                     TorchConvTranspose)

_BN_NAMES = {("params", "scale"): "weight", ("params", "bias"): "bias",
             ("batch_stats", "mean"): "running_mean",
             ("batch_stats", "var"): "running_var"}


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "_asdict"):       # a named tuple (GLIFParams)
            val = val._asdict()
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


# kernel layouts by module type (flax -> torch)
_KERNELS = ((TorchConvTranspose, lambda a: a.transpose(2, 3, 0, 1)),
            (Conv2d, lambda a: a.transpose(3, 2, 0, 1)),
            (nn.Linear, lambda a: a.T))


def _layout(module: nn.Module):
    """The flax -> torch layout of ``module``'s kernel, or None."""
    for cls, layout in _KERNELS:
        if isinstance(module, cls):
            return layout
    return None


def trailing_dim(module: nn.Module, name: str, ndim: int) -> int:
    """The dim of ``module``'s parameter ``name`` (``ndim`` dims) that holds
    its flax leaf's trailing axis (a kernel's output channels): the leaf's
    layout run over a probe of distinct extents. A parameter with no
    layout keeps the flax axes (its last dim)."""
    layout = _layout(module) if name == "weight" else None
    if layout is None:
        return ndim - 1
    probe = tuple(range(2, 2 + ndim))
    return layout(np.empty(probe, np.bool_)).shape.index(probe[-1])


def _convert(module: nn.Module, coll: str, leaf: str):
    """(torch name, layout or None) for one flax leaf of ``module``, or
    None."""
    if isinstance(module, TorchBatchNorm):
        name = _BN_NAMES.get((coll, leaf))
        return None if name is None else (name, None)
    if coll != "params":
        return None
    if isinstance(module, (nn.LayerNorm, InstanceNorm, GroupNorm)):
        name = {"scale": "weight", "bias": "bias"}.get(leaf)
        return None if name is None else (name, None)
    if leaf == "kernel":
        layout = _layout(module)
        return None if layout is None else ("weight", layout)
    # conv/linear/PSN bias, PSN weight, PLIF w, GLIF fields, positional
    # encoding, bias tables, logit_scale, BN_notrack scale: same name
    return leaf, None


def port_key(modules: Mapping, coll: str, path) -> tuple:
    """(the port's state_dict key, its layout or None) of the flax leaf at
    ``path`` of collection ``coll``; ``modules`` is the port model's
    ``dict(named_modules())``. The key is None for a leaf with no
    counterpart."""
    *mod_path, leaf = path
    mod_name = ".".join(mod_path)
    module = modules.get(mod_name)
    converted = None if module is None else _convert(module, coll, leaf)
    if converted is None:
        return None, None
    return ".".join(filter(None, (mod_name, converted[0]))), converted[1]


def from_jax(variables: Mapping, model: nn.Module) -> dict:
    """Build ``model``'s state_dict from JAX ``variables``; raises on any
    unmapped leaf or unfilled entry (and on shape mismatches)."""
    modules = dict(model.named_modules())
    targets = model.state_dict()
    out = {}
    for coll, tree in variables.items():
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {coll!r}")
        for path, arr in _leaves(tree):
            key, layout = port_key(modules, coll, path)
            if key not in targets:
                raise KeyError(f"JAX variable {coll}/{'/'.join(path)} has no "
                               "counterpart in the port")
            value = np.array(arr if layout is None else layout(arr),
                             order="C")
            if tuple(value.shape) != tuple(targets[key].shape):
                raise ValueError(f"{key}: shape {value.shape} vs "
                                 f"{tuple(targets[key].shape)}")
            out[key] = torch.from_numpy(value)
    missing = sorted(set(targets) - set(out))
    if missing:
        raise KeyError(f"port entries with no JAX variable: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out
