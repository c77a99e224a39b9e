"""JAX variables -> the port's ``state_dict``.

The port's module tree has the flax tree's names, so a flax leaf at
``a/b/c/<leaf>`` becomes ``a.b.c.<name>`` with the rules of
``sdformerflow_tpu/training/torch_interop.py`` run in reverse:

- Dense kernel ``[in, out]`` -> Linear weight ``[out, in]``;
- Conv kernel HWIO -> OIHW;
- transposed-conv kernel ``(kh, kw, I, O)`` -> ``(I, O, kh, kw)``;
- BN scale/bias/mean/var -> weight/bias/running_mean/running_var;
- PSN weight [T, T] / bias [T, 1] and positional encodings pass through.

Input: ``{"params": ..., "batch_stats": ...}`` as nested mappings of numpy
arrays (``jax.tree_util.tree_map(np.asarray, variables)``). Any leaf with
no counterpart, and any model entry left unfilled, raises ``KeyError``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

from ..models.spiking_layers import Conv2d, TorchBatchNorm, TorchConvTranspose

_BN_NAMES = {("params", "scale"): "weight", ("params", "bias"): "bias",
             ("batch_stats", "mean"): "running_mean",
             ("batch_stats", "var"): "running_var"}


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


# kernel layouts by module type (flax -> torch)
_KERNELS = ((TorchConvTranspose, lambda a: a.transpose(2, 3, 0, 1)),
            (Conv2d, lambda a: a.transpose(3, 2, 0, 1)),
            (nn.Linear, lambda a: a.T))


def _convert(module: nn.Module, coll: str, leaf: str, arr: np.ndarray):
    """(torch name, array) for one flax leaf of ``module``, or None."""
    if isinstance(module, TorchBatchNorm):
        name = _BN_NAMES.get((coll, leaf))
        return None if name is None else (name, arr)
    if coll != "params":
        return None
    if leaf == "kernel":
        for cls, layout in _KERNELS:
            if isinstance(module, cls):
                return "weight", layout(arr)
        return None
    # conv/linear/PSN bias, PSN weight, positional encoding: same name
    return leaf, arr


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
            *mod_path, leaf = path
            mod_name = ".".join(mod_path)
            module = modules.get(mod_name)
            converted = None if module is None else _convert(module, coll,
                                                             leaf, arr)
            key = converted and f"{mod_name}.{converted[0]}"
            if key not in targets:
                raise KeyError(f"JAX variable {coll}/{'/'.join(path)} has no "
                               "counterpart in the port")
            value = np.ascontiguousarray(converted[1])
            if tuple(value.shape) != tuple(targets[key].shape):
                raise ValueError(f"{key}: shape {value.shape} vs "
                                 f"{tuple(targets[key].shape)}")
            out[key] = torch.from_numpy(value)
    missing = sorted(set(targets) - set(out))
    if missing:
        raise KeyError(f"port entries with no JAX variable: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out
