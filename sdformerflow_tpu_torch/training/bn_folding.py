"""Eval-time BatchNorm folding, a mirror of
``sdformerflow_tpu/training/bn_folding.py`` on the port's module tree.

At inference every running-statistics BN (BN, TDBN) is the per-channel
affine ``y = a * x + b``, ``a = weight / sqrt(var + eps)``,
``b = bias - mean * a``. Every foldable BN of the zoo directly follows a
conv, linear or transposed conv (SEW: conv -> BN -> spike; MS: spike ->
conv -> BN), so the affine folds exactly into that layer: its weight scaled
along the output channels, its bias ``bias * a + b`` (``b`` where it had
none). BNTT (per-step statistics), BN_notrack (batch statistics in eval
too) and GN / IN / LN are no such affine and stay, as JAX's
``_FOLDABLE_NORMS`` leaves them; the residual blocks' and embedding
layers' plain BN folds whatever the config's norm. The folded model skips
the BN site (``FoldedNorm``), and a fused BN -> PSN site runs K2 with no
affine.

Usage: ``model_f = fold_model(model)``; ``model_f`` evaluates as ``model``
in eval mode does, up to rounding, and loads the state_dict of a model
built with ``cfg.fold_bn=True`` (or, through ``from_jax``, a folded JAX
tree). Inference only: train mode would need the batch statistics that
folding removed.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from ..models.spiking_layers import FoldedNorm, TorchBatchNorm

# norm name -> the partner layer names, in lookup order: every foldable BN
# and its producer are children of one module under these names
_PARTNERS = {
    "norm": ("conv", "deconv", "reduction"),
    "norm1": ("conv1", "pwconv1", "deconv1"),
    "norm2": ("conv2", "pwconv2", "deconv2"),
    "bn": ("linear",),
    "bn1": ("fc1",),
    "bn2": ("fc2",),
    "proj_bn": ("proj",),
}

_BN_EPS = 1e-5  # TorchBatchNorm's


def _foldable_bn(norm: nn.Module):
    """The running-statistics BN of a norm site (a TorchBatchNorm, or the
    ``BatchNorm_0`` child of a SpikingNorm), else None."""
    if isinstance(norm, TorchBatchNorm):
        return norm
    child = getattr(norm, "BatchNorm_0", None)
    return child if isinstance(child, TorchBatchNorm) else None


@torch.no_grad()
def _fold_into(partner: nn.Module, bn: TorchBatchNorm):
    """Fold ``bn``'s eval affine into ``partner``'s weight and bias, in
    float32 (float64 for a float64 layer), cast back after."""
    w = partner.weight
    cdt = torch.promote_types(w.dtype, torch.float32)
    a = bn.weight.to(cdt) / torch.sqrt(bn.running_var.to(cdt) + _BN_EPS)
    b = bn.bias.to(cdt) - bn.running_mean.to(cdt) * a
    # output channels: axis 1 of a transposed conv's [in, out, kh, kw],
    # axis 0 of a conv's [out, in, kh, kw] and a linear's [out, in]
    shape = [1] * w.dim()
    shape[1 if isinstance(partner, nn.ConvTranspose2d) else 0] = -1
    partner.weight = nn.Parameter((w.to(cdt) * a.reshape(shape)).to(w.dtype))
    if partner.bias is not None:
        b = partner.bias.to(cdt) * a + b
    partner.bias = nn.Parameter(b.to(w.dtype))


def _walk(module: nn.Module):
    children = dict(module.named_children())
    for name, child in children.items():
        bn = _foldable_bn(child) if name in _PARTNERS else None
        if bn is None:
            _walk(child)
            continue
        for cand in _PARTNERS[name]:
            partner = children.get(cand)
            if isinstance(getattr(partner, "weight", None), nn.Parameter):
                _fold_into(partner, bn)
                setattr(module, name, FoldedNorm())
                break
        else:
            raise ValueError(f"foldable BN {name!r} has no partner layer "
                             f"among {_PARTNERS[name]} (siblings: "
                             f"{sorted(children)})")


def fold_model(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every running-statistics BN folded into its
    partner layer (the copy's ``cfg``, where it has one, gets
    ``fold_bn=True``); ``model`` is left as it is. A foldable BN with no
    partner raises ``ValueError``."""
    folded = copy.deepcopy(model)
    _walk(folded)
    cfg = getattr(folded, "cfg", None)
    if cfg is not None:
        folded.cfg = cfg.replace(fold_bn=True)
    return folded
