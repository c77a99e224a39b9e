"""Eval-time space-to-depth re-expression of the flagship embed head, a
mirror of ``sdformerflow_tpu/training/s2d_embed.py`` on the port's
``state_dict`` (reference-named keys).

:func:`s2d_embed_state_dict` rearranges a model's embed-head entries into
2x2 block space (``ops/s2d.py``), exactly:

- ``...patch_embed.head.conv.weight`` [co, ci, 3, 3] -> ``s2d_kernel_s1``
  -> [4co, 4ci, 3, 3] (its bias, if any, tiled by 4);
- every [co] entry of ``...patch_embed.head.norm`` (BN weight, bias,
  running mean and variance) -> tiled by 4;
- ``...patch_embed.conv.conv.weight`` [c2, co, 3, 3] -> ``s2d_kernel_s2``
  -> [c2, 4co, 2, 2] (its BN acts on the normal-layout output: unchanged);
- the PSN parameters act per time step: unchanged.

The result loads into the same model built with ``cfg.s2d_embed=True``
(``serving.py:FlowServer(s2d=True)``). Inference only: train-mode BN would
compute its statistics per block-channel.
"""

from __future__ import annotations

from ..ops.s2d import s2d_kernel_s1, s2d_kernel_s2, tile4

_HEAD_CONV = "patch_embed.head.conv.weight"


def s2d_embed_state_dict(state_dict: dict) -> dict:
    """A new state_dict with the embed head's entries in block space (the
    other entries are the same tensors)."""
    heads = [k for k in state_dict if k.endswith(_HEAD_CONV)]
    if len(heads) != 1:
        raise ValueError("s2d_embed needs exactly one patch_embed with a head "
                         f"conv (the MS_PED conv-sfn embed), found {heads}")
    pre = heads[0][:-len("head.conv.weight")]
    out = dict(state_dict)
    w1 = state_dict[heads[0]]
    if w1.dim() != 4 or tuple(w1.shape[2:]) != (3, 3):
        raise ValueError(f"head conv kernel must be 3x3, got "
                         f"{tuple(w1.shape)}")
    co = w1.shape[0]
    out[heads[0]] = s2d_kernel_s1(w1)
    for key, val in state_dict.items():
        if (key == pre + "head.conv.bias"
                or (key.startswith(pre + "head.norm.")
                    and tuple(val.shape) == (co,))):
            out[key] = tile4(val)
    exit_key = pre + "conv.conv.weight"
    w2 = state_dict[exit_key]
    if tuple(w2.shape[1:]) != (co, 3, 3):
        raise ValueError(f"stride-2 conv kernel must be [*, {co}, 3, 3], got "
                         f"{tuple(w2.shape)}")
    out[exit_key] = s2d_kernel_s2(w2)
    return out

