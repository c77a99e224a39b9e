"""Analytic FLOP counting for the model zoo, a copy of
``sdformerflow_tpu/utils/flops.py`` (the same formulas, integer for
integer).

The reference threads hand-written ``flops()`` / ``record_flops()`` methods
through every model class. Here a single analytic routine walks the
architecture config: conv Cin*Cout*k^2*H*W; linear N*Cin*Cout; attention
per window qkv + scores + values + proj. ``record_flops_spikingformer``
gives the per-site record of SpikingformerFlowNet (SEW, or ``ms=True``:
the linear-QK attention the MS blocks compute), ``flops_stt`` and
``flops_multires_unet`` the ANN scalars, ``total_flops`` the sum of a
record. ``compiled_flops`` counts instead what one call of a function
actually runs (``torch.utils.flop_counter``).
"""

from __future__ import annotations

from typing import Dict

from ..models.common import SwinConfig


def _attention_flops(dim, num_heads, window_size, n_windows, linear_qk=False):
    N = window_size[0] * window_size[1] * window_size[2]
    rec = {}
    rec["q"] = n_windows * N * dim * dim
    rec["k"] = n_windows * N * dim * dim
    if not linear_qk:
        rec["v"] = n_windows * N * dim * dim
        rec["attn"] = 2 * n_windows * num_heads * N * N * (dim // num_heads)
    else:
        # att_token = sum_c q (N*dim adds), attn = k * token (N*dim mults)
        rec["attn"] = 2 * n_windows * N * dim
    rec["proj"] = n_windows * N * dim * dim
    return rec


def _mlp_flops(dim, mlp_ratio, H, W):
    hidden = int(dim * mlp_ratio)
    return {"mlp0": H * W * dim * hidden, "mlp1": H * W * hidden * dim}


def record_flops_spikingformer(swin: SwinConfig, *, base_channels=96,
                               num_encoders=4, num_residual_blocks=2,
                               num_output_channels=2, kernel_size=3,
                               num_ch=2, ms=True) -> Dict:
    """Per-layer FLOP record for SpikingformerFlowNet (matches the
    reference's record_flops structure)."""
    H, W = swin.input_size
    embed = base_channels
    rec: Dict = {}

    # patch embed (PED conv sfn): head, stride-2 conv, resblocks, proj
    pe = {}
    pe["head"] = num_ch * (embed // 2) * 9 * H * W
    pe["conv"] = (embed // 2) * embed * 9 * H * W // 4
    for i in range(2):
        pe[f"res{i}_conv0"] = embed * embed * 9 * H * W // 4
        pe[f"res{i}_conv1"] = embed * embed * 9 * H * W // 4
    ph, pw = H // swin.patch_size[-2] // 2, W // swin.patch_size[-1] // 2
    pe["proj"] = embed * embed * 9 * ph * pw
    rec["patch_embed"] = pe

    # swin stages
    h, w = ph, pw
    for i, depth in enumerate(swin.depths):
        dim = embed * 2 ** i
        stage = {}
        n_windows = (h * w) // (swin.window_size[1] * swin.window_size[2])
        for b in range(depth):
            blk = {}
            blk["attn"] = _attention_flops(dim, swin.num_heads[i],
                                           swin.window_size, n_windows,
                                           linear_qk=ms)
            blk.update(_mlp_flops(dim, swin.mlp_ratio, h, w))
            stage[f"block{b}"] = blk
        if i < len(swin.depths) - 1:
            stage["downsample"] = (h // 2) * (w // 2) * 4 * dim * 2 * dim
            h, w = h // 2, w // 2
        rec[f"layer{i}"] = stage

    # bottleneck residual blocks + decoder
    max_ch = embed * 2 ** (num_encoders - 1)
    for i in range(num_residual_blocks):
        rec[f"res{i}_conv0"] = max_ch * max_ch * 9 * h * w
        rec[f"res{i}_conv1"] = max_ch * max_ch * 9 * h * w
    out_sizes = [embed * 2 ** i for i in range(num_encoders)]
    in_sizes = [embed] + out_sizes[:-1]
    dh, dw = h, w
    for i, (inp, outp) in enumerate(zip(reversed(out_sizes),
                                        reversed(in_sizes))):
        pred_ch = 0 if i == 0 else num_output_channels
        dh, dw = dh * 2, dw * 2
        rec[f"decoder{i}"] = ((2 * inp + pred_ch) * outp * dh * dw
                              * kernel_size * kernel_size)
        rec[f"pred{i}"] = outp * num_output_channels * dh * dw
    return rec


def flops_stt(*, img_size, patch, in_chans, embed_dim, depths, num_heads,
              window_size, mlp_ratio, num_residual_blocks=2,
              num_output_channels=2, kernel_size=3) -> int:
    """Scalar analytic FLOPs for the ANN STTFlowNet family — reproduces the
    reference's own Module.flops() methods term-for-term, including their
    conventions (tests/test_flops_parity.py asserts exact equality):

    - PatchEmbedLocal (PatchEmbed.py:201-213): head/4-resblock/proj convs,
      all scaled by num_blocks = in_chans // patch[0] time chunks.
    - Swin blocks (swin_transformer3D_v2.py:212-227,341-353): LN + qkv +
      scores + values + proj + 2-linear MLP; the trailing *2 on norm/MLP
      terms is the reference's hardcoded two-chunk factor, which its
      attention terms deliberately lack (quirk kept).
    - PatchMerging (:528-533) and the per-stage backbone LN (:783-791).
    - Bottleneck res convs + decoders + preds (STSwinNet.py:285-306).
    """
    H, W = img_size
    pt = patch[0]
    num_blocks = in_chans // pt
    pr = (H // patch[1], W // patch[2])

    f = 0
    # patch embed
    f += H * W * pt * embed_dim * 9 * num_blocks
    f += H * W * embed_dim * embed_dim * 9 * 4 * 2 * num_blocks
    f += pr[0] * pr[1] * embed_dim * embed_dim * 9 * num_blocks

    wt, wh, ww = window_size
    N = wt * wh * ww
    h, w = pr
    for i, depth in enumerate(depths):
        dim = embed_dim * 2 ** i
        heads = num_heads[i]
        nW = h * w // wh // ww
        attn = (N * dim * 3 * dim + 2 * heads * N * N * (dim // heads)
                + N * dim * dim)
        for _ in range(depth):
            f += dim * h * w * 2                              # norm1
            f += nW * attn                                    # W-MSA
            f += 2 * h * w * dim * dim * mlp_ratio * 2        # mlp
            f += dim * h * w * 2                              # norm2
        if i < len(depths) - 1:
            f += (h // 2) * (w // 2) * 4 * dim * 2 * dim * 2  # merge
            f += h * w * dim * 4 * 2                          # merge LN
            h, w = h // 2, w // 2
    for i in range(len(depths)):                              # backbone LNs
        f += 2 * (embed_dim * 2 ** i) * (pr[0] // 2 ** i) * (pr[1] // 2 ** i)

    # bottleneck residual blocks + decoder/pred chain
    n_en = len(depths)
    max_ch = embed_dim * 2 ** (n_en - 1)
    bh, bw = pr[0] // 2 ** (n_en - 1), pr[1] // 2 ** (n_en - 1)
    f += 2 * max_ch * max_ch * 9 * bh * bw * num_residual_blocks
    out_sizes = [embed_dim * 2 ** i for i in range(n_en)]
    in_sizes = [embed_dim] + out_sizes[:-1]
    dh, dw = bh, bw
    for i, (inp, outp) in enumerate(zip(reversed(out_sizes),
                                        reversed(in_sizes))):
        pred_ch = 0 if i == 0 else num_output_channels
        dh, dw = dh * 2, dw * 2
        f += (2 * inp + pred_ch) * outp * dh * dw * kernel_size ** 2
        f += outp * num_output_channels * dh * dw
    return int(f)


def flops_multires_unet(*, num_bins, base_channels, num_encoders,
                        num_residual_blocks=2, num_output_channels=2,
                        kernel_size=3, channel_multiplier=2,
                        img_size=(288, 384)) -> int:
    """Scalar analytic FLOPs for the plain MultiResUNet family — reproduces
    the reference's own flops() (models/unet.py:232-256) exactly, including
    its hardcoded 288x384 input assumption (``img_size`` default) and the
    doubling channel scheme (encoder i: in base*m^i -> out base*m^(i+1),
    unet.py:73-80; first encoder input replaced by num_bins)."""
    in_sizes = [int(base_channels * channel_multiplier ** i)
                for i in range(num_encoders)]
    out_sizes = [int(base_channels * channel_multiplier ** (i + 1))
                 for i in range(num_encoders)]
    H, W = img_size
    f = 0
    for i, (inp, outp) in enumerate(zip(in_sizes, out_sizes)):
        if i == 0:
            inp = num_bins
        H, W = H // 2, W // 2
        f += inp * outp * kernel_size ** 2 * H * W
    max_ch = out_sizes[-1]
    f += 2 * max_ch * max_ch * 9 * H * W * num_residual_blocks
    for i, (inp, outp) in enumerate(zip(reversed(out_sizes),
                                        reversed(in_sizes))):
        pred_ch = 0 if i == 0 else num_output_channels
        H, W = H * 2, W * 2
        f += (2 * inp + pred_ch) * outp * H * W * kernel_size ** 2
        f += outp * num_output_channels * H * W
    return int(f)


def total_flops(record) -> int:
    if isinstance(record, dict):
        return sum(total_flops(v) for v in record.values())
    return int(record)


def compiled_flops(fn, *args) -> float:
    """The FLOPs one call ``fn(*args)`` runs, counted by
    ``torch.utils.flop_counter.FlopCounterMode``: the aten matrix products
    and convolutions (2 per multiply-add), not XLA's cost analysis of the
    JAX package's counterpart, and nothing of what runs elsewhere. It is
    meant for the plain path on the CPU: a hand kernel (K1-K4) is a ctypes
    call it cannot see into."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops())
