"""The tensor-core kernels' weight layouts and tile orders, on the CPU.

K4 (``csrc/conv_cs.cu``) and K1 (``csrc/qk_attn.cu``) read their bf16
weights in a layout that their wrappers make in PyTorch
(``hopper_embed.pack_conv_weight``, ``hopper_attn.pack_qk_weight``). The card
is not needed to check it: each packing is a contiguous copy (the kernel
reads the raw buffer) that unpacks to the weight it was given, and a float64
emulation that walks the packed weight in the kernel's order (K4:
output-channel block, 16-wide K chunk, tap; K1: 32-channel group, 64-wide K
chunk, [q | k] columns, per-head counts inside the group) gives the plain
twin's result on seeded numpy inputs. The build key of a kernel covers the
headers its source includes (``kernel_build.source_digest``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sdformerflow_tpu_torch import kernel_build
from sdformerflow_tpu_torch.ops import hopper_attn, hopper_embed

# (k, stride, cin, cout): the en4 fused embed's 5 conv shapes at a small
# width, the head's fold (Cin = 2 and 5), ragged Cin and Cout, two blocks
CONV_CASES = [(3, 1, 2, 48), (3, 2, 48, 96), (3, 1, 96, 96), (1, 2, 96, 96),
              (3, 1, 5, 7), (3, 2, 5, 7), (1, 1, 20, 40), (3, 1, 24, 100)]


def _dyadic(rng, shape, step, lo, hi):
    n = int(round((hi - lo) / step)) + 1
    return torch.from_numpy(rng.integers(0, n, shape) * step + lo)


def _unpack_conv_weight(packed, cout, cin, k, fold):
    """Inverse of ``pack_conv_weight``: the OIHW weight."""
    nn, nc, taps, _, nt, _ = packed.shape
    z = packed.permute(0, 4, 1, 3, 5, 2).reshape(nn * nt, 16 * nc, taps)
    kin = cin * k * k if fold else cin
    return z[:cout, :kin].reshape(cout, cin, k, k)


@pytest.mark.parametrize("k,stride,cin,cout", CONV_CASES)
def test_conv_weight_pack_roundtrip(k, stride, cin, cout):
    rng = np.random.default_rng(k + 10 * stride + cin + cout)
    w = torch.from_numpy(rng.standard_normal((cout, cin, k, k)))
    nt, fold = hopper_embed.conv_tile_config(cin, cout, k, stride)
    assert nt == (48 if cout <= 48 else 96)
    assert fold == (k == 3 and stride == 1 and cin * 9 <= 64)
    packed = hopper_embed.pack_conv_weight(w, nt, fold)
    assert packed.is_contiguous()
    chunks, taps = (4, 1) if fold else (-(-cin // 16), k * k)
    assert packed.shape == (-(-cout // nt), chunks, taps, 2, nt, 8)
    assert torch.equal(_unpack_conv_weight(packed, cout, cin, k,
                                                       fold), w)
    # the padding is zero: the packed weight holds nothing else
    assert (packed != 0).sum() == (w != 0).sum()


def _conv_by_tiles(x, w, a, b, stride):
    """K4's bf16 kernel's order in float64: per output-channel block of nt
    and per 16-wide K chunk, each tap's im2col [pixels, 16] times the packed
    [16, nt] chunk, accumulated; then * a + b."""
    N, cin, H, W = x.shape
    cout, _, k, _ = w.shape
    nt, fold = hopper_embed.conv_tile_config(cin, cout, k, stride)
    packed = hopper_embed.pack_conv_weight(w, nt, fold)
    nn, nc, taps = packed.shape[:3]
    pad = k // 2
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    xp = F.pad(x, (pad, pad, pad, pad))
    # every (input channel, tap) as a [N, ho, wo] view of the padded input
    cols = torch.stack([
        xp[:, :, dy:dy + stride * (ho - 1) + 1:stride,
           dx:dx + stride * (wo - 1) + 1:stride]
        for dy in range(k) for dx in range(k)], dim=2)  # [N, cin, k*k, ho, wo]
    if fold:
        cols = cols.reshape(N, cin * k * k, 1, ho, wo)
    kin = cols.shape[1]
    cols = F.pad(cols, (0, 0, 0, 0, 0, 0, 0, nc * 16 - kin))
    out = x.new_zeros(N, nn * nt, ho, wo)
    for n in range(nn):
        acc = x.new_zeros(N, ho, wo, nt)
        for c in range(nc):
            for t in range(taps):
                a_tile = cols[:, 16 * c:16 * c + 16, t].permute(0, 2, 3, 1)
                b_tile = packed[n, c, t].permute(0, 2, 1).reshape(16, nt)
                acc = acc + a_tile @ b_tile
        out[:, n * nt:(n + 1) * nt] = acc.permute(0, 3, 1, 2)
    out = out[:, :cout]
    return out * a.reshape(-1, 1, 1) + b.reshape(-1, 1, 1)


@pytest.mark.parametrize("k,stride,cin,cout", CONV_CASES)
def test_conv_tile_order_matches_plain(k, stride, cin, cout):
    """Dyadic inputs: every float64 sum exact in any order, so the tile
    order equals the twin bit for bit (ragged 11x13 frame)."""
    rng = np.random.default_rng(100 + k + 10 * stride + cin + cout)
    x = _dyadic(rng, (2, cin, 11, 13), 0.25, -2.0, 2.0)
    w = _dyadic(rng, (cout, cin, k, k), 0.125, -1.0, 1.0)
    a = _dyadic(rng, (cout,), 0.25, 0.25, 2.0)
    b = _dyadic(rng, (cout,), 0.25, -1.0, 1.0)
    got = _conv_by_tiles(x, w, a, b, stride)
    want = hopper_embed.conv3x3_affine_cs_plain(x, w, a, b, stride=stride)
    assert want.dtype == torch.float64 and got.shape == want.shape
    assert torch.equal(got, want)


# (M, C, nh): the four en4 (C, nh) pairs (hd = 32), narrower heads (hd 8,
# 16, 1) and heads that straddle the 32-channel groups (hd 24, 3)
QK_CASES = [(2, 96, 3), (2, 192, 6), (2, 384, 12), (2, 768, 24),
            (4, 32, 4), (2, 64, 4), (2, 16, 16), (2, 96, 4), (2, 48, 16)]


def _unpack_qk_weight(packed, C):
    """Inverse of ``pack_qk_weight``: (Wq, Wk), each [C, C]."""
    ng, nk = packed.shape[:2]
    z = packed.reshape(ng, nk, 8, 2, 32, 8).permute(1, 2, 5, 3, 0, 4)
    z = z.reshape(64 * nk, 2, 32 * ng)
    return z[:C, 0, :C], z[:C, 1, :C]


@pytest.mark.parametrize("C", [16, 32, 48, 96, 200, 768])
def test_qk_weight_pack_roundtrip(C):
    rng = np.random.default_rng(C)
    wq = torch.from_numpy(rng.standard_normal((C, C)))
    wk = torch.from_numpy(rng.standard_normal((C, C)))
    packed = hopper_attn.pack_qk_weight(wq, wk)
    assert packed.shape == (-(-C // 32), -(-C // 64), 8, 64, 8)
    # the kernel reads the raw buffer: the packing is a copy in this order
    assert packed.is_contiguous()
    uq, uk = _unpack_qk_weight(packed, C)
    assert torch.equal(uq, wq) and torch.equal(uk, wk)
    assert (packed != 0).sum() == (wq != 0).sum() + (wk != 0).sum()


def _params(rng, C, ns):
    def g(*s, step=0.125, lo=-1.0, hi=1.0):
        return _dyadic(rng, s, step, lo, hi)
    return hopper_attn.QKAttnParams(
        w_in=g(2, 2, step=0.25), b_in=g(2, step=0.25), wq=g(C, C),
        aq=g(C, step=0.25, lo=0.25, hi=2.0), cq=g(C),
        w_q=g(2, 2, step=0.25), b_q=g(2, step=0.25), wk=g(C, C),
        ak=g(C, step=0.25, lo=0.25, hi=2.0), ck=g(C), pe=g(2, ns, C),
        w_k=g(2, 2, step=0.25), b_k=g(2, step=0.25), w_t=g(2, 2, step=0.25),
        b_t=g(2, step=1.0, lo=-4.0, hi=0.0), wp=g(C, C), bp=g(C), ap=g(C),
        cp=g(C))


def _psn2(x0, x1, w, b):
    b = b.reshape(2)
    return ((w[0, 0] * x0 + w[0, 1] * x1 + b[0] >= 0).double(),
            (w[1, 0] * x0 + w[1, 1] * x1 + b[1] >= 0).double())


def _qk_by_groups(x, p, nh):
    """K1's bf16 kernel's order in float64: the input spikes, then per
    32-channel group the [q | k] products over 64-wide K chunks of the
    packed weight; q/k affine, pe and PSN per group; head counts inside a
    group when hd divides 32, else over all groups; k * tok."""
    _, M, wh, ww, C = x.shape
    ns, hd = wh * ww, C // nh
    rows = M * ns
    xf = x.reshape(2, rows, C)
    s0, s1 = _psn2(xf[0], xf[1], p.w_in, p.b_in)
    packed = hopper_attn.pack_qk_weight(p.wq, p.wk)
    ng, nk = packed.shape[:2]
    pe = p.pe.reshape(2, ns, C)[:, torch.arange(rows) % ns]   # [2, rows, C]
    qs, ks = [], []
    for grp in range(ng):
        cols = torch.arange(32 * grp, min(32 * grp + 32, C))
        acc = [xf.new_zeros(rows, 64), xf.new_zeros(rows, 64)]
        for kc in range(nk):
            b_tile = packed[grp, kc].permute(0, 2, 1).reshape(64, 64)
            for t, s in enumerate((s0, s1)):
                a_tile = s[:, 64 * kc:64 * kc + 64]
                a_tile = F.pad(a_tile, (0, 64 - a_tile.shape[1]))
                acc[t] = acc[t] + a_tile @ b_tile
        n = len(cols)
        yq = [p.aq[cols] * a[:, :n] + p.cq[cols] for a in acc]
        yk = [p.ak[cols] * a[:, 32:32 + n] + p.ck[cols] + pe[t][:, cols]
              for t, a in enumerate(acc)]
        qs.append(_psn2(*yq, p.w_q, p.b_q))
        ks.append(_psn2(*yk, p.w_k, p.b_k))
    out = []
    for t in range(2):
        if 32 % hd == 0:   # each group holds whole heads
            tok0, tok1 = [], []
            for q0, q1 in qs:
                c0 = q0.reshape(rows, -1, hd).sum(-1)
                c1 = q1.reshape(rows, -1, hd).sum(-1)
                a, b = _psn2(c0, c1, p.w_t, p.b_t)
                tok0.append(a.repeat_interleave(hd, 1))
                tok1.append(b.repeat_interleave(hd, 1))
            tok = torch.cat((tok0, tok1)[t], 1)
        else:
            q0 = torch.cat([qg[0] for qg in qs], 1)
            q1 = torch.cat([qg[1] for qg in qs], 1)
            a, b = _psn2(q0.reshape(rows, nh, hd).sum(-1),
                         q1.reshape(rows, nh, hd).sum(-1), p.w_t, p.b_t)
            tok = (a, b)[t].repeat_interleave(hd, 1)
        out.append(torch.cat([kg[t] for kg in ks], 1) * tok)
    return torch.stack(out).reshape(2, M, ns, C)


@pytest.mark.parametrize("M,C,nh", QK_CASES)
def test_qk_group_order_matches_plain(M, C, nh):
    """Dyadic inputs (float64 sums exact): equal bit for bit. Random PSN
    parameters can silence every head (all-0 output, a vacuous check), so
    the parameters are drawn again, from the next seed, until the twin's
    output holds both values."""
    for attempt in range(20):
        rng = np.random.default_rng((M, C, nh, attempt))
        p = _params(rng, C, 9)
        x = _dyadic(rng, (2, M, 3, 3, C), 0.25, -2.0, 2.0)
        want = hopper_attn.qk_attn_interior_plain(x, p, nh)
        if 0.0 < want.mean().item() < 1.0:
            break
    assert 0.0 < want.mean().item() < 1.0
    got = _qk_by_groups(x, p, nh)
    assert want.dtype == torch.float64 and got.shape == want.shape
    assert torch.equal(got, want)


def test_source_digest_covers_headers(tmp_path):
    """A library's key changes with its source, with any ``*.cuh`` header
    beside it (edited, added or removed) and with the flags, and with
    nothing else."""
    src = tmp_path / "k.cu"
    src.write_text("#include \"h.cuh\"\n")
    head = tmp_path / "h.cuh"
    head.write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("a")
    flags = ("-O3",)
    key = kernel_build.source_digest(src, flags, tmp_path)
    assert kernel_build.source_digest(src, flags, tmp_path) == key
    (tmp_path / "notes.txt").write_text("b")
    assert kernel_build.source_digest(src, flags, tmp_path) == key
    head.write_text("// v2\n")
    key2 = kernel_build.source_digest(src, flags, tmp_path)
    assert key2 != key
    other = tmp_path / "other.cuh"
    other.write_text("")
    key3 = kernel_build.source_digest(src, flags, tmp_path)
    assert key3 != key2
    other.unlink()
    assert kernel_build.source_digest(src, flags, tmp_path) == key2
    assert kernel_build.source_digest(src, ("-O2",), tmp_path) != key2
    src.write_text("#include \"h.cuh\"\n// edit\n")
    assert kernel_build.source_digest(src, flags, tmp_path) != key2


def test_package_headers_in_the_digest():
    """The package's own kernels include ``csrc/sm90_mma.cuh``, which the
    default digest covers."""
    assert (kernel_build.CSRC_DIR / "sm90_mma.cuh").exists()
    for name in ("conv_cs.cu", "qk_attn.cu"):
        text = (kernel_build.CSRC_DIR / name).read_text()
        assert '#include "sm90_mma.cuh"' in text
