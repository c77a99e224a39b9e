"""Hopper kernels vs their plain twins on the card (``-m cuda``).

These need an NVIDIA GPU with the CUDA toolkit and triton, so they skip on
a CPU-only host. On the card:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda

Inputs on power-of-two grids make every float32 sum exact in any order, so
kernel and twin must agree bit for bit.
"""

import pytest
import torch

from sdformerflow_tpu_torch.ops import hopper_attn, hopper_embed, hopper_psn
from sdformerflow_tpu_torch.ops import hopper_voxel, voxel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grid(shape, step, lo, hi, gen):
    n = int(round((hi - lo) / step)) + 1
    return torch.randint(0, n, shape, generator=gen) * step + lo


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,nh", [(12, 32, 4), (10, 96, 3), (30, 768, 24)])
def test_k1_matches_plain_bitwise(dev, dtype, M, C, nh):
    gen = torch.Generator().manual_seed(M + C)
    g = lambda *s, step=0.125, lo=-1.0, hi=1.0: _grid(  # noqa: E731
        s, step, lo, hi, gen).to(dev)
    p = hopper_attn.QKAttnParams(
        w_in=g(2, 2, step=0.25), b_in=g(2, step=0.25), wq=g(C, C),
        aq=g(C, step=0.25, lo=0.25, hi=2.0), cq=g(C),
        w_q=g(2, 2, step=0.25), b_q=g(2, step=0.25), wk=g(C, C),
        ak=g(C, step=0.25, lo=0.25, hi=2.0), ck=g(C), pe=g(2, 81, C),
        w_k=g(2, 2, step=0.25), b_k=g(2, step=0.25), w_t=g(2, 2, step=0.25),
        b_t=g(2, step=1.0, lo=-4.0, hi=0.0), wp=g(C, C), bp=g(C), ap=g(C),
        cp=g(C))
    x = _grid((2, M, 9, 9, C), 0.25, -2.0, 2.0, gen).to(dev, dtype)
    with torch.inference_mode():
        before = hopper_attn.qk_attn_interior.launches
        got = hopper_attn.qk_attn_interior(x, p, nh)
        assert hopper_attn.qk_attn_interior.launches == before + 1
        want = hopper_attn.qk_attn_interior_plain(x, p, nh)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert 0.0 < got.float().mean().item() < 1.0
        full = hopper_attn.fused_qk_attention(x, p, nh)
        assert torch.equal(full, hopper_attn.qk_attention_pairlocal(x, p, nh))
    with pytest.raises(NotImplementedError):
        hopper_attn.qk_attn_interior(x, p._replace(
            wq=p.wq.clone().requires_grad_()), nh)


# the four en4 (C, nh) pairs (hd = 32) with R = 81 M not a multiple of the
# 64-row tile, and heads that straddle the bf16 kernel's 32-channel groups
# (hd 24 and 3: one block walks every group)
K1_EN4_CASES = [(2, 96, 3), (4, 192, 6), (2, 384, 12), (2, 768, 24),
                (2, 96, 4), (2, 48, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,nh", K1_EN4_CASES)
def test_k1_head_widths_bitwise(dev, dtype, M, C, nh):
    """K1 at the en4 head widths and at straddling ones, ragged row tiles:
    equal to its twin bit for bit on dyadic inputs, not all-0 or all-1. The
    token PSN's threshold sits at 3/8 of a head's width, so the head counts
    decide the output."""
    gen = torch.Generator().manual_seed(3 * M + C + nh)
    g = lambda *s, step=0.125, lo=-1.0, hi=1.0: _grid(  # noqa: E731
        s, step, lo, hi, gen).to(dev)
    p = hopper_attn.QKAttnParams(
        w_in=g(2, 2, step=0.25), b_in=g(2, step=0.25), wq=g(C, C),
        aq=g(C, step=0.25, lo=0.25, hi=2.0), cq=g(C),
        w_q=g(2, 2, step=0.25), b_q=g(2, step=0.25), wk=g(C, C),
        ak=g(C, step=0.25, lo=0.25, hi=2.0), ck=g(C), pe=g(2, 81, C),
        w_k=g(2, 2, step=0.25), b_k=g(2, step=0.25),
        w_t=torch.tensor([[0.5, 0.25], [0.25, 0.5]], device=dev),
        b_t=torch.full((2,), -3 * (C // nh) / 8, device=dev), wp=g(C, C),
        bp=g(C),
        ap=g(C), cp=g(C))
    x = _grid((2, M, 9, 9, C), 0.25, -2.0, 2.0, gen).to(dev, dtype)
    assert (M * 81) % 64
    with torch.inference_mode():
        before = hopper_attn.qk_attn_interior.launches
        got = hopper_attn.qk_attn_interior(x, p, nh)
        assert hopper_attn.qk_attn_interior.launches == before + 1
        want = hopper_attn.qk_attn_interior_plain(x, p, nh)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert 0.0 < got.float().mean().item() < 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine", [False, True])
def test_k2_matches_plain_bitwise(dev, dtype, affine):
    gen = torch.Generator().manual_seed(7)
    T, C = 10, 48
    x = _grid((T, 1, 33, 17, C), 0.25, -2.0, 2.0, gen).to(dev, dtype)
    w = _grid((T, T), 0.125, -1.0, 1.0, gen).to(dev)
    b = _grid((T, 1), 0.25, -1.0, 1.0, gen).to(dev)
    kw = (dict(scale=_grid((C,), 0.25, 0.25, 2.0, gen).to(dev),
               shift=_grid((C,), 0.25, -1.0, 1.0, gen).to(dev))
          if affine else {})
    with torch.inference_mode():
        before = hopper_psn.fused_affine_psn.launches
        got = hopper_psn.fused_affine_psn(x, w, b, **kw)
        assert hopper_psn.fused_affine_psn.launches == before + 1
        assert got.dtype == dtype
        assert torch.equal(got, hopper_psn.psn_spike(x, w, b, **kw))
    with pytest.raises(NotImplementedError):
        hopper_psn.fused_affine_psn(x, w.clone().requires_grad_(), b, **kw)


# (T, site shape after T): a C <= 32 site with ragged columns, and en4
# shapes at 288x384 (the embed's [1, 144, 192, 48] head site and a stage-0
# attention site, T = 2 windows of [440, 9, 9, 96])
K2_H_CASES = [(4, (1, 7, 9, 24)), (10, (1, 144, 192, 48)),
              (2, (440, 9, 9, 96))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,shape", K2_H_CASES)
def test_k2_membrane_output_matches_twin(dev, dtype, T, shape):
    """K2 with its potential output against ``psn_neuron(return_v=True)``:
    on dyadic inputs the spikes and h bit for bit; on Gaussian inputs at
    most 1e-3 of the spikes flipped and h within 1e-6 of the twin's largest
    |h|; the spikes equal those of the launch without h."""
    gen = torch.Generator().manual_seed(T + shape[-1])
    C = shape[-1]
    for dyadic in (True, False):
        if dyadic:
            x = _grid((T,) + shape, 0.25, -2.0, 2.0, gen).to(dev, dtype)
            w = _grid((T, T), 0.125, -1.0, 1.0, gen).to(dev)
            b = _grid((T, 1), 0.25, -1.0, 1.0, gen).to(dev)
            kw = dict(scale=_grid((C,), 0.25, 0.25, 2.0, gen).to(dev),
                      shift=_grid((C,), 0.25, -1.0, 1.0, gen).to(dev))
        else:
            x = torch.randn((T,) + shape, generator=gen).to(dev, dtype)
            w = (torch.randn(T, T, generator=gen) * 0.4).to(dev)
            b = (torch.randn(T, 1, generator=gen) * 0.4).to(dev)
            kw = dict(scale=(torch.rand(C, generator=gen) + 0.5).to(dev),
                      shift=torch.randn(C, generator=gen).to(dev))
        with torch.inference_mode():
            before = hopper_psn.fused_affine_psn.launches
            spikes, h = hopper_psn.fused_affine_psn(x, w, b, return_v=True,
                                                    **kw)
            assert hopper_psn.fused_affine_psn.launches == before + 1
            want_s, want_h = hopper_psn.psn_spike(x, w, b, return_v=True,
                                                  **kw)
            plain = hopper_psn.fused_affine_psn(x, w, b, **kw)
            torch.cuda.synchronize()
        assert h.dtype == torch.float32 and h.shape == x.shape
        assert spikes.dtype == dtype and torch.equal(spikes, plain)
        if dyadic:
            assert torch.equal(spikes, want_s) and torch.equal(h, want_h)
            assert 0.0 < spikes.float().mean().item() < 1.0
        else:
            flips = (spikes != want_s).float().mean().item()
            assert flips <= 1e-3
            err = (h - want_h).abs().max().item()
            assert err <= 1e-6 * want_h.abs().max().item()
    with pytest.raises(NotImplementedError, match="forward only"):
        hopper_psn.affine_psn(x, w.clone().requires_grad_(), b,
                              return_v=True, **kw)


K3_ENTRIES = {
    "signed": (hopper_voxel.voxel_grid_signed_k3, voxel.voxel_grid_signed,
               "num_bins", {}),
    "polarities": (hopper_voxel.voxel_grid_polarities_k3,
                   voxel.voxel_grid_polarities, "num_bins", {}),
    "v2": (hopper_voxel.events_to_voxel_grid_v2_k3,
           voxel.events_to_voxel_grid_v2, "num_bins", {"normalize": False}),
    "frames": (hopper_voxel.events_to_frames_k3, voxel.events_to_frames,
               "num_frames", {}),
}


def _dyadic_events(n, h, w, bins, gen, layout="uniform"):
    """x/y on a 1/4 grid, one unit beyond every edge; t on a 1/4 grid in
    [0, bins - 1], so that with t_range (0, bins - 1) every weight and every
    sum is exact; a padded invalid tail. ``layout`` "band_edges" puts half
    the events within a unit of the edges of K3's row bands, "skewed" 9/10
    of them on the middle 1/10 of the rows."""
    x = _grid((n,), 0.25, -1.0, w + 1.0, gen)
    y = _grid((n,), 0.25, -1.0, h + 1.0, gen)
    if layout == "band_edges":
        rows = hopper_voxel.K3_ROWS
        edges = torch.randint(0, h // rows + 1, (n // 2,), generator=gen)
        y[: n // 2] = edges * rows + _grid((n // 2,), 0.25, -1.0, 1.0, gen)
    elif layout == "skewed":
        k = 9 * n // 10
        y[:k] = _grid((k,), 0.25, h * 45 // 100, h * 55 // 100, gen)
    t = _grid((n,), 0.25, 0.0, bins - 1.0, gen)
    p = torch.randint(0, 2, (n,), generator=gen).float()
    valid = torch.arange(n) < n - n // 8
    return x, y, t, p, valid


@pytest.mark.parametrize("kind,h,w,bins,layout", [
    (kind, 48, 64, 10, "uniform") for kind in sorted(K3_ENTRIES)] + [
    (kind, 48, 64, 10, "band_edges") for kind in sorted(K3_ENTRIES)] + [
    (kind, 96, 128, 10, "skewed") for kind in sorted(K3_ENTRIES)] + [
    (kind, 60, 346, 10, "uniform") for kind in sorted(K3_ENTRIES)] + [
    ("polarities", 24, 640, 15, "uniform"),
    ("frames", 24, 640, 15, "skewed")])
def test_k3_matches_plain_bitwise(dev, kind, h, w, bins, layout):
    entry, plain, bins_kw, extra = K3_ENTRIES[kind]
    gen = torch.Generator().manual_seed(11)
    x, y, t, p, valid = (a.to(dev) for a in _dyadic_events(
        200_000, h, w, bins, gen, layout))
    kw = {bins_kw: bins, "height": h, "width": w, "valid": valid,
          "t_range": (0.0, bins - 1.0), **extra}
    before = hopper_voxel.voxel_k3.launches
    got = entry(x, y, t, p, **kw)
    assert hopper_voxel.voxel_k3.launches == before + 1
    want = plain(x, y, t, p, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.abs().sum() > 0
    assert torch.equal(got, want)


# a budget of 4000 bytes holds 2 of a row's planes at W = 346 (the tiles
# split planes), one of 600 bytes 116 columns of one plane (they split
# columns, with a scalar head and tail in every other row); skewed windows
# split their heavy bands into shares as well
@pytest.mark.parametrize("kind,bins,budget,layout", [
    ("signed", 10, 4000, "uniform"), ("signed", 10, 600, "skewed"),
    ("polarities", 15, 4000, "skewed"), ("polarities", 15, 600, "band_edges"),
    ("v2", 10, 4000, "skewed"), ("v2", 10, 600, "uniform"),
    ("frames", 15, 4000, "band_edges"), ("frames", 15, 600, "skewed")])
def test_k3_split_tiles_match_plain_bitwise(dev, kind, bins, budget, layout):
    _, plain, bins_kw, extra = K3_ENTRIES[kind]
    h, w = 60, 346
    tiles = hopper_voxel.k3_tiles(kind, bins, h, w, smem_budget=budget)
    assert tiles.rows == 1
    if budget >= 4 * w:
        assert 1 < tiles.planes < tiles.n_planes and tiles.cols == w
    else:
        assert tiles.planes == 1 and tiles.col_slabs == 3
    gen = torch.Generator().manual_seed(14)
    x, y, t, p, valid = (a.to(dev) for a in _dyadic_events(
        200_000, h, w, bins, gen, layout))
    want = plain(x, y, t, p, **{bins_kw: bins}, height=h, width=w,
                 valid=valid, t_range=(0.0, bins - 1.0), **extra)
    out = torch.full(want.shape, float("nan"), device=dev)
    launch, _ = hopper_voxel.prepare_k3(
        x, y, t, p, mode=kind, num_bins=bins, height=h, width=w, valid=valid,
        t_range=(0.0, bins - 1.0), out=out, smem_budget=budget)
    launch()
    torch.cuda.synchronize()
    assert want.abs().sum() > 0
    assert torch.equal(out, want)


def test_voxelize_batch_writes_rows_in_place(dev):
    """One K3 launch a row, each over its valid span, straight into its row
    of the batch: equal to the twin bit for bit on exact rows."""
    from sdformerflow_tpu_torch.training.train_step import voxelize_batch
    gen = torch.Generator().manual_seed(13)
    h, w, bins, n = 40, 56, 5, 30_000
    rows = [_dyadic_events(n, h, w, bins, gen) for _ in range(3)]
    ev = {k: torch.stack([r[i] for r in rows]).to(dev)
          for i, k in enumerate("xytp")}
    # integer t from 2 to 2 + 4 (bins - 1), both ends among the valid events
    ev["t"] = torch.randint(2, 4 * bins - 1, (3, n), generator=gen).float(
        ).to(dev)
    ev["t"][:, :2] = torch.tensor([2.0, 4.0 * bins - 2.0])
    ev["valid"] = torch.stack([r[4] for r in rows]).to(dev)
    ev["valid"][1] = False                     # an empty row
    before = hopper_voxel.voxel_k3.launches
    got = voxelize_batch(ev, num_bins=bins, height=h, width=w)
    assert hopper_voxel.voxel_k3.launches == before + 3
    assert got.shape == (3, bins, h, w) and got.is_contiguous()
    out = torch.full((3, bins, h, w), float("nan"), device=dev)
    for b in range(3):
        view = out[b]
        hopper_voxel.voxel_k3(
            ev["x"][b], ev["y"][b], ev["t"][b], ev["p"][b], mode="signed",
            num_bins=bins, height=h, width=w, valid=ev["valid"][b],
            valid_span=True, out=view)
        assert view.data_ptr() == out[b].data_ptr()
    want = voxelize_batch({k: v.cpu() for k, v in ev.items()},
                          num_bins=bins, height=h, width=w)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()          # every cell written
    assert torch.equal(out.cpu(), want) and torch.equal(got.cpu(), want)
    assert want[0].abs().sum() > 0 and not want[1].any()


def test_k3_refuses_what_it_does_not_take(dev):
    gen = torch.Generator().manual_seed(12)
    x, y, t, p, valid = (a.to(dev) for a in _dyadic_events(1000, 8, 8, 4,
                                                           gen))
    kw = dict(num_bins=4, height=8, width=8, valid=valid)
    with pytest.raises(TypeError):
        hopper_voxel.voxel_grid_signed_k3(x.double(), y, t, p, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        hopper_voxel.voxel_grid_signed_k3(x[::2], y[::2], t[::2], p[::2],
                                          num_bins=4, height=8, width=8)
    with pytest.raises(ValueError):
        hopper_voxel.voxel_grid_signed_k3(x, y, t, p, num_bins=4, height=8,
                                          width=8, valid=valid.float())
    with pytest.raises(ValueError):
        hopper_voxel.voxel_grid_signed_k3(x, y[:-1], t, p, num_bins=4,
                                          height=8, width=8)


def _psn_site(T, C, dtype, affine, gen, dev, dyadic):
    """(x, g, W, b, affine kwargs) of one PSN site [T, 1, 33, 17, C]."""
    shape = (T, 1, 33, 17, C)
    if dyadic:
        x = _grid(shape, 0.25, -2.0, 2.0, gen)
        g = _grid(shape, 0.25, -1.0, 1.0, gen)
        w = _grid((T, T), 0.125, -1.0, 1.0, gen)
        b = _grid((T, 1), 0.25, -1.0, 1.0, gen)
        kw = (dict(scale=_grid((C,), 0.25, 0.25, 2.0, gen),
                   shift=_grid((C,), 0.25, -1.0, 1.0, gen)) if affine else {})
    else:
        x, g = torch.randn(shape, generator=gen), torch.randn(shape,
                                                              generator=gen)
        w = torch.randn(T, T, generator=gen) * 0.4
        b = torch.randn(T, 1, generator=gen) * 0.4
        kw = (dict(scale=torch.rand(C, generator=gen) + 0.5,
                   shift=torch.randn(C, generator=gen)) if affine else {})
    return (x.to(dev, dtype), g.to(dev, dtype), w.to(dev), b.to(dev),
            {k: v.to(dev) for k, v in kw.items()})


def _close(got, want, tol):
    """|got - want| within ``tol`` of ``want``'s largest magnitude."""
    got, want = got.float(), want.float()
    return (got - want).abs().max() <= tol * want.abs().max()


def _k2b_check(dev, x, g, w, b, kw, dtype):
    """K2b against its twin: dx within 1e-5 of the twin's largest (bf16:
    one rounding, 2^-7), dW, db, dscale and dshift within 1e-5; a second
    launch gives the same bits."""
    before = hopper_psn.fused_psn_backward.launches
    got = hopper_psn.fused_psn_backward(x, g, w, b, **kw)
    assert hopper_psn.fused_psn_backward.launches == before + 1
    again = hopper_psn.fused_psn_backward(x, g, w, b, **kw)
    want = hopper_psn.psn_backward_plain(x, g, w, b, **kw)
    torch.cuda.synchronize()
    dx, dx_p = got[0], want[0]
    assert dx.dtype == dtype and dx.shape == x.shape
    assert _close(dx, dx_p, 1e-5 if dtype == torch.float32 else 2.0 ** -7)
    for name, k, a, p in zip(("dW", "db", "dscale", "dshift"), got[1:],
                             again[1:], want[1:]):
        if p is None:
            assert k is None and not kw, name
            continue
        assert k.shape == p.shape and k.dtype == p.dtype, name
        assert _close(k, p, 1e-5), name
        assert torch.equal(k, a), name          # deterministic
        assert p.abs().max() > 0, name
    assert torch.equal(got[0], again[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [10, 5, 2])
@pytest.mark.parametrize("affine", [False, True])
def test_k2b_matches_plain(dev, dtype, T, affine):
    """The whole site VJP on dyadic and on Gaussian inputs (the sums' order
    differs from the twin's matrix products)."""
    gen = torch.Generator().manual_seed(T + 2 * affine)
    for dyadic in (True, False):
        x, g, w, b, kw = _psn_site(T, 48, dtype, affine, gen, dev, dyadic)
        _k2b_check(dev, x, g, w, b, kw, dtype)


def _offset(t, k):
    """``t`` copied into a buffer at an offset of ``k`` elements: contiguous,
    and misaligned for 16-byte loads when k is not a multiple of 4."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


# (T, C, element offset, W dtype): ragged channels (C % 4, C % 8), a
# misaligned base, bfloat16 parameters, T = 16
RAGGED = [(5, 6, 0, torch.float32), (5, 48, 1, torch.float32),
          (16, 12, 0, torch.bfloat16), (3, 100, 3, torch.bfloat16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C,offset,wdtype", RAGGED)
def test_k2_k2b_scalar_paths(dev, dtype, T, C, offset, wdtype):
    """K2 bitwise and K2b within tolerance where the kernels load element
    by element inside the kernel: channels not a multiple of the vector,
    a misaligned base pointer; W and b in bfloat16."""
    gen = torch.Generator().manual_seed(T * C + offset)
    for affine in (False, True):
        x, g, w, b, kw = _psn_site(T, C, dtype, affine, gen, dev, True)
        x, g = _offset(x, offset), _offset(g, offset)
        w, b = w.to(wdtype), b.to(wdtype)
        with torch.inference_mode():
            got = hopper_psn.fused_affine_psn(x, w, b, **kw)
            assert torch.equal(got, hopper_psn.psn_spike(x, w, b, **kw))
            assert 0.0 < got.float().mean().item() < 1.0
        _k2b_check(dev, x, g, w, b, kw, dtype)


@pytest.mark.parametrize("affine", [False, True])
def test_fused_affine_psn_grads_kernels_vs_plain(dev, affine):
    """The autograd Function through K2 + K2b against the same Function
    through the plain twins: equal spikes, gradients of x, W, b, scale and
    shift within 1e-5 of the twin's largest magnitude."""
    gen = torch.Generator().manual_seed(31 + affine)
    x, g, w, b, kw = _psn_site(10, 48, torch.float32, affine, gen, dev, False)
    grads = {}
    for name, impl in (("kernels", hopper_psn.KERNELS),
                       ("plain", hopper_psn.PLAIN)):
        leaves = [t.clone().requires_grad_() for t in (x, w, b,
                                                       *kw.values())]
        lkw = dict(zip(kw, leaves[3:]))
        y = hopper_psn.affine_psn(*leaves[:3], **lkw, impl=impl)
        (y * g).sum().backward()
        grads[name] = (y.detach(), [t.grad for t in leaves])
    torch.cuda.synchronize()
    assert torch.equal(grads["kernels"][0], grads["plain"][0])
    for got, want in zip(grads["kernels"][1], grads["plain"][1]):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k2b_block_space_head_width(dev, dtype):
    """The s2d_train head's fused site: 4 x 48 = 192 block channels (the
    en4 geometry's; here at 33x17 positions), its affine the tile of a
    48-channel one. K2 bitwise with and without the affine on dyadic
    inputs (at most 1e-3 of the spikes flipped on Gaussian ones), K2b
    within tolerance of its twin on both."""
    gen = torch.Generator().manual_seed(192)
    for dyadic in (True, False):
        x, g, w, b, kw = _psn_site(10, 192, dtype, True, gen, dev, dyadic)
        kw = {k: v[:48].repeat(4) for k, v in kw.items()}    # tile4
        for affine in ({}, kw):
            with torch.inference_mode():
                got = hopper_psn.fused_affine_psn(x, w, b, **affine)
                want = hopper_psn.psn_spike(x, w, b, **affine)
                torch.cuda.synchronize()
                if dyadic:
                    assert torch.equal(got, want)
                else:
                    assert (got != want).float().mean().item() <= 1e-3
                assert 0.0 < got.float().mean().item() < 1.0
            _k2b_check(dev, x, g, w, b, affine, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_unit_scale_with_shift_bitwise(dev, dtype):
    """K1 as the folded model feeds it: the q/k affines a unit scale with
    the folded linears' bias as the shift, proj_bn's (1, 0) after proj's
    folded bias. Bitwise against the twin on dyadic inputs."""
    M, C, nh = 4, 192, 6
    gen = torch.Generator().manual_seed(11)
    g = lambda *s, step=0.125, lo=-1.0, hi=1.0: _grid(  # noqa: E731
        s, step, lo, hi, gen).to(dev)
    ones = torch.ones(C, device=dev)
    p = hopper_attn.QKAttnParams(
        w_in=g(2, 2, step=0.25), b_in=g(2, step=0.25), wq=g(C, C), aq=ones,
        cq=g(C), w_q=g(2, 2, step=0.25), b_q=g(2, step=0.25), wk=g(C, C),
        ak=ones, ck=g(C), pe=g(2, 81, C), w_k=g(2, 2, step=0.25),
        b_k=g(2, step=0.25),
        w_t=torch.tensor([[0.5, 0.25], [0.25, 0.5]], device=dev),
        b_t=torch.full((2,), -3 * (C // nh) / 8, device=dev), wp=g(C, C),
        bp=g(C), ap=ones, cp=torch.zeros(C, device=dev))
    assert p.cq.abs().max() > 0 and p.ck.abs().max() > 0
    x = _grid((2, M, 9, 9, C), 0.25, -2.0, 2.0, gen).to(dev, dtype)
    with torch.inference_mode():
        before = hopper_attn.qk_attn_interior.launches
        got = hopper_attn.qk_attn_interior(x, p, nh)
        assert hopper_attn.qk_attn_interior.launches == before + 1
        want = hopper_attn.qk_attn_interior_plain(x, p, nh)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert 0.0 < got.float().mean().item() < 1.0
        assert torch.equal(hopper_attn.fused_qk_attention(x, p, nh),
                           hopper_attn.qk_attention_pairlocal(x, p, nh))


def test_k2b_refuses_what_it_does_not_take(dev):
    gen = torch.Generator().manual_seed(5)
    x, g, w, b, kw = _psn_site(10, 8, torch.float32, True, gen, dev, False)
    with pytest.raises(NotImplementedError, match="ATan"):
        hopper_psn.fused_psn_backward(x, g, w, b, **kw, surrogate="sigmoid")
    with pytest.raises(TypeError):
        hopper_psn.fused_psn_backward(x.double(), g.double(), w, b, **kw)
    with pytest.raises(ValueError):
        hopper_psn.fused_psn_backward(x, g[:, :, :-1], w, b, **kw)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = hopper_psn.affine_psn(*leaves, surrogate="sigmoid", alpha=4.0)
    with pytest.raises(NotImplementedError, match="ATan"):
        y.sum().backward()


K4_CASES = [(3, 1, 2, 48), (3, 2, 48, 96), (3, 1, 96, 96), (1, 2, 96, 96),
            (3, 1, 5, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,cin,cout", K4_CASES)
def test_k4_matches_plain_bitwise(dev, dtype, k, stride, cin, cout):
    """K4 vs its twin on dyadic inputs (every float32 sum exact): equal bit
    for bit, with and without the affine, ragged tiles included. The twin
    runs with cuDNN off: cuDNN may pick Winograd, whose transforms round."""
    gen = torch.Generator().manual_seed(k + 3 * stride + cin)
    x = _grid((3, cin, 19, 45), 0.25, -2.0, 2.0, gen).to(dev, dtype)
    w = _grid((cout, cin, k, k), 0.125, -1.0, 1.0, gen).to(dev, dtype)
    a = _grid((cout,), 0.25, 0.25, 2.0, gen).to(dev)
    b = _grid((cout,), 0.25, -1.0, 1.0, gen).to(dev)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=False):
        for kw in (dict(scale=a, shift=b), dict(shift=b), {}):
            before = hopper_embed.conv3x3_affine_cs.launches
            got = hopper_embed.conv3x3_affine_cs(x, w, stride=stride, **kw)
            assert hopper_embed.conv3x3_affine_cs.launches == before + 1
            want = hopper_embed.conv3x3_affine_cs_plain(x, w, stride=stride,
                                                        **kw)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == want.shape
            assert got.shape[-2:] == (-(-19 // stride), -(-45 // stride))
            assert torch.equal(got, want)
    with pytest.raises(NotImplementedError):
        hopper_embed.conv3x3_affine_cs(x, w.clone().requires_grad_(),
                                       stride=stride)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,cin,cout", K4_CASES)
def test_k4_wide_frame_bitwise(dev, dtype, k, stride, cin, cout):
    """K4 on a 21x200 frame: a width that is a multiple of 8 (the bf16
    kernel's 16-byte copies and stores) but not of its 64-column tile, and a
    height that is not a multiple of its 4-row tile; equal to the twin bit
    for bit on dyadic inputs."""
    gen = torch.Generator().manual_seed(100 + k + 3 * stride + cin)
    x = _grid((2, cin, 21, 200), 0.25, -2.0, 2.0, gen).to(dev, dtype)
    w = _grid((cout, cin, k, k), 0.125, -1.0, 1.0, gen).to(dev, dtype)
    a = _grid((cout,), 0.25, 0.25, 2.0, gen).to(dev)
    b = _grid((cout,), 0.25, -1.0, 1.0, gen).to(dev)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=False):
        before = hopper_embed.conv3x3_affine_cs.launches
        got = hopper_embed.conv3x3_affine_cs(x, w, a, b, stride=stride)
        assert hopper_embed.conv3x3_affine_cs.launches == before + 1
        want = hopper_embed.conv3x3_affine_cs_plain(x, w, a, b,
                                                    stride=stride)
        torch.cuda.synchronize()
        assert got.shape == (2, cout, -(-21 // stride), -(-200 // stride))
        assert torch.equal(got, want)
        assert want.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4a_and_k2c_match_plain_bitwise(dev, dtype):
    """K4a on channels-second [T, C, H, W] (with another output dtype) and
    K2c on [T, M, C], each on its own counter, equal to their twins."""
    gen = torch.Generator().manual_seed(17)
    T = 10
    w = _grid((T, T), 0.125, -1.0, 1.0, gen).to(dev)
    b = _grid((T, 1), 0.25, -1.0, 1.0, gen).to(dev)
    x = _grid((T, 12, 9, 31), 0.25, -2.0, 2.0, gen).to(dev, dtype)
    with torch.inference_mode():
        k2 = hopper_psn.fused_affine_psn.launches
        for out_dtype in (None, torch.bfloat16, torch.float32):
            before = hopper_embed.psn_spike_cs.launches
            got = hopper_embed.psn_spike_cs(x, w, b, out_dtype=out_dtype)
            assert hopper_embed.psn_spike_cs.launches == before + 1
            assert got.dtype == (out_dtype or dtype)
            assert torch.equal(got, hopper_embed.psn_spike_cs_plain(
                x, w, b, out_dtype))
        xt = _grid((T, 100, 96), 0.25, -2.0, 2.0, gen).to(dev, dtype)
        before = hopper_psn.psn_spike_tm.launches
        got = hopper_psn.psn_spike_tm(xt, w, b)
        assert hopper_psn.psn_spike_tm.launches == before + 1
        assert hopper_psn.fused_affine_psn.launches == k2
        assert got.dtype == dtype
        assert torch.equal(got, hopper_psn.psn_spike_tm_plain(xt, w, b))
        assert 0.0 < got.float().mean().item() < 1.0


# ------------------------------------------------- the evaluation protocol

def _metric_inputs(gen, b, h=24, w=32, bins=4):
    label = torch.randn((b, 2, h, w), generator=gen) * 4
    pred = label + torch.randn((b, 2, h, w), generator=gen) * 2
    mask = (torch.rand((b, 1, h, w), generator=gen) < 0.7).float()
    chunk = torch.randn((b, bins, h, w), generator=gen) * (
        torch.rand((b, bins, h, w), generator=gen) < 0.3)
    return pred, label, mask, chunk


def _run_metrics(batches, device, dtype, **kw):
    from sdformerflow_tpu_torch.training.evaluate import (
        MetricsAccumulator, make_metrics_fn)
    fn, acc = make_metrics_fn(metric_names=("AEE", "AAE"), **kw), \
        MetricsAccumulator()
    for parts in batches:
        acc.append(fn(*(p.to(device, dtype) for p in parts)),
                   parts[0].shape[0])
    return acc.results()


@pytest.mark.parametrize("mask_events", [False, True])
def test_metrics_on_card_match_float64_cpu(dev, mask_events):
    """float32 sums on the card against float64 on the CPU, same inputs."""
    gen = torch.Generator().manual_seed(21)
    batches = [_metric_inputs(gen, b) for b in (2, 2, 1)]
    got = _run_metrics(batches, dev, torch.float32, mask_events=mask_events)
    want = _run_metrics(batches, "cpu", torch.float64,
                        mask_events=mask_events)
    assert got["num_samples"] == 5 and set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_eval_entry_on_a_tiny_tree(dev, tmp_path, monkeypatch):
    """``eval_dsec.main`` on the card from a reference-named ``.pt``: the
    voxel layout's metrics (``mask_events``) equal a float64 recompute on
    the CPU from the same flows, labels, masks and chunks; without
    ``mask_events`` the event layout (K3 once a batch row) gives the voxel
    layout's results; K1 and K2 launch the same number of times each
    batch."""
    from dsec_tree import (N_VALID, make_tree, save_reference_checkpoint,
                           tiny_config, write_config)
    from sdformerflow_tpu_torch import eval_dsec
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training import config as t_config
    from sdformerflow_tpu_torch.training import evaluate, torch_interop
    tree = make_tree(str(tmp_path / "dsec"))
    cfg = t_config.load_config(write_config(
        tmp_path / "v.yaml", tiny_config(tree, mask_events=True,
                                         batch_size=1)))
    model = get_model(cfg["model"]["name"], *t_config.build_configs(cfg))
    randomize_(model, torch.Generator().manual_seed(22))
    pt = save_reference_checkpoint(
        tmp_path / "ref.pt", torch_interop.to_reference_state_dict(model))
    recorded = []
    make = evaluate.make_metrics_fn

    def recording_make_metrics_fn(**kw):
        fn = make(**kw)

        def run(pred, label, mask, chunk=None):
            recorded.append((pred, label, mask, chunk))
            return fn(pred, label, mask, chunk)
        return run

    monkeypatch.setattr(eval_dsec, "make_metrics_fn",
                        recording_make_metrics_fn)
    results = []
    for events, mask_events in ((False, True), (False, False),
                                (True, False)):
        path = write_config(tmp_path / "run.yaml", tiny_config(
            tree, events=events, mask_events=mask_events, batch_size=1))
        k1, k2, k3 = (hopper_attn.qk_attn_interior.launches,
                      hopper_psn.fused_affine_psn.launches,
                      hopper_voxel.voxel_k3.launches)
        results.append(eval_dsec.main(
            ["--train_config", path, "--torch_ckpt", pt,
             "--run_dir", str(tmp_path / f"run{len(results)}")]))
        assert hopper_voxel.voxel_k3.launches - k3 == (N_VALID if events
                                                       else 0)
        k1 = hopper_attn.qk_attn_interior.launches - k1
        k2 = hopper_psn.fused_affine_psn.launches - k2
        assert k1 > 0 and k2 > 0 and k1 % N_VALID == k2 % N_VALID == 0
    assert results[1] == results[2] != results[0]
    assert results[0]["num_samples"] == N_VALID
    voxel_batches = recorded[:N_VALID]
    assert all(r[3] is not None for r in voxel_batches)
    with torch.inference_mode():
        fn = make(metric_names=("AEE", "AAE"), mask_events=True)
        acc = evaluate.MetricsAccumulator()
        for parts in voxel_batches:
            acc.append(fn(*(p.cpu().double() for p in parts)), 1)
    want = acc.results()
    for k in want:
        assert results[0][k] == pytest.approx(want[k], rel=1e-5), k


def test_custom_ops_launch_on_the_card(dev):
    """The kernels' custom ops on CUDA tensors, as an exported program calls
    them: ``torch.library.opcheck`` (the schema, the fake form against the
    launch, the dispatch through aot_autograd), one counted launch a call
    (K3 one a row), and bitwise the plain twin's result on dyadic inputs."""
    # the first case of test_k1_matches_plain_bitwise: its sites fire
    C, nh = 32, 4
    gen = torch.Generator().manual_seed(12 + C)
    g = lambda *s, step=0.125, lo=-1.0, hi=1.0: _grid(  # noqa: E731
        s, step, lo, hi, gen).to(dev)
    p = hopper_attn.QKAttnParams(
        w_in=g(2, 2, step=0.25), b_in=g(2, step=0.25), wq=g(C, C),
        aq=g(C, step=0.25, lo=0.25, hi=2.0), cq=g(C),
        w_q=g(2, 2, step=0.25), b_q=g(2, step=0.25), wk=g(C, C),
        ak=g(C, step=0.25, lo=0.25, hi=2.0), ck=g(C), pe=g(2, 81, C),
        w_k=g(2, 2, step=0.25), b_k=g(2, step=0.25), w_t=g(2, 2, step=0.25),
        b_t=g(2, step=1.0, lo=-4.0, hi=0.0), wp=g(C, C), bp=g(C), ap=g(C),
        cp=g(C))
    x = g(2, 12, 9, 9, C, step=0.25, lo=-2.0, hi=2.0).to(torch.bfloat16)
    k1 = (x, list(p[:hopper_attn.N_INTERIOR]), nh)
    xs = g(10, 2, 6, 7, C, step=0.25, lo=-2.0, hi=2.0)
    k2 = (xs, g(10, 10, step=0.125), g(10, 1, step=0.25),
          g(C, step=0.25, lo=0.25, hi=2.0), g(C), torch.bfloat16)
    h, w, bins, n = 40, 56, 5, 3000
    t = torch.randint(0, 4 * (bins - 1) + 1, (2, n), generator=gen)
    t[:, :2] = torch.tensor([0, 4 * (bins - 1)])
    ev = [torch.randint(0, w, (2, n), generator=gen),
          torch.randint(0, h, (2, n), generator=gen), t,
          torch.randint(0, 2, (2, n), generator=gen)]
    k3 = (*(e.float().to(dev) for e in ev), torch.ones(2, n, dtype=torch.bool,
                                                       device=dev), bins, h, w)
    cases = [(hopper_attn.qk_attn_interior_op, k1, hopper_attn.qk_attn_interior,
              1, hopper_attn._interior),
             (hopper_psn.fused_affine_psn_op, k2, hopper_psn.fused_affine_psn,
              1, hopper_psn._site),
             (hopper_voxel.voxel_batch_signed_op, k3, hopper_voxel.voxel_k3,
              2, hopper_voxel._voxel_rows)]
    for op, args, wrapper, per_call, impl in cases:
        with torch.inference_mode():
            before = wrapper.launches
            got = op(*args)
            assert wrapper.launches == before + per_call
            cpu = [a.cpu() if isinstance(a, torch.Tensor)
                   else [t.cpu() for t in a] if isinstance(a, list) else a
                   for a in args]
            want = impl(*cpu)
        torch.cuda.synchronize()
        assert got.is_cuda and torch.equal(got.cpu(), want)
        assert got.float().abs().sum() > 0
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result


ZOO = [("SpikingformerFlowNet", "Spiking_PatchEmbed_Conv_sfn", 0),
       ("MS_SpikingformerFlowNet", "MS_Spiking_PatchEmbed_Conv_sfn", 3),
       ("SpikingMultiResUNet", None, 0)]


@pytest.mark.parametrize("name,embed,blocks", ZOO)
def test_zoo_models_launch_at_every_psn_site(dev, name, embed, blocks):
    """The SNN zoo's registry names, tiny, float32 on the card: an eval
    forward launches K2 once at every PSN site that fires (and K1 once a
    block of the MS model), a train step K2 and K2b once at every PSN site,
    with finite flows and gradients."""
    from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    swin = SwinConfig(input_size=(32, 32), depths=(1, 1, 1),
                      num_heads=(2, 2, 2), out_indices=(0, 1, 2),
                      window_size=(2, 3, 3), patch_embed_type=embed or "")
    cfg = SpikingConfig(num_steps=4, v_th=0.3, neuron_type="psn")
    model = get_model(name, {"num_bins": 4, "base_num_channels": 8}, swin,
                      cfg)
    randomize_(model, torch.Generator().manual_seed(7)).to(dev)
    calls = [0]
    for m in model.modules():
        if isinstance(m, SpikingNeuron):
            m.register_forward_pre_hook(
                lambda mod, args: calls.__setitem__(0, calls[0] + 1))
    x = torch.rand(1, 4, 2, 32, 32, generator=torch.Generator()
                   .manual_seed(8)).to(dev)
    P, A = hopper_psn, hopper_attn
    with torch.inference_mode():
        A.qk_attn_interior.launches = P.fused_affine_psn.launches = 0
        flows = model(x)["flow"]
        torch.cuda.synchronize()
    assert calls[0] > 0 and P.fused_affine_psn.launches == calls[0]
    assert A.qk_attn_interior.launches == blocks
    assert all(bool(torch.isfinite(f).all()) for f in flows)
    calls[0] = 0
    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    sum(f.square().mean() for f in model.train()(x)["flow"]).backward()
    torch.cuda.synchronize()
    assert P.fused_affine_psn.launches == P.fused_psn_backward.launches \
        == calls[0] > 0
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters() if p.grad is not None)


def test_global_bn_statistics_at_a_k2_site_over_two_ranks(dev, tmp_path):
    """A BN -> PSN site (K2 forward with the affine of the global batch
    statistics, K2b backward through them) over two gloo ranks on the one
    card, each holding two rows of a batch of 4, against one process on
    the whole batch on the same card: the ranks' spikes are one process's
    rows, and the gradients and running statistics its own (float32
    summation order aside)."""
    import torch_port_dp_ranks as R
    ranks = R.join(R.spawn("k2_site_case", 2, str(tmp_path)), str(tmp_path),
                   timeout=600)
    for r in ranks:
        assert r["launches"] == (1, 1)
        flipped = int((r["y"] != r["y_one"]).sum())
        assert flipped <= 1e-3 * r["y"].numel()
        assert 0.0 < r["y"].float().mean().item() < 1.0
        top = r["dx_one"].abs().max()
        assert (r["dx"] - r["dx_one"]).abs().max() <= 1e-4 * top
        for got, want in zip(r["grads"] + r["stats"],
                             r["grads_one"] + r["stats_one"]):
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * want.abs().max().item())
    assert torch.equal(ranks[0]["grads"][0], ranks[1]["grads"][0])
