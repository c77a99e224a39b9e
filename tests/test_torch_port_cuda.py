"""Hopper kernels vs their plain twins on the card (``-m cuda``).

These need an NVIDIA GPU with the CUDA toolkit and triton, so they skip on
a CPU-only host. On the card:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda

Inputs on power-of-two grids make every float32 sum exact in any order, so
kernel and twin must agree bit for bit.
"""

import pytest
import torch

from sdformerflow_tpu_torch.ops import hopper_attn, hopper_psn

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
