"""The launch plumbing of K2 and K2b (``csrc/psn.cu``), on the CPU.

The card is not needed to check that the wrappers and the C entry points
agree: the ctypes ``argtypes`` of ``psn_fwd``, ``psn_bwd`` and
``psn_bwd_workspace`` follow their C declarations parameter by parameter,
the argument tuples the wrappers build take exactly those types, and the
wrappers raise, before any build or launch, on what the kernels do not take
(more than 16 time steps, another dtype, a CPU tensor). No JAX here.
"""

import ctypes
import re

import pytest
import torch

from sdformerflow_tpu_torch import kernel_build
from sdformerflow_tpu_torch.ops import hopper_embed, hopper_psn

C_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
           "float": ctypes.c_float}


def _declarations():
    """{name: (return ctypes type, [parameter ctypes types])} of the
    ``extern "C"`` functions of csrc/psn.cu."""
    text = (kernel_build.CSRC_DIR / "psn.cu").read_text()
    out = {}
    for ret, name, params in re.findall(
            r'extern "C" (\w+) (\w+)\(([^)]*)\)', text):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            types.append(ctypes.c_void_p if "*" in p
                         else C_TYPES[p.rsplit(" ", 1)[0]])
        out[name] = (C_TYPES[ret], types)
    return out


@pytest.mark.parametrize("name", sorted(hopper_psn.ARGTYPES))
def test_argtypes_match_the_c_declarations(name):
    decl = _declarations()
    assert set(decl) == set(hopper_psn.ARGTYPES)
    ret, params = decl[name]
    assert hopper_psn.RESTYPES[name] is ret
    assert hopper_psn.ARGTYPES[name] == params


def _accepted(argtypes, args):
    """Each argument passes its ctypes type's conversion."""
    assert len(args) == len(argtypes)
    for t, a in zip(argtypes, args):
        t.from_param(a)


@pytest.mark.parametrize("membrane", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_k2_arguments_take_the_declared_types(affine, membrane):
    T, C = 5, 12
    x = torch.zeros(T, 3, 7, C, dtype=torch.bfloat16)
    w, b = torch.zeros(T, T), torch.zeros(T, 1)
    sc = sh = torch.ones(C) if affine else None
    out = torch.empty(x.shape, dtype=torch.float32)
    h = torch.empty(x.shape, dtype=torch.float32) if membrane else None
    args = hopper_psn.k2_args(x, w, b, sc, sh, out, h)
    _accepted(hopper_psn.ARGTYPES["psn_fwd"], args + (0,))   # + the stream
    # n, steps, channels and the dtype codes of x, W and out
    assert args[7:] == (3 * 7 * C, T, C, 1, 0, 0)
    assert (args[3] is None) == (not affine)
    # the potential's output: a null pointer when not asked for
    assert (args[6] is None) == (not membrane)


@pytest.mark.parametrize("affine", [False, True])
def test_k2b_arguments_take_the_declared_types(affine):
    T, C = 10, 8
    x = torch.zeros(T, 2, 5, C)
    g = torch.zeros_like(x)
    w, b = torch.zeros(T, T, dtype=torch.bfloat16), torch.zeros(
        T, dtype=torch.bfloat16)
    sc = sh = torch.ones(C) if affine else None
    grads = torch.empty(T * T + T + (2 * C if affine else 0))
    ws = torch.empty(33)
    args = hopper_psn.k2b_args(x, g, w, b, sc, sh, torch.empty_like(x),
                               grads, ws, alpha=2.0)
    _accepted(hopper_psn.ARGTYPES["psn_bwd"], args + (0,))
    # workspace floats, n, steps, channels, dtype codes of x and W
    assert args[9:15] == (33, 2 * 5 * C, T, C, 0, 1)
    assert args[15] == 1.0
    _accepted(hopper_psn.ARGTYPES["psn_bwd_workspace"],
              (2 * 5 * C, T, C, int(affine), 0))


def _site(T=10, C=8, dtype=torch.float32, wdtype=torch.float32):
    x = torch.zeros(T, 3, C, dtype=dtype)
    return (x, torch.zeros(T, T, dtype=wdtype), torch.zeros(T, 1,
                                                            dtype=wdtype))


REFUSALS = {
    "17 steps": (dict(T=17), {}, ValueError, "1-16"),
    "float64 x": (dict(dtype=torch.float64), {}, TypeError, "float32"),
    "float16 x": (dict(dtype=torch.float16), {}, TypeError, "float32"),
    "float64 W": (dict(wdtype=torch.float64), {}, TypeError, "W and b"),
    "float64 affine": (dict(), dict(scale=torch.ones(8, dtype=torch.float64),
                                    shift=torch.zeros(8, dtype=torch.float64)),
                       TypeError, "scale"),
    "cpu tensor": (dict(), {}, ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_kernel_entries_raise_and_do_not_fall_back(case):
    """The launch entries of K2, K4a, K2c and K2b raise on what the kernels
    do not take, CPU tensors included (only the dispatching entries run
    the twins on the CPU), and nothing is built."""
    site_kw, kw, err, match = REFUSALS[case]
    x, w, b = _site(**site_kw)
    with pytest.raises(err, match=match):
        hopper_psn.launch_k2(x, w, b, **kw)
    with pytest.raises(err, match=match):
        hopper_psn.prepare_k2b(x, torch.zeros_like(x), w, b, **kw)
    if not kw:
        for kernel in ("K4a", "K2c"):
            with pytest.raises(err, match=match):
                hopper_psn.launch_k2(x, w, b, kernel=kernel)
    with pytest.raises(TypeError, match="writes"):
        hopper_psn.prepare_k2(*_site(), out_dtype=torch.float16)
    assert hopper_psn._lib.cache_info().currsize == 0
    # the dispatching entries on CPU tensors: the plain twins, no count
    if case == "cpu tensor":
        before = (hopper_psn.fused_affine_psn.launches,
                  hopper_psn.fused_psn_backward.launches,
                  hopper_embed.psn_spike_cs.launches)
        hopper_psn.fused_affine_psn(x, w, b)
        hopper_psn.fused_psn_backward(x, torch.zeros_like(x), w, b)
        hopper_embed.psn_spike_cs(x, w, b)
        assert before == (hopper_psn.fused_affine_psn.launches,
                          hopper_psn.fused_psn_backward.launches,
                          hopper_embed.psn_spike_cs.launches)
