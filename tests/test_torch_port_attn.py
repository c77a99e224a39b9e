"""PyTorch port vs the JAX package: the spiking-QK window attention (K1's
module).

- The port's plain twin ``qk_attention_pairlocal`` vs JAX
  ``fused_qk_attention`` run in Pallas interpret mode, float32, atol 1e-5
  (as tests/test_pallas_attn.py holds the Pallas kernel to its oracle: a
  flipped spike would be an O(1) difference).
- The port's attention module, weights crossed through ``from_jax``, vs the
  flax ``SpikingQKWindowAttention3D`` in float64, atol 1e-12.

Every variable is randomized with numpy (degenerate inits hide wrong
pairings), at geometries including M not a multiple of 4 and 9x9 windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models.common import SpikingConfig as JSpikingConfig
from sdformerflow_tpu.models.spiking_swin import (
    SpikingQKWindowAttention3D as JAttention)
from sdformerflow_tpu.ops.pallas_attn import (QKAttnParams as JParams,
                                              bn_eval_affine,
                                              fused_qk_attention as j_fused)
from sdformerflow_tpu_torch.models.common import SpikingConfig
from sdformerflow_tpu_torch.models.spiking_swin import (
    SpikingQKWindowAttention3D)
from sdformerflow_tpu_torch.ops import hopper_attn
from sdformerflow_tpu_torch.training.from_jax import from_jax

from torch_port_harness import randomize_tree, to_torch

# (M, wh, ww, C, nh)
GEOMETRIES = [(12, 3, 3, 32, 4), (10, 2, 5, 48, 6), (30, 9, 9, 64, 4)]


def _case(M, wh, ww, C, nh, seed):
    """(flax module, port module with the same weights, numpy variables,
    numpy input)."""
    jmod = JAttention(dim=C, window_size=(2, wh, ww), num_heads=nh,
                      cfg=JSpikingConfig(num_steps=2, v_th=0.1,
                                         neuron_type="psn", spike_norm="BN"),
                      norm="BN")
    x = np.random.default_rng(seed).standard_normal((2, M, wh, ww, C))
    variables = randomize_tree(
        jmod.init({"params": jax.random.PRNGKey(0)},
                  jnp.asarray(x, jnp.float32), None, False), seed + 1)
    tmod = SpikingQKWindowAttention3D(
        C, (2, wh, ww), nh, SpikingConfig(num_steps=10, v_th=0.1,
                                          neuron_type="psn")).eval()
    tmod.double().load_state_dict(from_jax(variables, tmod))
    return jmod, tmod, variables, x


def _jax_params(variables, C):
    p, s = variables["params"], variables["batch_stats"]

    def aff(bn_p, bn_s):
        bn_p, bn_s = bn_p["BatchNorm_0"], bn_s["BatchNorm_0"]
        return bn_eval_affine(*(jnp.asarray(a) for a in (
            bn_p["scale"], bn_p["bias"], bn_s["mean"], bn_s["var"])))

    aq, cq = aff(p["q"]["bn"], s["q"]["bn"])
    ak, ck = aff(p["k"]["bn"], s["k"]["bn"])
    ap, cp = aff(p["proj_bn"], s["proj_bn"])
    j = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    return JParams(
        w_in=j(p["proj_sn"]["weight"]), b_in=j(p["proj_sn"]["bias"]),
        wq=j(p["q"]["linear"]["kernel"]), aq=j(aq), cq=j(cq),
        w_q=j(p["q"]["sn"]["weight"]), b_q=j(p["q"]["sn"]["bias"]),
        wk=j(p["k"]["linear"]["kernel"]), ak=j(ak), ck=j(ck),
        pe=j(p["k"]["positional_encoding"]).reshape(2, -1, C),
        w_k=j(p["k"]["sn"]["weight"]), b_k=j(p["k"]["sn"]["bias"]),
        w_t=j(p["sn2_q"]["weight"]), b_t=j(p["sn2_q"]["bias"]),
        wp=j(p["proj"]["kernel"]), bp=j(p["proj"]["bias"]), ap=j(ap),
        cp=j(cp))


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_pairlocal_twin_matches_jax_pallas_kernel_f32(geo):
    M, wh, ww, C, nh = geo
    _, tmod, variables, x = _case(*geo, seed=sum(geo))
    with jax.enable_x64(False):
        jp = _jax_params(variables, C)
        want = np.asarray(j_fused(jnp.asarray(x, jnp.float32), jp, nh,
                                  interpret=True))
    tp = hopper_attn.QKAttnParams(*(to_torch(np.asarray(a)) for a in jp))
    xt = to_torch(x).float()
    with torch.no_grad():
        got = hopper_attn.qk_attention_pairlocal(xt, tp, nh)
        # the CPU dispatch of the kernel wrapper is the same twin
        np.testing.assert_array_equal(
            hopper_attn.fused_qk_attention(xt, tp, nh).numpy(), got.numpy())
        # ...and the module in float32 runs that path too
        np.testing.assert_allclose(tmod.float()(xt).numpy(), want, rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    interior = hopper_attn.qk_attn_interior_plain(xt, tp, nh)
    assert 0.0 < interior.mean().item() < 1.0  # not degenerate


@pytest.mark.parametrize("geo", GEOMETRIES[:2])
def test_attention_module_matches_flax_f64(geo):
    M, wh, ww, C, nh = geo
    jmod, tmod, variables, x = _case(*geo, seed=2 * sum(geo))
    with jax.enable_x64(True):
        want, _ = jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                             jnp.asarray(x), None, False)
    with torch.no_grad():
        got = tmod(to_torch(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_attention_rejects_what_is_not_ported():
    _, tmod, _, x = _case(10, 2, 5, 48, 6, seed=0)
    xt = to_torch(x)
    with torch.no_grad():
        with pytest.raises(NotImplementedError):
            tmod(xt[:, :9])                      # odd window count
        with pytest.raises(ValueError, match="CUDA"):
            hopper_attn.qk_attn_interior(xt.float(), tmod.kernel_params(), 6)
        tmod.train()
        with pytest.raises(NotImplementedError):
            tmod(xt)
    with pytest.raises(NotImplementedError):
        SpikingQKWindowAttention3D(48, (1, 2, 5), 6,
                                   SpikingConfig(neuron_type="psn"))
