"""PyTorch port vs the JAX package: the fused-embed eval path (K4, K4a) and
K2c, and the s2d embed re-expression.

The plain twins of K4 (``conv3x3_affine_cs``), K4a (``psn_spike_cs``) and K2c
(``psn_spike_tm``) against the Pallas kernels run in interpret mode, on
dyadic inputs (every float32 sum exact): equal bit for bit. The fused embed
against the port's own module embed in float64 (an exact re-expression,
1e-12) and against JAX's fused embed in float32 (the JAX test's
tolerance); the fused eval step against JAX's module path in float64. The
s2d ops bit for bit; the s2d model against JAX's s2d model and the port's
base model in float64; the raising cases.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models.common import SpikingConfig as JSpikingConfig
from sdformerflow_tpu.models.spiking_patch_embed import (
    MSPEDSpikingPatchEmbedConvSfn as JEmbed)
from sdformerflow_tpu.ops import pallas_embed, pallas_psn
from sdformerflow_tpu.ops import s2d as j_s2d
from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu.training import train_step as j_train_step
from sdformerflow_tpu.training.s2d_embed import s2d_model_and_variables
from sdformerflow_tpu_torch.models.common import SpikingConfig
from sdformerflow_tpu_torch.models.registry import get_model, randomize_
from sdformerflow_tpu_torch.models.spiking_patch_embed import (
    MSPEDSpikingPatchEmbedConvSfn)
from sdformerflow_tpu_torch.ops import hopper_embed, hopper_psn, s2d
from sdformerflow_tpu_torch.serving import FlowServer
from sdformerflow_tpu_torch.training.config import build_configs, load_config
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.training.s2d_embed import s2d_embed_state_dict
from sdformerflow_tpu_torch.training.train_step import make_eval_step

from torch_port_harness import flownet_pair, init_pair, randomize_tree, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
TINY = dict(size=(24, 32), depths=(1, 1), heads=(2, 2), window=(2, 3, 3),
            num_steps=4, num_bins=4, base=16)
ENTRY = dict(size=(96, 128), depths=(2, 2, 2, 2), heads=(2, 2, 4, 4),
             window=(2, 3, 3), num_steps=10, num_bins=10, base=8)


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode on the CPU."""
    import jax.experimental.pallas as pl
    real_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real_call(*args, **kwargs)

    monkeypatch.setattr(pallas_embed.pl, "pallas_call", interp_call)
    monkeypatch.setattr(pallas_psn.pl, "pallas_call", interp_call)


def _dyadic(rng, shape, step, lo, hi):
    n = int(round((hi - lo) / step)) + 1
    return (rng.integers(0, n, shape) * step + lo).astype(np.float32)


# ------------------------------------------------------------- the twins

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("wd", [256, 200])
@pytest.mark.parametrize("ksize", [3, 1])
def test_k4_twin_matches_pallas_bitwise(interpret, ksize, wd, stride):
    rng = np.random.default_rng(ksize + wd + stride)
    T, cin, cout, H = 2, 8, 16, 16
    x = _dyadic(rng, (T, cin, H, wd), 0.25, -2.0, 2.0)
    k = _dyadic(rng, (ksize, ksize, cin, cout), 0.125, -1.0, 1.0)
    a = _dyadic(rng, (cout,), 0.25, 0.25, 2.0)
    b = _dyadic(rng, (cout,), 0.25, -1.0, 1.0)
    want = np.asarray(pallas_embed.conv3x3_affine_cs(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(a), jnp.asarray(b)))
    want = want[:, :, ::stride, ::stride]
    got = hopper_embed.conv3x3_affine_cs(
        to_torch(x), to_torch(k.transpose(3, 2, 0, 1)), to_torch(a),
        to_torch(b), stride=stride)
    assert got.dtype == torch.float32 and np.abs(want).max() > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_k4a_twin_matches_pallas_bitwise(interpret, out_dtype):
    rng = np.random.default_rng(4)
    T = 4
    x = _dyadic(rng, (T, 16, 12, 256), 0.25, -2.0, 2.0)
    w = _dyadic(rng, (T, T), 0.125, -1.0, 1.0)
    b = _dyadic(rng, (T, 1), 0.25, -1.0, 1.0)
    want = pallas_embed.psn_spike_cs(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        out_dtype=out_dtype and jnp.dtype(out_dtype))
    got = hopper_embed.psn_spike_cs(
        to_torch(x), to_torch(w), to_torch(b),
        out_dtype=out_dtype and getattr(torch, out_dtype))
    assert str(got.dtype)[6:] == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    assert 0.0 < want.mean() < 1.0
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("m", [1024, 100])   # a Pallas block, the fallback
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2c_twin_matches_pallas_bitwise(interpret, m, dtype):
    rng = np.random.default_rng(m)
    T = 4
    x = _dyadic(rng, (T, m, 16), 0.25, -2.0, 2.0)
    w = _dyadic(rng, (T, T), 0.125, -1.0, 1.0)
    b = _dyadic(rng, (T, 1), 0.25, -1.0, 1.0)
    want = pallas_psn.psn_spike_tm(jnp.asarray(x, dtype), jnp.asarray(w),
                                   jnp.asarray(b))
    got = hopper_psn.psn_spike_tm(to_torch(x).to(getattr(torch, dtype)),
                                  to_torch(w), to_torch(b))
    # the Pallas kernel keeps the input's dtype (its XLA fallback promotes
    # bfloat16 to float32; the port has no fallback)
    assert str(got.dtype)[6:] == dtype
    want = np.asarray(want.astype(jnp.float32))
    assert 0.0 < want.mean() < 1.0
    np.testing.assert_array_equal(got.float().numpy(), want)


# ------------------------------------------------------- the fused embed

def _port_embed(T, hw, dtype, seed):
    cfg = SpikingConfig(num_steps=T, v_th=0.1, neuron_type="psn")
    embed = MSPEDSpikingPatchEmbedConvSfn(img_size=hw, in_chans=T,
                                          embed_dim=16, cfg=cfg)
    randomize_(embed, torch.Generator().manual_seed(seed))
    return embed.to(dtype).eval()


def test_fused_embed_matches_module_f64():
    T, hw = 4, (32, 40)
    embed = _port_embed(T, hw, torch.float64, seed=1)
    x = torch.randn((2, T, 2) + hw, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    with torch.no_grad():
        want = embed(x)
        got = hopper_embed.fused_embed_forward(embed, x, num_steps=T)
    assert got.shape == want.shape == (T, 2, 8, 10, 16)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_fused_embed_matches_jax_fused_f32(interpret):
    T, hw = 4, (32, 32)
    cfg = JSpikingConfig(num_steps=T, v_th=0.1, v_reset=None,
                         neuron_type="psn", spike_norm="BN")
    jembed = JEmbed(img_size=hw, in_chans=T, embed_dim=16, cfg=cfg)
    x = np.random.default_rng(3).standard_normal((2, T, 2) + hw)
    variables = randomize_tree(jax.jit(lambda z: jembed.init(
        {"params": jax.random.PRNGKey(0)}, z, False))(
            x.astype(np.float32)), seed=4)
    v32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                 variables)
    want = np.asarray(pallas_embed.fused_embed_forward(
        v32["params"], v32["batch_stats"], jnp.asarray(x, jnp.float32),
        num_steps=T))
    embed = _port_embed(T, hw, torch.float32, seed=0)
    embed.load_state_dict(from_jax(variables, embed))
    with torch.no_grad():
        got = hopper_embed.fused_embed_forward(
            embed, to_torch(x).float(), num_steps=T)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)


def test_fused_eval_step_matches_jax_module_path_f64():
    jmodel, tmodel = flownet_pair(**ENTRY)
    rng = np.random.default_rng(5)
    chunk = (rng.standard_normal((1, 10) + ENTRY["size"])
             * (rng.random((1, 10) + ENTRY["size"]) < 0.3))
    with jax.enable_x64(True):
        x_enc = np.asarray(j_encode(jnp.asarray(chunk)))
        variables = init_pair(jmodel, tmodel, x_enc, seed=6)
        state = j_train_step.TrainState(
            step=0, params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=(),
            apply_fn=jmodel.apply, tx=None)
        want = j_train_step.make_eval_step()(state, jnp.asarray(chunk))
    got = make_eval_step(tmodel, compute_dtype=torch.float64,
                         fused_embed=True, num_steps=10)(to_torch(chunk))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=1e-10)


def test_fused_eval_step_composes_with_events_and_crop():
    """The raw-events step (voxelize at sensor size, centre crop) with the
    fused embed equals the same step on the module embed, in float64."""
    _, tmodel = flownet_pair(**TINY)
    randomize_(tmodel, torch.Generator().manual_seed(12))
    tmodel.double()
    rng = np.random.default_rng(13)
    n, (h, w) = 3000, (30, 40)
    ev = {"x": rng.uniform(-1.0, w, (2, n)), "y": rng.uniform(-1.0, h, (2, n)),
          "t": np.sort(rng.uniform(0.0, 1.0, (2, n))),
          "p": rng.integers(0, 2, (2, n))}
    ev = {k: to_torch(v).float() for k, v in ev.items()}
    ev["valid"] = torch.arange(n).expand(2, n) < torch.tensor([[n], [n // 2]])
    kw = dict(compute_dtype=torch.float64, crop=TINY["size"],
              voxelize=dict(num_bins=TINY["num_bins"], height=h, width=w))
    want = make_eval_step(tmodel, **kw)(ev)
    got = make_eval_step(tmodel, fused_embed=True,
                         num_steps=TINY["num_steps"], **kw)(ev)
    assert len(got) == len(want) == 2
    for g, w_ in zip(got, want):
        assert g.shape == (2, 2) + TINY["size"] and w_.abs().max() > 0
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-12)


# ------------------------------------------------------------------- s2d

S2D_FUNCS = {
    "space_to_depth": (s2d.space_to_depth, j_s2d.space_to_depth,
                       (2, 3, 8, 12, 5), None),
    "depth_to_space": (s2d.depth_to_space, j_s2d.depth_to_space,
                       (2, 3, 4, 6, 20), None),
    "s2d_kernel_s1": (s2d.s2d_kernel_s1, j_s2d.s2d_kernel_s1, (3, 3, 3, 5),
                      (3, 2, 0, 1)),
    "s2d_kernel_s2": (s2d.s2d_kernel_s2, j_s2d.s2d_kernel_s2, (3, 3, 4, 6),
                      (3, 2, 0, 1)),
    "tile4": (s2d.tile4, j_s2d.tile4, (7,), None),
}


@pytest.mark.parametrize("name", sorted(S2D_FUNCS))
def test_s2d_op_matches_jax_bitwise(name):
    port, jax_fn, shape, oihw = S2D_FUNCS[name]
    a = np.random.default_rng(len(name)).standard_normal(shape)
    want = np.asarray(jax_fn(jnp.asarray(a, jnp.float32)))
    if oihw is None:
        got = port(to_torch(a).float()).numpy()
    else:   # HWIO in JAX, OIHW in the port
        got = port(to_torch(a.transpose(oihw)).float()).numpy()
        want = want.transpose(oihw)
    np.testing.assert_array_equal(got, want)


def test_s2d_model_matches_jax_and_base_f64():
    jmodel, tmodel = flownet_pair(**TINY)
    rng = np.random.default_rng(8)
    chunk = rng.standard_normal((1, TINY["num_bins"]) + TINY["size"])
    with jax.enable_x64(True):
        x_enc = np.asarray(j_encode(jnp.asarray(chunk)))
        variables = init_pair(jmodel, tmodel, x_enc, seed=9)
        jmodel_s, vars_s = s2d_model_and_variables(jmodel, variables)
        want = jax.jit(lambda v, z: jmodel_s.apply(v, z, False)["flow"])(
            vars_s, jnp.asarray(x_enc))
    _, model_s = flownet_pair(**TINY, s2d_embed=True)
    model_s.double()
    sd = s2d_embed_state_dict(tmodel.state_dict())
    assert model_s.sttmultires_unet.encoders.patch_embed.s2d
    # the rearranged state is exactly JAX's rearranged variables
    crossed = from_jax(vars_s, model_s)
    assert set(crossed) == set(sd)
    for key, val in crossed.items():
        assert torch.equal(val, sd[key]), key
    model_s.load_state_dict(sd)
    with torch.no_grad():
        x = to_torch(x_enc)
        got, base = model_s(x)["flow"], tmodel(x)["flow"]
    for g, b, w in zip(got, base, want):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())
        torch.testing.assert_close(g, b, rtol=1e-9, atol=1e-12)


def _tiny_config():
    config = load_config(os.path.join(CONFIGS, "test_tiny_snn.yaml"))
    config["loader"]["crop"] = [96, 128]
    return config


def test_flow_server_s2d_cpu():
    config = _tiny_config()
    model_cfg, swin, spiking = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, spiking)
    randomize_(model, torch.Generator().manual_seed(10))
    state = model.state_dict()
    rng = np.random.default_rng(11)
    request = (rng.standard_normal((10, 96, 128))
               * (rng.random((10, 96, 128)) < 0.3)).astype(np.float32)
    model_s = get_model(config["model"]["name"], model_cfg, swin,
                        spiking.replace(s2d_embed=True))
    model_s.load_state_dict(s2d_embed_state_dict(state))
    want = make_eval_step(model_s)(torch.from_numpy(request)[None])[-1][0]
    with FlowServer(config, state, device="cpu", bf16=False,
                    s2d=True) as server:
        assert server.model.sttmultires_unet.encoders.patch_embed.s2d
        flow = server.infer(request)
    assert flow.shape == (2, 96, 128) and np.isfinite(flow).all()
    assert np.abs(flow).max() > 0
    np.testing.assert_array_equal(flow, want.numpy())


# --------------------------------------------------------- what raises

def _small_model(**cfg_kw):
    model_cfg, swin, spiking = build_configs(_tiny_config())
    swin = swin.replace(input_size=(24, 32), depths=(1, 1, 1, 1),
                        num_heads=(2, 2, 2, 2))
    return get_model("MS_SpikingformerFlowNet_en4",
                     {"num_bins": 10, "base_num_channels": 8}, swin,
                     spiking.replace(**cfg_kw))


def _fused_batch_stats():
    make_eval_step(_small_model(), fused_embed=True, num_steps=10,
                   use_batch_stats=True)


def _fused_no_steps():
    make_eval_step(_small_model(), fused_embed=True)


def _fused_s2d():
    make_eval_step(_small_model(s2d_embed=True), fused_embed=True,
                   num_steps=10)


def _fused_s2d_train():
    make_eval_step(_small_model(s2d_train=True), fused_embed=True,
                   num_steps=10)


def _s2d_train_mode():
    model = _small_model(s2d_embed=True).train()
    model(torch.zeros(1, 10, 2, 24, 32))


def _s2d_batch_stats():
    make_eval_step(_small_model(s2d_embed=True), use_batch_stats=True)(
        torch.zeros(1, 10, 24, 32))


def _s2d_train():
    # s2d_train is ported; with the eval-only s2d embed it is refused
    _small_model(s2d_train=True, s2d_embed=True)


def _s2d_norm():
    _small_model(s2d_embed=True, spike_norm="LN")


def _s2d_state_of_another_model():
    s2d_embed_state_dict({"proj.weight": torch.zeros(3, 3)})


RAISES = {
    "fused_batch_stats": (_fused_batch_stats, ValueError),
    "fused_no_steps": (_fused_no_steps, ValueError),
    "fused_s2d": (_fused_s2d, ValueError),
    "fused_s2d_train": (_fused_s2d_train, ValueError),
    "s2d_train_mode": (_s2d_train_mode, ValueError),
    "s2d_batch_stats": (_s2d_batch_stats, ValueError),
    "s2d_train": (_s2d_train, ValueError),
    "s2d_norm": (_s2d_norm, ValueError),     # JAX's refusal
    "s2d_state_of_another_model": (_s2d_state_of_another_model, ValueError),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_unsupported_cases_raise(case):
    fn, exc = RAISES[case]
    with pytest.raises(exc):
        fn()
