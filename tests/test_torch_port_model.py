"""PyTorch port vs the JAX package: the whole SDformerFlow forward.

Float64 on both sides with every variable randomized and crossed through
``from_jax``; JAX runs the fused Pallas QK attention in interpret mode, the
port its pair-local plain twins (CPU tensors). Spikes are exact 0/1, so a
wrong pairing shows as an O(1) difference; the tolerance (1e-9 relative)
only absorbs float64 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
from sdformerflow_tpu_torch.models.registry import get_model
from sdformerflow_tpu_torch.ops.normalization import encode_input
from sdformerflow_tpu_torch.training.from_jax import from_jax

from torch_port_harness import flownet_pair, init_pair, randomize_tree, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

GEOMETRIES = {
    # the tiny flagship of tests/test_fused_attn_model.py
    "tiny": dict(size=(24, 32), depths=(1, 1), heads=(2, 2), window=(2, 3, 3),
                 num_steps=4, num_bins=4, base=16),
    # 4 stages at 96x128: shifted blocks, stage-3 window clamp, M = 10
    "en4_96x128": dict(size=(96, 128), depths=(2, 2, 2, 2),
                       heads=(2, 2, 4, 4), window=(2, 3, 3), num_steps=10,
                       num_bins=10, base=8),
    # the MDR/MVSEC geometry (T=5, window (2, 8, 8)) cut to 64x64: M = 12
    # windows at stage 1 (even: K1's twin), M = 3 at stage 2 (odd: the
    # raw-refold form)
    "mdr_64x64": dict(size=(64, 64), depths=(1, 1), heads=(2, 2),
                      window=(2, 8, 8), num_steps=5, num_bins=10, base=8),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_flownet_forward_matches_jax_f64(name):
    geo = GEOMETRIES[name]
    jmodel, tmodel = flownet_pair(**geo)
    rng = np.random.default_rng(3)
    chunk = rng.standard_normal((1, geo["num_bins"]) + geo["size"])
    with jax.enable_x64(True):
        x_enc = np.asarray(j_encode(jnp.asarray(chunk)))
        variables = init_pair(jmodel, tmodel, x_enc, seed=5)
        want = jax.jit(lambda v, z: jmodel.apply(v, z, False)["flow"])(
            variables, jnp.asarray(x_enc))
    with torch.no_grad():
        x_port = encode_input(to_torch(chunk))
        np.testing.assert_allclose(x_port.numpy(), x_enc, rtol=0, atol=1e-15)
        got = tmodel(x_port)["flow"]
    assert len(got) == len(want) == len(geo["depths"])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())


def test_from_jax_rejects_unmapped_and_missing_keys():
    jmodel, tmodel = flownet_pair(**GEOMETRIES["tiny"])
    x = np.zeros((1, 4, 2, 24, 32), np.float32)
    variables = randomize_tree(jax.jit(lambda z: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, z, False))(x), seed=0)
    sd = from_jax(variables, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    extra = {"params": dict(variables["params"], stray={"kernel": np.ones(3)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        from_jax(extra, tmodel)
    params = dict(variables["params"])
    unet = dict(params["sttmultires_unet"])
    del unet["pred0"]
    params["sttmultires_unet"] = unet
    with pytest.raises(KeyError, match="pred0"):
        from_jax({"params": params,
                  "batch_stats": variables["batch_stats"]}, tmodel)


def test_registry_and_unported_options_raise():
    swin = SwinConfig(input_size=(24, 32), depths=(1, 1, 1, 1),
                      num_heads=(2, 2, 2, 2), window_size=(2, 3, 3))
    cfg = SpikingConfig(num_steps=4, v_th=0.1, neuron_type="psn")
    with pytest.raises(KeyError, match="MS_SpikingformerFlowNet_en4"):
        get_model("NoSuchFlowNet", {}, swin, cfg)
    model = get_model("MS_SpikingformerFlowNet_en4",
                      {"num_bins": 4, "base_num_channels": 8}, swin, cfg)
    assert not model.training
    assert get_model("MS_SpikingformerFlowNet_en4", {"num_bins": 4,
                     "base_num_channels": 8}, swin, cfg, train=True).training
    # train mode is ported: batch statistics, running statistics updated
    x = torch.rand(1, 4, 2, 24, 32)
    model.train()
    before = model.state_dict()["sttmultires_unet.decoder0.norm."
                                "BatchNorm_0.running_mean"].clone()
    flows = model(x)["flow"]
    assert all(bool(torch.isfinite(f).all()) for f in flows)
    after = model.state_dict()["sttmultires_unet.decoder0.norm."
                               "BatchNorm_0.running_mean"]
    assert not torch.equal(before, after)
    # the JAX default neuron and the other norms build and run (held
    # against JAX in tests/test_torch_port_zoo_*.py); the s2d embed needs
    # a running-statistics BN, as in JAX
    for other in (dict(neuron_type="lif"), dict(spike_norm="LN")):
        m = get_model("MS_SpikingformerFlowNet_en4", {"num_bins": 4,
                      "base_num_channels": 8}, swin, cfg.replace(**other))
        assert bool(torch.isfinite(m(x)["flow"][-1]).all())
    with pytest.raises(ValueError, match="running-statistics BN"):
        get_model("MS_SpikingformerFlowNet_en4", {"num_bins": 4,
                  "base_num_channels": 8}, swin,
                  cfg.replace(s2d_embed=True, spike_norm="LN"))
    # s2d_train is ported (test_torch_port_train_slice.py); it excludes
    # the eval-only s2d embed, as in JAX
    with pytest.raises(ValueError, match="mutually exclusive"):
        get_model("MS_SpikingformerFlowNet_en4", {"num_bins": 4,
                  "base_num_channels": 8}, swin,
                  cfg.replace(s2d_train=True, s2d_embed=True))
    # the s2d embed is ported, for eval only
    s2d = get_model("MS_SpikingformerFlowNet_en4", {"num_bins": 4,
                    "base_num_channels": 8}, swin, cfg.replace(s2d_embed=True))
    assert s2d(x)["flow"][-1].shape == (1, 2, 24, 32)
    with pytest.raises(ValueError, match="inference-only"):
        s2d.train()(x)
    # a temporal window of 1: the raw-refold attention, at every stage
    m = get_model("MS_SpikingformerFlowNet_en4", {"num_bins": 4,
                  "base_num_channels": 8},
                  swin.replace(window_size=(1, 3, 3)), cfg)
    assert m(x)["flow"][-1].shape == (1, 2, 24, 32)
