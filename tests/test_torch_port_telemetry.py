"""PyTorch port vs the JAX package: the neuron telemetry, float64, on the
tiny geometry of ``tests/test_energy.py`` (16x16, T = 4, base 16, depths
(1, 1), window (2, 2, 2), two encoders) with every variable randomized by
``torch_port_harness``: an MS model with PSN (the fused K2 sites' plain
twins on the CPU), an MS model with LIF (the recurrent loops' membranes)
and a SEW model with PSN (the BN window attention).

JAX's default eval (no fused attention) runs the raw-refold attention and
fires ``attn_sn``; the port, while collecting, runs its pair-local form at
these even window counts, which JAX says sows the same telemetry
(``spiking_swin.py:340-348``): held here rather than assumed. The keys are
taken from JAX itself, built as ``scripts/eval_dsec.py`` builds them.

Tolerances: firing rates are float32 means of 0/1 spikes on both sides,
within 1e-12. JAX takes the membrane statistics in float32
(``spiking_layers.py:73-75``), so its own means and standard deviations
carry float32 summation error (up to ~2.4e-6 of a site's largest statistic
here): the max column is held bit for bit, the mean and std within
``MEMBRANE_REL`` of the site's largest |statistic| (~84 float32 ulps). The
flows and the SEW attention scores are float64 on both sides (1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models.common import SpikingConfig as JSpikingConfig
from sdformerflow_tpu.models.common import SwinConfig as JSwinConfig
from sdformerflow_tpu.models.snn_flownet import (
    SpikingformerFlowNet as JSpikingformerFlowNet)
from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
from sdformerflow_tpu_torch.models.snn_flownet import SpikingformerFlowNet
from sdformerflow_tpu_torch.models.spiking_layers import collect_sites
from sdformerflow_tpu_torch.ops import hopper_psn
from sdformerflow_tpu_torch.ops.neurons import psn_neuron
from sdformerflow_tpu_torch.ops.normalization import encode_input
from sdformerflow_tpu_torch.training.train_step import make_eval_step

from torch_port_harness import init_pair, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

H, W, T, C0 = 16, 16, 4, 16
RATE_TOL = 1e-12
MEMBRANE_REL = 1e-5
FLOW_TOL = 1e-9
STEP_FLOW_TOL = 2 ** -23   # the eval step's float32 rounding of the flow
ENCODE = dict(encoding="voxel", polarity=True, norm_input="minmax",
              spike_th=None)

CASES = {
    "ms-psn": dict(neuron_type="psn", ms=True,
                   embed="MS_PED_Spiking_PatchEmbed_Conv_sfn"),
    "ms-lif": dict(neuron_type="lif", ms=True,
                   embed="MS_PED_Spiking_PatchEmbed_Conv_sfn"),
    "sew-psn": dict(neuron_type="psn", ms=False,
                    embed="Spiking_PatchEmbed_Conv_sfn"),
}


def jax_keyed(tree):
    """A sown tree flattened as ``scripts/eval_dsec.py:256-259`` keys it."""
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class Case:
    """One model on both sides and what JAX gives for it: the eval
    forward's flows and telemetry, the ``log=True`` attention maps, and
    the batch-statistics forward's flows and telemetry."""

    def __init__(self, neuron_type, ms, embed):
        swin_kw = dict(arc_type="swinv1", patch_embed_type=embed,
                       input_size=(H, W), patch_size=(1, 1, 2, 2),
                       depths=(1, 1), num_heads=(2, 2), out_indices=(0, 1),
                       window_size=(2, 2, 2), qk_scale=0.125,
                       drop_path_rate=0.0)
        cfg_kw = dict(num_steps=T, v_th=0.1, v_reset=None,
                      neuron_type=neuron_type, spike_norm="BN",
                      store_v_seq=True)
        net = dict(num_bins=T, base_num_channels=C0, num_encoders=2,
                   use_upsample_conv=False, ms=ms)
        jmodel = JSpikingformerFlowNet(swin=JSwinConfig(**swin_kw),
                                       cfg=JSpikingConfig(**cfg_kw), **net)
        self.ms = ms
        self.model = SpikingformerFlowNet(
            SwinConfig(**swin_kw), SpikingConfig(**cfg_kw), **net).eval()
        self.chunk = np.random.default_rng(5).standard_normal((1, T, H, W))
        with jax.enable_x64(True):
            x_enc = np.asarray(j_encode(jnp.asarray(self.chunk), **ENCODE))
            variables = init_pair(jmodel, self.model, x_enc, seed=6)

            @jax.jit
            def run(v, z):
                ev, sown = jmodel.apply(v, z, False,
                                        mutable=["intermediates"])
                logged = jmodel.apply(v, z, False, log=True)["attn"]
                tr, sown_tr = jmodel.apply(
                    v, z, True, mutable=["batch_stats", "intermediates"],
                    rngs={"droppath": jax.random.PRNGKey(0)})
                return (ev["flow"], sown["intermediates"], logged,
                        tr["flow"], sown_tr["intermediates"])

            (flows, sown, logged, flows_tr, sown_tr) = run(
                variables, jnp.asarray(x_enc))
        self.flows = [np.asarray(f) for f in flows]
        self.sites = jax_keyed(sown)
        self.attn = [np.asarray(a) for a in logged]
        self.flows_train = [np.asarray(f) for f in flows_tr]
        self.sites_train = jax_keyed(sown_tr)
        self.x = encode_input(to_torch(self.chunk), **ENCODE)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return Case(**CASES[request.param])


def port_sites(case):
    with torch.no_grad(), collect_sites(case.model) as sites:
        flows = case.model(case.x)["flow"]
    return flows, sites


def assert_sites_match(got, want):
    """Rates within RATE_TOL, membranes as the module docstring says."""
    assert list(got) and set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, key
        if "spike_rate" in key:
            assert abs(float(g) - float(w)) <= RATE_TOL, key
            continue
        # [steps, 3]: T, or the attention's temporal window
        assert w.shape in ((T, 3), (2, 3)), key
        np.testing.assert_array_equal(g[:, 2], w[:, 2], err_msg=key)
        scale = np.abs(w).max()
        assert np.abs(g[:, :2] - w[:, :2]).max() <= MEMBRANE_REL * scale, key


def assert_flows_match(got, want, dtype=torch.float64, tol=FLOW_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.double().numpy(), w, rtol=tol,
                                   atol=tol * np.abs(w).max())


def test_site_keys_are_jax_keys(case):
    _, sites = port_sites(case)
    assert set(sites) == set(case.sites)
    n = len(sites)
    assert sum("membrane" in k for k in sites) == n // 2
    # one attn_sn per MS attention block, as the energy join needs
    assert sum("attn/attn_sn/spike_rate" in k for k in sites) == (
        2 if case.ms else 0)


def test_spike_rates_and_membranes_match_jax(case):
    _, sites = port_sites(case)
    assert_sites_match(sites, case.sites)
    rates = [float(v) for k, v in case.sites.items() if "spike_rate" in k]
    # the check is not vacuous: most sites fire some spikes and not all
    assert sum(0.0 < r < 1.0 for r in rates) >= 0.8 * len(rates)


def test_collection_changes_no_flow(case):
    with torch.no_grad():
        plain = case.model(case.x)["flow"]
    collected, _ = port_sites(case)
    for a, b in zip(plain, collected):
        assert torch.equal(a, b)
    assert_flows_match(collected, case.flows)


def test_log_attention_maps_match_jax(case):
    with torch.no_grad():
        out = case.model(case.x, log=True)
        plain = case.model(case.x)["flow"]
    for a, b in zip(out["flow"], plain):
        assert torch.equal(a, b)
    assert len(out["attn"]) == len(case.attn) == 2
    assert any(np.abs(want).max() > 0 for want in case.attn)
    for got, want in zip(out["attn"], case.attn):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=FLOW_TOL,
                                   atol=FLOW_TOL * np.abs(want).max())


@pytest.mark.parametrize("batch_stats", [False, True])
def test_eval_step_collects_in_both_bn_modes(case, batch_stats):
    before = {k: v.clone() for k, v in case.model.state_dict().items()}
    step = make_eval_step(case.model, **ENCODE,
                          use_batch_stats=batch_stats,
                          collect_spike_rates=True)
    flows, sites = step(to_torch(case.chunk))
    want = case.sites_train if batch_stats else case.sites
    assert_sites_match(sites, want)
    assert list(sites) == list(want)   # in JAX's flatten order
    # the step returns float32 flows, as JAX's does
    assert_flows_match(flows,
                       case.flows_train if batch_stats else case.flows,
                       dtype=torch.float32, tol=STEP_FLOW_TOL)
    # the validation leaves the running statistics alone, and the
    # collection leaves no trace on the plain step
    after = case.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    plain = make_eval_step(case.model, **ENCODE,
                           use_batch_stats=batch_stats)(to_torch(case.chunk))
    assert all(torch.equal(a, b) for a, b in zip(plain, flows))
    case.model.eval()


def psn_model():
    """The tiny MS model with PSN and the init's weights, in eval."""
    swin = SwinConfig(input_size=(H, W), depths=(1, 1), num_heads=(2, 2),
                      out_indices=(0, 1), window_size=(2, 2, 2))
    return SpikingformerFlowNet(swin, SpikingConfig(num_steps=T,
                                                    neuron_type="psn"),
                                num_bins=T, base_num_channels=C0,
                                num_encoders=2).eval()


def test_fused_embed_refuses_collection():
    model = psn_model()
    with pytest.raises(ValueError, match="fused_embed collects no"):
        make_eval_step(model, fused_embed=True, num_steps=T,
                       collect_spike_rates=True)


def test_collections_do_not_nest_or_leak():
    model = psn_model()
    x = torch.rand(1, T, 2, H, W)
    with collect_sites(model):
        with pytest.raises(RuntimeError, match="already"):
            with collect_sites(model):
                pass
    with torch.no_grad(), collect_sites(model) as sites:
        model(x)
    # store_v_seq off: rates only; and nothing after the block
    assert sites and all("spike_rate" in k for k in sites)
    n = len(sites)
    with torch.no_grad():
        model(x)
    assert len(sites) == n


@pytest.mark.parametrize("affine", [False, True])
def test_psn_membrane_output_is_the_twins_potential(affine):
    """K2's CPU dispatch with ``return_v``: the spikes and the potential
    of ``psn_neuron(return_v=True)`` on the affine input; with a gradient
    to record it raises (the membrane output is forward only)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((T, 3, 5, 8)))
    w = torch.from_numpy(rng.standard_normal((T, T)))
    b = torch.from_numpy(rng.standard_normal((T, 1)))
    kw = (dict(scale=torch.from_numpy(rng.random(8) + 0.5),
               shift=torch.from_numpy(rng.standard_normal(8)))
          if affine else {})
    spikes, h = hopper_psn.fused_affine_psn(x, w, b, return_v=True, **kw)
    xa = x * kw["scale"] + kw["shift"] if affine else x
    want_s, want_h = psn_neuron(xa, w, b, return_v=True)
    assert torch.equal(spikes, want_s) and torch.equal(h, want_h)
    assert h.shape == x.shape and h.dtype == torch.float64
    assert torch.equal(hopper_psn.fused_affine_psn(x, w, b, **kw), spikes)
    with pytest.raises(NotImplementedError, match="forward only"):
        hopper_psn.affine_psn(x, w.requires_grad_(), b, return_v=True, **kw)
