"""PyTorch port vs the JAX package: rematerialization of the SNN train step.

The tiny MS spikingformer of ``torch_port_dp_ranks.snn_model`` (PSN + BN,
the model of ``tests/test_multichip_equivalence.py``) in float64 from one
randomized state, SGD at lr 1. One parametrised test holds:

- for each policy, a 2-step trajectory of the port's step under
  ``remat=policy`` against JAX's step with the same ``remat``: losses and
  grad norms to 1e-9 relative, every parameter and running statistic to
  1e-8 absolute (the tolerances of ``test_torch_port_train.py``);
- for each policy, the port's remat step against its own plain step with
  drop path on (rate 0.5, one generator seed), within 1e-12 relative, the
  generator left where the plain step leaves it;
- a recompute leaves the running statistics as they are: BNTT's per-step
  norms (which a recompute runs again) take one update a step;
- the SEW SpikingformerFlowNet, the ``s2d_train`` embed (its block-space
  head inside the embed's band) and bf16 compute under remat equal their
  plain steps;
- the neuron telemetry records each site once and the stages' attention
  maps (keyword arguments through a checkpointed block) are the plain
  forward's;
- the trainer runs ``configs/test_tiny_snn.yaml`` with ``optimizer.remat:
  dots`` (in the test's copy of the config).
"""

import contextlib
import copy
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import yaml

from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu.training import train_step as j_train_step
from sdformerflow_tpu_torch import train_dsec
from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
from sdformerflow_tpu_torch.models.registry import randomize_
from sdformerflow_tpu_torch.models.snn_flownet import SpikingformerFlowNet
from sdformerflow_tpu_torch.models.spiking_layers import (TorchBatchNorm,
                                                          collect_sites)
from sdformerflow_tpu_torch.training import optim
from sdformerflow_tpu_torch.training.remat import Remat, remat_blocks
from sdformerflow_tpu_torch.training import train_step
from sdformerflow_tpu_torch.training.train_step import make_train_step

import torch_port_dp_ranks as R
from test_torch_port_dp import (QUICK_XLA, _close, _jax_steps,
                                _voxel_batches)
from test_torch_port_tp import _snn_pair
from test_torch_port_train import _Float64Jnp
from torch_port_harness import one_torch_thread  # noqa: F401

POLICIES = ("dots", "dots_no_batch", "all")
CASES = (POLICIES + tuple(f"drop_path_{p}" for p in POLICIES)
         + ("running_stats", "sew", "s2d_train", "bf16", "telemetry",
            "trainer"))


@pytest.fixture(scope="module")
def jax_remat():
    """JAX's remat steps (one compile a policy) and the port's, from one
    randomized state over the same batches; the port's steps run in a
    thread while JAX compiles."""
    jsnn, tsnn, variables = _snn_pair()
    batches = _voxel_batches(2, 2, seed=41)
    job = dict(snn=tsnn.state_dict())
    with ThreadPoolExecutor(1) as pool:
        got = pool.submit(lambda: {
            p: R.run_steps(R._fresh(job, "snn"), batches, group=None,
                           remat=p) for p in POLICIES})
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(j_train_step, "jnp", _Float64Jnp())
            mp.setattr(j_optim, "jnp", _Float64Jnp())
            want = {p: _jax_steps(jsnn, tsnn, variables, batches, R.SGD,
                                  compiler_options=QUICK_XLA, remat=p)
                    for p in POLICIES}
        return want, got.result()


def _random(model, seed=23):
    randomize_(model.double(), torch.Generator().manual_seed(seed))
    return model


def _steps(model, batches, remat, seed=5, **kw):
    """(losses, state_dict, generator state) of the port's step over
    ``batches`` with drop path from a generator seeded ``seed``."""
    opt = optim.build_optimizer(model.named_parameters(), **R.SGD)
    gen = torch.Generator().manual_seed(seed)
    step = make_train_step(model, opt, remat=remat, generator=gen, **kw)
    losses = [float(step(R.rows(b, 0, 1))["loss"]) for b in batches]
    return losses, model.state_dict(), gen.get_state()


def _remat_equals_plain(model, policy="dots", **kw):
    batches = _voxel_batches(2, 2, seed=43)
    plain = _steps(copy.deepcopy(model), batches, None, **kw)
    remat = _steps(copy.deepcopy(model), batches, policy, **kw)
    np.testing.assert_allclose(remat[0], plain[0], rtol=1e-12)
    assert torch.equal(remat[2], plain[2])
    for k, v in plain[1].items():
        np.testing.assert_allclose(remat[1][k].numpy(), v.numpy(),
                                   rtol=1e-12, atol=1e-12 * float(
                                       v.abs().max()), err_msg=k)
    return plain


def _sew_model():
    swin = dict(R.SNN_SWIN, patch_embed_type="Spiking_PatchEmbed_Conv_sfn")
    return SpikingformerFlowNet(SwinConfig(**swin, drop_path_rate=0.5),
                                SpikingConfig(**R.SNN_CFG),
                                **dict(R.SNN_NET, ms=False))


def _bntt_model():
    return SpikingformerFlowNet(
        SwinConfig(**R.SNN_SWIN), SpikingConfig(**dict(
            R.SNN_CFG, spike_norm="BNTT")), **R.SNN_NET)


def _trainer(tmp_path, name, remat):
    config = yaml.safe_load(open(R.TINY_CONFIG))
    config["optimizer"]["remat"] = remat
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(config))
    model, opt = train_dsec.main(["--config", str(path), "--synthetic",
                                  "--device", "cpu", "--max_steps", "2",
                                  "--run_dir", str(tmp_path / name)])
    return model, opt


@pytest.mark.parametrize("case", CASES)
def test_snn_remat(case, request, tmp_path):
    if case in POLICIES:
        want, got = request.getfixturevalue("jax_remat")
        _close(got[case], want[case])
        return
    if case.startswith("drop_path_"):
        model = _random(R.snn_model(drop_path_rate=0.5))
        plain = _remat_equals_plain(model, case[len("drop_path_"):])
        if case == "drop_path_dots":
            # the masks matter: another seed moves the parameters elsewhere
            other = _steps(copy.deepcopy(model),
                           _voxel_batches(2, 2, seed=43), None, seed=6)
            assert any(not torch.allclose(other[1][k], v, rtol=1e-6)
                       for k, v in plain[1].items())
        return
    if case == "running_stats":
        model = _random(_bntt_model())
        calls = {"n": 0}
        batch_stats = TorchBatchNorm._batch_stats

        def counted(self, xf):
            calls["n"] += self.update_running_stats
            return batch_stats(self, xf)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TorchBatchNorm, "_batch_stats", counted)
            plain = _remat_equals_plain(model, "all")
        n_norms = sum(isinstance(m, TorchBatchNorm) for m in model.modules())
        assert n_norms > 10
        # the two plain and the two remat steps: one update a norm a step
        assert calls["n"] == 4 * n_norms
        return
    if case == "sew":
        _remat_equals_plain(_random(_sew_model()))
        return
    if case == "bf16":
        # bf16 compute on float64 master parameters
        _remat_equals_plain(_random(R.snn_model(drop_path_rate=0.5)),
                            compute_dtype=torch.bfloat16)
        return
    if case == "s2d_train":
        model = _random(SpikingformerFlowNet(
            SwinConfig(**R.SNN_SWIN, drop_path_rate=0.5),
            SpikingConfig(**R.SNN_CFG, s2d_train=True), **R.SNN_NET))
        embed = model.sttmultires_unet.encoders.patch_embed
        assert (embed, "band") in remat_blocks(model)
        _remat_equals_plain(model)
        return
    if case == "telemetry":
        model = _random(R.snn_model())
        x = torch.from_numpy(_voxel_batches(1, 2, seed=44)[0]["chunk"])
        x = x[:, :, None].expand(-1, -1, 2, -1, -1).contiguous()

        def run(m, remat):
            with collect_sites(m) as sites, (
                    Remat(m, remat) if remat else contextlib.nullcontext()):
                out = m.train()(x, log=True)
            sum(f.sum() for f in out["flow"]).backward()
            grads = {n: p.grad for n, p in m.named_parameters()
                     if p.grad is not None}
            return sites, out["attn"], grads
        want = run(copy.deepcopy(model), None)
        got = run(copy.deepcopy(model), "all")
        # each site's calls once (the last block's attention runs twice
        # with log=True, in both), at the plain forward's rates
        assert list(got[0]) == list(want[0])
        assert any(k.endswith("attn_sn/spike_rate/[1]") for k in got[0])
        assert all(torch.equal(v, want[0][k]) for k, v in got[0].items())
        for a, b in zip(got[1], want[1], strict=True):
            assert torch.equal(a, b)
        assert set(got[2]) == set(want[2])
        for k, g in want[2].items():
            np.testing.assert_allclose(got[2][k].numpy(), g.numpy(),
                                       rtol=1e-12, atol=1e-12 * float(
                                           g.abs().max()), err_msg=k)
        return
    assert case == "trainer"
    built = []

    def counted(*args, **kw):
        built.append(args[1])
        return Remat(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_step, "Remat", counted)
        model, opt = _trainer(tmp_path, "remat", "dots")
    assert built == ["dots"] and int(opt.count) == 2
    with open(tmp_path / "remat" / "metrics.jsonl") as f:
        losses = [r["value"] for r in map(json.loads, f)
                  if r["name"] == "train_loss"]
    assert losses and np.isfinite(losses).all()
    assert all(torch.isfinite(v).all() for v in model.state_dict().values()
               if v.is_floating_point())
