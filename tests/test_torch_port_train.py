"""PyTorch port vs the JAX package: the train step's trajectory, and the
port's trainer entry point.

Three steps of the port's ``make_train_step`` against JAX
``make_train_step`` from one randomized float64 state (drop-path off on
both sides: the two frameworks' random streams cannot be aligned), AdamW at
lr 1e-3 with the multistep schedule halving it at the third update, clip at
100. After each step the loss and the grad norm agree to 1e-9 relative,
and every parameter and BN statistic to 1e-8 absolute: an update moves a
parameter by up to 1e-3, so a wrong gradient shows. Adam's eps is 1e-6 on
both sides here (the default 1e-8 is held in
``test_torch_port_train_ops.py``): with random weights some gradients are
float64 noise (~1e-13), and below eps Adam turns a gradient g into an
update of lr * g / eps, so eps 1e-8 would amplify that noise 1e5-fold and
eps 1e-6 only 1e3-fold. The JAX step casts its
flows (``train_step.py:160``) and its reported grad norm (``optim.py:73``)
to float32 even under x64; the fixture keeps them float64 so that the
comparison is a float64 one. One events-path step (voxelize on the device,
center crop, labels cropped) is checked the same way, on events whose grids
are exact.
"""

import functools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu.training import train_step as j_train_step
from sdformerflow_tpu_torch import train_dsec
from sdformerflow_tpu_torch.data.dsec import SyntheticEventFlowDataset
from sdformerflow_tpu_torch.training import optim
from sdformerflow_tpu_torch.training.checkpoints import latest_epoch
from sdformerflow_tpu_torch.training.config import load_config
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.training.train_loop import train
from sdformerflow_tpu_torch.training.train_step import (make_eval_step,
                                                        make_train_step)

from test_torch_port_events import _padded_batch
from test_torch_port_model import GEOMETRIES
from torch_port_harness import flownet_pair, init_pair, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

OPT = dict(name="AdamW", lr=1e-3, weight_decay=0.01, scheduler="multistep",
           milestones=[1], steps_per_epoch=2, clip_grad=100.0)
EPS = 1e-6
TINY_CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                           "test_tiny_snn.yaml")


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` meaning float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture
def jax_keeps_float64(monkeypatch):
    """float64 flows and grad norm on the JAX side, and Adam's eps EPS."""
    monkeypatch.setattr(j_train_step, "jnp", _Float64Jnp())
    monkeypatch.setattr(j_optim, "jnp", _Float64Jnp())
    monkeypatch.setattr(optax, "adamw", functools.partial(optax.adamw,
                                                          eps=EPS))


def _voxel_batches(geo, n, batch, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, geo["num_bins"]) + geo["size"]
    return [dict(chunk=rng.standard_normal(shape) * (rng.random(shape) < 0.4),
                 label=3.0 * rng.standard_normal((batch, 2) + geo["size"]),
                 mask=(rng.random((batch, 1) + geo["size"]) > 0.2) * 1.0)
            for _ in range(n)]


def _trajectories(geo, batches, seed, **step_kw):
    """(JAX, port) per step: (loss, grad norm, state_dict after it)."""
    jmodel, tmodel = flownet_pair(**geo, drop_path_rate=0.0)
    with jax.enable_x64(True):
        x_enc = np.asarray(j_encode(jnp.zeros((1, geo["num_bins"])
                                              + geo["size"])))
        variables = init_pair(jmodel, tmodel, x_enc, seed)
        as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
        state = j_train_step.TrainState.create(
            apply_fn=jmodel.apply, params=as_jax(variables["params"]),
            batch_stats=as_jax(variables["batch_stats"]),
            tx=j_optim.build_optimizer(**OPT))
        step = j_train_step.make_train_step(donate=False, **step_kw)
        want = []
        for b in batches:
            state, m = step(state, as_jax(b), jax.random.PRNGKey(0))
            sd = from_jax(jax.tree_util.tree_map(np.asarray, {
                "params": state.params, "batch_stats": state.batch_stats}),
                tmodel)
            want.append((float(m["loss"]), float(m["grad_norm"]), sd))
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    opt = optim.build_optimizer(tmodel.named_parameters(), **OPT)
    opt.eps = EPS
    tstep = make_train_step(tmodel, opt, **step_kw)
    got = []
    for b in batches:
        m = tstep(jax.tree_util.tree_map(to_torch, b))
        got.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: v.clone() for k, v in tmodel.state_dict().items()}))
    return want, got, start, opt


def _check(want, got, start):
    for (wl, wn, wsd), (gl, gn, gsd) in zip(want, got):
        assert np.isfinite(wl) and wn > 0
        np.testing.assert_allclose(gl, wl, rtol=1e-9)
        np.testing.assert_allclose(gn, wn, rtol=1e-9)
        assert set(gsd) == set(wsd)
        for k, v in gsd.items():
            np.testing.assert_allclose(v.numpy(), wsd[k].numpy(), rtol=0,
                                       atol=1e-8, err_msg=k)
    moved = [k for k in start if not torch.equal(start[k], got[-1][2][k])]
    assert any("running_var" in k for k in moved)
    assert any(k.endswith("sn.weight") for k in moved)
    assert not any(k.startswith(("attn_sn", ".attn_sn")) or ".attn_sn." in k
                   for k in moved)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_train_trajectory_matches_jax_f64(name, jax_keeps_float64):
    geo = GEOMETRIES[name]
    batch = 2 if name == "tiny" else 1
    want, got, start, opt = _trajectories(geo, _voxel_batches(geo, 3, batch,
                                                              seed=11),
                                          seed=13)
    _check(want, got, start)
    assert int(opt.count) == 3 and int(opt.notfinite_count) == 0


def test_events_train_step_matches_jax_f64(jax_keeps_float64):
    geo = GEOMETRIES["tiny"]
    sensor, bins = (30, 40), geo["num_bins"]
    ev = _padded_batch(900, *sensor, t_hi=4 * (bins - 1), seed=3,
                       dyadic=True)
    rng = np.random.default_rng(4)
    batch = dict(events=ev,
                 label=3.0 * rng.standard_normal((2, 2) + geo["size"]),
                 mask=(rng.random((2, 1) + geo["size"]) > 0.2) * 1.0)
    want, got, start, _ = _trajectories(
        geo, [batch], seed=5, crop=geo["size"],
        voxelize=dict(num_bins=bins, height=sensor[0], width=sensor[1]))
    _check(want, got, start)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_entry_runs_and_resumes_on_cpu(tmp_path):
    run_dir = str(tmp_path / "run")
    args = ["--config", TINY_CONFIG, "--synthetic", "--device", "cpu",
            "--max_steps", "2", "--run_dir", run_dir]
    model, opt = train_dsec.main(args)
    assert int(opt.count) == 2
    recs = _metrics(run_dir)
    names = {r["name"] for r in recs}
    assert {"train_loss", "valid_loss", "epoch_time_s"} <= names
    assert all(np.isfinite(r["value"]) for r in recs)
    assert latest_epoch(os.path.join(run_dir, "ckpt")) == 0
    with open(os.path.join(run_dir, "config.json")) as f:
        assert json.load(f)["model"]["name"] == "MS_SpikingformerFlowNet_en4"
    # --resume restores the epoch-0 state and continues at epoch 1
    model2, opt2 = train_dsec.main(args + ["--resume"])
    assert int(opt2.count) == 4
    assert latest_epoch(os.path.join(run_dir, "ckpt")) == 1
    assert [r["step"] for r in _metrics(run_dir)
            if r["name"] == "train_loss"] == [0, 1]
    # without --synthetic it reads the DSEC tree at data.path
    with pytest.raises(FileNotFoundError, match="sequence_lists"):
        train_dsec.main(["--config", TINY_CONFIG, "--device", "cpu"])


class _PreemptingDataset(SyntheticEventFlowDataset):
    """Sends this process SIGTERM when item ``at`` is read."""

    def __init__(self, at, **kw):
        super().__init__(**kw)
        self.at = at

    def __getitem__(self, idx):
        if idx == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return super().__getitem__(idx)


def test_sigterm_checkpoints_and_resume_continues(tmp_path):
    config = load_config(TINY_CONFIG)            # batch 2
    run_dir = str(tmp_path / "run")
    kw = dict(num_samples=8, num_bins=10, height=64, width=96)
    ds = _PreemptingDataset(at=2, **kw)
    previous = signal.getsignal(signal.SIGTERM)
    _, opt = train(config, ds, None, run_dir=run_dir, device="cpu")
    assert signal.getsignal(signal.SIGTERM) == previous
    steps = int(opt.count)
    assert 1 <= steps < 4          # stopped inside epoch 0
    recs = _metrics(run_dir)
    assert [r["value"] for r in recs if r["name"] == "preempted_at_epoch"] \
        == [0.0]
    assert latest_epoch(os.path.join(run_dir, "ckpt")) == 0
    _, opt2 = train(config, SyntheticEventFlowDataset(**kw), None,
                    run_dir=run_dir, resume=True, device="cpu")
    assert int(opt2.count) == steps + 4   # all of epoch 1


def test_batch_stats_eval_step_matches_jax_f64():
    """Validation at batch 1 (``use_batch_stats=True``): batch statistics,
    the running statistics left as they were, drop-path off on both
    sides."""
    geo = GEOMETRIES["tiny"]
    jmodel, tmodel = flownet_pair(**geo, drop_path_rate=0.0)
    chunk = _voxel_batches(geo, 1, 1, seed=21)[0]["chunk"]
    with jax.enable_x64(True):
        x_enc = np.asarray(j_encode(jnp.asarray(chunk)))
        variables = init_pair(jmodel, tmodel, x_enc, seed=23)
        state = j_train_step.TrainState(
            step=0, params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=(),
            apply_fn=jmodel.apply, tx=None)
        want = j_train_step.make_eval_step(use_batch_stats=True)(
            state, jnp.asarray(chunk))
        want_running = j_train_step.make_eval_step()(state, jnp.asarray(chunk))
    stats = {k: v.clone() for k, v in tmodel.state_dict().items()
             if "running" in k}
    got = make_eval_step(tmodel, use_batch_stats=True,
                         compute_dtype=torch.float64)(to_torch(chunk))
    assert all(torch.equal(v, tmodel.state_dict()[k])
               for k, v in stats.items())
    for g, w, r in zip(got, want, want_running):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0, atol=1e-12)
        assert not np.allclose(w, np.asarray(r))  # not the running stats
