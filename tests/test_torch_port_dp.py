"""PyTorch port vs the JAX package: data-parallel training.

Two ranks of the port (one gloo group, spawned once for the whole file,
``torch_port_dp_ranks.py``), each holding half of every global batch, take
the step of the global batch: their losses, parameters and BN running
statistics equal JAX's single-device step at that batch (which
``tests/test_multichip_equivalence.py`` holds equal to JAX's dp8 step).
The model is the tiny MS spikingformer of that file (PSN + BN) in float64
from one randomized state, SGD at lr 1 (momentum 0.9, JAX's SGD), so the
first update moves each parameter by its gradient; losses and grad norms to
1e-9 relative, every parameter and statistic to 1e-8 absolute after each
step, as ``tests/test_torch_port_train.py``. The cases: 3-step
trajectories at global batch 2 (one row a rank) and 4 (with the clip at 1
active), an events step (K3's plain twin on each rank's rows), ``num_acc``
2, the tiny STTFlowNet with BN under remat "dots" (collectives in the
recompute) against JAX's plain step, and the SNN's first global-batch-2
step under remat "dots" (the batch statistics' all-reduces and the swin
blocks' row gathers re-issued in the recompute) against JAX's plain step.
Drop path and the "Drop" augmentation draw the port's own random numbers,
so with them on the two ranks are held against one process of the port at
the same seed. A group of one is bit for bit no group. The shard arithmetic
is JAX's index for index. The ranks also run the batch-statistics eval
step, the trainer entry point and a SIGTERM delivered to one rank.
"""

import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models import ann_flownet as j_flownet
from sdformerflow_tpu.models.common import SpikingConfig as JSpikingConfig
from sdformerflow_tpu.models.common import SwinConfig as JSwinConfig
from sdformerflow_tpu.models.snn_flownet import (
    SpikingformerFlowNet as JSpikingformerFlowNet)
from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu.parallel import multihost as j_multihost
from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu.training import train_step as j_train_step
from sdformerflow_tpu_torch.parallel import mesh, multihost
from sdformerflow_tpu_torch.training.checkpoints import latest_epoch
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.training.train_loop import train

import torch_port_dp_ranks as R
from test_torch_port_events import _padded_batch
from test_torch_port_train import _Float64Jnp
from torch_port_harness import init_pair, randomize_tree
from torch_port_harness import one_torch_thread  # noqa: F401

WORLD = 2
STEP_CASES = ("b2", "b4", "events", "acc", "ann", "snn_remat")
# XLA's CPU backend at LLVM level 0: a quicker compile of the same program
QUICK_XLA = dict(xla_backend_optimization_level=0)


def _voxel_batches(n, batch, seed, size=(16, 16), bins=4):
    rng = np.random.default_rng(seed)
    shape = (batch, bins) + size
    return [dict(chunk=rng.standard_normal(shape) * (rng.random(shape) < 0.4),
                 label=3.0 * rng.standard_normal((batch, 2) + size),
                 mask=(rng.random((batch, 1) + size) > 0.2) * 1.0)
            for _ in range(n)]


def _events_batch():
    h, w = R.EVENTS["sensor"]
    bins = R.SNN_NET["num_bins"]
    ev = _padded_batch(R.EVENTS["n_max"], h, w, t_hi=4 * (bins - 1), seed=3,
                       dyadic=True)
    rng = np.random.default_rng(4)
    size = R.SNN_SWIN["input_size"]
    return dict(events=ev, label=3.0 * rng.standard_normal((2, 2) + size),
                mask=(rng.random((2, 1) + size) > 0.2) * 1.0)


def _pairs():
    """(JAX SNN, port SNN, variables), (JAX STT, port STT, variables), in
    float64 from seeded random draws."""
    jsnn = JSpikingformerFlowNet(
        swin=JSwinConfig(**R.SNN_SWIN, drop_path_rate=0.0),
        cfg=JSpikingConfig(**R.SNN_CFG), **R.SNN_NET)
    tsnn = R.snn_model()
    with jax.enable_x64(True):
        x = np.asarray(j_encode(jnp.zeros((1, 4, 16, 16))))
        vsnn = init_pair(jsnn, tsnn, x, seed=13)
        jstt = j_flownet.STTFlowNet(swin=JSwinConfig(**R.STT_SWIN),
                                    **R.STT_NET)
        tstt = R.stt_model()
        shapes = jax.eval_shape(lambda z: jstt.init(
            {"params": jax.random.PRNGKey(0)}, z, False),
            np.zeros((2, 4, 16, 24), np.float32))
        vstt = randomize_tree(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape), shapes), 22)
        tstt.double().load_state_dict(from_jax(vstt, tstt))
    return (jsnn, tsnn, vsnn), (jstt, tstt, vstt)


def _jax_steps(jmodel, tmodel, variables, batches, opt, num_acc=1,
               compiler_options=None, **step_kw):
    """JAX's single-device train step over the global batches: per step
    (loss, grad norm, state_dict in the port's names). ``compiler_options``
    go to XLA's compile of the step."""
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    state = j_train_step.TrainState.create(
        apply_fn=jmodel.apply, params=as_jax(variables["params"]),
        batch_stats=as_jax(variables["batch_stats"]),
        tx=j_optim.build_optimizer(**opt, num_acc=num_acc))
    step = j_train_step.make_train_step(donate=False, **step_kw)
    if compiler_options is not None:
        step = step.lower(state, as_jax(batches[0]), jax.random.PRNGKey(0)
                          ).compile(compiler_options=compiler_options)
    out = []
    for b in batches:
        state, m = step(state, as_jax(b), jax.random.PRNGKey(0))
        out.append((float(m["loss"]), float(m["grad_norm"]), from_jax(
            jax.tree_util.tree_map(np.asarray, {
                "params": state.params,
                "batch_stats": state.batch_stats}), tmodel)))
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The ranks' results, JAX's references and the one-process port run
    of the random-draw case. The ranks run while JAX compiles."""
    workdir = str(tmp_path_factory.mktemp("dp"))
    (jsnn, tsnn, vsnn), (jstt, tstt, vstt) = _pairs()
    job = dict(snn=tsnn.state_dict(), stt=tstt.state_dict(),
               b2=_voxel_batches(3, 2, seed=11),
               b4=_voxel_batches(3, 4, seed=12), events=[_events_batch()],
               acc=_voxel_batches(4, 2, seed=14),
               draws=_voxel_batches(2, 4, seed=15),
               ann=_voxel_batches(2, 2, seed=16, size=(16, 24)))
    torch.save(job, os.path.join(workdir, "job.pt"))
    four_dir = os.path.join(workdir, "four")
    os.makedirs(four_dir)
    torch.save(job, os.path.join(four_dir, "job.pt"))
    procs = R.spawn("train_cases", WORLD, workdir)
    four = R.spawn("four_ranks", 4, four_dir)
    try:
        snn = functools.partial(_jax_steps, jsnn, tsnn, vsnn)
        h, w = R.EVENTS["sensor"]
        cases = {
            "b2": lambda: snn(job["b2"], R.SGD),
            "b4": lambda: snn(job["b4"], dict(R.SGD, clip_grad=1.0)),
            "events": lambda: snn(job["events"], R.SGD,
                                  crop=R.SNN_SWIN["input_size"],
                                  voxelize=dict(num_bins=4, height=h,
                                                width=w)),
            "acc": lambda: snn(job["acc"], R.SGD, num_acc=2),
            "ann": lambda: _jax_steps(jstt, tstt, vstt, job["ann"], R.SGD,
                                      polarity=False, norm_input=True)}

        def compiled(case):
            # float64 is a per-thread setting of JAX's
            with jax.enable_x64(True):
                return cases[case]()
        with pytest.MonkeyPatch.context() as mp:
            # float64 flows and grad norm on the JAX side
            mp.setattr(j_train_step, "jnp", _Float64Jnp())
            mp.setattr(j_optim, "jnp", _Float64Jnp())
            # one compile a case, in parallel (XLA compiles off the GIL)
            with ThreadPoolExecutor(len(cases)) as pool:
                want = dict(zip(cases, pool.map(compiled, cases)))
        # JAX's remat step is its plain step (tests/test_train_step.py)
        want["snn_remat"] = want["b2"][:1]
        one_process = R.draws_run(job, None, 0, 1)
        other_seed = R.draws_run(job, None, 0, 1, seed=8)
        one_eval = R.batch_stats_eval(job, None, 0, 1)
    finally:
        try:
            got = R.join(procs, workdir)
        finally:
            got_four = R.join(four, four_dir)
    return dict(got=got, four=got_four, want=want, one_process=one_process,
                other_seed=other_seed, one_eval=one_eval, workdir=workdir)


def _close(got, want):
    for (gl, gn, gsd), (wl, wn, wsd) in zip(got, want, strict=True):
        assert np.isfinite(wl) and wn > 0
        np.testing.assert_allclose(gl, wl, rtol=1e-9)
        np.testing.assert_allclose(gn, wn, rtol=1e-9)
        assert set(gsd) == set(wsd)
        for k, v in gsd.items():
            np.testing.assert_allclose(v.numpy(), wsd[k].numpy(), rtol=0,
                                       atol=1e-8, err_msg=k)


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_ranks_equal_jax_single_device_step(dp, case):
    ranks = [r[case] for r in dp["got"]]
    assert [r["world"] for r in dp["got"]] == [WORLD] * WORLD
    for steps in ranks:
        _close(steps, dp["want"][case])
    # every rank holds the same state after every step, bit for bit
    for a, b in zip(*ranks):
        assert a[0] == b[0]
        assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    moved = [k for k, v in ranks[0][-1][2].items()
             if not torch.equal(v, dp["want"][case][0][2][k])]
    assert any("running_var" in k for k in moved)


def test_four_ranks_one_row_each_equal_jax_single_device_step(dp):
    """Global batch 4 at one row a rank over four ranks, where each swin
    block's refold mixes every rank's row: JAX's single-device step, and
    the random draws one process's."""
    four = dp["four"]
    assert [r["world"] for r in four] == [4] * 4
    for r in four:
        _close(r["b4"], dp["want"]["b4"])
        _close(r["draws"], dp["one_process"])
    for r in four[1:]:
        for a, b in zip(four[0]["b4"], r["b4"]):
            assert a[0] == b[0]
            assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def test_random_draws_equal_one_process(dp):
    """Drop path 0.3 and "Drop" draw at the global batch: two ranks train
    as one process does at the same seed (summation order aside)."""
    want = dp["one_process"]
    for r in dp["got"]:
        _close(r["draws"], want)
    # the draws matter: another seed's one-process run differs
    assert abs(dp["other_seed"][0][0] - want[0][0]) > 1e-6 * abs(want[0][0])


def test_batch_statistics_eval_takes_the_global_batch(dp):
    """``make_eval_step(use_batch_stats=True, group=...)``: each rank's
    flows are its rows of one process's eval of the whole batch."""
    want = dp["one_eval"]
    per = want.shape[0] // WORLD
    for r in dp["got"]:
        rows = want[r["rank"] * per:(r["rank"] + 1) * per]
        np.testing.assert_allclose(r["eval"].numpy(), rows.numpy(),
                                   rtol=1e-9, atol=1e-9 * float(
                                       want.abs().max()))


def test_group_of_one_is_no_group_bit_for_bit(dp):
    for r in dp["got"]:
        (alone,), (plain,) = r["one"]
        assert alone[0] == plain[0] and alone[1] == plain[1]
        assert all(torch.equal(alone[2][k], plain[2][k]) for k in plain[2])


def test_rank_processes_import_no_jax(dp):
    assert [r["foreign_modules"] for r in dp["got"]] == [[]] * WORLD


def test_trainer_under_two_ranks_and_sigterm_on_one(dp):
    """``train_dsec.main`` in the group: the ranks end on the same state,
    rank 0 alone writes each metric once. A SIGTERM delivered to rank 1
    alone stops both ranks at the same step, and rank 0 checkpoints."""
    main = [r["trainer"]["main"] for r in dp["got"]]
    assert [m["count"] for m in main] == [2, 2]
    assert all(torch.equal(main[0]["state"][k], main[1]["state"][k])
               for k in main[0]["state"])
    run_dir = os.path.join(dp["workdir"], "trainer")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        names = [json.loads(line)["name"] for line in f]
    assert names.count("train_loss") == 1
    assert names.count("valid_loss") == 1
    stop = [r["trainer"]["preempt"] for r in dp["got"]]
    assert stop[0]["count"] == stop[1]["count"]
    assert 1 <= stop[0]["count"] < 8
    assert all(torch.equal(stop[0]["state"][k], stop[1]["state"][k])
               for k in stop[0]["state"])
    ckpt = os.path.join(dp["workdir"], "preempt", "ckpt")
    assert latest_epoch(ckpt) == 0
    payload = torch.load(os.path.join(ckpt, "epoch_000000.pt"),
                         weights_only=True)
    assert payload["metrics"]["preempted"] == 1.0
    assert payload["step"] == stop[0]["count"]


@pytest.mark.parametrize("n,count", [(10, 2), (17, 4), (8, 8), (3, 4)])
def test_shard_arithmetic_equals_jax(n, count):
    for index in range(count):
        assert multihost.shard_indices(n, process_index=index,
                                       process_count=count) \
            == j_multihost.shard_indices(n, process_index=index,
                                         process_count=count)
        data = list(range(n))
        got = multihost.ProcessShardedDataset(data, process_index=index,
                                              process_count=count)
        want = j_multihost.ProcessShardedDataset(data, process_index=index,
                                                 process_count=count)
        assert [got[i] for i in range(len(got))] == \
            [want[i] for i in range(len(want))]
        for seed in (0, 5):
            got.reshard(seed)
            want.reshard(seed)
            assert len(got) == len(want) == n // count
            assert [got[i] for i in range(len(got))] == \
                [want[i] for i in range(len(want))]


def test_mesh_helpers_split_rows_and_share_replicas():
    devs = mesh.make_mesh(devices=["cpu", "cpu", "cpu"], n_data=2)
    assert devs == [torch.device("cpu")] * 2
    assert mesh.distinct(devs) == [torch.device("cpu")]
    batch = {"chunk": torch.arange(8.0).reshape(4, 2),
             "events": {"x": torch.arange(4.0)}}
    a, b = mesh.shard_batch(batch, devs)
    assert torch.equal(a["chunk"], batch["chunk"][:2])
    assert torch.equal(b["events"]["x"], torch.tensor([2.0, 3.0]))
    with pytest.raises(ValueError, match="divisible"):
        mesh.shard_batch(torch.zeros(3, 1), devs)
    model = torch.nn.Linear(2, 2)
    replicas = mesh.replicate(model, devs)
    assert list(replicas) == [torch.device("cpu")]
    assert replicas[torch.device("cpu")] is model
    with pytest.raises(ValueError, match="n_data"):
        mesh.make_mesh(n_data=3, devices=["cpu"])


def test_n_data_without_a_group_raises(tmp_path):
    from sdformerflow_tpu_torch.training.config import load_config
    config = load_config(R.TINY_CONFIG)
    config["loader"]["n_data"] = 2
    with pytest.raises(ValueError, match="one process per card"):
        train(config, list(range(4)), None, run_dir=str(tmp_path),
              device="cpu")
