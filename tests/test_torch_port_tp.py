"""PyTorch port vs the JAX package: tensor parallelism over a model axis.

Four ranks of the port (one gloo group, spawned once for the whole file,
``torch_port_dp_ranks.tp_cases``) take the steps of the tiny MS
spikingformer of ``tests/test_multichip_equivalence.py`` (PSN + BN, float64,
one randomized state) at global batch 2, as dp2 x tp2 and as dp1 x tp4:
``parallel/sharding_rules.py:shard_model`` at ``min_size`` 2^8 (JAX's
test), SGD at lr 1 with the clip at 1 active (so the norm summed over the
model group moves every parameter). Their losses, grad norms, parameters
and running statistics after each step equal JAX's single-device step at
that batch (which ``test_multichip_equivalence.py`` holds equal to JAX's
dp(4) x tp(2) step), to the tolerances of ``test_torch_port_dp.py``: 1e-9
relative, 1e-8 absolute. Drop path draws the port's own numbers, so with
it on the ranks are held against one process of the port at the same
seed. A tensor-parallel checkpoint (whole tensors) loads in one process and
a one-process one resumes on the ranks. The leaf choice equals JAX's
``infer_param_shardings`` name for name, for en4 and the STT at full width
(JAX's shapes from ``jax.eval_shape``).
"""

import os

import jax
import numpy as np
import pytest
import torch

from sdformerflow_tpu.models.registry import get_model as j_get_model
from sdformerflow_tpu.parallel.mesh import make_mesh as j_make_mesh
from sdformerflow_tpu.parallel.sharding_rules import (
    infer_param_shardings as j_infer_param_shardings)
from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu.training import train_step as j_train_step
from sdformerflow_tpu.training.config import build_configs as j_build_configs
from sdformerflow_tpu.training.config import load_config as j_load_config
from sdformerflow_tpu_torch.models.registry import get_model
from sdformerflow_tpu_torch.parallel import mesh, sharding_rules
from sdformerflow_tpu_torch.training import optim
from sdformerflow_tpu_torch.training.checkpoints import (restore_checkpoint,
                                                         save_checkpoint)
from sdformerflow_tpu_torch.training.config import (build_configs,
                                                    chunk_bins, load_config)
from sdformerflow_tpu_torch.training.from_jax import port_key
from sdformerflow_tpu_torch.training.train_step import make_train_step

import torch_port_dp_ranks as R
from test_torch_port_dp import (QUICK_XLA, _close, _jax_steps,
                                _voxel_batches)
from test_torch_port_train import _Float64Jnp
from torch_port_harness import init_pair
from torch_port_harness import one_torch_thread  # noqa: F401

WORLD = 4
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                       "configs")


def _snn_pair():
    from sdformerflow_tpu.models.common import SpikingConfig, SwinConfig
    from sdformerflow_tpu.models.snn_flownet import SpikingformerFlowNet
    from sdformerflow_tpu.ops.normalization import encode_input
    jsnn = SpikingformerFlowNet(swin=SwinConfig(**R.SNN_SWIN,
                                                drop_path_rate=0.0),
                                cfg=SpikingConfig(**R.SNN_CFG), **R.SNN_NET)
    tsnn = R.snn_model()
    with jax.enable_x64(True):
        x = np.asarray(encode_input(np.zeros((1, 4, 16, 16))))
        variables = init_pair(jsnn, tsnn, x, seed=13)
    return jsnn, tsnn, variables


def _one_process(job, batches, seed=None, drop_path_rate=0.0, **cfg):
    """The port's one-process step over ``batches`` from ``job``'s state:
    (per step (loss, grad norm, state_dict), model, optimizer, step)."""
    model = R._fresh(job, "snn", drop_path_rate=drop_path_rate, **cfg)
    opt = optim.build_optimizer(model.named_parameters(), **R.TP_OPT)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    step = make_train_step(model, opt, generator=gen)
    out = []
    for b in batches:
        m = step(R.rows(b, 0, 1))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out, model, opt, step


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The ranks' results, JAX's single-device steps and the one-process
    port runs; the ranks run while JAX compiles."""
    workdir = str(tmp_path_factory.mktemp("tp"))
    jsnn, tsnn, variables = _snn_pair()
    job = dict(snn=tsnn.state_dict(), tp=_voxel_batches(2, 2, seed=31))
    # the one-process checkpoint the ranks resume: after the first step
    _, model, opt, step = _one_process(job, job["tp"][:1])
    save_checkpoint(os.path.join(workdir, "one"), model, opt, 0, 1)
    m = step(R.rows(job["tp"][1], 0, 1))
    resumed = [(float(m["loss"]), float(m["grad_norm"]),
                {k: v.clone() for k, v in model.state_dict().items()})]
    torch.save(job, os.path.join(workdir, "job.pt"))
    procs = R.spawn("tp_cases", WORLD, workdir)
    try:
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            # float64 flows and grad norm on the JAX side
            mp.setattr(j_train_step, "jnp", _Float64Jnp())
            mp.setattr(j_optim, "jnp", _Float64Jnp())
            want = _jax_steps(jsnn, tsnn, variables, job["tp"], R.TP_OPT,
                              compiler_options=QUICK_XLA)
        plain = _one_process(job, job["tp"])
        draws = _one_process(job, job["tp"], seed=7, drop_path_rate=0.3)[0]
        s2d = _one_process(job, job["tp"][:1], s2d_train=True)[0]
    finally:
        got = R.join(procs, workdir)
    return dict(got=got, want=want, plain=plain, resumed=resumed,
                draws=draws, s2d=s2d, job=job, workdir=workdir)


@pytest.mark.parametrize("layout", ["dp2_tp2", "dp1_tp4"])
def test_tp_steps_equal_jax_single_device_step(tp, layout):
    n_model = int(layout.split("tp")[1])
    ranks = [r[layout] for r in tp["got"]]
    assert [r["world"] for r in tp["got"]] == [WORLD] * WORLD
    for r in tp["got"]:
        assert r[layout + "_mesh"] == divmod(r["rank"], n_model)
    for steps, local, flat in ranks:
        _close(steps, tp["want"])
    # every rank gathers the same state after every step, bit for bit
    for a, b in zip(ranks[0][0], ranks[-1][0]):
        assert a[0] == b[0] and a[1] == b[1]
        assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    # each rank holds its slice of each sharded weight, and the flat
    # optimizer state covers what it holds
    model = R.snn_model()
    dims = sharding_rules.infer_param_shardings(model, n_model,
                                                R.TP_MIN_SIZE)
    sharded = [n for n, d in dims.items() if d is not None]
    assert len(sharded) >= 10
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    _, local, flat = ranks[0]
    for n, shape in whole.items():
        want = list(shape)
        if dims[n] is not None:
            want[dims[n]] //= n_model
        assert list(local[n]) == want, n
    trained = tp["plain"][2].names
    assert flat == sum(int(np.prod(local[n])) for n in trained)
    assert flat < sum(int(np.prod(whole[n])) for n in trained)


@pytest.mark.parametrize("case", ["draws", "s2d_train"])
def test_tp_equals_one_process(tp, case):
    """dp2 x tp2 trains as one process of the port does: with drop path 0.3
    from one seed on every rank (the model ranks of a data slice draw the
    same masks), and with the ``s2d_train`` embed, whose block-space head
    (``[8, 2, 3, 3]``, sharded at ``min_size`` 2^6) gathers its channels in
    block order."""
    if case == "s2d_train":
        model = R.snn_model(s2d_train=True)
        dims = sharding_rules.infer_param_shardings(model, 2,
                                                    R.TP_S2D_MIN_SIZE)
        head = "sttmultires_unet.encoders.patch_embed.head.conv.weight"
        assert dims[head] == 0
    want = tp["draws"] if case == "draws" else tp["s2d"]
    for r in tp["got"]:
        _close(r[case][0], want)


def test_tp_checkpoint_loads_across_layouts(tp):
    """The dp2 x tp2 checkpoint (whole tensors) loads in one process: the
    ranks' state, and the optimizer state one process has after the same
    steps. A one-process checkpoint resumes on the ranks: their next step
    is one process's."""
    plain_steps, _, plain_opt, _ = tp["plain"]
    model = R._fresh(tp["job"], "snn")
    opt = optim.build_optimizer(model.named_parameters(), **R.TP_OPT)
    restore_checkpoint(os.path.join(tp["workdir"], "dp2_tp2"), model, opt)
    last = tp["got"][0]["dp2_tp2"][0][-1][2]
    assert all(torch.equal(v, last[k]) for k, v in model.state_dict().items())
    assert opt.names == plain_opt.names and int(opt.count) == 2
    np.testing.assert_allclose(opt.trace.numpy(), plain_opt.trace.numpy(),
                               rtol=0, atol=1e-8)
    for r in tp["got"]:
        _close(r["resumed"][0], tp["resumed"])


def test_tp_rank_processes_import_no_jax(tp):
    assert [r["foreign_modules"] for r in tp["got"]] == [[]] * WORLD


def test_make_mesh_grid_is_jax_layout():
    devs = [torch.device("cuda", i) for i in range(8)]
    for n_data, n_model in ((4, 2), (2, 4), (1, 8)):
        grid = mesh.make_grid(n_data, n_model, devs)
        want = j_make_mesh(n_data=n_data, n_model=n_model).devices
        assert [[d.index for d in row] for row in grid] \
            == [[d.id for d in row] for row in want]
    assert mesh.make_grid(n_model=2, devices=devs)[-1] == devs[6:]
    assert mesh.make_mesh(3, devs) == devs[:3]
    with pytest.raises(ValueError, match="n_model"):
        mesh.make_grid(3, 4, devs)


@pytest.mark.parametrize("config", ["train_dsec_sdformerflow_en4.yaml",
                                    "train_dsec_stt_voxel.yaml"])
def test_leaf_choice_equals_jax(config):
    """At full width and the default ``min_size``, for 2 and 4 model ranks:
    the port shards the leaves JAX shards, name for name through
    ``from_jax``'s names, and its slice of each is the image of JAX's
    trailing-axis slice under the leaf's layout."""
    path = os.path.join(CONFIGS, config)
    cfg = load_config(path)
    bins = chunk_bins(cfg)
    with torch.device("meta"):   # shapes only
        tm = get_model(cfg["model"]["name"], *build_configs(cfg),
                       input_bins=bins)
    jm = j_get_model(cfg["model"]["name"], *j_build_configs(
        j_load_config(path)))
    h, w = cfg["loader"]["crop"]
    shape = ((1, bins, 2, h, w) if "Spiking" in cfg["model"]["name"]
             else (1, bins, h, w))
    params = jax.eval_shape(lambda z: jm.init(
        {"params": jax.random.PRNGKey(0)}, z, False),
        np.zeros(shape, np.float32))["params"]
    modules = dict(tm.named_modules())
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    for n_model in (2, 4):
        specs = j_infer_param_shardings(params, j_make_mesh(
            n_data=8 // n_model, n_model=n_model))
        got = sharding_rules.infer_param_shardings(tm, n_model)
        want, layouts = {}, {}
        for (path_, leaf), spec in zip(leaves, jax.tree_util.tree_leaves(
                specs)):
            keys = tuple(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path_)
            name, layouts[name] = port_key(modules, "params", keys)
            want[name] = (leaf.shape, any(a is not None for a in spec.spec))
        assert set(got) == set(want)
        assert {n for n, d in got.items() if d is not None} \
            == {n for n, (_, s) in want.items() if s}
        for name, dim in got.items():
            if dim is None:
                continue
            # a probe of the leaf's rank, its trailing extent 2 a rank
            probe = tuple(range(3, 2 + len(want[name][0]))) + (2 * n_model,)
            a = np.arange(np.prod(probe)).reshape(probe)
            layout = layouts[name] or (lambda t: t)
            port = sharding_rules._local(torch.from_numpy(layout(a)), dim,
                                         n_model, 1)
            np.testing.assert_array_equal(
                port.numpy(), layout(a[..., 2:4]), err_msg=name)
        assert sum(d is not None for d in got.values()) > 20
