"""The ranks of the data-parallel tests (tests/test_torch_port_dp*.py).

:func:`spawn` starts R processes that join one gloo group through a
``file://`` rendezvous and run a function of this module; each writes what
it returns to ``rank<r>.pt`` in the work directory, which
:func:`join` reads back. The ranks import this module, torch and the port,
never jax nor the JAX package (each result records what it finds in
``sys.modules``). The models and cases are defined here so that the test
files build the JAX twins from the same geometry.
"""

from __future__ import annotations

import os
import signal
import sys
import time
import traceback

import numpy as np
import torch

# the tiny MS spikingformer of tests/test_multichip_equivalence.py:28-40
SNN_SWIN = dict(arc_type="swinv1",
                patch_embed_type="MS_PED_Spiking_PatchEmbed_Conv_sfn",
                input_size=(16, 16), patch_size=(1, 1, 2, 2), depths=(1, 1),
                num_heads=(2, 2), out_indices=(0, 1), window_size=(2, 2, 2),
                qk_scale=0.125, mlp_ratio=4.0)
SNN_CFG = dict(num_steps=4, v_th=0.1, v_reset=None, neuron_type="psn",
               spike_norm="BN")
SNN_NET = dict(num_bins=4, base_num_channels=16, num_encoders=2,
               use_upsample_conv=False, ms=True)
# the tiny STTFlowNet of tests/test_torch_port_ann.py, with BN
STT_SWIN = dict(arc_type="swinv2", patch_embed_type="PatchEmbedLocal",
                input_size=(16, 24), patch_size=(2, 2, 2), depths=(1, 1, 1),
                num_heads=(2, 2, 4), out_indices=(0, 1, 2),
                window_size=(2, 3, 3), pretrained_window_size=(0, 0, 0),
                mlp_ratio=2.0, qk_scale=None, drop_path_rate=0.0)
STT_NET = dict(num_bins=4, base_num_channels=8, num_encoders=3,
               norm_input=True, norm="BN")
# SGD at lr 1: the first update moves each parameter by its gradient
SGD = dict(name="SGD", lr=1.0, scheduler="constant", steps_per_epoch=1,
           clip_grad=None)
EVENTS = dict(sensor=(24, 24), n_max=700)
TINY_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "configs", "test_tiny_snn.yaml")
RANK_TIMEOUT_S = 150


def snn_model(drop_path_rate=0.0, **cfg):
    """The tiny MS spikingformer; ``cfg`` overrides SpikingConfig fields
    (``s2d_train``)."""
    from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
    from sdformerflow_tpu_torch.models.snn_flownet import SpikingformerFlowNet
    return SpikingformerFlowNet(
        SwinConfig(**SNN_SWIN, drop_path_rate=drop_path_rate),
        SpikingConfig(**SNN_CFG, **cfg), **SNN_NET)


def stt_model():
    from sdformerflow_tpu_torch.models.ann_flownet import STTFlowNet
    from sdformerflow_tpu_torch.models.common import SwinConfig
    return STTFlowNet(SwinConfig(**STT_SWIN), **STT_NET, input_bins=4)


# -------------------------------------------------------------- the rig

def _rank_main(fn_name, rank, world, workdir):
    from sdformerflow_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    out = os.path.join(workdir, f"rank{rank}.pt")
    try:
        multihost.initialize(backend="gloo",
                             init_method=f"file://{workdir}/rendezvous",
                             world_size=world, rank=rank, timeout_s=120)
        result = globals()[fn_name](rank, world, workdir)
        result["foreign_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                   "sdformerflow_tpu"))
        torch.save(result, out + ".tmp")
        os.replace(out + ".tmp", out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        multihost.leave()


def spawn(fn_name: str, world: int, workdir: str) -> list:
    """Start ``world`` ranks running ``fn_name(rank, world, workdir)`` (a
    function of this module) in one gloo group."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn_name, r, world,
                                                  str(workdir)),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs: list, workdir: str, timeout: float = RANK_TIMEOUT_S) -> list:
    """Wait for the ranks (killing them after ``timeout`` seconds) and
    return what each returned; a failed rank raises with its traceback."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errs = []
    for r, p in enumerate(procs):
        err = os.path.join(str(workdir), f"rank{r}.pt.err")
        if os.path.exists(err):
            with open(err) as f:
                errs.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errs.append(f"rank {r}: exit code {p.exitcode}")
    if errs:
        raise RuntimeError("\n".join(errs))
    return [torch.load(os.path.join(str(workdir), f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


# ------------------------------------------------------------- the steps

def rows(batch, rank, world):
    """This rank's rows of a global batch (nested dicts of arrays), as
    tensors: the ranks' rows in rank order are the global batch."""
    if isinstance(batch, dict):
        return {k: rows(v, rank, world) for k, v in batch.items()}
    t = torch.as_tensor(np.asarray(batch))
    per = t.shape[0] // world
    return t[rank * per:(rank + 1) * per]


def run_steps(model, batches, *, group, rank=0, world=1, opt=SGD,
              num_acc=1, augment=None, seed=None, **step_kw):
    """The port's train step over ``batches`` (global batches; this rank
    takes its rows), from ``model``'s state: per step (loss, grad norm,
    state_dict after it)."""
    from sdformerflow_tpu_torch.training import optim
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    opt = optim.build_optimizer(model.named_parameters(), **opt,
                                num_acc=num_acc)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    step = make_train_step(model, opt, group=group, generator=gen, **step_kw)
    aug_gen = None if seed is None else torch.Generator().manual_seed(seed + 1)
    out = []
    for b in batches:
        b = rows(b, rank, world)
        if augment is not None:
            b = dict(zip(("chunk", "label", "mask"),
                         augment(aug_gen, b["chunk"], b["label"], b["mask"])))
        m = step(b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out


def _fresh(job, key, **kw):
    model = (stt_model() if key == "stt" else snn_model(**kw)).double()
    model.load_state_dict(job[key])
    return model


def augmentation(group):
    from sdformerflow_tpu_torch.data.augmentation import (
        build_train_augmentation)
    return build_train_augmentation(["Horizontal", "Drop"], [0.5, 1.0],
                                    max_drop_rate=0.6, group=group)


def draws_run(job, group, rank, world, seed=7):
    """Two steps with drop-path 0.3 and the "Drop" augmentation on, at
    global batch 4, from ``seed``."""
    return run_steps(_fresh(job, "snn", drop_path_rate=0.3),
                     job["draws"], group=group, rank=rank, world=world,
                     augment=augmentation(group), seed=seed)


def train_cases(rank, world, workdir):
    """Every step case of tests/test_torch_port_dp.py on this rank."""
    import torch.distributed as dist
    from sdformerflow_tpu_torch.parallel import multihost
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    group = multihost.world_group()
    res = {"rank": rank, "world": multihost.process_count()}
    kw = dict(group=group, rank=rank, world=world)
    res["b2"] = run_steps(_fresh(job, "snn"), job["b2"], **kw)
    res["b4"] = run_steps(_fresh(job, "snn"), job["b4"],
                          opt=dict(SGD, clip_grad=1.0), **kw)
    h, w = EVENTS["sensor"]
    res["events"] = run_steps(
        _fresh(job, "snn"), job["events"], crop=SNN_SWIN["input_size"],
        voxelize=dict(num_bins=SNN_NET["num_bins"], height=h, width=w), **kw)
    res["acc"] = run_steps(_fresh(job, "snn"), job["acc"], num_acc=2, **kw)
    res["draws"] = draws_run(job, group, rank, world)
    res["ann"] = run_steps(_fresh(job, "stt"), job["ann"], polarity=False,
                           norm_input=True, remat="dots", **kw)
    res["snn_remat"] = run_steps(_fresh(job, "snn"), job["b2"][:1],
                                 remat="dots", **kw)
    # a group of one is no group: each rank on its own rows, bit for bit
    ones = [dist.new_group([r]) for r in range(world)]
    alone = run_steps(_fresh(job, "snn"), job["b2"][:1], group=ones[rank],
                      rank=0, world=1)
    plain = run_steps(_fresh(job, "snn"), job["b2"][:1], group=None)
    res["one"] = (alone, plain)
    res["eval"] = batch_stats_eval(job, group, rank, world)
    res["trainer"] = trainer_runs(rank, workdir)
    return res


def four_ranks(rank, world, workdir):
    """The global-batch-4 cases at one row a rank (each swin block's
    refold then mixes every rank's row)."""
    from sdformerflow_tpu_torch.parallel import multihost
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    group = multihost.world_group()
    res = {"rank": rank, "world": multihost.process_count()}
    res["b4"] = run_steps(_fresh(job, "snn"), job["b4"],
                          opt=dict(SGD, clip_grad=1.0), group=group,
                          rank=rank, world=world)
    res["draws"] = draws_run(job, group, rank, world)
    return res


TP_MIN_SIZE = 1 << 8       # JAX's tests/test_multichip_equivalence.py
TP_S2D_MIN_SIZE = 1 << 6   # shards the tiny s2d_train head's [8, 2, 3, 3]
TP_LAYOUTS = ((2, 2), (1, 4))   # (n_data, n_model) over four ranks


def tp_run(job, mesh, batches, *, ckpt_in=None, ckpt_out=None,
           drop_path_rate=0.0, seed=None, min_size=TP_MIN_SIZE, **cfg):
    """The port's step over ``batches`` (global batches; this rank takes
    its data slice's rows) on the SNN sharded over ``mesh``, from a
    checkpoint ``ckpt_in`` (a whole one) or ``job``'s state; per step
    (loss, grad norm, whole state_dict after it); the last state saved to
    ``ckpt_out``. Also the shapes this rank holds and its flat optimizer
    state's length. With ``seed`` drop path draws from a generator seeded
    so on every rank (the same on the model ranks of a data slice);
    ``cfg`` overrides SpikingConfig fields."""
    from sdformerflow_tpu_torch.parallel import sharding_rules as S
    from sdformerflow_tpu_torch.training import checkpoints, optim
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    model = _fresh(job, "snn", drop_path_rate=drop_path_rate, **cfg)
    opt = optim.build_optimizer(model.named_parameters(), **TP_OPT)
    S.shard_model(model, opt, mesh, min_size=min_size)
    if ckpt_in is not None:
        checkpoints.restore_checkpoint(ckpt_in, model, opt, group=mesh.data)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    step = make_train_step(model, opt, group=mesh.data, generator=gen)
    out = []
    for b in batches:
        m = step(rows(b, mesh.data_rank, mesh.n_data))
        whole, _ = S.whole_state(model)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: v.clone() for k, v in whole.items()}))
    if ckpt_out is not None:
        checkpoints.save_checkpoint(ckpt_out, model, opt, 0, len(batches),
                                    group=mesh.data)
    local = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return out, local, int(opt.trace.numel())


# SGD at lr 1 with the clip at 1 active: the norm over the model group
TP_OPT = dict(SGD, clip_grad=1.0)


def tp_cases(rank, world, workdir):
    """tests/test_torch_port_tp.py: the SNN's steps at global batch 2 as
    dp2 x tp2 and dp1 x tp4 over the four ranks; a tensor-parallel
    checkpoint written, a one-process one resumed, drop path 0.3, and the
    s2d_train embed with its block-space head sharded."""
    from sdformerflow_tpu_torch.parallel import multihost
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    res = {"rank": rank, "world": multihost.process_count()}
    for n_data, n_model in TP_LAYOUTS:
        mesh = multihost.make_multihost_mesh(n_model)
        assert (mesh.n_data, mesh.n_model) == (n_data, n_model)
        key = f"dp{n_data}_tp{n_model}"
        res[key] = tp_run(job, mesh, job["tp"], ckpt_out=os.path.join(
            workdir, key) if key == "dp2_tp2" else None)
        res[key + "_mesh"] = (mesh.data_rank, mesh.model_rank)
        if key == "dp2_tp2":
            res["resumed"] = tp_run(job, mesh, job["tp"][1:],
                                    ckpt_in=os.path.join(workdir, "one"))
            res["draws"] = tp_run(job, mesh, job["tp"], drop_path_rate=0.3,
                                  seed=7)
            # the s2d_train head sharded too: its block-space channels
            res["s2d_train"] = tp_run(job, mesh, job["tp"][:1],
                                      min_size=TP_S2D_MIN_SIZE,
                                      s2d_train=True)
    return res


def batch_stats_eval(job, group, rank, world):
    """``make_eval_step(use_batch_stats=True)`` (the reference's batch-1
    validation) on this rank's rows of ``b4``'s first batch: its finest
    flow."""
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    step = make_eval_step(_fresh(job, "snn"), use_batch_stats=True,
                          group=group)
    return step(rows(job["b4"][0], rank, world)["chunk"])[-1]


def import_probe(rank, world, workdir):
    """Import every module of the port and run one batch-statistics BN
    forward and backward in the group (tests/test_torch_port_imports.py)."""
    import importlib
    import pkgutil

    import sdformerflow_tpu_torch as pkg
    from sdformerflow_tpu_torch.models.spiking_layers import TorchBatchNorm
    from sdformerflow_tpu_torch.parallel import multihost
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    group = multihost.world_group()
    multihost.establish_collectives(group)
    bn = TorchBatchNorm(3)
    bn.group = group
    x = torch.arange(12.0).reshape(4, 3).add(rank).requires_grad_()
    bn(x).square().sum().backward()
    # rank 1 takes rank 0's tensors
    other = TorchBatchNorm(3)
    with torch.no_grad():
        other.weight.fill_(rank + 1.0)
    multihost.broadcast_state(other, None, group)
    return {"modules": len(names), "running_mean": bn.running_mean.clone(),
            "mean_of_ranks": multihost.process_mean(float(rank), group),
            "broadcast": other.weight.clone()}


K2_SITE = dict(T=10, batch=4, hw=(12, 16), channels=96)


def k2_site_tensors(dev):
    """The card case's inputs, the same in every process: x [T, B, H, W, C]
    of the global batch, the cotangent, the site's BN and PSN parameters."""
    from sdformerflow_tpu_torch.models.common import SpikingConfig
    from sdformerflow_tpu_torch.models.spiking_layers import (SpikingNeuron,
                                                              TorchBatchNorm)
    gen = torch.Generator().manual_seed(31)
    T, B, C = K2_SITE["T"], K2_SITE["batch"], K2_SITE["channels"]
    shape = (T, B) + K2_SITE["hw"] + (C,)
    x = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(dev)
    g = torch.randn(shape, generator=gen).to(dev)
    bn = TorchBatchNorm(C)
    sn = SpikingNeuron(SpikingConfig(num_steps=T, v_th=0.1,
                                     neuron_type="psn"))
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(C, generator=gen))
        bn.bias.copy_(0.2 * torch.randn(C, generator=gen))
        sn.weight.copy_(0.3 * torch.randn(T, T, generator=gen))
        sn.bias.copy_(0.1 * torch.randn(T, 1, generator=gen) - 0.2)
    return x, g, bn.to(dev), sn.to(dev)


def k2_site_run(x, g, bn, sn, group):
    """A BN -> PSN site (K2 forward, K2b backward on a CUDA tensor) in
    train mode over ``x``: (spikes, dx, parameter gradients, running
    statistics)."""
    from sdformerflow_tpu_torch.models.spiking_layers import norm_spike
    bn.group = group
    x = x.clone().requires_grad_()
    y = norm_spike(bn, sn, x)
    (y * g).sum().backward()
    grads = [p.grad.clone() for p in (bn.weight, bn.bias, sn.weight, sn.bias)]
    return (y.detach(), x.grad, grads,
            [bn.running_mean.clone(), bn.running_var.clone()])


def k2_site_case(rank, world, workdir):
    """tests/test_torch_port_cuda.py: one BN -> PSN site over two gloo
    ranks on one card (each two rows of the global batch of 4; global
    batch statistics; the parameter gradients all-reduced) against one
    process on the whole batch, on the same card."""
    import torch.distributed as dist
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.parallel import multihost
    dev = multihost.local_device("cuda:0")
    group = multihost.world_group()
    x, g, bn, sn = k2_site_tensors(dev)
    per = x.shape[1] // world
    mine = slice(rank * per, (rank + 1) * per)
    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    y, dx, grads, stats = k2_site_run(x[:, mine], g[:, mine], bn, sn, group)
    launches = (P.fused_affine_psn.launches, P.fused_psn_backward.launches)
    for t in grads:
        dist.all_reduce(t, group=group)
    _, _, bn1, sn1 = k2_site_tensors(dev)
    y1, dx1, grads1, stats1 = k2_site_run(x, g, bn1, sn1, None)
    cpu = lambda ts: [t.cpu() for t in ts]  # noqa: E731
    return dict(launches=launches, y=y.cpu(), y_one=y1[:, mine].cpu(),
                dx=dx.cpu(), dx_one=dx1[:, mine].cpu(), grads=cpu(grads),
                grads_one=cpu(grads1), stats=cpu(stats),
                stats_one=cpu(stats1))


class PreemptingDataset:
    """A dataset that sends its process SIGTERM when item ``at`` is read
    (on one rank only)."""

    def __init__(self, dataset, at):
        self.dataset, self.at = dataset, at

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        if idx == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.dataset[idx]


def trainer_runs(rank, workdir):
    """``train_dsec.main`` on the tiny config for 2 steps in the group
    (rank 0 writes), then ``train`` with a SIGTERM delivered to rank 1
    alone: both ranks stop at the same step and rank 0 checkpoints."""
    from sdformerflow_tpu_torch import train_dsec
    from sdformerflow_tpu_torch.data.dsec import SyntheticEventFlowDataset
    from sdformerflow_tpu_torch.training.config import load_config
    from sdformerflow_tpu_torch.training.train_loop import train
    out = {}
    run_dir = os.path.join(workdir, "trainer")
    model, opt = train_dsec.main(["--config", TINY_CONFIG, "--synthetic",
                                  "--device", "cpu", "--max_steps", "2",
                                  "--run_dir", run_dir])
    out["main"] = dict(count=int(opt.count), state={
        k: v.clone() for k, v in model.state_dict().items()},
        wrote=sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else [])
    config = load_config(TINY_CONFIG)
    config["loader"]["sync_every"] = 1
    config["loader"]["n_epochs"] = 1
    res = config["loader"]["resolution"]
    data = SyntheticEventFlowDataset(num_samples=16, num_bins=10,
                                     height=res[0], width=res[1])
    # rank 1's shard of epoch 0; it reads its 4th item on the 3rd step
    # or, through the prefetcher, a step or two before
    if rank == 1:
        data = PreemptingDataset(data, at=_shard_item(16, 0, rank, 3))
    stop_dir = os.path.join(workdir, "preempt")
    model, opt = train(config, data, None, run_dir=stop_dir, device="cpu")
    out["preempt"] = dict(count=int(opt.count), state={
        k: v.clone() for k, v in model.state_dict().items()})
    return out


def _shard_item(n, seed, rank, k):
    """The dataset index of this rank's ``k``-th item of an epoch
    resharded with ``seed`` over two ranks."""
    perm = np.random.default_rng(seed).permutation(n)
    return int(perm[rank * (n // 2) + k])
