"""The training driver: the program's step loop, as ``training/train_loop.py``
runs one epoch on one card.

Set-up builds the model (weights made on the card from the seed), the
configured optimizer, the train step (``make_train_step``) and the input
path (``data/dsec.py:batch_iterator`` over the harness's dataset of scene
windows -> ``parallel/mesh.py:prefetch_to_device`` -> the configured
``build_train_augmentation``), and drives that same loop through its first
three steps: their losses, the optimizer's first gradient (from its first
moment after one step) and the parameters after the third step are kept
for the check. The window then steps on, draining the losses every
``loader.sync_every`` steps, and ends on a drain and a
``torch.cuda.synchronize()``. The time each step waits for its batch and
its augmentation is the harness's own span (``input_wait``).

Once the window has closed and the program's state is freed, the plain
reference works the three steps out again from the seed: the same
weights, the epoch's shuffle, each batch's augmentation decisions, the
drop-path draws.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import scene
from ..harness import Spans, profiled, read_trace, seeded_state
from ..reference import build as ref_build
from ..reference import compare, train_ref
from . import common

CHECKED_STEPS = 3


class SceneDataset:
    """``pool`` scene windows at the sensor's resolution, each in
    ``variants`` placements (rolled along the width by ``roll_px`` a
    variant): item ``i`` is window ``i % pool`` in placement ``i // pool``,
    as ``(chunk, mask, label)`` host arrays, a copy a read."""

    def __init__(self, chunk, flow, mask, variants: int, roll_px: int):
        self.chunk, self.flow, self.mask = chunk, flow, mask
        self.pool, self.variants, self.roll_px = len(chunk), variants, roll_px

    def __len__(self):
        return self.pool * self.variants

    def __getitem__(self, i):
        base, k = i % self.pool, i // self.pool
        s = k * self.roll_px
        return (np.roll(self.chunk[base], s, axis=-1),
                np.roll(self.mask[base], s, axis=-1),
                np.roll(self.flow[base], s, axis=-1))


def seeds(cell):
    """(data, shuffle, augmentation, drop-path) seeds of a run."""
    s = cell.seed
    return s * 7 + 2, s * 7 + 3, s * 7 + 4, s * 7 + 5


def make_dataset(cell, program, device):
    tr = cell.traffic
    made = scene.windows(tr["pool"], seeds(cell)[0], tr["scene"],
                         bins=common.chunk_bins(program), device=device,
                         labels=True)
    return SceneDataset(made["chunk"].cpu().numpy(),
                        made["flow"].cpu().numpy(),
                        made["mask"].cpu().numpy(), int(tr["variants"]),
                        int(tr["roll_px"]))


class Loop:
    """The loop of ``train_loop._train_epochs`` over one epoch: batches
    from the prefetcher, augmented, stepped; losses drained every
    ``sync_every`` steps."""

    def __init__(self, program, dataset, train_step, augment, aug_seed,
                 shuffle_seed, device, spans):
        loader = program["loader"]
        self.bs = loader["batch_size"]
        self.sync_every = loader.get("sync_every", 32)
        self.workers = loader.get("n_workers", 0)
        self.dataset, self.device = dataset, device
        self.aug_seed, self.shuffle_seed = aug_seed, shuffle_seed
        self.step_fn, self.augment = train_step, augment
        self.spans = spans
        self.pending, self.losses = [], []
        self.steps = 0
        self.epoch = -1
        self.batches = None
        self._next_epoch()

    def _next_epoch(self):
        """A new epoch's batcher and prefetcher: the shuffle and the
        augmentation's decisions drawn anew from the seeds plus the
        epoch."""
        from sdformerflow_tpu_torch.data.dsec import batch_iterator
        from sdformerflow_tpu_torch.parallel.mesh import prefetch_to_device
        if self.batches is not None:
            self.batches.close()
        self.epoch += 1
        rows = batch_iterator(self.dataset, self.bs, shuffle=True,
                              seed=self.shuffle_seed + self.epoch,
                              workers=self.workers)
        self.batches = prefetch_to_device(rows, self.device)
        self.aug_gen = torch.Generator().manual_seed(self.aug_seed
                                                     + self.epoch)

    def step(self):
        with self.spans("input_wait"):
            batch = next(self.batches, None)
            if batch is None:
                self._next_epoch()
                batch = next(self.batches)
            if "events" not in batch:
                chunk, label, mask = self.augment(
                    self.aug_gen, batch["chunk"], batch["label"],
                    batch["mask"])
                batch = {"chunk": chunk, "label": label, "mask": mask}
        with self.spans("step"):
            self.pending.append(self.step_fn(batch)["loss"])
        self.steps += 1
        if len(self.pending) >= self.sync_every:
            self.drain()

    def drain(self):
        if not self.pending:
            return
        with self.spans("drain"):
            vals = torch.stack(self.pending).cpu().numpy()
        if np.isnan(vals).any():
            raise RuntimeError("NaN loss")
        self.losses.extend(float(v) for v in vals)
        self.pending.clear()

    def close(self):
        self.batches.close()


def build(cell, program, device):
    """The program's model, optimizer, step and augmentation, as
    ``train_loop._train`` builds them."""
    from sdformerflow_tpu_torch.data.augmentation import \
        build_train_augmentation
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.optim import build_optimizer
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    model_cfg, swin, spiking = build_configs(program)
    loader, loss_cfg = program["loader"], program["loss"]
    opt = program["optimizer"]
    name = program["model"]["name"]
    with torch.device(device):
        model = get_model(name, model_cfg, swin, spiking, train=True,
                          input_bins=common.chunk_bins(program))
    model.to(device)
    model.load_state_dict(seeded_state(model.state_dict(), cell.seed,
                                       device))
    steps_per_epoch = max(cell.n_items // loader["batch_size"], 1)
    optimizer = build_optimizer(
        model.named_parameters(), name=opt.get("name", "AdamW"),
        lr=opt.get("lr", 1e-4), weight_decay=opt.get("wd", 0.01),
        scheduler=opt.get("scheduler", "multistep"),
        milestones=opt.get("milestones", ()),
        steps_per_epoch=steps_per_epoch, n_epochs=loader.get("n_epochs", 60),
        clip_grad=loss_cfg.get("clip_grad"),
        num_acc=opt.get("num_acc", 1))
    is_snn = "Spiking" in name
    step = make_train_step(
        model, optimizer, encoding=program["model"].get("encoding", "voxel"),
        polarity=loader.get("polarity", True) and is_snn,
        norm_input=program["model"].get("norm_input"),
        spike_th=program["data"].get("spike_th"),
        flow_scaling=program["metrics"].get("flow_scaling", 1.0),
        gamma=loss_cfg.get("gamma"),
        mask_events=program["metrics"].get("mask_events", False),
        compute_dtype=torch.bfloat16 if opt.get("use_amp") else None,
        remat=opt.get("remat"),
        generator=torch.Generator(device).manual_seed(seeds(cell)[3]))
    augment = build_train_augmentation(
        loader.get("augment"), loader.get("augment_prob"),
        crop=loader.get("crop"),
        max_drop_rate=loader.get("max_drop_rate", 0.6),
        rotation_degrees=loader.get("rotation_degrees", (0.0, 0.0)))
    return model, optimizer, step, augment


def _flat_to_leaves(flat, names, shapes):
    out, at = {}, 0
    for n in names:
        k = int(np.prod(shapes[n])) if shapes[n] else 1
        out[n] = flat[at:at + k].view(shapes[n])
        at += k
    return out


def run(cell):
    device = torch.device(cell.device)
    spans = Spans()
    program = common.program_config(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dataset = make_dataset(cell, program, device)
    cell.n_items = len(dataset)
    model, optimizer, step, augment = build(cell, program, device)
    _, shuffle_seed, aug_seed, _ = seeds(cell)
    loop = Loop(program, dataset, step, augment, aug_seed, shuffle_seed,
                device, spans)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    # the checked steps: the window's own loop, call and feed
    loop.step()
    loop.drain()
    names = list(optimizer.names)
    first_m = optimizer.m.detach().clone().cpu()
    for _ in range(CHECKED_STEPS - 1):
        loop.step()
    loop.drain()
    trained = torch.cat([p.detach().reshape(-1) for p in
                         (dict(model.named_parameters())[n] for n in names)
                         ]).cpu()
    prog_losses = list(loop.losses)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - cell.t0
    wait0, steps0 = spans.total.get("input_wait", 0.0), loop.steps

    start = time.perf_counter()
    while time.perf_counter() - start < cell.seconds:
        loop.step()
    loop.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - start
    n_steps = loop.steps - steps0
    bs = loop.bs
    out = {"attempted": n_steps, "failed": 0,
           "train_samples_per_s": n_steps * bs / elapsed,
           "setup_s": setup_s,
           "input_wait_ms": (spans.total["input_wait"] - wait0) / n_steps
           * 1e3}
    trace = None
    if cell.trace:
        path = common.trace_path(cell)
        with profiled(path):
            with spans("traced_window"):
                for _ in range(int(cell.traffic.get("trace_steps", 4))):
                    loop.step()
                loop.drain()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        trace = read_trace(path)
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    loop.close()
    first_grad = _flat_to_leaves(first_m / (1 - optimizer.b1), names, shapes)
    moved = _flat_to_leaves(trained, names, shapes)
    del model, optimizer, step, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog = {"losses": prog_losses[:CHECKED_STEPS], "first_grad": first_grad,
            "params": moved}
    ref = reference_steps(cell, program, dataset, device, tf32=False)
    out.update(trace=trace, spans=spans, checks=check(cell, prog, ref),
               readings={"per_step_loss_gaps": per_step_loss_gaps(prog,
                                                                  ref),
                         "leaves_left_out": len(ref["first_grad"]) - len(
                             compare.moving_leaves(ref["first_grad"]))},
               sample_flops=common.reckoning(cell).train_flops_per_sample(
                   program))
    return out


def reference_steps(cell, program, dataset, device, *, tf32=False,
                    fault=None):
    """The reference's first three steps from the seed: losses, the first
    (clipped) gradient and the parameters after the third step, each leaf
    on the host. ``tf32`` runs them with TF32 on (the control); ``fault``
    plants one of the faults the check must catch."""
    loader, opt = program["loader"], program["optimizer"]
    bs = loader["batch_size"]
    _, shuffle_seed, aug_seed, dp_seed = seeds(cell)
    model = ref_build.build(program).to(device).train()
    model.load_state_dict(seeded_state(model.state_dict(), cell.seed,
                                       device))
    gen = torch.Generator(device).manual_seed(dp_seed)
    for m in model.modules():
        if hasattr(m, "drop_path_generator"):
            m.drop_path_generator = gen
    params = dict(model.named_parameters())
    init = {n: p.detach().cpu().clone() for n, p in params.items()}
    adam = train_ref.AdamW(params, lr=opt.get("lr", 1e-4),
                           wd=opt.get("wd", 0.01),
                           clip=program["loss"].get("clip_grad"))
    aug_gen = torch.Generator().manual_seed(aug_seed)
    batches = train_ref.epoch_order(len(dataset), bs, shuffle_seed)
    losses, first = [], None
    with common.tf32(tf32):
        for k in range(CHECKED_STEPS):
            items = [dataset[int(i)] for i in batches[k]]
            chunk = torch.from_numpy(np.stack([c for c, _, _ in items]))
            mask = torch.from_numpy(np.stack([m for _, m, _ in items])[:, None]
                                    .astype(np.float32))
            label = torch.from_numpy(np.stack([f for _, _, f in items]))
            chunk, label, mask = train_ref.augment(
                aug_gen, chunk.to(device), label.to(device), mask.to(device),
                loader.get("augment", []), loader.get("augment_prob", []),
                loader["crop"])
            if fault == "half_batch":
                chunk, label, mask = chunk[:bs // 2], label[:bs // 2], \
                    mask[:bs // 2]
            flows = model(chunk.float())["flow"]
            loss = train_ref.flow_loss([f.float() for f in flows], label,
                                       mask)
            model.zero_grad(set_to_none=True)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()
                     if p.grad is not None}
            if first is None:
                norm = np.sqrt(sum(float((g.double() ** 2).sum())
                                   for g in grads.values()))
                clip = adam.clip
                scale = clip / norm if clip is not None and norm >= clip \
                    else 1.0
                first = {n: (g * scale).detach().cpu()
                         for n, g in grads.items()}
            adam.params = {n: params[n] for n in grads}
            if fault != "frozen":
                adam.step(grads)
            losses.append(float(loss.detach()))
    out = {"losses": losses, "first_grad": first, "init": init,
           "params": {n: p.detach().cpu() for n, p in params.items()}}
    del model, adam
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def numbers(prog, ref):
    """(loss_gap, grad_gap, move_gap) of a run ``prog`` against ``ref``:
    the relative gap of the first step's loss (the later steps' losses
    follow Adam's first, sign-like update of gradients at round-off, which
    sets them apart by the seed's luck: ``per_step_loss_gaps``); by the
    worst leaf,
    the gap of the first gradient's norms and of the norms of the
    parameters' change over the three steps, over the leaves that move
    (``compare.moving_leaves``)."""
    keep = compare.moving_leaves(ref["first_grad"])
    init = ref["init"]
    loss = compare.loss_gap(prog["losses"][0], ref["losses"][0])
    grad = compare.leaf_norm_gap(prog["first_grad"], ref["first_grad"],
                                 ref["first_grad"], keep)
    move_p = {n: prog["params"][n] - init[n] for n in keep}
    move_r = {n: ref["params"][n] - init[n] for n in keep}
    move = compare.leaf_norm_gap(move_p, move_r, move_r, keep)
    return loss, grad, move


def per_step_loss_gaps(prog, ref):
    return [compare.loss_gap(a, b) for a, b in zip(prog["losses"],
                                                   ref["losses"])]


def check(cell, prog, ref):
    loss, grad, move = numbers(prog, ref)
    lim = cell.limits
    return [("loss_gap", loss, lim["loss_gap"]),
            ("grad_gap", grad, lim["grad_gap"]),
            ("move_gap", move, lim["move_gap"])]
