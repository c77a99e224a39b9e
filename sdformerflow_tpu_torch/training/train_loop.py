"""Config-driven supervised training loop on one card, or one card a rank
of a process group, a mirror of
``sdformerflow_tpu/training/train_loop.py`` (``train``, ``validate``):

- the model from the registry in train mode, the configured optimizer
  (AdamW, Adam or SGD), schedule (multistep or OneCycle, counted in
  updates) and ``num_acc``, with global-norm clip and non-finite skipping
  (``optim.py``);
- per batch: host batcher in a background thread -> pinned memory ->
  device on a side stream (``parallel/mesh.py:prefetch_to_device``, as
  JAX's loop, ``train_loop.py:307``) -> augmentation (rotation, random
  crop, flips) -> train step (forward, backward, update; raw events
  voxelized on the device); ``metrics.jsonl`` gets each epoch's median
  wait of a step for its batch (``batch_wait_ms_p50``);
- losses stay device scalars and are fetched ``loader.sync_every`` steps
  at a time, so the host runs ahead of the card; a NaN loss raises at the
  fetch (the optimizer already skipped its update);
- epoch-best checkpoints (the newest three kept), validation every
  ``test.n_valid`` epochs on the center crop (batch 1 validates on batch
  statistics, the reference's quirk), ``metrics.jsonl`` in the run
  directory;
- SIGTERM drains the pending losses, checkpoints the current state at the
  epoch in progress and returns; ``resume=True`` continues at the next
  epoch.

``optimizer.remat`` ("dots", "dots_no_batch", "all") rematerializes the
train step's forward in the backward (``training/remat.py``), for the SNN
zoo and the ANN family alike. JAX's guard against remat at per-device batch
>= 8 (ANN-only) is not copied: it records an out-of-memory crash of a TPU
worker, not a fact about a GPU. Tensor parallelism has no config key, as in
JAX (its trainer builds a mesh of one model rank): it is an API
(``parallel/sharding_rules.py``).

Data parallelism (JAX ``train_loop.py:115-130,190-216,296-305``): in a
process group of R ranks (``torchrun``, ``parallel/multihost.py``)
``loader.batch_size`` is the global batch and must be divisible by R; each
rank trains on its card (``multihost.local_device``) and reads its shard of
a global permutation drawn anew each epoch (``ProcessShardedDataset``,
``reshard(seed + epoch)``), ``batch_size / R`` rows a step. The step is the
global batch's (``make_train_step(group=...)``: global batch statistics,
the loss's global normalisers, one all-reduce of the flat gradient), so R
ranks train as one process on the whole batch would. Rank 0's state is
broadcast at start and after a resume; rank 0 writes the checkpoints and
the logs; the validation loss is the global batch's. A SIGTERM reaches the
ranks at different times, so they agree on stopping by an all-reduced flag
at each loss fetch (every ``loader.sync_every`` steps and at the epoch's
end): no rank is left waiting in a collective. JAX's single-process
multi-device mesh has no counterpart (``loader.n_data > 1`` without a
process group raises): one process drives one card.
"""

from __future__ import annotations

import math
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.augmentation import build_train_augmentation, center_crop
from ..data.dsec import batch_iterator
from ..losses import flow_loss_supervised
from ..models.registry import get_model
from ..ops.normalization import encode_input
from ..parallel import multihost
from ..parallel.mesh import prefetch_to_device
from ..utils.logging import RunLogger, count_parameters
from .checkpoints import restore_checkpoint, save_checkpoint
from .config import build_configs, chunk_bins
from .evaluate import event_footprint_mask
from .optim import build_optimizer
from .train_step import make_eval_step, make_train_step


def _events_voxelize_cfg(config, dataset):
    """voxelize kwargs of the steps when the dataset yields raw events."""
    chunk, _, label = dataset[0]
    if not isinstance(chunk, dict):
        return None
    h, w = label.shape[-2:]
    return dict(num_bins=config["data"].get("num_frames", 10), height=h,
                width=w,
                presorted=bool(getattr(dataset, "events_presorted", False)))


def _to_device(batch, device):
    out = {}
    for key, val in batch.items():
        if isinstance(val, dict):
            out[key] = _to_device(val, device)
        else:
            out[key] = torch.from_numpy(np.ascontiguousarray(val)).to(
                device, non_blocking=True)
    return out


def train(config: dict, train_dataset, valid_dataset=None, *,
          run_dir: str = "runs/default", resume: bool = False,
          max_steps: Optional[int] = None, device="cuda"):
    """Train on ``device``; returns (model, optimizer). SIGTERM (when
    ``loader.save_on_preempt``, default on, and called from the main thread)
    checkpoints the state at the epoch in progress and returns. In a
    process group of more than one rank (``parallel/multihost.py:
    initialize``) this rank trains its share of each global batch on
    ``multihost.local_device(device)``."""
    preempt_sig: dict = {}
    prev = None
    if (config["loader"].get("save_on_preempt", True)
            and threading.current_thread() is threading.main_thread()):
        prev = signal.signal(signal.SIGTERM,
                             lambda s, f: preempt_sig.setdefault("sig", s))
    try:
        return _train(config, train_dataset, valid_dataset, run_dir=run_dir,
                      resume=resume, max_steps=max_steps,
                      device=torch.device(device), preempt_sig=preempt_sig)
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


def _train(config, train_dataset, valid_dataset, *, run_dir, resume,
           max_steps, device, preempt_sig):
    model_cfg, swin_cfg, spiking_cfg = build_configs(config)
    loader, loss_cfg = config["loader"], config["loss"]
    opt_cfg, name = config["optimizer"], config["model"]["name"]
    seed = loader.get("seed", 0)
    batch_size = loader["batch_size"]
    group = multihost.world_group()
    n_proc = multihost.process_count()
    local_bs = batch_size
    if dist.is_initialized():
        device = multihost.local_device(device)
    if group is not None:
        if batch_size % n_proc:
            raise ValueError(f"global batch_size {batch_size} must be "
                             f"divisible by process_count {n_proc}")
        local_bs = batch_size // n_proc
        train_dataset = multihost.ProcessShardedDataset(train_dataset)
        if valid_dataset is not None:
            valid_dataset = multihost.ProcessShardedDataset(valid_dataset)
    elif (loader.get("n_data") or 1) > 1:
        raise ValueError(
            f"loader.n_data = {loader['n_data']}: one process drives one "
            "card; train data-parallel with one process per card "
            "(torchrun, parallel/multihost.py)")
    # the model is built at the size it trains at, that of JAX's sample
    # batch: the whole frame for raw events, else the crop, else (no crop:
    # the dataset crops, as train_mdr's do) the chunk's. Like JAX, this
    # reads item 0 twice before training: an augmenting dataset draws from
    # its generator at each read, so both loops then see the same batches
    chunk = train_dataset[0][0]
    voxelize = _events_voxelize_cfg(config, train_dataset)
    if voxelize is not None:
        swin_cfg = swin_cfg.replace(
            input_size=(voxelize["height"], voxelize["width"]))
    elif loader.get("crop") is None:
        swin_cfg = swin_cfg.replace(input_size=tuple(chunk.shape[-2:]))
    torch.manual_seed(seed)
    model = get_model(name, model_cfg, swin_cfg, spiking_cfg, train=True,
                      input_bins=chunk_bins(config)).to(device)
    steps_per_epoch = max(len(train_dataset) // local_bs, 1)
    optimizer = build_optimizer(
        model.named_parameters(), name=opt_cfg.get("name", "AdamW"),
        lr=opt_cfg.get("lr", 1e-4), weight_decay=opt_cfg.get("wd", 0.01),
        scheduler=opt_cfg.get("scheduler", "multistep"),
        milestones=opt_cfg.get("milestones", ()),
        steps_per_epoch=steps_per_epoch, n_epochs=loader.get("n_epochs", 60),
        clip_grad=loss_cfg.get("clip_grad"),
        num_acc=opt_cfg.get("num_acc", 1))

    logger = RunLogger(run_dir, config,
                       enabled=multihost.process_index() == 0)
    logger.log_artifact_dict("model_info.json", {
        "model": name, "params": count_parameters(model),
        "device": str(device), "processes": n_proc,
        "backend": dist.get_backend() if dist.is_initialized() else None})
    multihost.establish_collectives(group)
    start_epoch = 0
    if resume:
        _, start_epoch = restore_checkpoint(f"{run_dir}/ckpt", model,
                                            optimizer, group=group)
        start_epoch += 1
    else:
        multihost.broadcast_state(model, optimizer, group)

    is_snn = "Spiking" in name
    kw = dict(encoding=config["model"].get("encoding", "voxel"),
              polarity=loader.get("polarity", True) and is_snn,
              norm_input=config["model"].get("norm_input"),
              spike_th=config["data"].get("spike_th"))
    train_step = make_train_step(
        model, optimizer, **kw,
        flow_scaling=config["metrics"].get("flow_scaling", 1.0),
        gamma=loss_cfg.get("gamma"),
        mask_events=config["metrics"].get("mask_events", False),
        compute_dtype=torch.bfloat16 if opt_cfg.get("use_amp") else None,
        voxelize=voxelize, remat=opt_cfg.get("remat"),
        generator=torch.Generator(device).manual_seed(seed + 1), group=group)
    eval_step = make_eval_step(model, **kw, voxelize=voxelize,
                               use_batch_stats=batch_size == 1, group=group)
    augment = build_train_augmentation(
        loader.get("augment"), loader.get("augment_prob"),
        crop=loader.get("crop"),
        max_drop_rate=loader.get("max_drop_rate", 0.6),
        rotation_degrees=loader.get("rotation_degrees", (0.0, 0.0)),
        group=group)
    try:
        _train_epochs(config, model, optimizer, train_dataset, valid_dataset,
                      run_dir=run_dir, start_epoch=start_epoch,
                      max_steps=max_steps, train_step=train_step,
                      eval_step=eval_step, augment=augment, device=device,
                      logger=logger, preempt_sig=preempt_sig, group=group,
                      local_bs=local_bs)
    finally:
        logger.close()
    return model, optimizer


def _stop_agreed(preempt_sig, group) -> bool:
    """Whether to stop for a SIGTERM: this process's flag, or with a
    ``group`` whether any rank has one (an all-reduced flag, reached by
    every rank at the same step)."""
    if group is None:
        return bool(preempt_sig)
    flag = torch.tensor([1.0 if preempt_sig else 0.0],
                        device=multihost.comm_device(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def _train_epochs(config, model, optimizer, train_dataset, valid_dataset, *,
                  run_dir, start_epoch, max_steps, train_step, eval_step,
                  augment, device, logger, preempt_sig, group, local_bs):
    loader = config["loader"]
    batch_size, seed = loader["batch_size"], loader.get("seed", 0)
    crop = loader.get("crop")
    sync_every = loader.get("sync_every", 32)
    best_loss = math.inf
    global_step = 0
    for epoch in range(start_epoch, loader.get("n_epochs", 60)):
        epoch_loss, n_samples = 0.0, 0
        pending = []    # un-fetched device losses, one per step
        t0 = time.time()
        # the decisions of the augmentation, on the host: no device sync
        aug_gen = torch.Generator().manual_seed(seed * 1_000_003 + epoch)

        def drain():
            nonlocal epoch_loss
            if not pending:
                return
            vals = torch.stack(pending).cpu().numpy()
            if np.isnan(vals).any():
                bad = global_step - len(pending) + int(np.isnan(vals).argmax())
                raise RuntimeError(f"NaN loss at step {bad}")
            epoch_loss += float(vals.sum()) * batch_size
            pending.clear()

        if group is not None:
            # the global permutation of the epoch, this rank's slice
            train_dataset.reshard(seed + epoch)
            rows = batch_iterator(train_dataset, local_bs,
                                  workers=loader.get("n_workers", 0))
        else:
            rows = batch_iterator(train_dataset, batch_size, shuffle=True,
                                  seed=seed + epoch,
                                  workers=loader.get("n_workers", 0))
        batches = prefetch_to_device(rows, device)
        waits = []      # host seconds each step waited for its batch
        stop = False    # a SIGTERM every rank has agreed on
        t_wait = time.perf_counter()
        for batch in batches:
            waits.append(time.perf_counter() - t_wait)
            if "events" not in batch:
                chunk, label, mask = augment(aug_gen, batch["chunk"],
                                             batch["label"], batch["mask"])
                batch = {"chunk": chunk, "label": label, "mask": mask}
            pending.append(train_step(batch)["loss"])
            n_samples += batch_size
            global_step += 1
            if len(pending) >= sync_every:
                drain()
                stop = group is not None and _stop_agreed(preempt_sig, group)
            if max_steps is not None and global_step >= max_steps:
                break
            if stop or (group is None and preempt_sig):
                break
            t_wait = time.perf_counter()
        batches.close()
        drain()

        step = int(optimizer.count)
        if _stop_agreed(preempt_sig, group):
            partial = epoch_loss / max(n_samples, 1)
            save_checkpoint(f"{run_dir}/ckpt", model, optimizer, epoch, step,
                            metrics={"train_loss": partial, "preempted": 1.0},
                            group=group)
            logger.log_metric("preempted_at_epoch", float(epoch), epoch)
            break
        epoch_loss /= max(n_samples, 1)
        logger.log_metric("train_loss", epoch_loss, epoch)
        logger.log_metric("epoch_time_s", time.time() - t0, epoch)
        logger.log_metric("skipped_updates", int(optimizer.notfinite_count),
                          epoch)
        logger.log_metric("batch_wait_ms_p50",
                          float(np.median(waits)) * 1e3 if waits else 0.0,
                          epoch)
        if epoch_loss < best_loss:
            save_checkpoint(f"{run_dir}/ckpt", model, optimizer, epoch, step,
                            metrics={"train_loss": epoch_loss}, group=group)
            best_loss = epoch_loss
        if (valid_dataset is not None
                and epoch % config["test"].get("n_valid", 5) == 0):
            vloss = validate(config, eval_step, valid_dataset, crop=crop,
                             batch_size=local_bs, device=device, group=group)
            logger.log_metric("valid_loss", vloss, epoch)
        if max_steps is not None and global_step >= max_steps:
            break


def validate(config, eval_step, dataset, crop=None, batch_size=None,
             device="cuda", group=None):
    """Mean per-batch validation loss on the finest flow, over
    ``test.sample // batch_size + 1`` batches at most (the reference's cap);
    voxel chunks center-cropped to ``crop``. The loss value depends on the
    batch size by the reference's design (one valid count per batch), so
    with a data-parallel ``group`` (``batch_size`` this rank's rows of each
    global batch) the loss is the global batch's, the ranks' shares summed
    (JAX validates on the assembled global batch: averaging the ranks'
    local losses would report R times the one-process value)."""
    loader = config["loader"]
    batch_size = batch_size or loader["batch_size"]
    max_batches = config["test"].get("sample", 40) // batch_size + 1
    flow_scaling = config["metrics"].get("flow_scaling", 1.0)
    # the reference validates on the finest flow only and, with
    # metrics.mask_events, masks by the encoded chunk's footprint
    mask_events = config["metrics"].get("mask_events", False)
    encode_kw = dict(encoding=config["model"].get("encoding", "voxel"),
                     polarity=(loader.get("polarity", True)
                               and "Spiking" in config["model"]["name"]),
                     norm_input=config["model"].get("norm_input"),
                     spike_th=config["data"].get("spike_th"))
    losses, count = [], 0
    for i, batch in enumerate(batch_iterator(
            dataset, batch_size, workers=loader.get("n_workers", 0))):
        if i >= max_batches:
            break
        batch = _to_device(batch, device)
        label, mask = batch["label"], batch["mask"]
        if "events" in batch:
            chunk = batch["events"]
        else:
            chunk = batch["chunk"]
            if crop is not None:
                chunk, label, mask = center_crop(chunk, label, mask,
                                                 tuple(crop))
        flows = eval_step(chunk)
        with torch.inference_mode():
            if mask_events and not isinstance(chunk, dict):
                mask = event_footprint_mask(mask,
                                            encode_input(chunk, **encode_kw))
            losses.append(flow_loss_supervised(
                [flows[-1]], label, mask, flow_scaling=flow_scaling,
                group=group))
        count += batch_size
    if not losses:
        return 0.0
    total = float(multihost.all_reduce_sum(torch.stack(losses).sum(), group))
    return total * batch_size / max(count, 1)
