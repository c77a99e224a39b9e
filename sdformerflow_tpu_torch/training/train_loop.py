"""Config-driven supervised training loop on one card, a mirror of
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
train step's forward in the backward (``train_step.rematerialized``). JAX's
guard against remat at per-device batch >= 8 is not copied: it records an
out-of-memory crash of a TPU worker, not a fact about a GPU.

Not ported: the device mesh and multi-host sharding (one card).
"""

from __future__ import annotations

import math
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..data.augmentation import build_train_augmentation, center_crop
from ..data.dsec import batch_iterator
from ..losses import flow_loss_supervised
from ..models.registry import get_model
from ..ops.normalization import encode_input
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
    checkpoints the state at the epoch in progress and returns."""
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
    batch_size = loader["batch_size"]
    steps_per_epoch = max(len(train_dataset) // batch_size, 1)
    optimizer = build_optimizer(
        model.named_parameters(), name=opt_cfg.get("name", "AdamW"),
        lr=opt_cfg.get("lr", 1e-4), weight_decay=opt_cfg.get("wd", 0.01),
        scheduler=opt_cfg.get("scheduler", "multistep"),
        milestones=opt_cfg.get("milestones", ()),
        steps_per_epoch=steps_per_epoch, n_epochs=loader.get("n_epochs", 60),
        clip_grad=loss_cfg.get("clip_grad"),
        num_acc=opt_cfg.get("num_acc", 1))

    logger = RunLogger(run_dir, config)
    logger.log_artifact_dict("model_info.json", {
        "model": name, "params": count_parameters(model),
        "device": str(device)})
    start_epoch = 0
    if resume:
        _, start_epoch = restore_checkpoint(f"{run_dir}/ckpt", model,
                                            optimizer)
        start_epoch += 1

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
        generator=torch.Generator(device).manual_seed(seed + 1))
    eval_step = make_eval_step(model, **kw, voxelize=voxelize,
                               use_batch_stats=batch_size == 1)
    augment = build_train_augmentation(
        loader.get("augment"), loader.get("augment_prob"),
        crop=loader.get("crop"),
        max_drop_rate=loader.get("max_drop_rate", 0.6),
        rotation_degrees=loader.get("rotation_degrees", (0.0, 0.0)))
    try:
        _train_epochs(config, model, optimizer, train_dataset, valid_dataset,
                      run_dir=run_dir, start_epoch=start_epoch,
                      max_steps=max_steps, train_step=train_step,
                      eval_step=eval_step, augment=augment, device=device,
                      logger=logger, preempt_sig=preempt_sig)
    finally:
        logger.close()
    return model, optimizer


def _train_epochs(config, model, optimizer, train_dataset, valid_dataset, *,
                  run_dir, start_epoch, max_steps, train_step, eval_step,
                  augment, device, logger, preempt_sig):
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

        batches = prefetch_to_device(
            batch_iterator(train_dataset, batch_size, shuffle=True,
                           seed=seed + epoch,
                           workers=loader.get("n_workers", 0)), device)
        waits = []      # host seconds each step waited for its batch
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
            if max_steps is not None and global_step >= max_steps:
                break
            if preempt_sig:
                break
            t_wait = time.perf_counter()
        batches.close()
        drain()

        step = int(optimizer.count)
        if preempt_sig:
            partial = epoch_loss / max(n_samples, 1)
            save_checkpoint(f"{run_dir}/ckpt", model, optimizer, epoch, step,
                            metrics={"train_loss": partial, "preempted": 1.0})
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
                            metrics={"train_loss": epoch_loss})
            best_loss = epoch_loss
        if (valid_dataset is not None
                and epoch % config["test"].get("n_valid", 5) == 0):
            vloss = validate(config, eval_step, valid_dataset, crop=crop,
                             batch_size=batch_size, device=device)
            logger.log_metric("valid_loss", vloss, epoch)
        if max_steps is not None and global_step >= max_steps:
            break


def validate(config, eval_step, dataset, crop=None, batch_size=None,
             device="cuda"):
    """Mean per-batch validation loss on the finest flow, over
    ``test.sample // batch_size + 1`` batches at most (the reference's cap);
    voxel chunks center-cropped to ``crop``. The loss value depends on the
    batch size by the reference's design (one valid count per batch)."""
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
                [flows[-1]], label, mask, flow_scaling=flow_scaling))
        count += batch_size
    if not losses:
        return 0.0
    total = float(torch.stack(losses).sum())
    return total * batch_size / max(count, 1)
