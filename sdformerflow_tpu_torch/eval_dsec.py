"""DSEC evaluation on one card, the port's counterpart of
``scripts/eval_dsec.py``: the centre-crop protocol, AEE / PE1-3 / outlier /
AAE on the GT-valid mask (and, with ``metrics.mask_events``, the encoded
chunk's footprint), optionally flow images and the DSEC test-server
submission PNGs. Run from the repository root:

    python -m sdformerflow_tpu_torch.eval_dsec \\
        --train_config configs/train_dsec_sdformerflow_en4.yaml \\
        --eval_config configs/valid_dsec.yaml --torch_ckpt <file.pt> \\
        --path <dsec> [--bf16] [--store_submission] [--device cpu]

The train config (the model) and the eval config (the protocol) are
merged, eval keys winning. The data is the offline preprocessor's tree:
voxel tensors (``event_tensors/NNbins/left``), or raw event lists
(``event_tensors/01lists/left``) when the config sets
``data.events_input: list`` or ``data.preprocessed: false``; those are
voxelized on the card by K3 at sensor resolution and centre-cropped in the
step, the labels and masks on the host. Weights come from a port
checkpoint directory (``--ckpt``) or a ``.pt`` under the reference's
state_dict names (``--torch_ckpt``). BN always uses its running
statistics. ``results.json`` in the run directory holds the metrics.

The monitors of the JAX script, with its artefacts under its names:
``--store_spike_rates`` (``spike_rates.json``, each neuron site's firing
rate on the first batch, and ``mean_firing_rate`` in ``results.json``),
``--store_membrane`` (``membrane_stats.json``, each site's per-step
membrane mean, std and max on the first batch), ``--energy_report`` (implies
``--store_spike_rates``; ``energy.json``, the firing-rate-weighted SynOps
estimate of ``utils/energy.py``, and ``energy_mj`` / ``snn_vs_ann_ratio``
in ``results.json``; the MS spikeformer family only) and ``--log_attn``
(``attention_maps.npz``, each stage's attention map on the first batch,
from a forward of the model in its own dtype). The first batch's
collecting forward runs the MS attention in its module form (no K1), as
JAX's unfused eval does; the other batches run as without the flags.
``--show`` (live cv2 windows) is not ported: the card's host has no GUI
and no cv2 (ROADMAP section 1 item 9).

It runs on the CUDA card unless ``--device cpu`` is given, and fails when
there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .data.augmentation import center_crop
from .data.dsec import (DSECDatasetLite, DSECEventListDataset,
                        SyntheticEventFlowDataset, SyntheticEventListDataset,
                        batch_iterator)
from .models.registry import get_model
from .models.spiking_layers import collect_sites
from .training.checkpoints import restore_checkpoint
from .training.config import (build_configs, chunk_bins, load_config,
                              merge_eval_config)
from .training.evaluate import MetricsAccumulator, make_metrics_fn
from .training.s2d_embed import s2d_embed_state_dict
from .training.torch_interop import (load_reference_state_dict,
                                     load_torch_checkpoint)
from .training.train_loop import _events_voxelize_cfg, _to_device
from .training.train_step import _model_input, make_eval_step
from .utils.energy import energy_spikingformer
from .utils.logging import RunLogger

# flags of scripts/eval_dsec.py whose monitors are not ported
_NOT_PORTED = ("show",)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train_config", required=True)
    ap.add_argument("--eval_config", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory of the port's trainer")
    ap.add_argument("--torch_ckpt", default=None,
                    help=".pt/.pth under the reference's state_dict names")
    ap.add_argument("--run_dir", default="runs/eval_dsec")
    ap.add_argument("--path", default=None, help="override data.path")
    ap.add_argument("--synthetic", action="store_true",
                    help="evaluate on 16 seeded synthetic windows")
    ap.add_argument("--structured", action="store_true",
                    help="with --synthetic: the learnable moving-bar task")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 parameters and activations, BN statistics "
                         "float32")
    ap.add_argument("--s2d_embed", action="store_true",
                    help="the exact space-to-depth re-expression of the "
                         "embed head (training/s2d_embed.py)")
    ap.add_argument("--fused_attn", action="store_true",
                    help="accepted, no effect: the port's eval attention "
                         "runs K1 at every even window count, and the JAX "
                         "package holds the fused and unfused forms equal "
                         "in float64")
    ap.add_argument("--max_batches", type=int, default=None,
                    help="stop after this many batches (the protocol runs "
                         "the whole split)")
    ap.add_argument("--store_vis", action="store_true",
                    help="flow and GT flow images under run_dir/vis")
    ap.add_argument("--store_submission", action="store_true",
                    help="DSEC test-server 16-bit PNGs under "
                         "run_dir/vis/submission")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--store_spike_rates", action="store_true",
                    help="record each neuron site's firing rate (SNN only)")
    ap.add_argument("--energy_report", action="store_true",
                    help="firing-rate-weighted SynOps energy estimate (MS "
                         "spikeformer family; implies --store_spike_rates)")
    ap.add_argument("--store_membrane", action="store_true",
                    help="record each neuron site's membrane statistics "
                         "(mean / std / max per time step)")
    ap.add_argument("--log_attn", action="store_true",
                    help="store each stage's attention map of the first "
                         "batch")
    for flag in _NOT_PORTED:
        ap.add_argument(f"--{flag}", action="store_true",
                        help="not ported (ROADMAP section 1 item 9)")
    return ap.parse_args(argv)


def build_dataset(config: dict, *, synthetic=False, structured=False):
    """The ``valid`` split in the layout the config names (raw event lists
    when ``data.events_input == "list"`` or ``data.preprocessed`` is false,
    else voxel tensors), or 16 synthetic windows."""
    events = (config["data"].get("events_input") == "list"
              or not config["data"].get("preprocessed", True))
    if synthetic:
        res = config["loader"]["resolution"]
        cls = SyntheticEventListDataset if events else \
            SyntheticEventFlowDataset
        return cls(num_samples=16, num_bins=config["model"]["num_bins"],
                   height=res[0], width=res[1], seed=7,
                   structured=structured)
    cls = DSECEventListDataset if events else DSECDatasetLite
    return cls(config, "valid")


def evaluate(config: dict, model, dataset, *, device="cuda", bf16=False,
             max_batches=None, vis=None, submission=False, sites=None,
             attention=None) -> dict:
    """Run the protocol over ``dataset`` with ``model`` (already on
    ``device``, running-statistics BN) and return the metrics dict
    (AEE, PE1-3, outlier, AAE if named, num_batches, num_samples), computed
    in float64.

    ``bf16`` runs a bf16 copy of the parameters; else the model's own dtype.
    ``vis`` (``utils.visualization.AsyncVisWriter``) gets the first sample
    of each batch: its flow, GT flow and, with ``submission``, the
    submission flow.

    ``sites`` (a dict) receives the neuron telemetry of the first batch's
    forward (``models/spiking_layers.py:collect_sites``, device tensors in
    JAX's key order); ``attention`` (a list) the first batch's attention
    maps, one a stage, from a forward of ``model`` in its own dtype on the
    encoded chunk (``log=True``), as JAX's ``--log_attn`` runs its uncast
    parameters."""
    loader = config["loader"]
    kw = dict(encoding=config["model"].get("encoding", "voxel"),
              polarity=(loader.get("polarity", True)
                        and "Spiking" in config["model"]["name"]),
              norm_input=config["model"].get("norm_input"),
              spike_th=config["data"].get("spike_th"))
    crop = tuple(loader["crop"]) if loader.get("crop") else None
    voxelize = _events_voxelize_cfg(config, dataset)
    dtype = torch.bfloat16 if bf16 else next(model.parameters()).dtype
    eval_step = make_eval_step(model, **kw, compute_dtype=dtype,
                               voxelize=voxelize,
                               crop=crop if voxelize else None,
                               use_batch_stats=False)
    metrics = config["metrics"]
    metrics_fn = make_metrics_fn(
        metric_names=metrics.get("name", ["AEE"]),
        flow_scaling=metrics.get("flow_scaling", 1.0),
        mask_events=metrics.get("mask_events", False), **kw)
    acc = MetricsAccumulator()
    for i, batch in enumerate(batch_iterator(
            dataset, loader["batch_size"], drop_last=False,
            workers=loader.get("n_workers", 0))):
        if max_batches is not None and i >= max_batches:
            break
        batch = _to_device(batch, device)
        label, mask = batch["label"], batch["mask"]
        if "events" in batch:
            # the voxels are cropped in the step, the labels here
            chunk = batch["events"]
            if crop:
                _, label, mask = center_crop(label, label, mask, crop)
        else:
            chunk = batch["chunk"]
            if crop:
                chunk, label, mask = center_crop(chunk, label, mask, crop)
        if i == 0 and sites is not None:
            with collect_sites(eval_step.model) as found:
                flows = eval_step(chunk)
            sites.update(found)
        else:
            flows = eval_step(chunk)
        if i == 0 and attention is not None:
            attention.extend(attention_maps(model, chunk, voxelize, crop, kw))
        # the step's float32 flows, the metrics in float64: in float32,
        # acos quantizes small angles, which moved AAE by 1.4e-5 of itself
        # against float64 on an H100 (chip_smoke.py phase 12)
        pred, label, mask = (t.double()
                             for t in (flows[-1], label, mask))
        acc.append(metrics_fn(pred, label, mask,
                              None if "events" in batch else chunk),
                   label.shape[0])
        if vis is not None:
            vis.update(flow=pred[0], gt_flow=label[0],
                       submission_flow=pred[0] if submission else None)
    return acc.results()


def attention_maps(model, chunk, voxelize, crop, input_kw):
    """Each stage's attention map (``log=True``) of one forward of
    ``model`` in eval mode and in its own dtype on ``chunk`` (a batch of
    the step's input: voxels, or raw events that are voxelized and
    cropped), as numpy arrays. The forward runs under a collection whose
    records are dropped, so that every attention takes its module form, as
    in JAX's unfused forward."""
    with torch.inference_mode():
        x = _model_input(chunk, None, voxelize, crop if voxelize else None,
                         **input_kw)
        model.eval()
        with collect_sites(model):
            out = model(x.to(next(model.parameters()).dtype), log=True)
    return [a.cpu().numpy() for a in out["attn"] or []]


def load_weights(model, *, ckpt=None, torch_ckpt=None):
    """Load a port checkpoint directory (``ckpt``, the newest epoch) or a
    ``.pt`` under the reference's state_dict names (``torch_ckpt``) into
    ``model``; with neither, the model keeps the weights it was built
    with."""
    if ckpt:
        _, epoch = restore_checkpoint(ckpt, model)
        print(f"restored checkpoint epoch {epoch}")
    elif torch_ckpt:
        state, unmatched = load_reference_state_dict(
            load_torch_checkpoint(torch_ckpt), model)
        if unmatched:
            print(f"warning: {len(unmatched)} reference keys unmatched, "
                  f"e.g. {unmatched[:5]}")
        model.load_state_dict(state)
        print(f"converted reference checkpoint {torch_ckpt}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported: live cv2 windows need a GUI and "
                "cv2, which the card's host lacks (ROADMAP section 1 item 9)")
    if args.energy_report:
        args.store_spike_rates = True
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("eval_dsec: no CUDA device; pass --device cpu to "
                         "evaluate on the CPU")
    if args.ckpt and args.torch_ckpt:
        raise SystemExit("eval_dsec: give --ckpt or --torch_ckpt, not both")
    config = load_config(args.train_config)
    if args.eval_config:
        config = merge_eval_config(config, load_config(args.eval_config))
    if args.path:
        config["data"]["path"] = args.path
    dataset = build_dataset(config, synthetic=args.synthetic,
                            structured=args.structured)

    model_cfg, swin_cfg, spiking_cfg = build_configs(config)
    if args.store_membrane:
        spiking_cfg = spiking_cfg.replace(store_v_seq=True)
    name = config["model"]["name"]
    model = get_model(name, model_cfg, swin_cfg, spiking_cfg,
                      input_bins=chunk_bins(config))
    load_weights(model, ckpt=args.ckpt, torch_ckpt=args.torch_ckpt)
    if args.s2d_embed:
        state = s2d_embed_state_dict(model.state_dict())
        model = get_model(name, model_cfg, swin_cfg,
                          spiking_cfg.replace(s2d_embed=True))
        model.load_state_dict(state)
    model.to(args.device)

    vis = None
    if args.store_vis or args.store_submission:
        from .utils.visualization import AsyncVisWriter, FlowVisualizer
        vis = AsyncVisWriter(FlowVisualizer(f"{args.run_dir}/vis"))
    sites = {} if args.store_spike_rates or args.store_membrane else None
    attention = [] if args.log_attn else None
    try:
        results = evaluate(config, model, dataset, device=args.device,
                           bf16=args.bf16, max_batches=args.max_batches,
                           vis=vis, submission=args.store_submission,
                           sites=sites, attention=attention)
    finally:
        if vis is not None:
            vis.close()
    spike_rates = membrane = energy = None
    if sites is not None:
        # one copy to the host for all the sites (an ANN has none)
        keys, values = list(sites), {}
        if keys:
            flat = torch.cat([sites[k].float().reshape(-1)
                              for k in keys]).cpu()
            values = {k: t.tolist() for k, t in zip(keys, flat.split(
                [sites[k].numel() for k in keys]))}
        if args.store_spike_rates:
            spike_rates = {k: float(np.mean(v)) for k, v in values.items()
                           if "spike_rate" in k}
        if args.store_membrane:
            membrane = {k: np.asarray(v, np.float32).reshape(-1, 3).tolist()
                        for k, v in values.items() if "membrane" in k}
    if spike_rates is not None:
        results["mean_firing_rate"] = float(
            np.mean(list(spike_rates.values())))
    if args.energy_report and spike_rates:
        if name.startswith("MS_Spikingformer"):
            polarity = (config["loader"].get("polarity", True)
                        and "Spiking" in name)
            energy = energy_spikingformer(
                swin_cfg, spike_rates, num_steps=spiking_cfg.num_steps,
                base_channels=config["model"].get("base_num_channels", 96),
                num_encoders=model.sttmultires_unet.num_encoders,
                num_ch=2 if polarity else 1,
                kernel_size=config["model"].get("kernel_size", 3))
            results["energy_mj"] = energy["energy_mj"]
            results["snn_vs_ann_ratio"] = energy["snn_vs_ann_ratio"]
        else:
            print(f"--energy_report: SynOps mapping is scoped to the "
                  f"MS spikingformer family (got {name}); skipped")
    logger = RunLogger(args.run_dir, config)
    logger.log_artifact_dict("results.json", results)
    if spike_rates is not None:
        logger.log_artifact_dict("spike_rates.json", spike_rates)
    if energy is not None:
        logger.log_artifact_dict("energy.json", energy)
        print(f"energy: {energy['energy_mj']:.3f} mJ/forward "
              f"({energy['snn_vs_ann_ratio']:.3f}x of the "
              f"all-MAC ANN equivalent)")
    if membrane is not None:
        logger.log_artifact_dict("membrane_stats.json", membrane)
    logger.close()
    if attention is not None:
        os.makedirs(args.run_dir, exist_ok=True)
        np.savez(os.path.join(args.run_dir, "attention_maps.npz"),
                 **{f"stage{k}": a for k, a in enumerate(attention)})
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
