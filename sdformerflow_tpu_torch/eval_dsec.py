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

It runs on the CUDA card unless ``--device cpu`` is given, and fails when
there is no card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .data.augmentation import center_crop
from .data.dsec import (DSECDatasetLite, DSECEventListDataset,
                        SyntheticEventFlowDataset, SyntheticEventListDataset,
                        batch_iterator)
from .models.registry import get_model
from .training.checkpoints import restore_checkpoint
from .training.config import (build_configs, chunk_bins, load_config,
                              merge_eval_config)
from .training.evaluate import MetricsAccumulator, make_metrics_fn
from .training.s2d_embed import s2d_embed_state_dict
from .training.torch_interop import (load_reference_state_dict,
                                     load_torch_checkpoint)
from .training.train_loop import _events_voxelize_cfg, _to_device
from .training.train_step import make_eval_step
from .utils.logging import RunLogger

# flags of scripts/eval_dsec.py whose monitors are not ported
_NOT_PORTED = ("store_spike_rates", "energy_report", "store_membrane",
               "log_attn", "show")


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
    for flag in _NOT_PORTED:
        ap.add_argument(f"--{flag}", action="store_true",
                        help="not ported (ROADMAP section 1 item 11)")
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
             max_batches=None, vis=None, submission=False) -> dict:
    """Run the protocol over ``dataset`` with ``model`` (already on
    ``device``, running-statistics BN) and return the metrics dict
    (AEE, PE1-3, outlier, AAE if named, num_batches, num_samples), computed
    in float64.

    ``bf16`` runs a bf16 copy of the parameters; else the model's own dtype.
    ``vis`` (``utils.visualization.AsyncVisWriter``) gets the first sample
    of each batch: its flow, GT flow and, with ``submission``, the
    submission flow."""
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
        # the step's float32 flows, the metrics in float64: in float32,
        # acos quantizes small angles, which moved AAE by 1.4e-5 of itself
        # against float64 on an H100 (chip_smoke.py phase 12)
        pred, label, mask = (t.double()
                             for t in (eval_step(chunk)[-1], label, mask))
        acc.append(metrics_fn(pred, label, mask,
                              None if "events" in batch else chunk),
                   label.shape[0])
        if vis is not None:
            vis.update(flow=pred[0], gt_flow=label[0],
                       submission_flow=pred[0] if submission else None)
    return acc.results()


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
                f"--{flag} is not ported (ROADMAP section 1 item 11)")
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
    try:
        results = evaluate(config, model, dataset, device=args.device,
                           bf16=args.bf16, max_batches=args.max_batches,
                           vis=vis, submission=args.store_submission)
    finally:
        if vis is not None:
            vis.close()
    logger = RunLogger(args.run_dir, config)
    logger.log_artifact_dict("results.json", results)
    logger.close()
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
