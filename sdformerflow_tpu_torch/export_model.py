"""Export a trained flow model as ``torch.export`` inference programs,
weights included, loadable by a process that has torch and the kernels'
op registrations and no model code (``training/export.py`` has the
artifact contract). The counterpart of ``scripts/export_model.py``.

    python -m sdformerflow_tpu_torch.export_model \\
        --train_config configs/train_dsec_sdformerflow_en4.yaml \\
        --ckpt runs/en4/ckpt --out runs/en4/export \\
        [--event_buckets 1048576] [--device cpu] [--s2d] [--verify]

It runs on the card unless ``--device cpu``; a program is tied to the
device it was exported on, so ``--device`` takes the place of JAX's
``--platforms``. JAX's ``--fused_attn`` has no counterpart: K1 is always
in the port's eval step at an even window count.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train_config", required=True)
    ap.add_argument("--eval_config", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="a trainer checkpoint directory, or a .pt under "
                         "the reference's state_dict names")
    ap.add_argument("--out", required=True, help="output artifact dir")
    ap.add_argument("--no_bf16", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the programs run (default: the card)")
    ap.add_argument("--event_buckets", default="",
                    help="comma list of padded event counts to also export "
                         "raw-events steps for (powers of two, as the "
                         "server's buckets)")
    ap.add_argument("--s2d", action="store_true",
                    help="export the exact space-to-depth embed "
                         "re-expression (MS_PED models with running-stats "
                         "BN only)")
    ap.add_argument("--verify", action="store_true",
                    help="reload each artifact and require it to equal the "
                         "live step, bit for bit, on random input")
    return ap.parse_args(argv)


def random_inputs(meta, name, seed=0):
    """An input of artifact ``name`` on the meta's device: a Gaussian voxel
    chunk, or 3/4 of the bucket's slots of random events whose grid is
    exact (integer x/y in the frame, integer t from 0 to 4 (bins - 1) with
    both ends present, so every trilinear weight and sum is a multiple of
    1/4): K3 sums with float atomics in shared memory, and only an exact
    grid is the same in every order."""
    rng = np.random.default_rng(seed)
    dev, batch, bins = meta["device"], meta["batch"], meta["num_bins"]
    if name == "voxel":
        return torch.from_numpy(rng.standard_normal(
            meta["artifacts"]["voxel"]["input"]).astype(np.float32)).to(dev)
    n = meta["artifacts"][name]["input"]["valid"][1]
    h, w = meta["resolution"]
    t = rng.integers(0, 4 * (bins - 1) + 1, (batch, n))
    t[:, :2] = 0, 4 * (bins - 1)
    ev = {"x": rng.integers(0, w, (batch, n)),
          "y": rng.integers(0, h, (batch, n)), "t": t,
          "p": rng.integers(0, 2, (batch, n))}
    out = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
           for k, v in ev.items()}
    out["valid"] = (torch.arange(n) < n * 3 // 4).expand(batch, n).to(dev)
    return out


def verify(config, model, out_dir, bf16):
    """Each reloaded artifact against the live step on random input:
    returns ``({name: max |live - exported|}, {name: loaded callable})``,
    and raises unless every difference is 0."""
    from .training.export import _eval_fn, cast_for, load_exported

    meta, fns = load_exported(out_dir)
    model = cast_for(model, bf16)
    errs = {}
    for name, fn in fns.items():
        inputs = random_inputs(meta, name)
        live = _eval_fn(config, model, bf16=bf16, events=name != "voxel")
        with torch.inference_mode():
            want = live(inputs)
        errs[name] = float((want - fn(inputs)).abs().max())
        print(f"{name} artifact max|live - exported| = {errs[name]:.3e}")
    if any(errs.values()):
        raise SystemExit(f"verify: an exported program diverged from the "
                         f"live step: {errs}")
    print("verify: OK")
    return errs, fns


def main(argv=None) -> dict:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("export_model: no CUDA device; pass --device cpu "
                         "to export for the CPU")
    from .training.config import load_config, merge_eval_config
    from .training.export import build_inference_state, export_flow_model

    config = load_config(args.train_config)
    if args.eval_config:
        config = merge_eval_config(config, load_config(args.eval_config))
    model = build_inference_state(config, args.ckpt, s2d=args.s2d,
                                  device=args.device)
    buckets = [int(b) for b in args.event_buckets.split(",") if b]
    meta = export_flow_model(config, model, args.out, bf16=not args.no_bf16,
                             batch=args.batch, device=args.device,
                             event_buckets=buckets)
    for name in meta["artifacts"]:
        path = os.path.join(args.out, name + ".pt2")
        print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    if args.verify:
        meta["verify"], _ = verify(config, model, args.out,
                                   not args.no_bf16)
    return meta


if __name__ == "__main__":
    main()
