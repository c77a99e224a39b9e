"""Long-horizon training A/B: the PyTorch port against the JAX package.

A port of ``scripts/convergence_ab.py`` with the port in the reference's
place. N real AdamW steps (clip 100, weight decay 0.01, lr 1e-4, no
milestone) of ``MS_SpikingformerFlowNet_en4`` at JAX's A/B geometry
(depths (1, 1, 1, 1), heads (2, 2, 4, 4), window (2, 2, 2), base 32,
T = 10, PSN + BN, drop-path off, 10 bins, spike_th 0.05), float64 on the
CPU, each side through its own ``make_train_step``:

- both start from JAX's init, carried to the port by ``from_jax``;
- both read one moving-bar numpy stream (``_structured_item``, a copy of
  the JAX script's, which imports the reference harness);
- JAX's step keeps its flows and grad norm float64 (it casts them to
  float32 even under x64, ``train_step.py:160``, ``optim.py:73``), as
  ``tests/test_torch_port_train.py`` has it.

It records both loss trajectories, the first step whose relative gap
crosses 1e-9 / 1e-6 / 1e-3, and both final eval-mode AEEs on a held-out
window. ``--f32`` also runs the port in float32 against its own float64
run (where single-precision chaos takes over). Not collected by pytest;
it imports both packages and runs on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_port_convergence_ab.py --steps 300 \\
        [--f32] [--out docs/convergence_ab_torch.json]

``tests/test_torch_port_convergence.py`` runs it for a few steps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CLIP, WEIGHT_DECAY, NUM_BINS = 100.0, 0.01, 10
THRESHOLDS = (1e-9, 1e-6, 1e-3)


def _structured_item(rng, num_bins, h, w):
    """Moving-bar sample (``data/dsec.py`` SyntheticEventFlowDataset
    structured=True), framework-neutral numpy."""
    v = rng.uniform(-4, 4, size=2).astype(np.float64)
    chunk = np.zeros((num_bins, h, w), np.float64)
    ys, xs = np.mgrid[0:h, 0:w]
    cx = rng.uniform(0.25, 0.75) * w
    cy = rng.uniform(0.25, 0.75) * h
    for b in range(num_bins):
        frac = b / max(num_bins - 1, 1)
        bx, by = cx + frac * v[0], cy + frac * v[1]
        bar = (np.abs(xs - bx) < 2) | (np.abs(ys - by) < 2)
        chunk[b][bar] = 1.0 if b % 2 == 0 else -1.0
    label = np.broadcast_to(v[:, None, None], (2, h, w)).copy()
    mask = np.ones((1, h, w), np.float64)
    return chunk, mask, label


def ab_config(h: int, w: int) -> dict:
    """The A/B's config sections, as both packages' ``build_configs``
    read them."""
    model = {
        "name": "MS_SpikingformerFlowNet_en4", "encoding": "voxel",
        "norm_input": "minmax", "num_bins": NUM_BINS,
        "base_num_channels": 32, "kernel_size": 3,
        "use_upsample_conv": False,
        "spiking_neuron": {
            "num_steps": 10, "v_th": 0.1, "v_reset": None,
            "neuron_type": "psn", "surrogate_fun": "surrogate.ATan()",
            "tau": 2.0, "detach_reset": True, "spike_norm": "BN"}}
    swin = {
        "use_arc": ["swinv1", "MS_PED_Spiking_PatchEmbed_Conv_sfn"],
        "swin_depths": [1, 1, 1, 1], "swin_num_heads": [2, 2, 4, 4],
        "swin_out_indices": [0, 1, 2, 3], "swin_patch_size": [1, 1, 2, 2],
        "window_size": [2, 2, 2], "pretrained_window_size": [0, 0, 0],
        "mlp_ratio": 2, "input_size": [h, w], "drop_path_rate": 0.0}
    return {"model": model, "swin_transformer": swin, "loader": {}}


def _aee(flow, label, mask):
    err = np.sqrt(((flow - label) ** 2).sum(axis=1))
    return float(err[mask[:, 0] > 0].mean())


def divergence(a, b) -> dict:
    """Largest and final relative gap of ``a`` to ``b``, and the first step
    whose gap crosses each threshold (None if none does)."""
    a, b = np.asarray(a), np.asarray(b)
    rel = np.abs(a - b) / (np.abs(b) + 1e-12)
    cross = {}
    for th in THRESHOLDS:
        idx = np.nonzero(rel > th)[0]
        cross[f"first_step_rel_gt_{th:g}"] = int(idx[0]) if len(idx) else None
    return {"max_rel": float(rel.max()), "final_rel": float(rel[-1]),
            **cross}


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` meaning float64."""

    def __getattr__(self, name):
        import jax.numpy as jnp
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def run_jax(config, batches, eval_batch, lr, spike_th, log=print):
    """JAX's init and trajectory in float64: (numpy variables of the init,
    losses, final AEE)."""
    import jax
    import jax.numpy as jnp
    from sdformerflow_tpu.models import get_model
    from sdformerflow_tpu.ops.normalization import encode_input
    from sdformerflow_tpu.training import optim as j_optim
    from sdformerflow_tpu.training import train_step as j_train_step
    from sdformerflow_tpu.training.config import build_configs

    model = get_model(config["model"]["name"], *build_configs(config))
    h, w = batches[0][0].shape[-2:]
    saved = (j_train_step.jnp, j_optim.jnp)
    j_train_step.jnp = j_optim.jnp = _Float64Jnp()
    try:
        with jax.enable_x64(True):
            sample = encode_input(jnp.zeros((1, NUM_BINS, h, w), jnp.float32),
                                  polarity=True, norm_input="minmax",
                                  spike_th=spike_th)
            tx = j_optim.build_optimizer(lr=lr, weight_decay=WEIGHT_DECAY,
                                         milestones=(),
                                         steps_per_epoch=10 ** 9,
                                         clip_grad=CLIP)
            state = j_train_step.create_train_state(
                model, tx, sample.astype(jnp.float32), jax.random.PRNGKey(0))
            init = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64),
                {"params": state.params, "batch_stats": state.batch_stats})
            state = j_train_step.TrainState.create(
                apply_fn=model.apply, tx=tx,
                params=jax.tree_util.tree_map(jnp.asarray, init["params"]),
                batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                   init["batch_stats"]))
            step = j_train_step.make_train_step(donate=False,
                                                spike_th=spike_th)
            losses, t0 = [], time.time()
            for i, (chunk, mask, label) in enumerate(batches):
                batch = {"chunk": jnp.asarray(chunk[None]),
                         "label": jnp.asarray(label[None]),
                         "mask": jnp.asarray(mask[None])}
                state, metrics = step(state, batch, jax.random.PRNGKey(0))
                losses.append(float(metrics["loss"]))
                if (i + 1) % 25 == 0:
                    log(f"jax step {i + 1}/{len(batches)} loss "
                        f"{losses[-1]:.6f} ({time.time() - t0:.0f}s)")
            ev = j_train_step.make_eval_step(spike_th=spike_th)
            flow = np.asarray(ev(state, jnp.asarray(eval_batch[0][None]))[-1])
    finally:
        j_train_step.jnp, j_optim.jnp = saved
    return init, losses, _aee(flow, eval_batch[2][None], eval_batch[1][None])


def run_port(config, init, batches, eval_batch, lr, spike_th, dtype,
             log=print):
    """The port's trajectory from JAX's init, in ``dtype``: (losses, final
    AEE)."""
    import torch
    from sdformerflow_tpu_torch.training import optim
    from sdformerflow_tpu_torch.training.train_step import (make_eval_step,
                                                            make_train_step)

    model = port_model(config, init, dtype)
    opt = optim.build_optimizer(model.named_parameters(), lr=lr,
                                weight_decay=WEIGHT_DECAY, milestones=(),
                                steps_per_epoch=10 ** 9, clip_grad=CLIP)
    step = make_train_step(model, opt, spike_th=spike_th)
    label = "f64" if dtype == torch.float64 else "f32"
    losses, t0 = [], time.time()
    for i, item in enumerate(batches):
        losses.append(float(step(_port_batch(item, dtype))["loss"]))
        if (i + 1) % 25 == 0:
            log(f"port({label}) step {i + 1}/{len(batches)} loss "
                f"{losses[-1]:.6f} ({time.time() - t0:.0f}s)")
    ev = make_eval_step(model, spike_th=spike_th, compute_dtype=dtype)
    with torch.no_grad():
        flow = ev(torch.from_numpy(eval_batch[0][None]).to(dtype))[-1]
    return losses, _aee(flow.double().numpy(), eval_batch[2][None],
                        eval_batch[1][None])


def port_model(config, variables, dtype):
    """The A/B's model in the port, ``dtype``, holding JAX ``variables``
    (cast before the load: JAX's float64 init holds values that a float32
    model would round)."""
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.from_jax import from_jax

    model = get_model(config["model"]["name"], *build_configs(config))
    model.to(dtype).load_state_dict(from_jax(variables, model))
    return model


def _port_batch(item, dtype):
    import torch
    chunk, mask, label = item
    return {k: torch.from_numpy(v[None]).to(dtype) for k, v in
            (("chunk", chunk), ("mask", mask), ("label", label))}


def stream(steps, h, w):
    """The A/B's training items and its held-out item."""
    rng = np.random.RandomState(97)
    return ([_structured_item(rng, NUM_BINS, h, w) for _ in range(steps)],
            _structured_item(np.random.RandomState(1234), NUM_BINS, h, w))


def run(steps=300, size=(48, 48), lr=1e-4, spike_th=0.05, f32=False,
        log=print) -> dict:
    """The A/B over ``steps`` steps; returns the result dict."""
    import torch

    h, w = size
    config = ab_config(h, w)
    batches, eval_batch = stream(steps, h, w)
    t0 = time.time()
    init, j_losses, j_aee = run_jax(config, batches, eval_batch, lr,
                                    spike_th, log)
    jax_s = time.time() - t0
    t0 = time.time()
    p_losses, p_aee = run_port(config, init, batches, eval_batch, lr,
                               spike_th, torch.float64, log)
    port_s = time.time() - t0
    result = {
        "steps": steps, "size": [h, w], "lr": lr, "spike_th": spike_th,
        "jax_loss_first": j_losses[0], "jax_loss_last": j_losses[-1],
        "port_loss_first": p_losses[0], "port_loss_last": p_losses[-1],
        "jax_f64_final_aee": j_aee, "port_f64_final_aee": p_aee,
        "final_aee_rel": abs(p_aee - j_aee) / abs(j_aee),
        "f64_divergence": divergence(p_losses, j_losses),
        "cpu_s": {"jax_f64": jax_s, "port_f64": port_s},
        "jax_f64_losses": j_losses, "port_f64_losses": p_losses,
    }
    if f32:
        t0 = time.time()
        p32, p32_aee = run_port(config, init, batches, eval_batch, lr,
                                spike_th, torch.float32, log)
        result["cpu_s"]["port_f32"] = time.time() - t0
        result["port_f32_final_aee"] = p32_aee
        result["f32_vs_f64_divergence"] = divergence(p32, p_losses)
        result["port_f32_losses"] = p32
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, nargs=2, default=(48, 48))
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--spike_th", type=float, default=0.05)
    ap.add_argument("--f32", action="store_true",
                    help="also run the port in float32 against its float64 "
                         "run")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))       # run as a script from tests/
    result = run(args.steps, tuple(args.size), args.lr, args.spike_th,
                 args.f32, log=lambda m: print(m, flush=True))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if not k.endswith("losses")}, indent=1))
    return result


if __name__ == "__main__":
    main()
