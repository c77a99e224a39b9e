"""A tiny DSEC tree and an en4 config small enough for float64 on the CPU,
shared by the port's DSEC tests (``test_torch_port_dsec.py``) and its
card-only tests (``test_torch_port_cuda.py``). Imports no JAX.

The tree has the offline preprocessor's layout: voxels (``NNbins``,
``NNbins_pol``), raw event lists (``01lists``: pickled dicts in DSEC's
dtypes), GT flow, masks and the split lists. Each window's events are
dyadic (integer x/y, t on a 2500 us grid with both ends present), so every
voxelizer's grid of them is exact, and its ``NNbins`` tensor is that grid:
the voxel layout and the event layout carry the same windows.
"""

import os

import numpy as np
import torch
import yaml

from sdformerflow_tpu_torch.ops.voxel import voxel_grid_signed

BINS, FRAME, CROP = 4, (64, 96), [48, 64]
SEQ = "zurich_city_01_a"
N_VALID = 3
T_STEP_US = 2500


def dyadic_events(rng, m, h, w, bins):
    """DSEC dtypes (uint16 x/y, int64 us t, uint8 p), time-sorted."""
    k = np.sort(rng.integers(0, 4 * (bins - 1) + 1, m))
    k[0], k[-1] = 0, 4 * (bins - 1)
    return {"x": rng.integers(0, w, m).astype(np.uint16),
            "y": rng.integers(0, h, m).astype(np.uint16),
            "t": (49_000_000_000 + T_STEP_US * k).astype(np.int64),
            "p": rng.integers(0, 2, m).astype(np.uint8)}


def events_grid(ev, bins, h, w):
    """The plain twin's signed grid of a window (t rebased, its span)."""
    t = torch.from_numpy((ev["t"] - ev["t"][0]).astype(np.float32))
    return voxel_grid_signed(
        *(torch.from_numpy(ev[k].astype(np.float32)) for k in "xy"), t,
        torch.from_numpy(ev["p"].astype(np.float32)), num_bins=bins,
        height=h, width=w, t_range=(0.0, float(t[-1]))).numpy()


def make_tree(root, n_valid=N_VALID, n_train=2, seed=0):
    rng = np.random.default_rng(seed)
    h, w = FRAME
    dirs = {"gt": "gt_tensors", "mask": "mask_tensors",
            "lists": "sequence_lists",
            "bins": f"event_tensors/{BINS:02d}bins/left/{SEQ}",
            "pol": f"event_tensors/{BINS:02d}bins_pol/left/{SEQ}",
            "ev": "event_tensors/01lists/left"}
    for d in dirs.values():
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = [f"{SEQ}_{i:06d}.npy" for i in range(n_valid + n_train + 1)]
    for name in names:
        def save(d, a):
            np.save(os.path.join(root, dirs[d], name), a)
        save("gt", rng.normal(0, 4, (2, h, w)).astype(np.float32))
        save("mask", rng.random((h, w)) < 0.7)
        ev = dyadic_events(rng, int(rng.integers(3000, 5000)), h, w, BINS)
        np.save(os.path.join(root, dirs["ev"], name),
                np.array([ev], dtype=object))
        vox = events_grid(ev, BINS, h, w)
        save("bins", vox)
        save("pol", np.stack([np.maximum(vox, 0), np.maximum(-vox, 0)], 1))
    valid, train = names[:n_valid], names[n_valid:n_valid + n_train]
    for split, rows in (("valid", valid), ("train", train)):
        with open(os.path.join(root, dirs["lists"], f"{split}_split_seq.csv"),
                  "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, dirs["lists"], "valid_split_doubleseq.csv"),
              "w") as f:
        f.write("\n".join(f"{a},{b}" for a, b in zip(names[:n_valid],
                                                     names[1:n_valid + 1])))
    return root


def tiny_config(root, *, events=False, mask_events=False, batch_size=2):
    return {
        "data": {"path": root, "num_frames": BINS, "num_chunks": 1,
                 "preprocessed": not events},
        "model": {"name": "MS_SpikingformerFlowNet_en4", "encoding": "voxel",
                  "norm_input": "minmax", "num_bins": BINS,
                  "base_num_channels": 8, "kernel_size": 3,
                  "use_upsample_conv": False},
        "swin_transformer": {
            "use_arc": ["swinv1", "MS_PED_Spiking_PatchEmbed_Conv_sfn"],
            "swin_depths": [1, 1, 1, 1], "swin_num_heads": [2, 2, 4, 4],
            "swin_out_indices": [0, 1, 2, 3], "swin_patch_size": [1, 1, 2, 2],
            "window_size": [2, 3, 3], "pretrained_window_size": [0, 0, 0],
            "mlp_ratio": 2},
        "spiking_neuron": {"num_steps": BINS, "v_th": 0.1, "v_reset": None,
                           "neuron_type": "psn", "surrogate_fun": "atan",
                           "spike_norm": "BN"},
        "loss": {"clip_grad": 100.0},
        "optimizer": {"lr": 1e-4, "milestones": [10]},
        "loader": {"batch_size": batch_size, "resolution": list(FRAME),
                   "crop": CROP, "polarity": True, "n_epochs": 1,
                   "augment": [], "augment_prob": []},
        "metrics": {"name": ["AEE", "AAE"], "flow_scaling": 1,
                    "mask_events": mask_events},
        "test": {"sample": 40, "n_valid": 1},
    }


def write_config(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def save_reference_checkpoint(path, state_dict):
    """``state_dict`` (reference names) as a DataParallel ``.pt``: the
    ``module.`` prefix, plus a ``num_batches_tracked`` and a membrane-state
    entry, which the loader skips."""
    state = {"module." + k: v for k, v in state_dict.items()}
    state["module.sttmultires_unet.encoders.swin3d.patch_embed.head."
          "norm_layer.norm_layer.num_batches_tracked"] = torch.tensor(7)
    state["module.sttmultires_unet.resblocks.0.sn1.spiking_neuron.v"] = \
        torch.zeros(3)
    torch.save(state, str(path))
    return str(path)
