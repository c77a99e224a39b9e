"""MDR dataset, the port's own copy of ``sdformerflow_tpu/data/mdr.py``:
events1/events2 .npz pairs + best-density variants + .flo GT, voxelized on
the host in numpy.

- train: {events, d_events} x {old, new} volumes + flow;
  DenseSparseAugmentor crop/scale/flip; validity = finite flow with
  norm > 0;
- val: random crop; validity = |flow| < 1000; event-occupancy mask from a
  2D histogram of the old event sequence.

Items are dicts of numpy arrays; ``data/adapters.py`` concatenates the
(old, new) volumes along the bin axis into the model's chunk.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .loader_utils import (DenseSparseAugmentor, EventSequence,
                           events_to_voxel_grid, get_compressed_events,
                           read_flo)


class MDREventFlow:
    def __init__(self, config: dict, train: bool = True, aug: bool = False,
                 rng=None):
        self.config = config
        self.num_frames = config["data"]["num_frames"]
        self.num_chunks = config["data"]["num_chunks"]
        self.height = int(config["loader"]["resolution"][0])
        self.width = int(config["loader"]["resolution"][1])
        self.type = "train" if train else "val"
        self.dt = config["data"].get("event_interval", "dt1")
        self.pol = config["loader"].get("polarity", True)
        self.crop = config["loader"].get("crop", (256, 256))
        self.rng = rng or np.random.default_rng(config["loader"].get("seed", 0))
        if train:
            self._index_train()
        else:
            self.change_test_sequence(config["data"]["valid_sequence"])
        self.augmentor = None
        if aug:
            self.augmentor = DenseSparseAugmentor(
                self.crop, min_scale=config["loader"].get("min_scale", -0.2),
                max_scale=config["loader"].get("max_scale", 0.5),
                do_flip=True, rng=self.rng)

    def _index_train(self):
        base = os.path.join(self.config["data"]["path"], "dt1", "train")
        self.events1_path = os.path.join(base, "events1")
        self.events2_path = os.path.join(base, "events2")
        self.d_events1_path = os.path.join(base, "best_density_events1")
        self.d_events2_path = os.path.join(base, "best_density_events2")
        self.flow_path = os.path.join(base, "flow")
        self._collect(train=True)

    def change_test_sequence(self, sequence: str):
        base = os.path.join(self.config["data"]["path"], self.dt, "test",
                            sequence)
        self.events1_path = os.path.join(base, "events1")
        self.events2_path = os.path.join(base, "events2")
        self.flow_path = os.path.join(base, "flow")
        self._collect(train=False)

    def _collect(self, train: bool):
        self.names, self.events1_list, self.events2_list = [], [], []
        self.d_events1_list, self.d_events2_list, self.flow_list = [], [], []
        for root, _, files in os.walk(self.events1_path):
            for f in sorted(files):
                if not f.endswith(".npz"):
                    continue
                name = os.path.basename(root)
                e1 = os.path.join(self.events1_path, name, f)
                e2 = os.path.join(self.events2_path, name,
                                  f.replace("events1", "events2"))
                fl = os.path.join(self.flow_path, f"{name}_flow.flo")
                ok = os.path.exists(e2) and os.path.exists(fl)
                if train:
                    d1 = os.path.join(self.d_events1_path,
                                      f"{name}_best_density_events1.npz")
                    d2 = os.path.join(self.d_events2_path,
                                      f"{name}_best_density_events2.npz")
                    ok = ok and os.path.exists(d1) and os.path.exists(d2)
                if not ok:
                    continue
                self.names.append(f.replace(".npz", "").replace("events1", ""))
                self.events1_list.append(e1)
                self.events2_list.append(e2)
                self.flow_list.append(fl)
                if train:
                    self.d_events1_list.append(d1)
                    self.d_events2_list.append(d2)

    def __len__(self):
        return len(self.names)

    def _voxelize(self, path):
        ev = get_compressed_events(path)
        seq = EventSequence(ev, self.height, self.width,
                            timestamp_multiplier=1e6,
                            convert_to_relative=True)
        return events_to_voxel_grid(seq, self.num_frames, normalize=True,
                                    pol=self.pol)

    def __getitem__(self, idx):
        idx = idx % len(self)
        flow = read_flo(self.flow_list[idx])  # [H, W, 2]
        sample = {"idx": self.names[idx]}

        vol_old = self._voxelize(self.events1_list[idx])
        vol_new = self._voxelize(self.events2_list[idx])

        if self.type == "train":
            d_old = self._voxelize(self.d_events1_list[idx])
            d_new = self._voxelize(self.d_events2_list[idx])
            if self.augmentor is not None:
                def hwc(v):  # [bins(,2),H,W] -> [H,W,C...]
                    return (v.transpose(1, 2, 0) if v.ndim == 3
                            else v.transpose(2, 3, 0, 1))

                def chw(v, ref_ndim):
                    return (v.transpose(2, 0, 1) if ref_ndim == 3
                            else v.transpose(2, 3, 0, 1))

                nd = vol_old.ndim
                e1, e2, de1, de2, flow = self.augmentor(
                    hwc(vol_old), hwc(vol_new), hwc(d_old), hwc(d_new), flow)
                vol_old, vol_new = chw(e1, nd), chw(e2, nd)
                d_old, d_new = chw(de1, nd), chw(de2, nd)
            valid = (np.isfinite(flow[..., 0]) & np.isfinite(flow[..., 1])
                     & (np.linalg.norm(flow, axis=2) > 0))
            sample.update(
                event_volume_old=vol_old.astype(np.float32),
                event_volume_new=vol_new.astype(np.float32),
                d_event_volume_old=d_old.astype(np.float32),
                d_event_volume_new=d_new.astype(np.float32),
                flow=flow.transpose(2, 0, 1).astype(np.float32),
                valid=valid.astype(np.float32))
        else:
            # validation: shared random crop of flow/volumes + event mask
            ev = get_compressed_events(self.events1_list[idx])
            hist, _, _ = np.histogram2d(
                x=ev[:, 1], y=ev[:, 2], bins=(self.width, self.height),
                range=[[0, self.width], [0, self.height]])
            ev_mask = hist.T > 0
            th, tw = self.crop
            y0 = self.rng.integers(0, self.height - th + 1)
            x0 = self.rng.integers(0, self.width - tw + 1)
            sl = (slice(y0, y0 + th), slice(x0, x0 + tw))
            flow_c = flow.transpose(2, 0, 1)[:, sl[0], sl[1]]
            valid = (np.abs(flow_c[0]) < 1000) & (np.abs(flow_c[1]) < 1000)
            sample.update(
                event_volume_old=vol_old[..., sl[0], sl[1]].astype(np.float32),
                event_volume_new=vol_new[..., sl[0], sl[1]].astype(np.float32),
                flow=flow_c.astype(np.float32),
                valid=valid.astype(np.float32),
                event_valid=ev_mask[None, sl[0], sl[1]].astype(np.float32))
        return sample
