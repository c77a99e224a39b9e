"""MVSEC dataset, the port's own copy of ``sdformerflow_tpu/data/mvsec.py``:
per-frame event .h5 (pandas' fixed-format HDF, read by ``data/hdf5.py``) +
dt1/dt4 GT flow .npy.

- hardcoded valid frame ranges per sequence;
- dt4 concatenates 4 consecutive event files per sample;
- val: center crop, validity = |flow| < 1000, ``outdoor_day1`` masks rows
  >= 193 (the car's hood), event-occupancy mask.
"""

from __future__ import annotations

import os

import numpy as np

from .loader_utils import (EventSequence, events_to_voxel_grid, get_events_h5)

VALID_TIME_INDEX = {
    "indoor_flying1": [(314, 2197)],
    "indoor_flying2": [(314, 2199)],
    "indoor_flying3": [(314, 2199)],
    "indoor_flying4": [(196, 570)],
    "outdoor_day1": [(245, 3000)],
    "outdoor_day2": [(4375, 7002)],
}


class MvsecEventFlow:
    dt = "dt1"
    files_per_sample = 1

    def __init__(self, config: dict, train: bool = False):
        self.config = config
        self.num_frames = config["data"]["num_frames"]
        self.height = int(config["loader"]["resolution"][0])
        self.width = int(config["loader"]["resolution"][1])
        self.type = "train" if train else "val"
        self.pol = config["loader"].get("polarity", True)
        self.crop = config["loader"].get("crop", (256, 256))
        self.change_test_sequence(config["data"]["test_sequence"])

    def change_test_sequence(self, sequence: str):
        self.names = []
        for s in VALID_TIME_INDEX[sequence]:
            self.names.extend(range(s[0], s[1]))
        self.sequence = ("outdoor_day1" if "outdoor_day1" in sequence
                         else sequence)
        base = os.path.join(self.config["data"]["path"], self.sequence)
        self.flowgt_path = os.path.join(base, f"flowgt_{self.dt}")
        self.event_path = os.path.join(base, "event")
        self.flow_list = [os.path.join(self.flowgt_path, f"{i}.npy")
                          for i in self.names]
        self.event_list = [os.path.join(self.event_path, f"{i + 1:06d}.h5")
                           for i in self.names]
        last = self.names[-1]
        extra = 1 if self.files_per_sample == 1 else 5
        for j in range(extra):
            self.event_list.append(
                os.path.join(self.event_path, f"{last + 2 + j:06d}.h5"))

    def __len__(self):
        return len(self.names)

    def _load_events(self, idx, offset):
        parts = [get_events_h5(self.event_list[(idx + offset + i)
                                               % len(self.event_list)])
                 for i in range(self.files_per_sample)]
        ev = np.concatenate(parts) if len(parts) > 1 else parts[0]
        if len(parts) > 1:
            ev = ev[np.argsort(ev[:, 0], kind="stable")]
        return EventSequence(ev, self.height, self.width,
                             timestamp_multiplier=1e6,
                             convert_to_relative=True)

    def __getitem__(self, idx):
        idx = idx % len(self)
        flow = np.load(self.flow_list[idx])
        if flow.shape[-1] == 2:
            flow = flow.transpose(2, 0, 1)

        seq_old = self._load_events(idx, 0)
        seq_new = self._load_events(idx, self.files_per_sample)
        vol_old = events_to_voxel_grid(seq_old, self.num_frames,
                                       normalize=True, pol=self.pol)
        vol_new = events_to_voxel_grid(seq_new, self.num_frames,
                                       normalize=True, pol=self.pol)

        hist, _, _ = np.histogram2d(
            x=seq_old.features[:, 1], y=seq_old.features[:, 2],
            bins=(self.width, self.height),
            range=[[0, self.width], [0, self.height]])
        ev_mask = hist.T > 0

        # center crop
        th, tw = self.crop
        i0 = int(round((self.height - th) / 2.0))
        j0 = int(round((self.width - tw) / 2.0))
        sl = (slice(i0, i0 + th), slice(j0, j0 + tw))

        flow_c = flow[:, sl[0], sl[1]].astype(np.float32)
        valid = (np.abs(flow_c[0]) < 1000) & (np.abs(flow_c[1]) < 1000)
        if self.sequence == "outdoor_day1":
            row_cut = max(0, 193 - i0)
            valid[row_cut:, :] = False
        return {
            "idx": self.names[idx],
            "flow": flow_c,
            "valid": valid.astype(np.float32),
            "event_volume_old": vol_old[..., sl[0], sl[1]].astype(np.float32),
            "event_volume_new": vol_new[..., sl[0], sl[1]].astype(np.float32),
            "event_valid": ev_mask[None, sl[0], sl[1]].astype(np.float32),
        }


class MvsecEventFlow_dt4(MvsecEventFlow):
    dt = "dt4"
    files_per_sample = 4
