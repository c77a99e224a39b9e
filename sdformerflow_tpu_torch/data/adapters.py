"""Adapters exposing the MDR/MVSEC dict datasets through the (chunk, mask,
label) triple that the train loop and the evaluation batch, the port's own
copy of ``sdformerflow_tpu/data/adapters.py``:

- MDR train uses the best-density volumes: chunk = d_event_volume_new, with
  d_event_volume_old concatenated in front along the bin axis when
  num_chunks == 2;
- MVSEC eval: chunk = event_volume_new (+ old in front when num_chunks ==
  2).

Kept quirk: with num_frames=10, num_chunks=2 the concatenated chunk has 20
bins but the model's ``num_bins`` stays 10, so the patch embed reads the
FIRST 10 bins, the old volume, as the reference and the JAX package do.
"""

from __future__ import annotations

import numpy as np


class MDRChunkAdapter:
    def __init__(self, dataset, num_chunks: int, train: bool = True):
        self.ds = dataset
        self.num_chunks = num_chunks
        self.train = train

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        s = self.ds[idx]
        if self.train:
            new = s["d_event_volume_new"]
            old = s.get("d_event_volume_old")
        else:
            new = s["event_volume_new"]
            old = s.get("event_volume_old")
        chunk = (np.concatenate([old, new], axis=0)
                 if self.num_chunks == 2 and old is not None else new)
        return chunk.astype(np.float32), s["valid"], s["flow"]


class MvsecChunkAdapter:
    """MVSEC eval adapter. Deliberately does NOT fold the dataset's
    ``event_valid`` histogram mask into the validity mask: the reference
    loaders produce it (MDR_dataloader/MVSEC.py:145-150) but no reference
    script consumes it — the eval protocol's ``metrics.mask_events`` masks
    by the ENCODED chunk's footprint instead (eval_MV_flow_SNN.py:217-219,
    implemented in training/evaluate.py::event_footprint_mask)."""

    def __init__(self, dataset, num_chunks: int):
        self.ds = dataset
        self.num_chunks = num_chunks

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        s = self.ds[idx]
        new, old = s["event_volume_new"], s["event_volume_old"]
        chunk = (np.concatenate([old, new], axis=0)
                 if self.num_chunks == 2 else new)
        return chunk.astype(np.float32), s["valid"], s["flow"]
