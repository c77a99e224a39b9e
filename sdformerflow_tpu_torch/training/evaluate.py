"""The evaluation protocol's metric machinery, a mirror of
``sdformerflow_tpu/training/evaluate.py``.

- ``mask_events``: the event mask is the nonzero footprint of the
  *encoded* chunk, the tensor the model consumed (after the polarity split,
  the nonzero min-max or std normalization and ``spike_th``), not of the
  raw chunk.
- Accumulation: per-sample metric values summed over every sample and
  divided by the total sample count at the end, so a ragged last batch
  counts its real size.
- The reference's conventions (``losses.aee_metrics``): AEE per sample;
  PE1/2/3 and outlier batch-global counts over the per-sample valid count;
  AAE one batch-global scalar, summed for a batch of B as ``AAE * B``.
"""

from __future__ import annotations

import torch

from ..losses import aae_metric, aee_metrics
from ..ops.normalization import encode_input


def event_footprint_mask(mask, x):
    """``mask`` AND the nonzero footprint of the encoded chunk ``x``.

    ``x`` [B, bins, 2, H, W]: bins and polarity are summed and the sum
    tested ``!= 0``, so a std-normalization sign cancellation counts as the
    reference counts it. ``x`` [B, bins, H, W]: the per-pixel footprint."""
    dims = (1, 2) if x.dim() == 5 else (1,)
    ev = x.sum(dim=dims) != 0
    return mask * ev[:, None].to(mask.dtype)


def make_metrics_fn(*, metric_names=("AEE",), flow_scaling=1.0,
                    mask_events=False, encoding="voxel", polarity=True,
                    norm_input="minmax", spike_th=None):
    """``fn(pred, label, mask, chunk=None) -> {name: sum over the batch's
    samples}``, 0-d tensors on the metrics' device (no host sync).

    ``chunk`` is the raw voxel chunk (before encoding, after the crop); with
    ``mask_events`` the mask is ANDed with its encoded footprint, encoded
    with the eval step's own arguments. ``chunk=None`` (the raw-events
    layout, whose chunk exists only inside the step) uses the GT mask
    alone."""
    want_aae = "AAE" in tuple(metric_names)
    kw = dict(encoding=encoding, polarity=polarity, norm_input=norm_input,
              spike_th=spike_th)

    def fn(pred, label, mask, chunk=None):
        with torch.inference_mode():
            if mask_events and chunk is not None:
                mask = event_footprint_mask(mask, encode_input(chunk, **kw))
            stats = aee_metrics(pred, label, mask, flow_scaling)
            out = {k: stats[k].sum()
                   for k in ("AEE", "PE1", "PE2", "PE3", "outlier")}
            if want_aae:
                out["AAE"] = aae_metric(pred, label, mask,
                                        flow_scaling) * pred.shape[0]
            return out

    return fn


class MetricsAccumulator:
    """Per-batch metric sums kept on their device, copied to the host once
    in :meth:`results` and divided there by the total sample count."""

    def __init__(self):
        self._pending = []
        self._samples = 0

    def append(self, sums: dict, batch_size: int):
        self._pending.append(sums)
        self._samples += int(batch_size)

    @property
    def num_batches(self):
        return len(self._pending)

    @property
    def num_samples(self):
        return self._samples

    def results(self) -> dict:
        if not self._pending:
            return {}
        keys = list(self._pending[0])
        sums = torch.stack([torch.stack([s[k] for s in self._pending])
                            for k in keys]).cpu()
        out = {k: float(v.sum()) / self._samples for k, v in zip(keys, sums)}
        out["num_batches"] = len(self._pending)
        out["num_samples"] = self._samples
        return out
