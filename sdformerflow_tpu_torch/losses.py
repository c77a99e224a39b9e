"""Flow metrics, a mirror of ``sdformerflow_tpu/losses.py:aee_metrics``."""

from __future__ import annotations

import torch


def aee_metrics(pred, gt_flow, mask, flow_scaling=1.0):
    """dict(AEE, PE1, PE2, PE3, outlier) with the reference's conventions:
    AEE per sample; PE*/outlier summed over the batch and divided by the
    per-sample valid count. ``pred``/``gt_flow`` [B, 2, H, W], ``mask``
    [B, 1, H, W] or [B, H, W]."""
    b = pred.shape[0]
    flow = pred * flow_scaling
    flow_mag = torch.sqrt((flow ** 2).sum(dim=1)).reshape(b, -1)
    error = torch.sqrt(((flow - gt_flow) ** 2).sum(dim=1)).reshape(b, -1)
    m = mask.reshape(b, -1).to(error.dtype)
    error = error * m
    flow_mag = flow_mag * m
    num_valid = m.sum(dim=1)
    aee = error.sum(dim=1) / (num_valid + 1e-9)
    outliers = (error > 3.0) & (error > 0.05 * flow_mag)
    return {"AEE": aee,
            "PE1": (error > 1.0).sum() / (num_valid + 1e-9),
            "PE2": (error > 2.0).sum() / (num_valid + 1e-9),
            "PE3": (error > 3.0).sum() / (num_valid + 1e-9),
            "outlier": outliers.sum() / (num_valid + 1e-9)}
