"""Supervised flow loss and metrics, a mirror of ``sdformerflow_tpu/losses.py``
(``masked_epe``, the angular, relative and cosine losses,
``sequence_loss``, ``flow_loss_supervised``, ``aee_metrics``,
``aae_metric``). Flow tensors are ``[B, 2, H, W]``, masks ``[B, 1, H, W]``
(or ``[B, H, W]``).

Under data parallelism (a ``group`` of ranks, ``parallel/multihost.py``)
each rank holds some rows of the global batch. The training losses then
return this rank's share of the global batch's loss: the valid-pixel
count and the batch size in their normalisers are the global ones, so the
shares sum over the ranks to the loss one process computes on the whole
batch, and so do their gradients.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .parallel.multihost import active, all_reduce_sum

MAX_FLOW = 400.0


def masked_epe(flow, gt_flow, mask, num_valid_px):
    """Per-sample masked average endpoint error; ``num_valid_px`` is the
    TOTAL valid count over the whole batch (reference quirk: the per-sample
    sum is divided by the global count, then averaged over batch), over
    every rank's rows under data parallelism."""
    b = flow.shape[0]
    error = torch.sqrt(((flow - gt_flow) ** 2).sum(dim=1) + 1e-8)
    error = error.reshape(b, -1) * mask.reshape(b, -1)
    return error.sum(dim=1) / (num_valid_px + 1e-9)


def _pixel_mask(mask):
    return mask.squeeze(1) if mask.dim() == 4 else mask


def _cosine(flow, gt_flow, epsilon, with_eps_in_mag):
    """Clipped cosine of the angle between ``flow`` and ``gt_flow`` per
    pixel, the epsilons placed as the reference places them."""
    add = epsilon if with_eps_in_mag else 0.0
    flow_mag = torch.sqrt((flow ** 2).sum(dim=1) + add)
    gt_mag = torch.sqrt((gt_flow ** 2).sum(dim=1) + add)
    dot = flow[:, 0] * gt_flow[:, 0] + flow[:, 1] * gt_flow[:, 1]
    cos = (dot + epsilon) / (flow_mag * gt_mag + epsilon)
    return cos.clamp(-1.0 + epsilon, 1.0 - epsilon)


def angular_loss(flow, gt_flow, mask, num_valid_px, epsilon=1e-8):
    """Masked mean angular error in radians (the reference's
    angular_loss_function)."""
    cos = _cosine(flow, gt_flow, epsilon, with_eps_in_mag=True)
    return (torch.arccos(cos) * _pixel_mask(mask)).sum() / (
        num_valid_px + 1e-9)


def relative_loss(flow, gt_flow, mask, num_valid_px, epsilon=1e-7):
    """EPE normalized by the GT magnitude (rel_loss_function)."""
    error = torch.sqrt(((flow - gt_flow) ** 2).sum(dim=1))
    gt_mag = torch.sqrt((gt_flow ** 2).sum(dim=1))
    return ((error * _pixel_mask(mask)) / (gt_mag + epsilon)).sum() / (
        num_valid_px + 1e-9)


def cosine_loss(flow, gt_flow, mask, num_valid_px, epsilon=1e-7):
    """1 - cosine similarity of the flow directions (cosine_loss_function)."""
    cos = _cosine(flow, gt_flow, epsilon, with_eps_in_mag=False)
    return ((1.0 - cos) * _pixel_mask(mask)).sum() / (num_valid_px + 1e-9)


def sequence_loss(pred_list, gt_flow, valid, gamma=0.8, max_flow=MAX_FLOW,
                  group=None):
    """RAFT-style gamma-weighted L1 sequence loss with magnitude validity,
    the mask kept per sample (the JAX package's deliberate deviation from
    the reference at batch > 1). With a data-parallel ``group``, this
    rank's share: its sums over the global element count."""
    n = len(pred_list)
    mag = torch.sqrt((gt_flow ** 2).sum(dim=1))
    valid = (valid.squeeze(1) >= 0.5) & (mag < max_flow)
    count = None
    if active(group):
        count = all_reduce_sum(gt_flow.new_full((1,), float(
            gt_flow.numel())), group)[0]
    loss = 0.0
    for i, pred in enumerate(pred_list):
        w = gamma ** (n - i - 1)
        err = valid[:, None] * (pred - gt_flow).abs()
        loss = loss + w * (err.mean() if count is None
                           else err.sum() / count)
    return loss


def flow_loss_supervised(pred_list: Sequence, gt_flow, mask, *,
                         flow_scaling=1.0, lambda_mod=1.0, gamma=None,
                         group=None):
    """Multi-res supervised flow loss (the training objective): the mean
    over the predictions of the masked EPE, meaned over the batch; the
    sequence loss when ``gamma`` is set. With a data-parallel ``group``,
    this rank's share: the valid count and the batch size of every rank's
    rows (one all-reduce)."""
    if gamma is not None:
        return sequence_loss(pred_list, gt_flow, mask, gamma, group=group)
    num_valid_px = mask.sum()
    batch = None
    if active(group):
        counts = all_reduce_sum(torch.stack([
            num_valid_px, num_valid_px.new_full((), float(mask.shape[0]))]),
            group)
        num_valid_px, batch = counts[0], counts[1]
    loss = 0.0
    for pred in pred_list:
        loss = loss + lambda_mod * masked_epe(pred * flow_scaling, gt_flow,
                                              mask, num_valid_px)
    loss = loss / len(pred_list)
    return loss.mean() if batch is None else loss.sum() / batch


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


def aae_metric(pred, gt_flow, mask, flow_scaling=1.0):
    """Masked mean angular error in degrees (the reference AAE): a scalar
    over the whole batch, divided by the batch's valid count, ``cos``
    clipped at +-(1 - 1e-7)."""
    mask = _pixel_mask(mask)
    flow = pred * flow_scaling
    flow_mag = torch.sqrt((flow ** 2).sum(dim=1)) * mask
    gt_mag = torch.sqrt((gt_flow ** 2).sum(dim=1)) * mask
    dot = flow[:, 0] * gt_flow[:, 0] + flow[:, 1] * gt_flow[:, 1]
    cos = ((dot + 1e-7) / (flow_mag * gt_mag + 1e-7)).clamp(-1.0 + 1e-7,
                                                            1.0 - 1e-7)
    aae = (torch.arccos(cos) * mask).sum() / mask.sum()
    return aae * 180.0 / math.pi
