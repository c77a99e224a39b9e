"""The reference of a training step: the supervised multi-scale EPE loss,
AdamW as optax defines it (bias corrections at the update count, decoupled
weight decay, global-norm clipping), and the input path's decisions worked
out again from their seeds: the epoch's shuffle of the item indices and
each batch's random crop and flips."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def epoch_order(n_items: int, batch_size: int, seed: int) -> List[np.ndarray]:
    """The item indices of each batch of an epoch shuffled from ``seed``
    (numpy's ``default_rng(seed).shuffle``), the last short batch dropped."""
    order = np.arange(n_items)
    np.random.default_rng(seed).shuffle(order)
    return [order[s:s + batch_size]
            for s in range(0, n_items - batch_size + 1, batch_size)]


def _u(gen) -> float:
    return float(torch.rand((), generator=gen, dtype=torch.float64))


def augment(gen, chunk, flow, mask, names, probs, crop):
    """Random crop then, in config order, horizontal and vertical flips
    (the flow's component negated) and a polarity flip, shared by the
    batch; the decisions drawn from the CPU generator ``gen``."""
    names = [n.lower() for n in names]
    th, tw = crop
    h, w = chunk.shape[-2:]
    i = int(torch.randint(0, h - th + 1, (), generator=gen))
    j = int(torch.randint(0, w - tw + 1, (), generator=gen))
    sl = (..., slice(i, i + th), slice(j, j + tw))
    chunk, flow, mask = chunk[sl], flow[sl], mask[sl]
    for k, n in enumerate(names):
        p = probs[k] if k < len(probs) else 0.5
        if n.startswith("horizontal"):
            if _u(gen) <= p:
                chunk, mask = chunk.flip(-1), mask.flip(-1)
                flow = flow.flip(-1) * torch.tensor(
                    [-1.0, 1.0], device=flow.device).view(1, 2, 1, 1)
        elif n.startswith("vertical"):
            if _u(gen) <= p:
                chunk, mask = chunk.flip(-2), mask.flip(-2)
                flow = flow.flip(-2) * torch.tensor(
                    [1.0, -1.0], device=flow.device).view(1, 2, 1, 1)
        elif n.startswith("polarity") and p > 0:
            if _u(gen) <= p:
                chunk = -chunk
        elif n:
            raise ValueError(f"no reference for the augmentation {n!r}")
    return chunk, flow, mask


def flow_loss(flows, label, mask):
    """The mean over the predictions of the per-sample masked EPE summed
    and divided by the batch's valid count, meaned over the batch."""
    n_valid = mask.sum()
    total = 0.0
    for f in flows:
        err = torch.sqrt(((f - label) ** 2).sum(1) + 1e-8)
        b = f.shape[0]
        total = total + (err.reshape(b, -1) * mask.reshape(b, -1)).sum(1) \
            / (n_valid + 1e-9)
    return (total / len(flows)).mean()


class AdamW:
    """optax ``adamw``: m, v moments, bias corrections at the update count,
    ``u = m_hat / (sqrt(v_hat) + eps) + wd p``, ``p -= lr u``; gradients
    clipped by their global norm at ``clip`` when it is set."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, wd, clip=None,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params = params
        self.lr, self.wd, self.clip = lr, wd, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values()))
        scale = 1.0
        if self.clip is not None and norm >= self.clip:
            scale = self.clip / norm
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n] * scale
            self.m[n].mul_(self.b1).add_(g * (1 - self.b1))
            self.v[n].mul_(self.b2).add_(g * g * (1 - self.b2))
            u = (self.m[n] / bc1) / (torch.sqrt(self.v[n] / bc2) + self.eps)
            p.sub_(self.lr * (u + self.wd * p))
        return norm
