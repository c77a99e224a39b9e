"""Train-time augmentation of (events, flow, mask) batches on the device, a
mirror of ``sdformerflow_tpu/data/augmentation.py``: random crop, horizontal
and vertical flips (with the flow's sign fixed), polarity flip and event
drop, and the rotation with flips (:func:`rotate_flip`), composed by
:func:`build_train_augmentation`.

Each transform is a plain function of its decisions (crop corner, flip or
not, keep mask), so it can be held against the JAX transform at fixed
decisions. The composition draws the decisions from an explicit CPU
``torch.Generator`` (no device synchronisation) and the event-drop mask on
the events' device. Contracts: events [B, bins, H, W] (or
[B, bins, 2, H, W]), flow [B, 2, H, W], mask [B, 1, H, W]; the crop and the
flips are shared across the batch, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..parallel.multihost import global_rows


def center_crop(events, flow, mask, size: Tuple[int, int]):
    h, w = events.shape[-2], events.shape[-1]
    th, tw = size
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return crop_at(events, flow, mask, i, j, size)


def crop_at(events, flow, mask, i: int, j: int, size: Tuple[int, int]):
    """The [th, tw] window at row ``i``, column ``j`` of every tensor."""
    th, tw = size
    sl = (..., slice(i, i + th), slice(j, j + tw))
    return events[sl], flow[sl], mask[sl]


def hflip(events, flow, mask):
    """Mirror left-right; the flow's x component changes sign."""
    flow = flow.flip(-1)
    flow = torch.cat([-flow[:, :1], flow[:, 1:]], dim=1)
    return events.flip(-1), flow, mask.flip(-1)


def vflip(events, flow, mask):
    """Mirror top-bottom; the flow's y component changes sign."""
    flow = flow.flip(-2)
    flow = torch.cat([flow[:, :1], -flow[:, 1:2], flow[:, 2:]], dim=1)
    return events.flip(-2), flow, mask.flip(-2)


def event_drop(events, keep):
    """Zero the entries where ``keep`` is False."""
    return events * keep


def rotate_flip(events, flow, mask, angle: float, hflip: bool,
                vflip: bool):
    """Rotate by ``angle`` degrees and mirror (``hflip`` / ``vflip``), the
    same transform for the whole batch: JAX ``rotation_flip``
    (``data/augmentation.py:75-113``, the reference's RandomRotationFlip)
    at fixed decisions. Output pixel (y, x) samples the input bilinearly at
    ``A @ (x, y)`` in normalized coordinates (torch ``affine_grid``'s
    convention), ``A = [[c h, -s h], [s v, c v]]`` with h, v = -1 where
    mirrored; a corner outside the frame counts as 0
    (``map_coordinates(order=1, mode="constant")``). The flow vectors then
    turn by ``A^-1``; the mask comes back as float32, as JAX's."""
    h, w = events.shape[-2], events.shape[-1]
    dev = events.device
    a = math.radians(angle)
    c, s = math.cos(a), math.sin(a)
    fh, fv = (-1.0 if hflip else 1.0), (-1.0 if vflip else 1.0)
    A = torch.tensor([[c * fh, -s * fh], [s * fv, c * fv]],
                     dtype=torch.float64)
    ys = (torch.arange(h, dtype=torch.float64) + 0.5) / h * 2.0 - 1.0
    xs = (torch.arange(w, dtype=torch.float64) + 0.5) / w * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px = (A[0, 0] * gx + A[0, 1] * gy + 1.0) * w / 2.0 - 0.5
    py = (A[1, 0] * gx + A[1, 1] * gy + 1.0) * h / 2.0 - 0.5
    x0, y0 = px.floor(), py.floor()
    corners = []     # (row index, column index, weight) of the 4 corners
    for yi, wy in ((y0, 1.0 - (py - y0)), (y0 + 1, py - y0)):
        for xi, wx in ((x0, 1.0 - (px - x0)), (x0 + 1, px - x0)):
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            corners.append((yi.clamp(0, h - 1).long().to(dev),
                            xi.clamp(0, w - 1).long().to(dev),
                            (wy * wx * inside).to(dev)))

    def sample(img):
        out = 0.0
        for yi, xi, wt in corners:
            out = out + img[..., yi, xi] * wt.to(img.dtype)
        return out

    ev, fl = sample(events), sample(flow)
    mk = sample(mask.to(torch.float32))
    Ainv = torch.linalg.inv(A).tolist()
    vx, vy = fl[:, 0], fl[:, 1]
    fl = torch.stack([Ainv[0][0] * vx + Ainv[0][1] * vy,
                      Ainv[1][0] * vx + Ainv[1][1] * vy], dim=1)
    return ev, fl, mk


def _uniform(gen) -> float:
    return float(torch.rand((), generator=gen, dtype=torch.float64))


def downsample_data(arrays, scale_factor: float):
    """Bilinearly downscale a tuple of [..., C, H, W] tensors to
    ``int(size * scale_factor)`` (JAX ``augmentation.py:116-127``, whose
    ``jax.image.resize`` filters when it downsamples)."""
    from ..ops.interpolate import resize_bilinear
    out = []
    for a in arrays:
        hw = (int(a.shape[-2] * scale_factor), int(a.shape[-1] * scale_factor))
        res = resize_bilinear(a.movedim(-3, -1), hw, antialias=True)
        out.append(res.movedim(-1, -3))
    return tuple(out)


def build_train_augmentation(augment_names, augment_prob, crop=None,
                             max_drop_rate=0.6, rotation_degrees=(0.0, 0.0),
                             group=None):
    """Compose the configured train transforms into
    ``fn(generator, events, flow, mask)``, ``generator`` a CPU
    ``torch.Generator``: "Rotation" first (:func:`rotate_flip`, the angle
    uniform in ``rotation_degrees``, each mirror with probability p, before
    the crop as in the reference's composition), then the random crop, then
    in config order "Horizontal" / "Vertical" flips (probability p each),
    "Polarity" (negate the signed voxels, p > 0 only) and "Drop" (with
    probability p, drop each entry at a rate uniform in [0,
    max_drop_rate)).

    With a data-parallel ``group`` the batch is this rank's rows of the
    global batch: the decisions, drawn per batch from a generator seeded
    alike on every rank, are the same everywhere, and the "Drop" keep mask
    is drawn at the global batch shape, of which this rank keeps its rows
    (``parallel/multihost.py:global_rows``), so R ranks augment as one
    process would."""
    names = [n.lower() for n in (augment_names or [])]
    probs = list(augment_prob or [])

    def apply(gen, events, flow, mask):
        for k, n in enumerate(names):
            if n.startswith("rotation"):
                p = probs[k] if k < len(probs) else 0.5
                lo, hi = rotation_degrees
                angle = lo + (hi - lo) * _uniform(gen)
                h_flip, v_flip = _uniform(gen) < p, _uniform(gen) < p
                events, flow, mask = rotate_flip(events, flow, mask, angle,
                                                 h_flip, v_flip)
        if crop is not None:
            th, tw = crop
            h, w = events.shape[-2], events.shape[-1]
            i = int(torch.randint(0, h - th + 1, (), generator=gen))
            j = int(torch.randint(0, w - tw + 1, (), generator=gen))
            events, flow, mask = crop_at(events, flow, mask, i, j, crop)
        for k, n in enumerate(names):
            p = probs[k] if k < len(probs) else 0.5
            if n.startswith("horizontal"):
                if _uniform(gen) <= p:
                    events, flow, mask = hflip(events, flow, mask)
            elif n.startswith("vertical"):
                if _uniform(gen) <= p:
                    events, flow, mask = vflip(events, flow, mask)
            elif n.startswith("polarity") and p > 0:
                if _uniform(gen) <= p:
                    events = -events
            elif n.startswith("drop"):
                apply_drop, u = _uniform(gen) <= p, _uniform(gen)
                if apply_drop:
                    q = (0.0 - max_drop_rate) * u + max_drop_rate
                    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
                    dgen = torch.Generator(events.device).manual_seed(seed)
                    keep = global_rows(
                        lambda shape: torch.rand(shape, generator=dgen,
                                                 device=events.device),
                        events.shape, 0, group) > q
                    events = event_drop(events, keep)
        return events, flow, mask

    return apply
