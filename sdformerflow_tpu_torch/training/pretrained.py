"""Cross-resolution and cross-window remapping of pretrained Swin
parameters, the port's copy of the numpy functions of
``sdformerflow_tpu/training/pretrained.py``: inflate a 2-D Swin(-v2)
checkpoint into the 3-D ANN encoder's shapes, re-grid bias tables and
resize position embeddings. They take and return numpy arrays under the
reference's names and layouts (which the port keeps).

Not ported: ``torch_tensor_layout_to_flax``, which converts to flax
layouts; the port has none.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.windows import relative_coords_table


def interpolate_rel_pos_bias_table(table: np.ndarray, src_window,
                                   dst_window) -> np.ndarray:
    """Bicubic-resample a v1 relative-position-bias table
    [(2wd-1)(2wh-1)(2ww-1), nH] from src_window to dst_window sizes.

    The temporal axis is resampled with nearest (it is tiny, typically 2);
    spatial axes use bicubic like the reference.
    """
    from scipy import ndimage

    sd, sh, sw = (2 * s - 1 for s in src_window)
    dd, dh, dw = (2 * d - 1 for d in dst_window)
    nh = table.shape[1]
    t = table.reshape(sd, sh, sw, nh)
    zoom = (dd / sd, dh / sh, dw / sw, 1.0)
    out = ndimage.zoom(t, zoom, order=3, mode="nearest")
    return out.reshape(-1, nh)


def geometric_relative_coords(window_size, pretrained_window_size):
    """Swin-v2 style log-spaced relative coordinates for re-gridding the cpb
    MLP input when transferring across window sizes (the cpb MLP itself is
    resolution-independent — only the coordinate table changes).
    """
    return relative_coords_table(tuple(window_size),
                                 tuple(pretrained_window_size))


def inflate_swin2d_state_dict(state_dict, *, time_patch: int, window_size,
                              rename_blocks: bool = True) -> dict:
    """Inflate a 2-D swin(-v2) checkpoint to the 3-D backbone's shapes.

    Parity: SwinTransformer3D_v2.inflate_weights
    (the reference's models/STSwinNet/swin_transformer3D_v2.py:651-707):
    - drop relative_position_index / attn_mask buffers (re-initialized);
    - patch_embed.proj.weight [O, I, kh, kw] -> [O, I, kd, kh, kw] by
      repeating over the temporal patch axis and dividing by it (mean
      inflation, preserves the response to a temporally-constant input);
    - relative_position_bias_table: bicubic-resize the (2w-1)^2 spatial
      table to (2wh'-1, 2ww'-1), then tile (2wd-1) times along rows for the
      temporal axis.

    ``rename_blocks``: 2-D ImageNet checkpoints name blocks
    ``layers.{i}.blocks.{j}``; the 3-D model uses ``swin_blocks`` — the
    reference relies on ``load_state_dict(strict=False)`` with video-swin
    style checkpoints, we rename so ImageNet checkpoints land too.
    """
    sd = {}
    for k, v in state_dict.items():
        if "relative_position_index" in k or "attn_mask" in k:
            continue
        if rename_blocks:
            k = k.replace(".blocks.", ".swin_blocks.")
        sd[k] = np.asarray(v)

    if "patch_embed.proj.weight" in sd:
        w = torch.as_tensor(sd["patch_embed.proj.weight"])
        if w.ndim == 4:
            w = (w.unsqueeze(2).repeat(1, 1, time_patch, 1, 1) / time_patch)
        sd["patch_embed.proj.weight"] = w.numpy()

    wd, wh, ww = window_size
    L2 = (2 * wh - 1) * (2 * ww - 1)
    for k in [k for k in sd if "relative_position_bias_table" in k]:
        t = torch.as_tensor(sd[k]).float()
        L1, nh = t.shape
        if L1 != L2:
            s1 = int(L1 ** 0.5)
            t = torch.nn.functional.interpolate(
                t.permute(1, 0).view(1, nh, s1, s1),
                size=(2 * wh - 1, 2 * ww - 1), mode="bicubic")
            t = t.reshape(nh, L2).permute(1, 0)
        sd[k] = t.repeat(2 * wd - 1, 1).numpy()
    return sd


def geometric_regrid_bias_table(table: np.ndarray, dst_size: int) -> np.ndarray:
    """Geometric-progression re-gridding of a square relative-position-bias
    table [S1*S1, nH] -> [dst*dst, nH] (cubic spline on the log-spaced grid).

    Parity: remap_pretrained_keys_swin
    (the reference's models/STSwinNet/load_pretrained.py:4-66). The source
    positions follow a geometric progression whose ratio q is bisected so
    the outermost source point lands just past the outermost target point;
    targets are the integer grid [-dst//2, dst//2].
    """
    from scipy.interpolate import RectBivariateSpline

    L1, nh = table.shape
    src_size = int(L1 ** 0.5)
    if src_size * src_size != L1:
        raise ValueError(f"table of {L1} rows is not square")
    if src_size == dst_size:
        return table

    def geometric_progression(a, r, n):
        return a * (1.0 - r ** n) / (1.0 - r)

    left, right = 1.01, 1.5
    while right - left > 1e-6:
        q = (left + right) / 2.0
        gp = geometric_progression(1, q, src_size // 2)
        if gp > dst_size // 2:
            right = q
        else:
            left = q

    dis, cur = [], 1.0
    for i in range(src_size // 2):
        dis.append(cur)
        cur += q ** (i + 1)
    r_ids = [-d for d in reversed(dis)]
    x = np.asarray(r_ids + [0] + dis)
    t = dst_size // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)

    out = []
    for i in range(nh):
        z = table[:, i].reshape(src_size, src_size).astype(np.float64)
        spline = RectBivariateSpline(x, x, z, kx=3, ky=3)
        out.append(spline(dx, dx).reshape(-1, 1))
    return np.concatenate(out, axis=-1).astype(table.dtype)


def interpolate_abs_pos_embed(embed: np.ndarray, dst_len: int) -> np.ndarray:
    """Bicubic resize of an absolute position embedding [1, L1, C] to
    [1, L2, C] across square token grids (load_pretrained.py:133-153)."""
    _, L1, C = embed.shape
    if L1 == dst_len:
        return embed
    s1, s2 = int(L1 ** 0.5), int(dst_len ** 0.5)
    e = torch.as_tensor(embed).float().reshape(-1, s1, s1, C).permute(0, 3, 1, 2)
    e = torch.nn.functional.interpolate(e, size=(s2, s2), mode="bicubic")
    e = e.permute(0, 2, 3, 1).flatten(1, 2)
    return e.numpy().astype(embed.dtype)


def interpolate_positional_encoding(pe: np.ndarray, dst_len: int,
                                    time_window: int = 2) -> np.ndarray:
    """Trilinear resize of the spiking-QK additive positional encoding
    [1, nH, L1, C] -> [1, nH, L2, C], treating tokens as a
    (time_window, S, S) grid (load_pretrained.py:156-176)."""
    B, nh, L1, C = pe.shape
    if L1 == dst_len:
        return pe
    s1 = int((L1 / time_window) ** 0.5)
    s2 = int((dst_len / time_window) ** 0.5)
    p = torch.as_tensor(pe).float().permute(0, 1, 3, 2).reshape(
        nh, C, time_window, s1, s1)
    p = torch.nn.functional.interpolate(p, size=(time_window, s2, s2),
                                        mode="trilinear")
    p = p.reshape(B, nh, C, dst_len).permute(0, 1, 3, 2)
    return p.numpy().astype(pe.dtype)
