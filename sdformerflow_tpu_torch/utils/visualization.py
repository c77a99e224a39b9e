"""Flow and event images and the DSEC test-server submission writer, a
port of ``sdformerflow_tpu/utils/visualization.py`` in numpy and the
standard library (the card's host has no cv2, imageio or matplotlib).

- :func:`flow_to_image`: HSV colour wheel (hue the angle, value the
  min-max normalized magnitude), HSV -> RGB as matplotlib converts.
- :func:`write_flow_png` / :func:`read_flow_png`: the DSEC submission
  format, a 16-bit RGB PNG with ``v * 128 + 2^15`` in channels 0 and 1 and
  channel 2 zero.
- :func:`events_to_image`: ON events green, OFF red, both yellow.
- :class:`FlowVisualizer` stores 8-bit PNGs under a run directory;
  :class:`AsyncVisWriter` runs it on a background thread.

PNGs are written and read by hand (``zlib`` and ``struct``): colour type 2
(RGB), bit depth 8 or 16 (samples big-endian), no interlace; rows are
written with filter 0 and read with any of the five filters. The JAX
package's live cv2 windows (``LiveViewer``) are not ported.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """[..., 3] HSV in [0, 1] -> RGB in [0, 1] (matplotlib's algorithm)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i %= 6
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
               (v, p, q)]
    return np.stack([np.select([i == k for k in range(6)],
                               [c[ch] for c in choices]) for ch in range(3)],
                    axis=-1)


def flow_to_image(flow_x: np.ndarray, flow_y: np.ndarray) -> np.ndarray:
    """[H, W] x2 -> [H, W, 3] uint8 colour-wheel rendering."""
    mag = np.sqrt(flow_x ** 2 + flow_y ** 2)
    min_mag = mag.min()
    mag_range = mag.max() - min_mag
    hsv = np.zeros(flow_x.shape + (3,))
    hsv[..., 0] = (np.arctan2(flow_y, flow_x) + np.pi) / (2.0 * np.pi)
    hsv[..., 1] = 1.0
    hsv[..., 2] = mag - min_mag
    if mag_range != 0.0:
        hsv[..., 2] /= mag_range
    return (255 * _hsv_to_rgb(hsv)).astype(np.uint8)


def events_to_image(event_cnt: np.ndarray) -> np.ndarray:
    """[2, H, W] per-polarity counts -> green (ON) / red (OFF) uint8 image."""
    pos, neg = event_cnt[0], event_cnt[1]
    img = np.zeros(pos.shape + (3,), np.uint8)
    img[pos > 0] = [0, 255, 0]
    img[neg > 0] = [255, 0, 0]
    img[(pos > 0) & (neg > 0)] = [255, 255, 0]
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """[H, W, 3] uint8 or uint16 -> an RGB PNG of bit depth 8 or 16."""
    if img.ndim != 3 or img.shape[-1] != 3 or img.dtype not in (np.uint8,
                                                                np.uint16):
        raise ValueError(f"need an [H, W, 3] uint8 or uint16 image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img, img.dtype.newbyteorder(">"))
    raw = np.zeros((h, 1 + rows[0].nbytes), np.uint8)   # filter byte 0
    raw[:, 1:] = rows.view(np.uint8).reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The five PNG row filters undone: [h, stride] bytes."""
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        ftype = int(data[r, 0])
        line = data[r, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for i in range(0, stride, bpp):   # left neighbour: bpp at a time
                left = cur[i - bpp:i] if i else np.zeros(bpp, np.int32)
                up = prev[i:i + bpp]
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) // 2
                else:
                    ul = prev[i - bpp:i] if i else np.zeros(bpp, np.int32)
                    pred = _paeth(left, up, ul)
                cur[i:i + bpp] = (line[i:i + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row filter {ftype} is not defined")
        out[r] = prev = cur
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An RGB PNG of bit depth 8 or 16, not interlaced -> [H, W, 3] uint8 or
    uint16."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype != 2 or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace}; only RGB 8/16 is read")
    bpp = 3 * depth // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(data.reshape(h, 1 + w * bpp), h, w * bpp, bpp)
    dtype = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    return rows.view(dtype).reshape(h, w, 3).astype(dtype.newbyteorder("="))


def write_flow_png(path: str, flow: np.ndarray):
    """DSEC submission format: [2, H, W] float flow -> 16-bit RGB PNG,
    ``v * 128 + 2^15`` in channels 0 and 1, channel 2 zero."""
    h, w = flow.shape[-2:]
    out = np.zeros((h, w, 3), np.uint16)
    out[..., 0] = (flow[0] * 128.0 + 2 ** 15).astype(np.uint16)
    out[..., 1] = (flow[1] * 128.0 + 2 ** 15).astype(np.uint16)
    write_png(path, out)


def read_flow_png(path: str):
    """Inverse of :func:`write_flow_png`: (flow [2, H, W] float32, valid
    [H, W], channel 2 nonzero)."""
    img = read_png(path).astype(np.float64)
    flow = np.stack([(img[..., 0] - 2 ** 15) / 128.0,
                     (img[..., 1] - 2 ** 15) / 128.0])
    return flow.astype(np.float32), img[..., 2].astype(bool)


class FlowVisualizer:
    """Per-sample images under ``out_dir``: the flow and GT flow as 8-bit
    colour-wheel PNGs (``flow/``, ``gtflow/``), events (``events/``), and
    the submission PNGs (``submission/``)."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.idx = 0
        for sub in ("flow", "events", "gtflow", "submission"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    def update(self, event_cnt=None, gt_flow=None, flow=None,
               submission_flow=None):
        name = f"{self.idx:09d}.png"
        for sub, arr in (("flow", flow), ("gtflow", gt_flow)):
            if arr is not None:
                a = np.asarray(arr)
                write_png(os.path.join(self.out_dir, sub, name),
                          flow_to_image(a[0], a[1]))
        if event_cnt is not None:
            write_png(os.path.join(self.out_dir, "events", name),
                      events_to_image(np.asarray(event_cnt)))
        if submission_flow is not None:
            write_flow_png(os.path.join(self.out_dir, "submission",
                                        f"{self.idx:06d}.png"),
                           np.asarray(submission_flow))
        self.idx += 1


def _host(v) -> np.ndarray:
    """A host numpy array of ``v`` (a numpy array or a tensor on any
    device)."""
    return np.asarray(v.cpu() if hasattr(v, "cpu") else v)


class AsyncVisWriter:
    """:class:`FlowVisualizer` on a background thread: ``update`` takes
    arrays or device tensors and returns at once; the thread copies them to
    the host and encodes the PNGs. A bounded queue applies backpressure;
    the worker's first exception is raised again by ``close``."""

    def __init__(self, vis: FlowVisualizer):
        import queue
        import threading
        self.vis = vis
        self._q: "queue.Queue" = queue.Queue(maxsize=4)
        self._errs: list = []
        self._end = object()

        def worker():
            while True:
                item = self._q.get()
                if item is self._end:
                    return
                try:
                    self.vis.update(**{k: _host(v) for k, v in item.items()
                                       if v is not None})
                except Exception as e:  # noqa: BLE001 - raised on close
                    self._errs.append(e)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="vis-writer")
        self._thread.start()

    def update(self, **arrays):
        self._q.put(arrays)

    def close(self):
        self._q.put(self._end)
        self._thread.join()
        if self._errs:
            raise self._errs[0]
