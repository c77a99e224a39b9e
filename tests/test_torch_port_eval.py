"""PyTorch port vs the JAX package: the evaluation protocol's metrics, the
config merge and the submission PNGs.

Every loss and metric of ``losses.py`` and ``make_metrics_fn`` with
``MetricsAccumulator`` against the JAX functions on the same float64
inputs (``rtol=1e-12``): the GT mask alone, the encoded chunk's footprint
(min-max and std normalization) and ``chunk=None``, batches of 1 and 2 and
a ragged last batch. ``merge_eval_config`` equal to JAX's on the repo's
configs. The hand-written PNGs decoded by cv2 (JAX's reader) and cv2's
PNGs, every row filter, read by the port.
"""

import os
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu import losses as j_losses
from sdformerflow_tpu.training import config as j_config
from sdformerflow_tpu.training import evaluate as j_evaluate
from sdformerflow_tpu.utils import visualization as j_vis
from sdformerflow_tpu_torch import losses
from sdformerflow_tpu_torch.training import config as t_config
from sdformerflow_tpu_torch.training import evaluate
from sdformerflow_tpu_torch.utils import visualization as vis

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _flows(rng, b, h=12, w=16):
    """(pred, label, mask [B, 1, H, W] of 0/1): a quarter of the pixels
    nearly parallel to the label (acos near its clip), some zero flows."""
    label = rng.normal(0, 3, (b, 2, h, w))
    pred = label + rng.normal(0, 1.5, (b, 2, h, w))
    near = rng.random((b, 1, h, w)) < 0.25
    pred = np.where(near, label * rng.uniform(0.5, 2, (b, 1, h, w)), pred)
    pred[:, :, 0, :3] = 0.0
    mask = (rng.random((b, 1, h, w)) < 0.7).astype(np.float64)
    return pred, label, mask


def _chunk(rng, b, bins=4, h=12, w=16):
    c = rng.normal(0, 1, (b, bins, h, w)) * (rng.random((b, bins, h, w))
                                             < 0.3)
    c[:, :, 5] = 0.0                 # an empty row: outside the footprint
    c[:, 0, 2, 2], c[:, 1, 2, 2] = 0.7, -0.7    # sign cancellation
    return c


@pytest.mark.parametrize("mask_dims", [4, 3])
@pytest.mark.parametrize("name", ["angular_loss", "relative_loss",
                                  "cosine_loss"])
def test_losses_match_jax_f64(name, mask_dims):
    rng = np.random.default_rng(1)
    pred, label, mask = _flows(rng, 2)
    if mask_dims == 3:
        mask = mask[:, 0]
    n = mask.sum()
    with jax.enable_x64(True):
        want = float(getattr(j_losses, name)(
            jnp.asarray(pred), jnp.asarray(label), jnp.asarray(mask), n))
    got = float(getattr(losses, name)(
        torch.from_numpy(pred), torch.from_numpy(label),
        torch.from_numpy(mask), n))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("scaling", [1.0, 0.5])
@pytest.mark.parametrize("b", [1, 2])
def test_aee_and_aae_match_jax_f64(b, scaling):
    rng = np.random.default_rng(2 + b)
    pred, label, mask = _flows(rng, b)
    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in (pred, label, mask)]
        want = {k: np.asarray(v) for k, v in
                j_losses.aee_metrics(*args, scaling).items()}
        want["AAE"] = np.asarray(j_losses.aae_metric(*args, scaling))
    targs = [torch.from_numpy(a) for a in (pred, label, mask)]
    got = losses.aee_metrics(*targs, scaling)
    got["AAE"] = losses.aae_metric(*targs, scaling)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("norm_input", ["minmax", "std"])
@pytest.mark.parametrize("masking", ["gt", "events", "events_chunk_none"])
def test_metrics_fn_and_accumulator_match_jax_f64(masking, norm_input, b):
    """Three batches, the last ragged when b == 2 (sizes b, b, 1)."""
    rng = np.random.default_rng(10 + b)
    batches = []
    for size in (b, b, 1):
        pred, label, mask = _flows(rng, size)
        batches.append((pred, label, mask, _chunk(rng, size)))
    kw = dict(metric_names=("AEE", "AAE"), flow_scaling=1.0,
              mask_events=masking != "gt", norm_input=norm_input)
    no_chunk = masking == "events_chunk_none"
    with jax.enable_x64(True):
        fn = j_evaluate.make_metrics_fn(**kw)
        acc = j_evaluate.MetricsAccumulator()
        for pred, label, mask, chunk in batches:
            acc.append(fn(jnp.asarray(pred), jnp.asarray(label),
                          jnp.asarray(mask),
                          None if no_chunk else jnp.asarray(chunk)),
                       pred.shape[0])
        want = acc.results()
    fn, acc = evaluate.make_metrics_fn(**kw), evaluate.MetricsAccumulator()
    for pred, label, mask, chunk in batches:
        acc.append(fn(*(torch.from_numpy(a) for a in (pred, label, mask)),
                      None if no_chunk else torch.from_numpy(chunk)),
                   pred.shape[0])
    got = acc.results()
    assert got["num_samples"] == 2 * b + 1 and got["num_batches"] == 3
    assert acc.num_batches == 3 and acc.num_samples == 2 * b + 1
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    if masking == "events":        # the footprint moved the metrics
        fn_gt = evaluate.make_metrics_fn(**{**kw, "mask_events": False})
        pred, label, mask, chunk = (torch.from_numpy(a) for a in batches[0])
        assert float(fn_gt(pred, label, mask)["AEE"]) != float(
            fn(pred, label, mask, chunk)["AEE"])


@pytest.mark.parametrize("dims", [5, 4])
def test_event_footprint_mask_matches_jax(dims):
    rng = np.random.default_rng(4)
    x = _chunk(rng, 2)
    if dims == 5:
        x = np.stack([x, -x * (rng.random(x.shape) < 0.5)], axis=2)
    mask = (rng.random((2, 1, 12, 16)) < 0.8).astype(np.float64)
    with jax.enable_x64(True):
        want = np.asarray(j_evaluate.event_footprint_mask(jnp.asarray(mask),
                                                          jnp.asarray(x)))
    got = evaluate.event_footprint_mask(torch.from_numpy(mask),
                                        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum()


@pytest.mark.parametrize("train,ev", [
    ("train_dsec_sdformerflow_en4.yaml", "valid_dsec.yaml"),
    ("test_tiny_snn.yaml", "valid_dsec.yaml"),
    ("train_mdr_sdformerflow.yaml", "eval_mvsec.yaml")])
def test_merge_eval_config_matches_jax(train, ev):
    t, e = (os.path.join(CONFIGS, f) for f in (train, ev))
    want = j_config.merge_eval_config(j_config.load_config(t),
                                      j_config.load_config(e))
    got = t_config.merge_eval_config(t_config.load_config(t),
                                     t_config.load_config(e))
    assert got == want
    assert got["loader"]["crop"] == want["loader"]["crop"]


# ------------------------------------------------------------------ PNGs

def test_submission_png_decodes_through_jax_reader(tmp_path):
    rng = np.random.default_rng(5)
    flow = rng.normal(0, 30, (2, 30, 41)).astype(np.float32)
    flow[:, 0, 0] = 0.0
    path = str(tmp_path / "ours.png")
    vis.write_flow_png(path, flow)
    got, valid = j_vis.read_flow_png(path)           # cv2
    assert np.abs(got - flow).max() < 1 / 128 and not valid.any()
    theirs = str(tmp_path / "theirs.png")
    j_vis.write_flow_png(theirs, flow)
    np.testing.assert_array_equal(vis.read_flow_png(theirs)[0], got)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4])
def test_png_reader_every_row_filter_matches_cv2(tmp_path, dtype, row_filter):
    """A PNG whose rows carry ``row_filter`` (the first row filter 0),
    filtered as the PNG specification defines, read by cv2 and the port."""
    rng = np.random.default_rng(6)
    h, w = 7, 9
    img = rng.integers(0, np.iinfo(dtype).max, (h, w, 3)).astype(dtype)
    raw = np.ascontiguousarray(img, img.dtype.newbyteorder(">")).view(
        np.uint8).reshape(h, -1).astype(np.int64)
    bpp, rows, prev = 3 * img.dtype.itemsize, [], np.zeros(raw.shape[1],
                                                           np.int64)
    for r in range(h):
        ftype = row_filter if r else 0
        left = np.concatenate([np.zeros(bpp, np.int64), raw[r, :-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        pred = [0, left, prev, (left + prev) // 2, paeth][ftype]
        rows.append(np.concatenate([[ftype], (raw[r] - pred) & 0xFF]))
        prev = raw[r]
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, 2, 0, 0, 0)
    data = zlib.compress(np.asarray(rows, np.uint8).tobytes())
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + vis._chunk(b"IHDR", ihdr)
                + vis._chunk(b"IDAT", data) + vis._chunk(b"IEND", b""))
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(want, img)
    got = vis.read_png(path)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_writer_decodes_through_cv2(tmp_path, dtype):
    rng = np.random.default_rng(7)
    img = rng.integers(0, np.iinfo(dtype).max, (5, 11, 3)).astype(dtype)
    vis.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "w.png"), cv2.IMREAD_UNCHANGED)[..., ::-1],
        img)
    cv2.imwrite(str(tmp_path / "c.png"), img[..., ::-1])   # adaptive filters
    np.testing.assert_array_equal(vis.read_png(str(tmp_path / "c.png")), img)


def test_flow_and_event_images_match_jax():
    rng = np.random.default_rng(8)
    fx, fy = rng.normal(0, 5, (2, 40, 50))
    got = vis.flow_to_image(fx, fy).astype(int)
    assert np.abs(got - j_vis.flow_to_image(fx, fy)).max() <= 1
    zero = np.zeros((4, 5))
    np.testing.assert_array_equal(vis.flow_to_image(zero, zero),
                                  j_vis.flow_to_image(zero, zero))
    cnt = rng.integers(0, 2, (2, 6, 7))
    np.testing.assert_array_equal(vis.events_to_image(cnt),
                                  j_vis.events_to_image(cnt))


def test_async_vis_writer_writes_and_raises(tmp_path):
    flow = torch.ones(2, 6, 8)
    writer = vis.AsyncVisWriter(vis.FlowVisualizer(str(tmp_path)))
    writer.update(flow=flow, gt_flow=flow.numpy(), submission_flow=flow)
    writer.close()
    assert sorted(os.listdir(tmp_path / "flow")) == ["000000000.png"]
    np.testing.assert_array_equal(
        vis.read_flow_png(str(tmp_path / "submission" / "000000.png"))[0],
        flow.numpy())
    assert vis.read_png(str(tmp_path / "gtflow" / "000000000.png")).shape \
        == (6, 8, 3)
    bad = vis.AsyncVisWriter(vis.FlowVisualizer(str(tmp_path)))
    bad.update(flow=np.zeros((2, 3)))       # a flow of one row of pixels
    with pytest.raises(ValueError, match="image"):
        bad.close()
