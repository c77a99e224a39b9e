"""The port's raw-data preparation against the JAX package's scripts on the
same trees, on the CPU: ``preprocess_dsec`` against
``scripts/preprocess_dsec.py`` and ``encode_mvsec`` against
``scripts/encode_mvsec.py``.

The DSEC tree (written by h5py, ``events.h5`` chunked with gzip and
shuffle) holds two sequences at 480x640: three 100 ms GT windows with
``ms_to_idx`` and a non-zero ``t_offset``, and two without ``ms_to_idx``
(the index rebuilt). Its rectify map is not the identity: it sends events
to x or y in (-1, 0), where truncation toward zero gives corner 1 a
negative weight, and past 639 / 479. The voxel grids (signed and
polarities; the port with ``--device cpu``, K3's plain twin, JAX's jitted
XLA scatter) agree within 1e-5 of the largest |value| (the scatters sum in
other orders); cnt, list, GT flow, masks and the split CSVs are
equal; the host voxel equals JAX's on a canvas wide enough that
nothing wraps (the port drops the events past the frame). MVSEC:
``encode_events`` / ``generate_flowgt`` at dt 1 and 4 on the same arrays
and GT file, and ``main`` on a raw
``_data.hdf5`` h5py writes chunked with gzip: every event row and GT flow
equal.
"""

import filecmp
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sdformerflow_tpu.data import loader_utils as j_lu
from sdformerflow_tpu_torch import encode_mvsec, preprocess_dsec as T
from sdformerflow_tpu_torch.data import loader_utils as lu
from sdformerflow_tpu_torch.utils.visualization import write_png

from torch_port_harness import one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")
pytest.importorskip("cv2")      # JAX's create_flow_maps reads the PNGs

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import encode_mvsec as J_MV  # noqa: E402
import preprocess_dsec as J  # noqa: E402

SEQ_A, SEQ_B = "zurich_city_90_a", "zurich_city_91_b"
H, W = T.HEIGHT, T.WIDTH
T_OFFSET = 48_000_000_000
GRID_TOL = 1e-5


def rectify_map(rng):
    """x' = 1.004 x - 0.6 + a wave + jitter, y' alike: column and row 0
    land in (-1, 0), the last ones at 640 / 480 and past."""
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float64)
    rx = 1.004 * gx - 0.6 + 0.3 * np.sin(gy / 37.0)
    ry = 1.005 * gy - 0.55 + 0.3 * np.cos(gx / 41.0)
    jitter = rng.uniform(-0.05, 0.05, (H, W, 2))
    return (np.stack([rx, ry], -1) + jitter).astype(np.float32)


def write_sequence(root, seq, windows, rng, with_index):
    n = 3000 * windows
    t = np.sort(rng.integers(0, 100_000 * windows, n)).astype(np.int64)
    # a tenth of the events on the first and last columns and rows of the
    # sensor, so that every window hits the map's edges (outside the
    # frame, or in (-1, 0))
    x = rng.integers(0, W, n).astype(np.uint16)
    y = rng.integers(0, H, n).astype(np.uint16)
    for a, n_px in ((x, W), (y, H)):
        edge = rng.random(n) < 0.1
        a[edge] = rng.choice([0, 1, n_px - 1], edge.sum())
    p = rng.integers(0, 2, n).astype(np.uint8)
    ev = root / "train_events" / seq / "events" / "left"
    ev.mkdir(parents=True)
    with h5py.File(ev / "events.h5", "w") as f:
        for k, v in (("p", p), ("x", x), ("y", y), ("t", t)):
            f.create_dataset(f"events/{k}", data=v, chunks=(1024,),
                             compression="gzip", shuffle=True)
        if with_index:
            ms = np.arange(100 * windows + 1)
            f.create_dataset("ms_to_idx", data=np.searchsorted(
                t, ms * 1000).astype(np.uint64))
            f.create_dataset("t_offset", data=np.int64(T_OFFSET))
    offset = T_OFFSET if with_index else 0
    with h5py.File(ev / "rectify_map.h5", "w") as f:
        f.create_dataset("rectify_map", data=rectify_map(rng))
    flow = root / "train_optical_flow" / seq / "flow"
    (flow / "forward").mkdir(parents=True)
    bounds = offset + 100_000 * np.arange(windows + 1)
    np.savetxt(flow / "forward_timestamps.txt",
               np.stack([bounds[:-1], bounds[1:]], 1), delimiter=",",
               fmt="%d")
    for i in range(windows):
        img = rng.integers(0, 2 ** 16, (H, W, 3)).astype(np.uint16)
        img[..., 2] = rng.random((H, W)) < 0.7
        write_png(str(flow / "forward" / f"{i:06d}.png"), img)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same raw tree twice (JAX's outputs, the port's outputs), each
    prepared in every mode by its own side."""
    roots = {}
    for side in ("jax", "port"):
        root = tmp_path_factory.mktemp(side)
        rng = np.random.default_rng(0)
        write_sequence(root, SEQ_A, 3, rng, with_index=True)
        write_sequence(root, SEQ_B, 2, rng, with_index=False)
        roots[side] = root
    for seq in (SEQ_A, SEQ_B):
        for mode, kw in (("voxel", {}), ("voxel", dict(signed=False)),
                         ("cnt", {}), ("list", {})):
            J.process_sequence(str(roots["jax"]), seq, mode, 10, **kw)
            if mode != "voxel" or kw:
                T.process_sequence(str(roots["port"]), seq, mode, 10,
                                   device="cpu", **kw)
    J.write_split_csvs(str(roots["jax"]), [SEQ_A], [SEQ_B])
    # the port's voxel mode and lists through its entry point
    T.main(["--root", str(roots["port"]), "--sequence", SEQ_B, "--device",
            "cpu"])
    records = T.main(["--root", str(roots["port"]), "--sequence", SEQ_A,
                      "--device", "cpu", "--make_lists", "--valid_seqs",
                      SEQ_B])
    return roots, records


def outputs(root, sub):
    base = Path(root) / "saved_flow_data"
    return sorted((base / sub).rglob("*.npy"))


@pytest.mark.parametrize("sub", ["10bins", "10bins_pol"])
def test_device_voxel_grids_match_jax(trees, sub):
    roots, records = trees
    want = outputs(roots["jax"], f"event_tensors/{sub}")
    got = outputs(roots["port"], f"event_tensors/{sub}")
    assert [p.name for p in got] == [p.name for p in want]
    assert len(got) == 5
    for g, w in zip(got, want):
        g, w = np.load(g), np.load(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g - w).max() <= GRID_TOL * scale, g.shape
    assert [r["window"] for r in records[SEQ_A]] == [1, 2, 3]
    assert all(r["events"] > 2000 and r["voxel_ms"] >= 0
               for r in records[SEQ_A])


def test_rectified_events_leave_the_frame(trees):
    roots, _ = trees
    for seq in (SEQ_A, SEQ_B):
        for path in outputs(roots["port"], f"event_tensors/10lists/left/"
                            f"{seq}"):
            ev = np.load(path, allow_pickle=True)[0]
            for k, n in (("x", W), ("y", H)):
                v = ev[k]
                assert v.dtype == np.float32
                assert ((v > -1) & (v < 0)).any() and (v > n - 1).any()


@pytest.mark.parametrize("sub", ["event_tensors/10frames", "gt_tensors",
                                 "mask_tensors"])
def test_cnt_gt_and_masks_equal_jax(trees, sub):
    roots, _ = trees
    want = outputs(roots["jax"], sub)
    got = outputs(roots["port"], sub)
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 5
    for g, w in zip(got, want):
        g, w = np.load(g), np.load(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    if sub.endswith("10frames"):
        assert 0 < np.load(got[0]).sum() < 3000


def test_event_lists_equal_jax(trees):
    roots, _ = trees
    want = outputs(roots["jax"], "event_tensors/10lists")
    got = outputs(roots["port"], "event_tensors/10lists")
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 5
    for g, w in zip(got, want):
        g = np.load(g, allow_pickle=True)[0]
        w = np.load(w, allow_pickle=True)[0]
        assert sorted(g) == sorted(w) == ["p", "t", "x", "y"]
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


def test_split_csvs_equal_jax(trees):
    roots, records = trees
    lists = [Path(p).name for p, _ in records["lists"]]
    assert lists == ["train_split_seq.csv", "train_split_doubleseq.csv",
                     "valid_split_seq.csv", "valid_split_doubleseq.csv"]
    assert [n for _, n in records["lists"]] == [3, 2, 2, 1]
    for name in lists:
        a, b = (Path(r) / "saved_flow_data" / "sequence_lists" / name
                for r in (roots["jax"], roots["port"]))
        assert filecmp.cmp(a, b, shallow=False), name


def test_host_voxel_equals_jax_on_a_wider_canvas(trees, tmp_path):
    """``--host``: JAX's numpy voxelizer indexes x + W y, so an event the
    map sends past the frame lands in another pixel, or past the grid's
    end (IndexError); the port's drops it. The reference is JAX's
    voxelizer on a canvas 8 px wider and taller, where nothing wraps,
    cropped to the frame, on the events JAX's slicer, map and time
    normalization give."""
    roots, _ = trees
    root = tmp_path / "port"
    for sub in ("train_events", "train_optical_flow"):
        shutil.copytree(roots["port"] / sub / SEQ_B, root / sub / SEQ_B)
    T.process_sequence(str(root), SEQ_B, "voxel", 5, on_device=False)
    got = outputs(root, "event_tensors/05bins")
    assert len(got) == 2
    ev_dir = roots["jax"] / "train_events" / SEQ_B / "events" / "left"
    stamps = np.loadtxt(roots["jax"] / "train_optical_flow" / SEQ_B / "flow"
                        / "forward_timestamps.txt", delimiter=",",
                        dtype="int64")
    with h5py.File(ev_dir / "events.h5", "r") as f, \
            h5py.File(ev_dir / "rectify_map.h5", "r") as rf:
        slicer, rectmap = J.EventSlicer(f), rf["rectify_map"][()]
        for path, (t_beg, t_end) in zip(got, stamps):
            ev = slicer.get_events(int(t_beg), int(t_end))
            xy = J.rectify_events(ev["x"], ev["y"], rectmap)
            assert (xy[:, 0] >= W).any() and (xy[:, 1] >= H).any()
            t = (ev["t"] - ev["t"][0]).astype("float32")
            t = t / t[-1]
            seq = j_lu.EventSequence(np.stack(
                [t, xy[:, 0], xy[:, 1], ev["p"].astype(np.float32)], 1),
                H + 8, W + 8)
            want = j_lu.events_to_voxel_grid(seq, 5, normalize=False,
                                             pol=True)[:, :H, :W]
            g = np.load(path)
            assert g.shape == (5, H, W) and np.abs(want).max() > 0
            assert g.dtype == want.dtype and np.array_equal(g, want)


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        T.main(["--root", str(tmp_path), "--sequence", SEQ_A])


# ------------------------------------------------------------------ MVSEC

MV_H, MV_W, FRAMES = 26, 35, 48


def mvsec_arrays(seed):
    """Raw DAVIS rows (x, y, ts, p) over FRAMES image frames of ~32 ms, the
    frames' event indices and timestamps, and 20 Hz distorted GT flow
    [M, 2, H, W] reaching past the last frame."""
    rng = np.random.default_rng(seed)
    ts = 1.4e9 + 0.032 * np.arange(FRAMES) + rng.uniform(0, 1e-3, FRAMES)
    n = 200 * FRAMES
    t = np.sort(rng.uniform(ts[0] - 0.03, ts[-1], n))
    raw = np.stack([rng.integers(0, MV_W, n), rng.integers(0, MV_H, n), t,
                    rng.choice([-1.0, 1.0], n)], 1).astype(np.float64)
    inds = np.searchsorted(t, ts).astype(np.int64)
    gt_ts = ts[0] - 0.05 + 0.05 * np.arange(int(0.032 * FRAMES / 0.05) + 4)
    gy, gx = np.mgrid[0:MV_H, 0:MV_W] / np.array([MV_H, MV_W])[:, None, None]
    a = rng.uniform(-20, 20, (len(gt_ts), 4, 1, 1))
    flow = np.stack([a[:, 0] * gx + a[:, 1] * gy,
                     a[:, 2] * gx - a[:, 3] * gy], 1).astype(np.float32)
    return raw, inds, ts, flow, gt_ts


def write_gt(path, flow, gt_ts, **kw):
    with h5py.File(path, "w") as f:
        f.create_dataset("davis/left/flow_dist", data=flow, **kw)
        f.create_dataset("davis/left/flow_dist_ts", data=gt_ts)


def compare_mvsec(want_dir, got_dir):
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) and names
    for name in names:
        w, g = os.path.join(want_dir, name), os.path.join(got_dir, name)
        if name.endswith(".h5"):
            rows = lu.get_events_h5(g)
            assert rows.tobytes() == lu.get_events_h5(w).tobytes(), name
        else:
            assert np.load(g).tobytes() == np.load(w).tobytes(), name
    return names


@pytest.mark.parametrize("dt", [1, 4])
def test_encode_events_and_flowgt_equal_jax(tmp_path, dt):
    raw, inds, ts, flow, gt_ts = mvsec_arrays(dt)
    gt_file = str(tmp_path / "gt.hdf5")
    write_gt(gt_file, flow, gt_ts)
    for side, mod in (("jax", J_MV), ("port", encode_mvsec)):
        mod.encode_events(raw, inds, ts, str(tmp_path / side / "event"), dt)
        mod.generate_flowgt(gt_file, ts, str(tmp_path / side / "gt"), dt)
    events = compare_mvsec(tmp_path / "jax" / "event",
                           tmp_path / "port" / "event")
    # frame 0 is skipped (inds[-1] >= 0: the negative-index quirk)
    assert events[0] == "000001.h5"
    assert len(events) == FRAMES - 1 - (dt - 1)
    gt = compare_mvsec(tmp_path / "jax" / "gt", tmp_path / "port" / "gt")
    assert len(gt) > 10 and np.abs(np.load(
        tmp_path / "port" / "gt" / gt[0])).max() > 0


def test_encode_mvsec_main_on_a_chunked_gzip_file(tmp_path, monkeypatch):
    raw, inds, ts, flow, gt_ts = mvsec_arrays(7)
    seq = "indoor_flying1"
    src = tmp_path / "raw" / seq
    src.mkdir(parents=True)
    with h5py.File(src / f"{seq}_data.hdf5", "w") as f:
        left = f.create_group("davis/left")
        left.create_dataset("events", data=raw, chunks=(1000, 4),
                            compression="gzip")
        left.create_dataset("image_raw_event_inds", data=inds, chunks=(16,),
                            compression="gzip")
        left.create_dataset("image_raw_ts", data=ts)
        left.create_dataset("image_raw", data=np.zeros(
            (FRAMES, MV_H, MV_W), np.uint8), chunks=(1, MV_H, MV_W),
            compression="lzf")     # never read: the port refuses lzf
    write_gt(src / f"{seq}_gt.hdf5", flow, gt_ts, chunks=(1, 2, MV_H, MV_W),
             compression="gzip", shuffle=True)
    for dt in ("1", "4"):
        argv = ["--data_dir", str(tmp_path / "raw"), "--sequence", seq,
                "--dt", dt]
        monkeypatch.setattr(sys, "argv", ["encode_mvsec.py", "--out_dir",
                                          str(tmp_path / "jax")] + argv)
        J_MV.main()
        encode_mvsec.main(["--out_dir", str(tmp_path / "port")] + argv)
    for sub in ("event", "flowgt_dt1", "flowgt_dt4"):
        compare_mvsec(tmp_path / "jax" / seq / sub,
                      tmp_path / "port" / seq / sub)
