"""The port's numpy HDF5 reader and writer (``data/hdf5.py``) against h5py
and the JAX package's ``get_events_h5`` / ``write_events_h5``.

- The reader on files h5py writes: JAX's writer at 0, 1 and 10^4 rows;
  permuted columns; pandas/PyTables-style attributes on the group and the
  datasets, enough that libhdf5 moves messages to a continuation block; a
  compact dataset; integer and float32 blocks.
- The writer read back bitwise by h5py and by JAX's ``get_events_h5``.
- A ``ValueError`` naming the feature for what the subset leaves out:
  the fletcher32 and lzf filters, big-endian data, superblock version 3,
  a user block; and for a truncated file or a header continuation loop.
  (Chunked, deflate and shuffle storage is read: test_torch_port_hdf5_raw.)
"""

import struct

import h5py
import numpy as np
import pytest

from sdformerflow_tpu.data import loader_utils as j_lu
from sdformerflow_tpu_torch.data import hdf5
from sdformerflow_tpu_torch.data import loader_utils as lu

NAMES = np.array([b"ts", b"x", b"y", b"p"])


def events(rng, n):
    return np.stack([np.sort(rng.uniform(0, 0.05, n)),
                     rng.integers(0, 346, n).astype(np.float64),
                     rng.integers(0, 260, n).astype(np.float64),
                     rng.choice([0.0, 1.0], n)], axis=1)


@pytest.mark.parametrize("rows", [0, 1, 10 ** 4])
def test_reader_reads_jax_writer(tmp_path, rows):
    data = events(np.random.default_rng(rows), rows)
    path = str(tmp_path / "w.h5")
    j_lu.write_events_h5(path, data)
    cols, vals = hdf5.read_event_block(path)
    assert cols == ["ts", "x", "y", "p"]
    assert vals.dtype == np.float64 and vals.shape == (rows, 4)
    np.testing.assert_array_equal(vals, data)
    np.testing.assert_array_equal(lu.get_events_h5(path),
                                  j_lu.get_events_h5(path))


def test_reader_takes_permuted_columns(tmp_path):
    data = events(np.random.default_rng(1), 50)
    order = ["p", "ts", "y", "x"]
    perm = data[:, [["ts", "x", "y", "p"].index(c) for c in order]]
    path = str(tmp_path / "perm.h5")
    j_lu.write_events_h5(path, perm, columns=order)
    assert hdf5.read_event_block(path)[0] == order
    np.testing.assert_array_equal(lu.get_events_h5(path), data)
    np.testing.assert_array_equal(j_lu.get_events_h5(path), data)


def pandas_attrs(obj, attrs):
    for k, v in attrs.items():
        obj.attrs[k] = np.bytes_(v) if isinstance(v, str) else v


def test_reader_follows_continuation_blocks(tmp_path):
    """The attributes PyTables writes for a pandas fixed-format frame
    overflow the group's first header chunk: libhdf5 reports 2 chunks."""
    data = events(np.random.default_rng(2), 300)
    path = str(tmp_path / "attrs.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("myDataset")
        pandas_attrs(g, dict(
            CLASS="GROUP", TITLE="", VERSION="1.0", pandas_type="frame",
            pandas_version="0.15.2", encoding="UTF-8", errors="strict",
            axis0_variety="regular", axis1_variety="regular",
            block0_items_variety="regular", ndim=np.int64(2),
            nblocks=np.int64(1)))
        for name, a in (("axis0", NAMES), ("axis1", np.arange(300)),
                        ("block0_items", NAMES), ("block0_values", data)):
            d = g.create_dataset(name, data=a)
            pandas_attrs(d, dict(CLASS="ARRAY", FLAVOR="numpy", TITLE="",
                                 VERSION="2.4", kind="string", name="N.",
                                 transposed=np.int64(1)))
        chunks = [h5py.h5o.get_info(o.id).hdr.nchunks
                  for o in (g, g["axis0"], g["block0_values"])]
    assert chunks[0] > 1 and chunks[1] > 1, chunks
    cols, vals = hdf5.read_event_block(path)
    assert cols == ["ts", "x", "y", "p"]
    np.testing.assert_array_equal(vals, data)


def test_reader_takes_a_compact_dataset(tmp_path):
    data = events(np.random.default_rng(3), 20)
    path = str(tmp_path / "compact.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("myDataset")
        g.create_dataset("block0_items", data=NAMES)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(g.id, b"block0_values", h5py.h5t.IEEE_F64LE,
                             h5py.h5s.create_simple(data.shape), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        assert g["block0_values"].id.get_create_plist().get_layout() == \
            h5py.h5d.COMPACT
    np.testing.assert_array_equal(hdf5.read_event_block(path)[1], data)


@pytest.mark.parametrize("dtype", ["<i8", "<u2", "<i4", "<f4", "<f8"])
def test_reader_takes_integer_and_float_blocks(tmp_path, dtype):
    data = (events(np.random.default_rng(4), 30) * 100).astype(dtype)
    path = str(tmp_path / "ints.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("myDataset")
        g.create_dataset("block0_items", data=NAMES)
        g.create_dataset("block0_values", data=data)
    vals = hdf5.read_event_block(path)[1]
    assert vals.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(vals, data)


@pytest.mark.parametrize("rows", [0, 1, 10 ** 4])
def test_writer_reads_back_through_h5py_and_jax(tmp_path, rows):
    data = events(np.random.default_rng(10 + rows), rows)
    path = str(tmp_path / "port.h5")
    lu.write_events_h5(path, data)
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["myDataset"]
        g = f["myDataset"]
        assert sorted(g) == ["axis0", "block0_items", "block0_values"]
        np.testing.assert_array_equal(g["axis0"][()], NAMES)
        np.testing.assert_array_equal(g["block0_items"][()], NAMES)
        vals = g["block0_values"][()]
    assert vals.dtype == np.float64 and vals.shape == (rows, 4)
    assert vals.tobytes() == data.tobytes()
    assert j_lu.get_events_h5(path).tobytes() == data.tobytes()
    assert lu.get_events_h5(path).tobytes() == data.tobytes()


@pytest.mark.parametrize("kind,what", [
    ("fletcher32", r"filter 3 \(fletcher32\)"),
    ("lzf", r"filter 32000 \(lzf\)"),
    ("big_endian", "big-endian"), ("latest", "superblock version 3"),
    ("userblock", "user block")])
def test_reader_refuses_what_is_outside_the_subset(tmp_path, kind, what):
    data = events(np.random.default_rng(5), 40)
    path = str(tmp_path / f"{kind}.h5")
    kw = {"fletcher32": dict(chunks=(8, 4), fletcher32=True),
          "lzf": dict(compression="lzf"),
          "big_endian": dict(dtype=">f8")}.get(kind, {})
    file_kw = {"latest": dict(libver="latest"),
               "userblock": dict(userblock_size=512)}.get(kind, {})
    with h5py.File(path, "w", **file_kw) as f:
        g = f.create_group("myDataset")
        g.create_dataset("block0_items", data=NAMES)
        g.create_dataset("block0_values", data=data, **kw)
    np.testing.assert_array_equal(j_lu.get_events_h5(path), data)
    with pytest.raises(ValueError, match=what):
        lu.get_events_h5(path)


@pytest.mark.parametrize("damage", ["truncated", "superblock", "loop"])
def test_reader_refuses_a_damaged_file(tmp_path, damage):
    """The port's own file cut short, or its root header's symbol-table
    message turned into a continuation back to the same chunk."""
    path = str(tmp_path / "damaged.h5")
    lu.write_events_h5(path, events(np.random.default_rng(6), 64))
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    if damage == "truncated":
        buf = buf[:len(buf) // 2]
    elif damage == "superblock":
        buf = buf[:40]
    else:
        (root,) = struct.unpack_from("<Q", buf, 64)
        assert struct.unpack_from("<H", buf, root + 16)[0] == 0x11
        struct.pack_into("<H", buf, root + 16, 0x10)
        struct.pack_into("<QQ", buf, root + 24, root + 16, 24)
    with open(path, "wb") as f:
        f.write(bytes(buf))
    with pytest.raises(ValueError, match={
            "truncated": "truncated", "superblock": "truncated",
            "loop": "continuation loop"}[damage]):
        lu.get_events_h5(path)
