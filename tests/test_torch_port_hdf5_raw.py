"""The port's HDF5 reader (``data/hdf5.py``) on raw-dataset storage that
h5py writes, and its writer read back by h5py.

- Bit for bit against h5py: contiguous, chunked, chunked with gzip at
  levels 1 and 9, and shuffle + gzip; edge chunks, a chunk index of more
  than one B-tree level, nested groups, scalars, u8 / u16 / i64 / f32 /
  f64 at ranks 0-3.
- Storage never written reads as the fill value, else as zeros.
- A first-axis slice decodes only the chunks it touches (decompressions
  counted) and equals h5py's slice.
- Every other filter is refused by its id and name (lzf 32000, fletcher32
  3, scaleoffset 6), as is a ``libver="latest"`` file.
- The port's writer, contiguous and chunked with deflate and shuffle,
  read back by h5py equal.
"""

import zlib

import numpy as np
import pytest

from sdformerflow_tpu_torch.data import hdf5

h5py = pytest.importorskip("h5py")

DTYPES = ("u1", "<u2", "<i8", "<f4", "<f8")
SHAPES = {0: (), 1: (1000,), 2: (37, 11), 3: (9, 13, 5)}
CHUNKS = {1: (64,), 2: (8, 4), 3: (4, 5, 5)}       # edge chunks on every axis
STORAGE = {"contiguous": {}, "chunked": {"chunks": True},
           "gzip1": {"compression": "gzip", "compression_opts": 1},
           "gzip9": {"compression": "gzip", "compression_opts": 9},
           "shuffle_gzip": {"compression": "gzip", "shuffle": True}}


def draw(rng, dtype, shape):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


def tree(seed):
    """{"r<rank>/<dtype>": array} plus a 1-D float64 of 200 chunks (a chunk
    index of two B-tree levels: libhdf5 holds 64 chunks a node)."""
    rng = np.random.default_rng(seed)
    out = {f"r{rank}/{np.dtype(dt).name}": draw(rng, dt, shape)
           for rank, shape in SHAPES.items() for dt in DTYPES}
    out["deep/a/b/long"] = rng.standard_normal(200 * 50)
    return out


def write_h5py(path, arrays, **kw):
    with h5py.File(path, "w") as f:
        for name, a in arrays.items():
            opts = dict(kw)
            if a.ndim == 0:
                opts = {}                      # scalars are never chunked
            elif opts.get("chunks") is True or opts:
                opts["chunks"] = (50,) if a.size == 10000 else CHUNKS[a.ndim]
            f.create_dataset(name, data=a, **opts)


@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_reader_equals_h5py(tmp_path, storage):
    arrays = tree(sorted(STORAGE).index(storage))
    path = str(tmp_path / f"{storage}.h5")
    write_h5py(path, arrays, **STORAGE[storage])
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        assert f.keys() == sorted(ref.keys())
        for name, a in arrays.items():
            assert name in f and f"{name}x" not in f
            ds = f[name]
            want = ref[name][()]
            assert (ds.shape, ds.dtype) == (want.shape, want.dtype), name
            got = ds[()]
            assert type(got) is type(want), name
            assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
            if storage != "contiguous" and a.ndim:
                assert ref[name].chunks is not None
        if storage != "contiguous":
            assert len(f["deep/a/b/long"].chunk_index()) == 200


def test_unwritten_storage_reads_the_fill_value(tmp_path):
    path = str(tmp_path / "fill.h5")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("filled", shape=(100, 7), dtype="<i8",
                             chunks=(16, 7), fillvalue=-3)
        d[20:40] = np.arange(140).reshape(20, 7)
        z = f.create_dataset("zeros", shape=(50,), dtype="<f4", chunks=(8,),
                             compression="gzip")
        z[9:11] = 5.0
        f.create_dataset("never", shape=(6, 2), dtype="<f8", fillvalue=2.5)
        f.create_dataset("empty", shape=(0, 3), dtype="<u2", chunks=(4, 3),
                         maxshape=(None, 3))
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        assert len(f["filled"].chunk_index()) == 2       # 2 of 7 written
        for name in ("filled", "zeros", "never", "empty"):
            want = ref[name][()]
            got = f[name][()]
            assert (got.dtype, got.shape) == (want.dtype, want.shape)
            np.testing.assert_array_equal(got, want)
        assert f["filled"][0][0] == -3 and f["never"][5][1] == 2.5


def test_a_slice_decodes_only_the_chunks_it_touches(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    t = np.sort(rng.integers(0, 10 ** 9, 10_000)).astype(np.int64)
    xy = rng.integers(0, 640, (10_000, 2)).astype(np.uint16)
    path = str(tmp_path / "lazy.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("events/t", data=t, chunks=(1000,),
                         compression="gzip", shuffle=True)
        f.create_dataset("events/xy", data=xy, chunks=(1000, 2),
                         compression="gzip")
        f.create_dataset("plain", data=t)
    inflated = []
    real = zlib.decompress

    def counted(data, *a):
        inflated.append(len(data))
        return real(data, *a)
    monkeypatch.setattr(zlib, "decompress", counted)
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        for name, key, chunks in (
                ("events/t", slice(2500, 3500), 2),
                ("events/t", slice(3000, 4000), 1),
                ("events/t", slice(9999, None), 1),
                ("events/t", slice(-1500, -600), 2),
                ("events/t", 4321, 1),
                ("events/t", slice(5, 5), 0),
                ("events/xy", slice(999, 1001), 2),
                ("events/t", (), 10),
                ("plain", slice(10, 20), 0)):
            inflated.clear()
            got = f[name][key]
            np.testing.assert_array_equal(got, ref[name][key])
            assert len(inflated) == chunks, (name, key, inflated)


@pytest.mark.parametrize("kind,what", [
    ("lzf", r"filter 32000 \(lzf\)"),
    ("fletcher32", r"filter 3 \(fletcher32\)"),
    ("scaleoffset", r"filter 6 \(scaleoffset\)"),
    ("latest", "superblock version 3")])
def test_reader_refuses_other_filters_by_id_and_name(tmp_path, kind, what):
    path = str(tmp_path / f"{kind}.h5")
    data = np.arange(4096, dtype="<i4")
    kw = {"lzf": dict(compression="lzf"),
          "fletcher32": dict(fletcher32=True, chunks=(256,)),
          "scaleoffset": dict(scaleoffset=0, chunks=(256,))}.get(kind, {})
    with h5py.File(path, "w", **({"libver": "latest"} if kind == "latest"
                                 else {})) as f:
        f.create_dataset("events/x", data=data, **kw)
        f.create_dataset("ok", data=data)
    with pytest.raises(ValueError, match=what):
        with hdf5.File(path) as f:
            assert "events/x" in f           # naming it reads no storage
            np.testing.assert_array_equal(f["ok"][()], data)
            f["events/x"]


@pytest.mark.parametrize("opts", [
    dict(), dict(chunks=1000), dict(chunks=64, deflate=1),
    dict(chunks=64, deflate=9, shuffle=True)], ids=[
        "contiguous", "chunked", "deflate1", "shuffle_deflate9"])
def test_writer_reads_back_through_h5py(tmp_path, opts):
    arrays = tree(11)
    nested = {}
    for name, a in arrays.items():
        *groups, leaf = name.split("/")
        node = nested
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = a
    if opts.get("chunks") == 64:
        # a chunk shape of every rank, edge chunks included; the long
        # array in 200 chunks (two B-tree levels)
        opts = dict(opts, chunks={**{f"r{r}/{np.dtype(dt).name}": CHUNKS[r]
                                     for r in (1, 2, 3) for dt in DTYPES},
                                  "deep/a/b/long": (50,)})
    path = str(tmp_path / "port.h5")
    hdf5.write(path, nested, **opts)
    with h5py.File(path, "r") as f, hdf5.File(path) as port:
        for name, a in arrays.items():
            got = f[name][()]
            assert got.dtype == a.dtype and got.shape == a.shape, name
            assert np.asarray(got).tobytes() == a.tobytes(), name
            assert np.asarray(port[name][()]).tobytes() == a.tobytes()
            if a.ndim and opts.get("chunks"):
                assert f[name].chunks is not None, name
                assert f[name].compression == ("gzip" if "deflate" in opts
                                               else None)
                assert f[name].shuffle == bool(opts.get("shuffle"))
            else:
                assert f[name].chunks is None, name
    with pytest.raises(ValueError, match="need chunks"):
        hdf5.write(path, nested, deflate=4)
