"""A numpy reader and writer for the subset of HDF5 that event data comes
in, in place of the h5py / pandas / PyTables stack that the JAX package
reads and writes it with (``sdformerflow_tpu/data/loader_utils.py``,
``scripts/preprocess_dsec.py``, ``scripts/encode_mvsec.py``).

:class:`File` maps a file and reads nothing until it is asked:
``f["events/t"]`` walks the groups to a :class:`Dataset`, whose ``.shape``
and ``.dtype`` come from its object header, and ``ds[()]``, ``ds[i]`` and
``ds[i0:i1]`` (the first axis) read only the bytes, or the chunks, that
they touch. The subset it takes is what h5py and PyTables write at their
default (earliest) format settings:

- superblock version 0 or 1, 8-byte offsets and lengths;
- version 1 object headers, continuation blocks included;
- symbol-table groups: a version 1 B-tree of group nodes, symbol-table
  nodes (``SNOD``) and a local heap;
- datasets of layout message version 3 stored compactly, contiguously or
  in chunks (indexed by a version 1 B-tree of raw-data-chunk nodes; the
  edge chunks are cropped);
- storage never written (a contiguous dataset, or a chunk) reads as the
  fill value of the fill-value message, else as zeros;
- the filter pipeline (message versions 1 and 2) with deflate (filter 1,
  through ``zlib``) and shuffle (filter 2), undone in reverse order and
  skipped where a chunk's filter mask says so;
- scalar and simple dataspaces; little-endian IEEE floats, little-endian
  integers and fixed-length byte strings.

Messages that the reader does not need (attributes, modification times,
...) are skipped. Anything outside the subset raises a ``ValueError`` that
names it: any other filter by its id and, where known, its name (fletcher32
3, szip 4, nbit 5, scaleoffset 6, lzf 32000, blosc 32001, lz4 32004,
bitshuffle 32008, zstd 32015: DSEC's raw ``events.h5`` is compressed with
such a plugin filter), layout message versions other than 3, version 2
object headers or B-trees, link messages (groups of the newer format),
big-endian data, superblock version 2 or later. The reader never guesses
at such a file.

:func:`write` writes a nested dict of arrays in that subset (superblock 0,
version 1 object headers, symbol-table groups), contiguous, or chunked
with deflate and shuffle, which libhdf5 (h5py) reads. :func:`read_event_block`
and :func:`write_event_block` keep pandas' fixed-format frame: a group
holding ``block0_items`` (the column names) and ``block0_values`` (a 2-D
array, one row an event), as the JAX package's h5py branch writes it.
"""

from __future__ import annotations

import itertools
import mmap
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL_OLD, _FILL_NEW, _LINK, _EXTERNAL = 0x04, 0x05, 0x06, 0x07
_LAYOUT, _GROUP_INFO, _FILTERS = 0x08, 0x0A, 0x0B
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11

DEFLATE, SHUFFLE = 1, 2
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                5: "nbit", 6: "scaleoffset", 32000: "lzf", 32001: "blosc",
                32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}

_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumerated", 9: "variable-length",
                10: "array"}
# (bit offset, precision, exponent location, exponent size, mantissa
# location, mantissa size, exponent bias) of the IEEE formats, by size
_IEEE = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127),
         8: (0, 64, 52, 11, 0, 52, 1023)}


def _shuffle(raw: bytes, size: int) -> bytes:
    """HDF5's shuffle filter: byte k of every element, for k = 0..size-1;
    a tail shorter than an element stays as it is."""
    n = len(raw) // size
    body = np.frombuffer(raw, np.uint8, n * size).reshape(n, size)
    return body.T.tobytes() + raw[n * size:]


def _unshuffle(raw: bytes, size: int) -> bytes:
    n = len(raw) // size
    body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
    return body.T.tobytes() + raw[n * size:]


class File:
    """An HDF5 file mapped for reading. ``f[path]`` is the :class:`Group`
    or :class:`Dataset` at ``path`` (``"a/b/c"``, through symbol-table
    groups), ``path in f`` asks whether it exists, ``f.keys()`` lists the
    root group. Usable as a context manager; :meth:`close` unmaps it."""

    def __init__(self, path):
        self.path = os.fspath(path)
        with open(self.path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            self.buf = (mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
                        if size else b"")
        self.base, root = self._superblock()
        self.root = Group(self, root, "/")

    def close(self):
        if isinstance(self.buf, mmap.mmap):
            self.buf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getitem__(self, path: str):
        return self.root[path]

    def __contains__(self, path: str) -> bool:
        return path in self.root

    def keys(self) -> List[str]:
        return self.root.keys()

    # ------------------------------------------------------------ bytes

    def unsupported(self, what: str):
        raise ValueError(f"{self.path}: {what} is outside the HDF5 subset "
                         f"this reader takes (data/hdf5.py)")

    def corrupt(self, what: str):
        raise ValueError(f"{self.path}: not a valid HDF5 file ({what})")

    def unpack(self, fmt: str, pos: int):
        if pos < 0 or pos + struct.calcsize(fmt) > len(self.buf):
            self.corrupt(f"a read at byte {pos} past the end of the file")
        return struct.unpack_from(fmt, self.buf, pos)

    def read(self, addr: int, size: int) -> bytes:
        """``size`` bytes at file address ``addr``."""
        pos = self.base + addr
        if addr == UNDEFINED or pos + size > len(self.buf):
            self.corrupt(f"{size} bytes at address {addr} past the end of "
                         f"the file")
        return self.buf[pos:pos + size]

    def _superblock(self) -> Tuple[int, int]:
        if self.buf[:8] != SIGNATURE:
            self.unsupported("a file without the HDF5 signature at byte 0 "
                             "(not HDF5, or a user block)")
        if len(self.buf) < 96:
            self.corrupt("truncated in its superblock")
        version = self.buf[8]
        if version >= 2:
            self.unsupported(f"superblock version {version}")
        size_offsets, size_lengths = self.buf[13], self.buf[14]
        if (size_offsets, size_lengths) != (8, 8):
            self.unsupported(f"{size_offsets}-byte offsets and "
                             f"{size_lengths}-byte lengths")
        p = 24 + (4 if version == 1 else 0)
        base, _, eof, layout_info = self.unpack("<4Q", p)
        if layout_info != UNDEFINED:
            self.unsupported("a superblock naming a multi-file layout "
                             "(family, multi or split files)")
        if base + eof > len(self.buf):
            self.corrupt(f"truncated: {len(self.buf)} bytes of {base + eof}")
        # the root group's symbol-table entry: its object header
        (root,) = self.unpack("<Q", p + 32 + 8)
        return base, root

    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the object header at
        ``addr``, continuation blocks followed."""
        pos = self.base + addr
        if self.buf[pos:pos + 4] == b"OHDR":
            self.unsupported("a version 2 object header")
        if self.buf[pos:pos + 1] != b"\x01":
            self.corrupt(f"object header version {self.buf[pos:pos + 1]!r}")
        _, size = self.unpack("<II", pos + 4)
        chunks, out, seen = [(pos + 16, size)], [], set()
        while chunks:
            start, length = chunks.pop(0)
            if start + length > len(self.buf):
                self.corrupt("an object header past the end of the file")
            q, end = start, start + length
            while q + 8 <= end:
                mtype, msize, mflags = self.unpack("<HHB", q)
                if q + 8 + msize > end:
                    self.corrupt("a message past its header chunk")
                data = self.buf[q + 8:q + 8 + msize]
                q += 8 + msize
                if mtype == _CONTINUATION:
                    if msize < 16:
                        self.corrupt("a short continuation message")
                    caddr, clen = struct.unpack_from("<QQ", data)
                    if caddr in seen:
                        self.corrupt("an object header continuation loop")
                    seen.add(caddr)
                    chunks.append((self.base + caddr, clen))
                elif mtype != _NIL:
                    out.append((mtype, mflags, data))
        return out

    def node(self, addr: int, name: str):
        """The :class:`Group` or :class:`Dataset` whose object header is at
        ``addr``."""
        msgs = self.messages(addr)
        kinds = {t for t, _, _ in msgs}
        if _SYMBOL_TABLE in kinds:
            return Group(self, addr, name, msgs)
        if kinds & {_LINK, _LINK_INFO, _GROUP_INFO}:
            self.unsupported("link messages (a group of the newer format)")
        if _LAYOUT in kinds:
            return Dataset(self, addr, name, msgs)
        raise KeyError(f"{self.path}: {name!r} is neither a group nor a "
                       f"dataset")

    # ------------------------------------------------------------ groups

    def links(self, msgs) -> Dict[str, int]:
        """{name: object header address} of a group's symbol table."""
        if any(t in (_LINK, _LINK_INFO, _GROUP_INFO) for t, _, _ in msgs):
            self.unsupported("link messages (a group of the newer format)")
        tables = [d for t, _, d in msgs if t == _SYMBOL_TABLE]
        if not tables:
            self.corrupt("a group without a symbol table")
        btree, heap_addr = struct.unpack_from("<QQ", tables[0])
        heap = self._local_heap(heap_addr)
        out: Dict[str, int] = {}
        self._btree(btree, heap, out, set())
        return out

    def _local_heap(self, addr: int) -> bytes:
        pos = self.base + addr
        if self.buf[pos:pos + 4] != b"HEAP" or self.buf[pos + 4] != 0:
            self.corrupt("a local heap")
        size, _, data = self.unpack("<QQQ", pos + 8)
        return self.buf[self.base + data:self.base + data + size]

    def _tree_node(self, addr: int, node_type: int, seen: set):
        """(level, entries used, position) of a version 1 B-tree node."""
        pos = self.base + addr
        sig = self.buf[pos:pos + 4]
        if sig == b"BTHD":
            self.unsupported("a version 2 B-tree")
        if sig != b"TREE" or self.buf[pos + 4] != node_type:
            self.corrupt(f"a B-tree node of type {node_type}")
        if addr in seen:
            self.corrupt("a B-tree loop")
        seen.add(addr)
        return self.buf[pos + 5], self.unpack("<H", pos + 6)[0], pos

    def _btree(self, addr: int, heap: bytes, out: Dict[str, int], seen):
        level, used, pos = self._tree_node(addr, 0, seen)
        for i in range(used):
            # key 0, child 0, key 1, child 1, ... after the two siblings
            (child,) = self.unpack("<Q", pos + 24 + 8 + 16 * i)
            if level > 0:
                self._btree(child, heap, out, seen)
            else:
                self._symbol_node(child, heap, out)

    def _symbol_node(self, addr: int, heap: bytes, out: Dict[str, int]):
        pos = self.base + addr
        if self.buf[pos:pos + 4] != b"SNOD":
            self.corrupt("a symbol-table node")
        (n,) = self.unpack("<H", pos + 6)
        for i in range(n):
            name_off, header, cache = self.unpack("<QQI", pos + 8 + 40 * i)
            end = heap.find(b"\0", name_off)
            if end < 0:
                self.corrupt("a link name outside its heap")
            name = heap[name_off:end].decode()
            if cache == 2:
                self.unsupported(f"the soft link {name!r}")
            out[name] = header

    # ---------------------------------------------------------- datasets

    def chunk_index(self, addr: int, rank: int):
        """[(offsets, stored size, filter mask, address)] of every chunk
        under the raw-data-chunk B-tree at ``addr``, in key order."""
        out, seen = [], set()
        key = 8 + 8 * (rank + 1)

        def walk(node):
            level, used, pos = self._tree_node(node, 1, seen)
            p = pos + 24
            for _ in range(used):
                size, mask = self.unpack("<II", p)
                offsets = self.unpack(f"<{rank}Q", p + 8)
                (child,) = self.unpack("<Q", p + key)
                if level > 0:
                    walk(child)
                else:
                    out.append((offsets, size, mask, child))
                p += key + 8

        if addr != UNDEFINED:
            walk(addr)
        return out

    def dataspace(self, d: bytes) -> Tuple[int, ...]:
        version, rank, flags = d[0], d[1], d[2]
        if version == 1:
            pos = 8
        elif version == 2:
            if d[3] == 2:
                self.unsupported("a null dataspace")
            pos = 4
        else:
            self.unsupported(f"dataspace message version {version}")
        if flags & 0x02:
            self.unsupported("a permuted dataspace")
        return struct.unpack_from(f"<{rank}Q", d, pos)

    def datatype(self, d: bytes) -> np.dtype:
        cls, bits = d[0] & 0x0F, d[1] | d[2] << 8 | d[3] << 16
        (size,) = struct.unpack_from("<I", d, 4)
        if cls == 0:                                    # fixed-point
            if bits & 0x01:
                self.unsupported("big-endian data")
            offset, precision = struct.unpack_from("<HH", d, 8)
            if size not in (1, 2, 4, 8) or (offset, precision) != (
                    0, 8 * size):
                self.unsupported(f"a {size}-byte integer with bit offset "
                                 f"{offset} and precision {precision}")
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:                                    # floating point
            order = (bits & 0x01) | (bits >> 5 & 0x02)
            if order:
                self.unsupported("big-endian data" if order == 1
                                 else "a VAX float byte order")
            fields = struct.unpack_from("<HHBBBBI", d, 8)
            if _IEEE.get(size) != fields:
                self.unsupported(f"a {size}-byte float of layout {fields}")
            return np.dtype(f"<f{size}")
        if cls == 3:                                    # fixed-length string
            if bits & 0x0F == 2:
                self.unsupported("space-padded strings")
            return np.dtype(f"S{size}")
        self.unsupported(f"datatype class {cls} "
                         f"({_CLASS_NAMES.get(cls, 'unknown')})")

    def filters(self, d: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
        """[(filter id, client data)] of a filter pipeline message, in the
        order they were applied; any filter but deflate and shuffle
        raises."""
        version, count = d[0], d[1]
        if version not in (1, 2):
            self.unsupported(f"filter pipeline message version {version}")
        pos, out = (8 if version == 1 else 2), []
        for _ in range(count):
            (fid,) = struct.unpack_from("<H", d, pos)
            pos += 2
            name_len = 0
            if version == 1 or fid >= 256:
                (name_len,) = struct.unpack_from("<H", d, pos)
                pos += 2
            _, n_values = struct.unpack_from("<HH", d, pos)
            pos += 4
            name = bytes(d[pos:pos + name_len]).split(b"\0")[0].decode(
                "ascii", "replace")
            pos += name_len
            values = struct.unpack_from(f"<{n_values}I", d, pos)
            pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
            if fid not in (DEFLATE, SHUFFLE):
                self.unsupported(f"the filter {fid} "
                                 f"({FILTER_NAMES.get(fid) or name or 'unknown'})")
            out.append((fid, values))
        return out

    def fill_value(self, new: Optional[bytes], old: Optional[bytes],
                   dtype: np.dtype) -> Optional[bytes]:
        """The fill value's bytes, or None for the default (zeros)."""
        value = b""
        if new is not None:
            version = new[0]
            if version in (1, 2):
                if version == 1 or new[3]:
                    (size,) = struct.unpack_from("<I", new, 4)
                    value = new[8:8 + size]
            elif version == 3:
                if new[1] & 0x20:
                    (size,) = struct.unpack_from("<I", new, 2)
                    value = new[6:6 + size]
            else:
                self.unsupported(f"fill value message version {version}")
        elif old is not None:
            (size,) = struct.unpack_from("<I", old, 0)
            value = old[4:4 + size]
        if not value:
            return None
        if len(value) != dtype.itemsize:
            self.corrupt(f"a fill value of {len(value)} bytes for {dtype}")
        return bytes(value)

    def layout(self, d: bytes, rank: int, dtype: np.dtype):
        """("compact", bytes) | ("contiguous", address, size) |
        ("chunked", B-tree address, chunk shape)."""
        version = d[0]
        if version != 3:
            self.unsupported(f"layout message version {version}")
        cls = d[1]
        if cls == 0:
            (size,) = struct.unpack_from("<H", d, 2)
            return ("compact", bytes(d[4:4 + size]))
        if cls == 1:
            return ("contiguous",) + struct.unpack_from("<QQ", d, 2)
        if cls == 2:
            ndims = d[2]
            (addr,) = struct.unpack_from("<Q", d, 3)
            dims = struct.unpack_from(f"<{ndims}I", d, 11)
            if ndims != rank + 1 or dims[-1] != dtype.itemsize or 0 in dims:
                self.corrupt(f"chunk dimensions {dims} for a rank-{rank} "
                             f"{dtype} dataset")
            return ("chunked", addr, dims[:-1])
        self.unsupported(f"layout class {cls}")


class Group:
    """A symbol-table group: ``g[path]``, ``path in g``, ``g.keys()``."""

    def __init__(self, file: File, addr: int, name: str, msgs=None):
        self.file, self.addr, self.name = file, addr, name
        self._msgs = msgs
        self._links = None

    def links(self) -> Dict[str, int]:
        if self._links is None:
            msgs = self._msgs or self.file.messages(self.addr)
            self._links = self.file.links(msgs)
        return self._links

    def keys(self) -> List[str]:
        return sorted(self.links())

    def _walk(self, path: str):
        """(the group holding the last part of ``path``, that part)."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise KeyError(f"{self.file.path}: an empty path")
        group = self.file.root if path.startswith("/") else self
        for i, part in enumerate(parts[:-1]):
            child = group.links().get(part)
            if child is None:
                raise KeyError(f"{self.file.path}: no object {path!r}")
            group = self.file.node(child, "/".join(parts[:i + 1]))
            if not isinstance(group, Group):
                raise KeyError(f"{self.file.path}: {group.name!r} is a "
                               f"dataset, not a group")
        return group, parts[-1]

    def __getitem__(self, path: str):
        group, last = self._walk(path)
        if last not in group.links():
            raise KeyError(f"{self.file.path}: no object {path!r}")
        return self.file.node(group.links()[last], path)

    def __contains__(self, path: str) -> bool:
        try:
            group, last = self._walk(path)
        except KeyError:
            return False
        return last in group.links()


class Dataset:
    """A dataset: ``.shape``, ``.dtype``, and ``ds[()]`` (all of it),
    ``ds[i]`` and ``ds[i0:i1]`` on the first axis, which read only the
    bytes, or decode only the chunks, that they touch."""

    def __init__(self, file: File, addr: int, name: str, msgs):
        self.file, self.name = file, name
        found = {}
        for mtype, flags, data in msgs:
            if mtype == _EXTERNAL:
                file.unsupported("external storage")
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS,
                         _FILL_NEW, _FILL_OLD):
                if flags & 0x02:
                    file.unsupported("a shared (committed) message")
                found.setdefault(mtype, data)
        for need, what in ((_DATASPACE, "dataspace"), (_DATATYPE, "datatype"),
                           (_LAYOUT, "layout")):
            if need not in found:
                raise KeyError(f"{file.path}: {name!r} is not a dataset (no "
                               f"{what} message)")
        self.shape = file.dataspace(found[_DATASPACE])
        self.dtype = file.datatype(found[_DATATYPE])
        self._filters = (file.filters(found[_FILTERS])
                         if _FILTERS in found else [])
        self._fill = file.fill_value(found.get(_FILL_NEW),
                                     found.get(_FILL_OLD), self.dtype)
        self._layout = file.layout(found[_LAYOUT], len(self.shape),
                                   self.dtype)
        if self._filters and self._layout[0] != "chunked":
            file.corrupt(f"a filter pipeline on {self._layout[0]} storage")
        self._chunks = None

    def __getitem__(self, key):
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            out = self._rows(0, self.shape[0] if self.shape else 1)
            return out[()] if not self.shape else out
        if not self.shape:
            raise TypeError(f"{self.name!r} is a scalar dataset: read it "
                            f"with ds[()]")
        n = self.shape[0]
        if isinstance(key, (int, np.integer)):
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {key} out of range for {n} rows")
            return self._rows(i, i + 1)[0]
        if isinstance(key, slice) and key.step in (None, 1):
            start, stop, _ = key.indices(n)
            return self._rows(start, max(start, stop))
        raise TypeError(f"{self.name!r}: only ds[()], ds[i] and ds[i0:i1] "
                        f"(the first axis) are read, not {key!r}")

    def _filled(self, shape) -> np.ndarray:
        if self._fill is None:
            return np.zeros(shape, self.dtype)
        return np.full(shape, np.frombuffer(self._fill, self.dtype)[0],
                       self.dtype)

    def _rows(self, i0: int, i1: int) -> np.ndarray:
        shape = (i1 - i0,) + tuple(self.shape[1:]) if self.shape else ()
        kind = self._layout[0]
        if kind == "chunked":
            return self._chunked_rows(i0, i1, shape)
        count = int(np.prod(shape, dtype=np.int64))
        row = self.dtype.itemsize * int(np.prod(self.shape[1:],
                                                dtype=np.int64))
        nbytes = self.dtype.itemsize * int(np.prod(self.shape,
                                                   dtype=np.int64))
        if kind == "compact":
            buf, start = self._layout[1], i0 * row
            if len(buf) < nbytes:
                self.file.corrupt(f"{len(buf)} bytes of data where the "
                                  f"dataspace needs {nbytes}")
        else:
            _, addr, size = self._layout
            if addr == UNDEFINED:
                return self._filled(shape)
            if size < nbytes:
                self.file.corrupt(f"{size} bytes of data where the "
                                  f"dataspace needs {nbytes}")
            buf, start = self.file.buf, self.file.base + addr + i0 * row
            if self.file.base + addr + nbytes > len(buf):
                self.file.corrupt(f"{nbytes} bytes at address {addr} past "
                                  f"the end of the file")
        if not count:
            return np.empty(shape, self.dtype)
        # only the rows asked for are read (and copied out of the map)
        return np.frombuffer(buf, self.dtype, count, start).reshape(
            shape).copy()

    def chunk_index(self):
        """The chunks' (offsets, stored size, filter mask, address)."""
        if self._chunks is None:
            self._chunks = self.file.chunk_index(self._layout[1],
                                                 len(self.shape))
        return self._chunks

    def _decode(self, size: int, mask: int, addr: int,
                cshape) -> np.ndarray:
        raw = self.file.read(addr, size)
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:                       # skipped for this chunk
                continue
            fid, values = self._filters[i]
            if fid == DEFLATE:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    self.file.corrupt(f"a deflate chunk at {addr}: {e}")
            else:
                raw = _unshuffle(raw, values[0] if values
                                 else self.dtype.itemsize)
        want = self.dtype.itemsize * int(np.prod(cshape, dtype=np.int64))
        if len(raw) != want:
            self.file.corrupt(f"a chunk of {len(raw)} bytes where its shape "
                              f"{tuple(cshape)} needs {want}")
        return np.frombuffer(raw, self.dtype).reshape(cshape)

    def _chunked_rows(self, i0: int, i1: int, shape) -> np.ndarray:
        out = self._filled(shape)
        if not out.size:
            return out
        cshape = self._layout[2]
        for offsets, size, mask, addr in self.chunk_index():
            lo = offsets[0]
            if lo >= i1 or lo + cshape[0] <= i0:
                continue
            chunk = self._decode(size, mask, addr, cshape)
            a, b = max(i0, lo), min(i1, lo + cshape[0])
            src = [slice(a - lo, b - lo)]
            dst = [slice(a - i0, b - i0)]
            for o, c, n in zip(offsets[1:], cshape[1:], self.shape[1:]):
                m = min(c, n - o)
                src.append(slice(0, m))
                dst.append(slice(o, o + m))
            out[tuple(dst)] = chunk[tuple(src)]
        return out


def read_event_block(path: str, key: str = "myDataset"
                     ) -> Tuple[List[str], np.ndarray]:
    """(column names, values [N, C]) of the pandas fixed-format frame
    stored under ``key``: its ``block0_items`` and ``block0_values``."""
    with File(path) as f:
        group = f[key]
        if not isinstance(group, Group):
            raise KeyError(f"{path}: {key!r} is not a group")
        for need in ("block0_items", "block0_values"):
            if need not in group:
                raise KeyError(f"{path}: no {key}/{need}")
        items = group["block0_items"][()]
        values = group["block0_values"][()]
    return [c.decode() for c in items.tolist()], values


# ------------------------------------------------------------------ writer

def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data += b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: Sequence[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    if dtype.kind == "f" and dtype.itemsize in _IEEE:
        sign = 8 * dtype.itemsize - 1
        # mantissa normalization "implied", sign bit position
        bits = (2 << 4) | (sign << 8)
        return (struct.pack("<BBBBI", 0x11, bits & 0xFF, bits >> 8 & 0xFF,
                            0, dtype.itemsize)
                + struct.pack("<HHBBBBI", *_IEEE[dtype.itemsize]))
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        return (struct.pack("<BBBBI", 0x10, 0x08 if dtype.kind == "i" else 0,
                            0, 0, dtype.itemsize)
                + struct.pack("<HH", 0, 8 * dtype.itemsize))
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dtype.itemsize)
    raise ValueError(f"hdf5.write: no HDF5 datatype for {dtype}")


def _dataspace_message(shape: Tuple[int, ...]) -> bytes:
    # version 1; rank 0 is a scalar
    return (struct.pack("<BBBx4x", 1, len(shape), 1 if shape else 0)
            + struct.pack(f"<{2 * len(shape)}Q", *shape, *shape))


def _filter_message(filters) -> bytes:
    """Version 1 of the filter pipeline message: (id, name, client data)
    each, optional as libhdf5 marks deflate and shuffle."""
    out = struct.pack("<BB6x", 1, len(filters))
    for fid, name, values in filters:
        name = name.encode() + b"\0"
        name += b"\0" * (-len(name) % 8)
        out += struct.pack("<HHHH", fid, len(name), 1, len(values)) + name
        out += struct.pack(f"<{len(values)}I", *values)
        out += b"\0" * (4 * (len(values) % 2))
    return out


class _Builder:
    """Appends 8-byte-aligned blocks and hands out their addresses."""

    def __init__(self, start: int):
        self.parts: List[bytes] = []
        self.end = start

    def add(self, block: bytes) -> int:
        addr = self.end
        block += b"\0" * (-len(block) % 8)
        self.parts.append(block)
        self.end += len(block)
        return addr


_LEAF_K, _INTERNAL_K = 4, 16          # the format's defaults, as libhdf5
_CHUNK_K = 32                         # libhdf5's chunk B-tree K (superblock
                                      # 0 has no field for it)
_SUPERBLOCK_SIZE = 96


def _group(b: _Builder, entries: Dict[str, int]) -> Tuple[int, int, int]:
    """A symbol-table group holding ``entries`` (name -> object header
    address, at most 2 * leaf K): (its object header, B-tree and local heap
    addresses)."""
    names = sorted(entries)
    if len(names) > 2 * _LEAF_K:
        raise ValueError(f"hdf5.write: {len(names)} links in one group; "
                         f"at most {2 * _LEAF_K} are written")
    heap_data = b"\0" * 8                      # offset 0: the empty name
    offsets = {}
    for n in names:
        offsets[n] = len(heap_data)
        s = n.encode() + b"\0"
        heap_data += s + b"\0" * (-len(s) % 8)
    data_addr = b.add(heap_data)
    # free list 1: no free block (libhdf5's encoding of none)
    heap = b.add(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1,
                                       data_addr))
    node = b"SNOD" + struct.pack("<BxH", 1, len(names))
    for n in names:
        node += struct.pack("<QQI4x16x", offsets[n], entries[n], 0)
    node += b"\0" * (8 + 2 * _LEAF_K * 40 - len(node))
    snod = b.add(node)
    tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEFINED, UNDEFINED)
    tree += struct.pack("<QQQ", 0, snod, offsets[names[-1]] if names else 0)
    tree += b"\0" * (24 + (2 * _INTERNAL_K + 1) * 8
                     + 2 * _INTERNAL_K * 8 - len(tree))
    btree = b.add(tree)
    header = b.add(_object_header([_message(
        _SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
    return header, btree, heap


def _chunk_btree(b: _Builder, chunks, cshape) -> int:
    """The version 1 B-tree (node type 1) over ``chunks`` [(offsets, stored
    size, address)] in row-major order: up to 2 K entries a node, levels
    added until one node holds them; key i of a node is its child i's first
    key, its last key the first chunk past it (the last chunk's offsets plus
    the chunk shape at the end)."""
    rank1 = len(cshape) + 1

    def key(offsets, size=0):
        return struct.pack(f"<II{rank1}Q", size, 0, *offsets, 0)

    node_size = 24 + (2 * _CHUNK_K + 1) * len(key(cshape)) + 2 * _CHUNK_K * 8
    end = key(tuple(o + c for o, c in zip(chunks[-1][0], cshape)))
    level, entries = 0, [(key(o, s), a) for o, s, a in chunks]
    while True:
        groups = [entries[i:i + 2 * _CHUNK_K]
                  for i in range(0, len(entries), 2 * _CHUNK_K)]
        first = b.end
        nodes = []
        for j, group in enumerate(groups):
            left = first + (j - 1) * node_size if j else UNDEFINED
            right = (first + (j + 1) * node_size if j + 1 < len(groups)
                     else UNDEFINED)
            body = b"TREE" + struct.pack("<BBHQQ", 1, level, len(group),
                                         left, right)
            for k, child in group:
                body += k + struct.pack("<Q", child)
            body += groups[j + 1][0][0] if j + 1 < len(groups) else end
            body += b"\0" * (node_size - len(body))
            nodes.append((group[0][0], b.add(body)))
        if len(nodes) == 1:
            return nodes[0][1]
        level, entries = level + 1, nodes


def _dataset(b: _Builder, array: np.ndarray, cshape=None, deflate=None,
             shuffle=False) -> int:
    array = np.asarray(array)
    if array.dtype.byteorder == ">":
        array = array.astype(array.dtype.newbyteorder("<"))
    array = np.asarray(array, order="C")   # (ascontiguousarray makes 0-d 1-d)
    dtype = array.dtype
    messages = [_message(_DATASPACE, _dataspace_message(array.shape)),
                _message(_DATATYPE, _datatype_message(dtype), flags=0x01)]
    if cshape is None:
        raw = array.tobytes()
        addr = b.add(raw) if raw else UNDEFINED
        # version 2: late allocation, written if set, the default value
        messages += [
            _message(_FILL_NEW, struct.pack("<BBBBI", 2, 2, 2, 1, 0),
                     flags=0x01),
            _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, len(raw)))]
        return b.add(_object_header(messages))
    cshape = tuple(int(c) for c in cshape)
    if len(cshape) != array.ndim or min(cshape, default=0) < 1:
        raise ValueError(f"hdf5.write: chunk shape {cshape} for an array "
                         f"of shape {array.shape}")
    filters = []
    if shuffle:
        filters.append((SHUFFLE, "shuffle", (dtype.itemsize,)))
    if deflate is not None:
        filters.append((DEFLATE, "deflate", (int(deflate),)))
    chunks = []
    for offsets in itertools.product(*(range(0, n, c) for n, c in
                                       zip(array.shape, cshape))):
        block = np.zeros(cshape, dtype)           # edge chunks: full size
        part = array[tuple(slice(o, o + c) for o, c in zip(offsets, cshape))]
        block[tuple(slice(0, s) for s in part.shape)] = part
        raw = block.tobytes()
        if shuffle:
            raw = _shuffle(raw, dtype.itemsize)
        if deflate is not None:
            raw = zlib.compress(raw, int(deflate))
        chunks.append((offsets, len(raw), b.add(raw)))
    btree = _chunk_btree(b, chunks, cshape) if chunks else UNDEFINED
    # version 2: incremental allocation, written if set, the default value
    messages.append(_message(_FILL_NEW, struct.pack("<BBBBI", 2, 3, 2, 1, 0),
                             flags=0x01))
    if filters:
        messages.append(_message(_FILTERS, _filter_message(filters)))
    messages.append(_message(_LAYOUT, struct.pack(
        f"<BBBQ{len(cshape) + 1}I", 3, 2, len(cshape) + 1, btree, *cshape,
        dtype.itemsize)))
    return b.add(_object_header(messages))


Tree = Dict[str, Union[np.ndarray, "Tree"]]


def write(path: str, tree: Tree, *,
          chunks: Union[None, int, Dict[str, Sequence[int]]] = None,
          deflate: Optional[int] = None, shuffle: bool = False):
    """Write ``tree``, a nested dict of arrays (a dict is a group), as an
    HDF5 file: integers, IEEE floats and fixed-length byte strings, of any
    rank (0 is a scalar).

    ``chunks`` chunks the datasets: an int is the rows a chunk holds along
    the first axis of every dataset of rank >= 1 (the other axes whole), a
    dict gives the chunk shape of the datasets it names (``"a/b"``); the
    rest are contiguous. ``deflate`` (a zlib level) and ``shuffle`` filter
    every chunked dataset, shuffle first, as h5py orders them."""
    if (deflate is not None or shuffle) and chunks is None:
        raise ValueError("hdf5.write: deflate and shuffle need chunks=")

    def chunk_shape(name, array):
        if isinstance(chunks, dict):
            return chunks.get(name)
        if chunks is None or array.ndim == 0:
            return None
        return (max(1, min(int(chunks), array.shape[0])),) + array.shape[1:]

    b = _Builder(_SUPERBLOCK_SIZE)

    def group(prefix, members):
        entries = {}
        for k, obj in members.items():
            if "/" in k or not k:
                raise ValueError(f"hdf5.write: the name {k!r}")
            name = prefix + k
            if isinstance(obj, dict):
                entries[k] = group(name + "/", obj)[0]
            else:
                array = np.asarray(obj)
                entries[k] = _dataset(b, array, chunk_shape(name, array),
                                      deflate, shuffle)
        return _group(b, entries)

    root, btree, heap = group("", tree)
    eof = b.end
    sb = SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
    sb += struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
    sb += struct.pack("<4Q", 0, UNDEFINED, eof, UNDEFINED)
    # the root's entry, its B-tree and heap cached (as libhdf5 writes it)
    sb += struct.pack("<QQI4xQQ", 0, root, 1, btree, heap)
    if len(sb) != _SUPERBLOCK_SIZE:
        raise AssertionError(len(sb))
    with open(path, "wb") as f:
        f.write(sb)
        for part in b.parts:
            f.write(part)


def write_event_block(path: str, values: np.ndarray,
                      columns: Sequence[str] = ("ts", "x", "y", "p"),
                      key: str = "myDataset"):
    """Write ``values`` [N, C] (float64) with its column names as the
    JAX package's h5py branch does: ``{key}/axis0`` and
    ``{key}/block0_items`` (the names, fixed-length byte strings) and
    ``{key}/block0_values``, contiguous."""
    names = np.array([c.encode() for c in columns])
    write(path, {key: {"axis0": names, "block0_items": names,
                       "block0_values": np.asarray(values, np.float64)}})
