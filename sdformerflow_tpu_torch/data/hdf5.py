"""A numpy reader and writer for the subset of HDF5 that holds an event
window, in place of the pandas / PyTables / h5py stack that
``sdformerflow_tpu/data/loader_utils.py`` (``get_events_h5``,
``write_events_h5``) reads and writes it with.

An event window is pandas' fixed-format frame under the key
``myDataset``: a group holding ``block0_items`` (the column names as
fixed-length byte strings) and ``block0_values`` (a 2-D array, one row an
event). Both pandas (through PyTables) and h5py write it, at their default
settings, in this subset of the format, which is all the reader takes:

- superblock version 0 or 1, 8-byte offsets and lengths;
- version 1 object headers, continuation blocks included (PyTables writes
  many attributes);
- symbol-table groups: a version 1 B-tree of group nodes, symbol-table
  nodes (``SNOD``) and a local heap;
- datasets stored contiguously or compactly (layout message version 3);
- little-endian IEEE floats, little-endian integers and fixed-length
  byte strings.

Messages that the reader does not need (attributes, fill values,
modification times, ...) are skipped. Anything outside the subset raises a
``ValueError`` that names the feature: chunked storage, a filter pipeline
(compression), version 2 object headers or B-trees, link messages (groups
of the newer format), big-endian data, superblock version 2 or later. The
reader never guesses at such a file.

:func:`write_event_block` writes the layout of the JAX package's h5py
branch (``myDataset/{axis0, block0_items, block0_values}``) and nothing
more: superblock 0, version 1 object headers, symbol-table groups and
contiguous datasets, which h5py (libhdf5) reads.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO = 0x06, 0x07, 0x08, 0x0A
_FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x0B, 0x10, 0x11
_FILL_NEW = 0x05

_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumerated", 9: "variable-length",
                10: "array"}
# (bit offset, precision, exponent location, exponent size, mantissa
# location, mantissa size, exponent bias) of the IEEE formats, by size
_IEEE = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127),
         8: (0, 64, 52, 11, 0, 52, 1023)}


class _File:
    """One HDF5 file's bytes and the walk of its objects."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()
        self.base, self.root = self._superblock()

    def unsupported(self, what: str):
        raise ValueError(f"{self.path}: {what} is outside the HDF5 subset "
                         f"this reader takes (data/hdf5.py)")

    def corrupt(self, what: str):
        raise ValueError(f"{self.path}: not a valid HDF5 file ({what})")

    def unpack(self, fmt: str, pos: int):
        if pos < 0 or pos + struct.calcsize(fmt) > len(self.buf):
            self.corrupt(f"a read at byte {pos} past the end of the file")
        return struct.unpack_from(fmt, self.buf, pos)

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

    # ------------------------------------------------------------ groups

    def links(self, addr: int) -> Dict[str, int]:
        """{name: object header address} of the group at ``addr``."""
        msgs = self.messages(addr)
        if any(t in (_LINK, _LINK_INFO, _GROUP_INFO) for t, _, _ in msgs):
            self.unsupported("link messages (a group of the newer format)")
        tables = [d for t, _, d in msgs if t == _SYMBOL_TABLE]
        if not tables:
            raise KeyError(f"{self.path}: the object at {addr} is not a "
                           f"group")
        btree, heap_addr = struct.unpack_from("<QQ", tables[0])
        heap = self._local_heap(heap_addr)
        out: Dict[str, int] = {}
        self._btree(btree, heap, out)
        return out

    def _local_heap(self, addr: int) -> bytes:
        pos = self.base + addr
        if self.buf[pos:pos + 4] != b"HEAP" or self.buf[pos + 4] != 0:
            self.corrupt("a local heap")
        size, _, data = self.unpack("<QQQ", pos + 8)
        return self.buf[self.base + data:self.base + data + size]

    def _btree(self, addr: int, heap: bytes, out: Dict[str, int]):
        pos = self.base + addr
        sig = self.buf[pos:pos + 4]
        if sig == b"BTHD":
            self.unsupported("a version 2 B-tree")
        if sig != b"TREE" or self.buf[pos + 4] != 0:
            self.corrupt("a group B-tree node")
        level, used = self.buf[pos + 5], self.unpack("<H", pos + 6)[0]
        for i in range(used):
            # key 0, child 0, key 1, child 1, ... after the two siblings
            (child,) = self.unpack("<Q", pos + 24 + 8 + 16 * i)
            if level > 0:
                self._btree(child, heap, out)
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

    def find(self, name: str) -> int:
        """The object header address of the object at path ``name``."""
        addr = self.root
        for part in (p for p in name.split("/") if p):
            links = self.links(addr)
            if part not in links:
                raise KeyError(f"{self.path}: no object {name!r}")
            addr = links[part]
        return addr

    # ---------------------------------------------------------- datasets

    def dataset(self, addr: int) -> np.ndarray:
        msgs = self.messages(addr)
        found = {}
        for mtype, flags, data in msgs:
            if mtype == _FILTERS:
                self.unsupported("a filter pipeline (compressed or filtered "
                                 "storage)")
            if mtype == _EXTERNAL:
                self.unsupported("external storage")
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT):
                if flags & 0x02:
                    self.unsupported("a shared (committed) message")
                found.setdefault(mtype, data)
        for need, what in ((_DATASPACE, "dataspace"), (_DATATYPE, "datatype"),
                           (_LAYOUT, "layout")):
            if need not in found:
                raise KeyError(f"{self.path}: the object at {addr} is not a "
                               f"dataset (no {what} message)")
        shape = self._dataspace(found[_DATASPACE])
        dtype = self._datatype(found[_DATATYPE])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        raw = self._layout(found[_LAYOUT], nbytes)
        return np.frombuffer(raw, dtype).reshape(shape).copy()

    def _dataspace(self, d: bytes) -> Tuple[int, ...]:
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

    def _datatype(self, d: bytes) -> np.dtype:
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

    def _layout(self, d: bytes, nbytes: int) -> bytes:
        version = d[0]
        if version != 3:
            self.unsupported(f"layout message version {version}")
        cls = d[1]
        if cls == 2:
            self.unsupported("chunked storage")
        if cls == 0:                                    # compact
            (size,) = struct.unpack_from("<H", d, 2)
            raw = d[4:4 + size]
        elif cls == 1:                                  # contiguous
            addr, size = struct.unpack_from("<QQ", d, 2)
            if addr == UNDEFINED:
                if nbytes:
                    self.unsupported("a dataset whose storage was never "
                                     "written (fill values)")
                return b""
            raw = self.buf[self.base + addr:self.base + addr + size]
        else:
            self.unsupported(f"layout class {cls}")
        if len(raw) < nbytes:
            self.corrupt(f"{len(raw)} bytes of data where the dataspace "
                         f"needs {nbytes}")
        return raw[:nbytes]


def read_event_block(path: str, key: str = "myDataset"
                     ) -> Tuple[List[str], np.ndarray]:
    """(column names, values [N, C]) of the pandas fixed-format frame
    stored under ``key``: its ``block0_items`` and ``block0_values``."""
    f = _File(path)
    group = f.links(f.find(key))
    for need in ("block0_items", "block0_values"):
        if need not in group:
            raise KeyError(f"{path}: no {key}/{need}")
    items = f.dataset(group["block0_items"])
    values = f.dataset(group["block0_values"])
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
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dtype.itemsize)
    raise ValueError(f"write_event_block: no HDF5 datatype for {dtype}")


def _dataspace_message(shape: Tuple[int, ...]) -> bytes:
    return (struct.pack("<BBBx4x", 1, len(shape), 1)
            + struct.pack(f"<{2 * len(shape)}Q", *shape, *shape))


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
_SUPERBLOCK_SIZE = 96


def _group(b: _Builder, entries: Dict[str, int]) -> Tuple[int, int, int]:
    """A symbol-table group holding ``entries`` (name -> object header
    address, at most 2 * leaf K): (its object header, B-tree and local heap
    addresses)."""
    names = sorted(entries)
    if len(names) > 2 * _LEAF_K:
        raise ValueError("write_event_block: too many links for one node")
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


def _dataset(b: _Builder, array: np.ndarray) -> int:
    raw = np.ascontiguousarray(array).tobytes()
    addr = b.add(raw) if raw else UNDEFINED
    # version 2: late allocation, written if set, the default value
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    layout = struct.pack("<BBQQ", 3, 1, addr, len(raw))
    return b.add(_object_header([
        _message(_DATASPACE, _dataspace_message(array.shape)),
        _message(_DATATYPE, _datatype_message(array.dtype), flags=0x01),
        _message(_FILL_NEW, fill, flags=0x01),
        _message(_LAYOUT, layout)]))


def write_event_block(path: str, values: np.ndarray,
                      columns: Sequence[str] = ("ts", "x", "y", "p"),
                      key: str = "myDataset"):
    """Write ``values`` [N, C] (float64) with its column names as the
    JAX package's h5py branch does: ``{key}/axis0`` and
    ``{key}/block0_items`` (the names, fixed-length byte strings) and
    ``{key}/block0_values``."""
    values = np.asarray(values, np.float64)
    names = np.array([c.encode() for c in columns])
    b = _Builder(_SUPERBLOCK_SIZE)
    datasets = {"axis0": _dataset(b, names),
                "block0_items": _dataset(b, names),
                "block0_values": _dataset(b, values)}
    group, _, _ = _group(b, datasets)
    root, btree, heap = _group(b, {key: group})
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
