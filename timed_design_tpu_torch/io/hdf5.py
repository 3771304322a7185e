"""The subset of HDF5 that frame datasets use, read and written in pure
Python (numpy, ``zlib``), with no h5py: the card's machine has none.

The subset is what h5py writes by default (``libver="earliest"``) for the
JAX package's ``make_frame_dataset``, ``_FlatWriter`` and
``convert_to_flat``, and for aposteriori's datasets:
  - superblock version 0 or 1, 8-byte offsets and lengths;
  - version 1 object headers, with continuation blocks;
  - groups as symbol tables: a v1 B-tree of any depth over symbol-table
    nodes, names in a local heap;
  - fixed-point and IEEE floating-point types (f16, f32, f64), h5py's bool
    (an enum over int8), fixed-length and variable-length strings (the
    latter in global heap collections);
  - scalar and simple dataspaces, with max dims;
  - compact, contiguous and chunked layouts, chunks indexed by a v1 B-tree,
    edge chunks stored at full size;
  - the deflate, shuffle and fletcher32 filters;
  - attributes in the object header.
Anything else raises a ``ValueError`` that names the structure met: a
superblock of version 2 or 3 and version 2 object headers (``libver=
"latest"``), link messages, dense attribute storage, compound and other
types, other filters, chunk indexes other than the v1 B-tree.

``File`` reads, with an h5py-shaped surface (``Group``: ``[]``, ``in``,
``keys()``, ``attrs``; ``Dataset``: ``shape``, ``dtype``, ``chunks``,
``compression``, ``attrs``, ``[()]`` and slices), and what a loader needs to
read raw data itself (``Dataset.data_offset``, ``Dataset.chunk_index()``,
``Dataset.decode_chunk``). It holds no global lock: metadata is read from a
read-only memory map, data with ``os.pread``. Values read equal h5py's:
variable-length strings are ``bytes`` in datasets and ``str`` in
attributes, h5py's bool enum reads as ``numpy.bool_``.

``Writer`` writes a new file that h5py opens: groups, datasets (contiguous,
or chunked with gzip) and attributes converted as h5py converts them (a
``str`` to a variable-length UTF-8 string, a list of ``str`` to an array of
them, ``bool`` to h5py's enum, a Python ``int`` or ``float`` to a 64-bit
scalar). Data goes to the file as it comes; the metadata is written when
the file closes, which is also when an appendable dataset (``Group.
create_appendable``) takes its final size.
"""
from __future__ import annotations

import mmap
import os
import struct
import typing as t
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _BOGUS, _GROUP_INFO, _FILTERS = 0x6, 0x7, 0x8, 0x9, 0xA, 0xB
_ATTRIBUTE, _COMMENT, _MTIME_OLD, _SHARED_TABLE, _CONTINUATION = 0xC, 0xD, 0xE, 0xF, 0x10
_SYMBOL_TABLE, _MTIME, _BTREE_K, _DRV_INFO, _ATTR_INFO, _REFCOUNT = 0x11, 0x12, 0x13, 0x14, 0x15, 0x16
_REFUSED_MESSAGES = {
    _LINK_INFO: "a link info message (a group in the new format)",
    _LINK: "a link message (a group in the new format)",
    _GROUP_INFO: "a group info message (a group in the new format)",
    _EXTERNAL: "external data storage",
    _SHARED_TABLE: "a shared message table",
}
_IGNORED_MESSAGES = {_NIL, _FILL_OLD, _BOGUS, _COMMENT, _MTIME_OLD, _MTIME, _BTREE_K,
                     _DRV_INFO, _REFCOUNT}

# filters
DEFLATE, SHUFFLE, FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf", 32001: "blosc",
                 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}

# datatype classes
_FIXED, _FLOAT, _TIME, _STRING, _BITFIELD, _OPAQUE = 0, 1, 2, 3, 4, 5
_COMPOUND, _REFERENCE, _ENUM, _VLEN, _ARRAY = 6, 7, 8, 9, 10
_CLASS_NAMES = {_TIME: "time", _BITFIELD: "bitfield", _OPAQUE: "opaque",
                _COMPOUND: "compound", _REFERENCE: "reference", _ARRAY: "array"}

# one variable-length element as stored: byte length, global heap collection, object index
_VLEN_REF = np.dtype([("len", "<u4"), ("addr", "<u8"), ("index", "<u4")])


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Type(t.NamedTuple):
    """A datatype read from a file: ``kind`` is 'num' (``dtype`` is the
    numpy dtype), 'bool' (h5py's enum over int8; ``dtype`` the stored int8),
    'fixed_str' (``dtype`` 'S<n>') or 'vlen_str'."""

    kind: str
    dtype: np.dtype
    size: int


# ------------------------------------------------------------------ reading

class File:
    """A read-only HDF5 file (the subset in the module docstring)."""

    def __init__(self, path, mode: str = "r"):
        if mode != "r":
            raise ValueError(f"File opens files for reading only (mode {mode!r}); "
                             "use Writer to write one")
        self.filename = str(path)
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._mm = mmap.mmap(self._fd, 0, access=mmap.ACCESS_READ)
            root = self._superblock()
        except BaseException:
            self.close()
            raise
        self._headers: dict[int, list] = {}
        self._heaps: dict[int, dict[int, bytes]] = {}
        self._tables: dict[int, dict[str, int]] = {}  # group members, by B-tree address
        self._root = Group(self, root, "/")

    # -- the h5py surface, through the root group
    @property
    def attrs(self) -> "Attributes":
        return self._root.attrs

    def __getitem__(self, name: str):
        return self._root[name]

    def __contains__(self, name: str) -> bool:
        return name in self._root

    def __iter__(self):
        return iter(self._root)

    def __len__(self) -> int:
        return len(self._root)

    def keys(self) -> list[str]:
        return self._root.keys()

    def close(self) -> None:
        mm = getattr(self, "_mm", None)
        if mm is not None:
            mm.close()
            self._mm = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- raw access
    def read_raw(self, addr: int, size: int) -> bytes:
        """``size`` bytes at file address ``addr`` (``os.pread``: no lock,
        the interpreter lock released while the disk reads)."""
        data = os.pread(self._fd, size, addr)
        if len(data) != size:
            raise ValueError(f"{self.filename}: {size} bytes at {addr} run past the end "
                             "of the file")
        return data

    def _u(self, fmt: str, off: int) -> tuple:
        try:
            return struct.unpack_from("<" + fmt, self._mm, off)
        except struct.error:
            raise ValueError(f"{self.filename}: truncated file (reading at {off})") from None

    def _superblock(self) -> int:
        """The root group's object header address."""
        if self._mm[:8] != SIGNATURE:
            raise ValueError(f"{self.filename}: not an HDF5 file, or one with a user block "
                             "(no superblock signature at its start)")
        off = 0
        version = self._mm[off + 8]
        if version not in (0, 1):
            raise ValueError(
                f"{self.filename}: superblock version {version} (a file written with "
                "libver='latest' or a newer format) is outside the subset read here, "
                "which is superblock version 0 or 1")
        sizeof_offsets, sizeof_lengths = self._mm[off + 13], self._mm[off + 14]
        if (sizeof_offsets, sizeof_lengths) != (8, 8):
            raise ValueError(f"{self.filename}: {sizeof_offsets}-byte offsets and "
                             f"{sizeof_lengths}-byte lengths; the subset reads 8-byte ones")
        p = off + 24 + (4 if version == 1 else 0)
        base, _free, _eof, _drv = self._u("4Q", p)
        if base:
            raise ValueError(f"{self.filename}: base address {base}; the subset reads files "
                             "whose addresses start at 0")
        _name, header = self._u("2Q", p + 32)
        return header

    # -- object headers
    def _messages(self, addr: int) -> list[tuple[int, int, int, int]]:
        """[(type, flags, payload address, payload size)] of the version 1
        object header at ``addr``, continuation blocks followed."""
        cached = self._headers.get(addr)
        if cached is not None:
            return cached
        if self._mm[addr:addr + 4] == b"OHDR":
            raise ValueError(f"{self.filename}: a version 2 object header at {addr} (as "
                             "libver='latest' or track_order=True write); the subset "
                             "reads version 1 headers")
        version, _, n_messages, _refs, size = self._u("BBHII", addr)
        if version != 1:
            raise ValueError(f"{self.filename}: object header version {version} at {addr}")
        out = []
        blocks = [(addr + 16, size)]
        while blocks:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end:
                mtype, msize, flags = self._u("HHB", p)
                data = p + 8
                if data + msize > end:
                    raise ValueError(f"{self.filename}: a header message overruns its "
                                     f"block at {p}")
                if mtype == _CONTINUATION:
                    blocks.append(self._u("2Q", data))
                elif mtype not in _IGNORED_MESSAGES:
                    if flags & 0x02:
                        raise ValueError(f"{self.filename}: a shared header message (type "
                                         f"{mtype:#x}) at {p}; the subset reads unshared ones")
                    out.append((mtype, flags, data, msize))
                p = data + msize
        if len(out) > n_messages:
            raise ValueError(f"{self.filename}: object header at {addr} holds more messages "
                             "than it declares")
        for mtype, flags, _, _ in out:
            if mtype in _REFUSED_MESSAGES:
                raise ValueError(f"{self.filename}: {_REFUSED_MESSAGES[mtype]} in the object "
                                 f"header at {addr}; the subset reads symbol-table groups")
            if mtype == _ATTR_INFO:
                fractal, = self._u("Q", self._attr_info_heap(out))
                if fractal != UNDEF:
                    raise ValueError(f"{self.filename}: dense attribute storage (a fractal "
                                     f"heap) in the object header at {addr}")
            elif mtype not in _KNOWN and flags & 0x80:
                raise ValueError(f"{self.filename}: header message type {mtype:#x}, marked "
                                 f"fail-if-unknown, at {addr}")
        self._headers[addr] = out
        return out

    def _attr_info_heap(self, msgs) -> int:
        """Address of the fractal-heap field of an attribute info message."""
        data = next(d for m, _, d, _ in msgs if m == _ATTR_INFO)
        flags = self._mm[data + 1]
        return data + 2 + (2 if flags & 1 else 0)

    # -- datatypes, dataspaces
    def _datatype(self, off: int) -> tuple[_Type, int]:
        """The datatype at ``off`` and the bytes it takes."""
        cv, b0, b1, b2, size = self._u("BBBBI", off)
        cls, version = cv & 0x0F, cv >> 4
        bits = b0 | (b1 << 8) | (b2 << 16)
        order = ">" if bits & 1 else "<"
        if cls == _FIXED:
            if size not in (1, 2, 4, 8):
                raise ValueError(f"{self.filename}: a {size}-byte integer type")
            kind = "i" if bits & 0x08 else "u"
            return _Type("num", np.dtype(f"{order}{kind}{size}"), size), 12
        if cls == _FLOAT:
            _offset, precision, epos, esize, mpos, msize, bias = self._u("HHBBBBI", off + 8)
            ieee = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
                    8: (64, 52, 11, 0, 52, 1023)}.get(size)
            sign = (bits >> 8) & 0xFF
            if ieee != (precision, epos, esize, mpos, msize, bias) or sign != size * 8 - 1:
                raise ValueError(f"{self.filename}: a {size}-byte floating-point type that "
                                 "is not IEEE 754 binary16/32/64")
            return _Type("num", np.dtype(f"{order}f{size}"), size), 20
        if cls == _STRING:
            return _Type("fixed_str", np.dtype(f"S{size}"), size), 8
        if cls == _VLEN:
            base, n = self._datatype(off + 8)
            if bits & 0x0F != 1:
                raise ValueError(f"{self.filename}: a variable-length sequence type; the "
                                 "subset reads variable-length strings")
            return _Type("vlen_str", np.dtype(object), size), 8 + n
        if cls == _ENUM:
            base, n = self._datatype(off + 8)
            n_members = bits & 0xFFFF
            p = off + 8 + n
            names = []
            for _ in range(n_members):
                end = self._mm.find(b"\0", p)
                names.append(self._mm[p:end].decode())
                p = end + 1 if version >= 3 else p + _pad8(end + 1 - p)
            values = np.frombuffer(self._mm[p:p + n_members * base.size], base.dtype)
            p += n_members * base.size
            if (base.kind == "num" and base.dtype.itemsize == 1 and base.dtype.kind == "i"
                    and dict(zip(names, values.tolist())) == {"FALSE": 0, "TRUE": 1}):
                return _Type("bool", base.dtype, 1), p - off
            return _Type("num", base.dtype, base.size), p - off
        raise ValueError(f"{self.filename}: a {_CLASS_NAMES.get(cls, f'class {cls}')} "
                         "datatype; the subset reads integers, floats, h5py's bool "
                         "enum and strings")

    def _dataspace(self, off: int) -> tuple[tuple[int, ...], tuple[int | None, ...] | None]:
        version, rank, flags = self._u("BBB", off)
        if version == 1:
            p = off + 8
        elif version == 2:
            if self._mm[off + 3] == 2:
                raise ValueError(f"{self.filename}: a null dataspace at {off}")
            p = off + 4
        else:
            raise ValueError(f"{self.filename}: dataspace message version {version}")
        dims = self._u(f"{rank}Q", p)
        maxdims = None
        if flags & 1:
            maxdims = tuple(None if d == UNDEF else d for d in self._u(f"{rank}Q", p + 8 * rank))
        return tuple(dims), maxdims

    # -- values
    def _global_heap(self, addr: int) -> dict[int, bytes]:
        heap = self._heaps.get(addr)
        if heap is None:
            if self._mm[addr:addr + 4] != b"GCOL":
                raise ValueError(f"{self.filename}: no global heap collection at {addr}")
            size, = self._u("Q", addr + 8)
            heap, p, end = {}, addr + 16, addr + size
            while p + 16 <= end:
                index, _refs, osize = self._u("HHxxxxQ", p)
                if index == 0:
                    break  # free space: the rest of the collection
                heap[index] = bytes(self._mm[p + 16:p + 16 + osize])
                p += 16 + _pad8(osize)
            self._heaps[addr] = heap
        return heap

    def _vlen_strings(self, refs: np.ndarray) -> list[bytes]:
        out = []
        for length, addr, index in refs.tolist():
            out.append(self._global_heap(addr)[index][:length] if addr else b"")
        return out

    def _values(self, stored: np.ndarray, typ: _Type, as_str: bool):
        """Stored elements -> what h5py gives: variable-length strings as
        ``bytes`` (``str`` with ``as_str``, as in attributes), h5py's bool
        enum as bool, numbers as a writable array; a scalar for shape ()."""
        if typ.kind == "vlen_str":
            vals = self._vlen_strings(stored.reshape(-1))
            arr = np.empty(len(vals), object)
            arr[:] = [v.decode("utf-8") for v in vals] if as_str else vals
            arr = arr.reshape(stored.shape)
        elif typ.kind == "bool":
            arr = stored != 0
        else:
            arr = np.array(stored)
        if stored.shape == ():
            v = arr[()]
            return v if typ.kind == "vlen_str" else arr.dtype.type(v)
        return arr


def _storage_dtype(typ: _Type) -> np.dtype:
    """The numpy dtype of a type's stored elements."""
    return _VLEN_REF if typ.kind == "vlen_str" else typ.dtype


_KNOWN = set(_IGNORED_MESSAGES) | {_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _FILTERS, _ATTRIBUTE,
                                   _SYMBOL_TABLE, _ATTR_INFO, _CONTINUATION}


class Attributes:
    """An object's attributes, by name in byte order (as h5py lists them)."""

    def __init__(self, f: File, msgs):
        self._f = f
        self._where: dict[str, tuple[int, int]] = {}
        for mtype, _, data, size in msgs:
            if mtype == _ATTRIBUTE:
                name, _ = self._header(data)
                self._where[name] = (data, size)
        self._where = dict(sorted(self._where.items(), key=lambda kv: kv[0].encode()))

    def _header(self, off: int):
        f = self._f
        version, flags, nlen, tlen, slen = f._u("BBHHH", off)
        if version == 1:
            p = off + 8
            pad = _pad8
        elif version in (2, 3):
            if flags & 0x3:
                raise ValueError(f"{f.filename}: an attribute with a shared datatype or "
                                 "dataspace")
            p = off + 8 + (1 if version == 3 else 0)
            pad = int
        else:
            raise ValueError(f"{f.filename}: attribute message version {version}")
        name = f._mm[p:p + nlen - 1].decode("utf-8")
        p += pad(nlen)
        tp = p
        p += pad(tlen)
        sp = p
        p += pad(slen)
        return name, (tp, sp, p)

    def keys(self) -> list[str]:
        return list(self._where)

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def __getitem__(self, name: str):
        off, _ = self._where[name]
        f = self._f
        _, (tp, sp, dp) = self._header(off)
        typ, _ = f._datatype(tp)
        shape, _ = f._dataspace(sp)
        n = int(np.prod(shape, dtype=np.int64))
        stored = np.frombuffer(f._mm[dp:dp + n * typ.size], _storage_dtype(typ)).reshape(shape)
        return f._values(stored, typ, as_str=True)

    def get(self, name: str, default=None):
        return self[name] if name in self._where else default

    def items(self):
        return [(k, self[k]) for k in self._where]


class Group:
    """A symbol-table group: members by name in byte order (h5py's order)."""

    def __init__(self, f: File, addr: int, name: str):
        self.file, self.name, self._addr = f, name, addr
        msgs = f._messages(addr)
        sym = [d for m, _, d, _ in msgs if m == _SYMBOL_TABLE]
        if not sym:
            raise ValueError(f"{f.filename}: {name} is not a symbol-table group")
        self._btree, heap = f._u("2Q", sym[0])
        self.attrs = Attributes(f, msgs)
        if f._mm[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{f.filename}: no local heap at {heap} for group {name}")
        self._heap_data, = f._u("Q", heap + 24)
        self._members: dict[str, int] | None = None

    def _member_table(self) -> dict[str, int]:
        if self._members is None:
            self._members = self.file._tables.get(self._btree)
        if self._members is None:
            f = self.file
            members: dict[str, int] = {}
            for snod in self._leaves(self._btree):
                if f._mm[snod:snod + 4] != b"SNOD":
                    raise ValueError(f"{f.filename}: no symbol table node at {snod}")
                n, = f._u("H", snod + 6)
                for i in range(n):
                    e = snod + 8 + 40 * i
                    name_off, header, cache = f._u("QQI", e)
                    if cache == 2:
                        raise ValueError(f"{f.filename}: a soft link in group {self.name}")
                    members[self._name_at(name_off)] = header
            self._members = f._tables[self._btree] = members
        return self._members

    def _leaves(self, node: int) -> t.Iterator[int]:
        """Children of the group B-tree's level-0 nodes (symbol table
        nodes), left to right."""
        f = self.file
        if f._mm[node:node + 4] != b"TREE":
            raise ValueError(f"{f.filename}: no v1 B-tree node at {node}")
        ntype, level, used = f._u("BBH", node + 4)
        if ntype != 0:
            raise ValueError(f"{f.filename}: a group B-tree node of type {ntype}")
        children = [f._u("Q", node + 24 + 8 + 16 * i)[0] for i in range(used)]
        for c in children:
            if level == 0:
                yield c
            else:
                yield from self._leaves(c)

    def _name_at(self, off: int) -> str:
        mm = self.file._mm
        p = self._heap_data + off
        return mm[p:mm.find(b"\0", p)].decode("utf-8")

    def keys(self) -> list[str]:
        return list(self._member_table())

    def __iter__(self):
        return iter(self._member_table())

    def __len__(self) -> int:
        return len(self._member_table())

    def __contains__(self, name: str) -> bool:
        node = self
        for part in [p for p in name.split("/") if p]:
            if not isinstance(node, Group) or part not in node._member_table():
                return False
            node = node[part]
        return True

    def __getitem__(self, name: str):
        node = self
        for part in [p for p in name.split("/") if p]:
            addr = node._member_table()[part]  # KeyError for a missing name, as h5py
            path = f"{node.name.rstrip('/')}/{part}"
            msgs = node.file._messages(addr)
            kinds = {m for m, _, _, _ in msgs}
            node = (Group if _SYMBOL_TABLE in kinds else Dataset)(node.file, addr, path)
        return node


class ChunkInfo(t.NamedTuple):
    """One stored chunk: its offset in the dataset (elements), file address,
    stored size in bytes and filter mask (bit i set: filter i skipped)."""

    offset: tuple[int, ...]
    addr: int
    size: int
    filter_mask: int


class Dataset:
    """A dataset of the subset. ``data_offset`` is the file address of a
    contiguous dataset's data (None otherwise); ``chunk_index()`` lists a
    chunked one's chunks; ``decode_chunk`` undoes the filters of one."""

    def __init__(self, f: File, addr: int, name: str):
        self.file, self.name = f, name
        msgs = f._messages(addr)
        by_type: dict[int, list[int]] = {}
        for mtype, _, data, _ in msgs:
            by_type.setdefault(mtype, []).append(data)
        for need, what in ((_DATASPACE, "dataspace"), (_DATATYPE, "datatype"),
                           (_LAYOUT, "data layout")):
            if need not in by_type:
                raise ValueError(f"{f.filename}: {name} has no {what} message")
        self._type, _ = f._datatype(by_type[_DATATYPE][0])
        self.shape, self.maxshape = f._dataspace(by_type[_DATASPACE][0])
        if self.maxshape is None:
            self.maxshape = self.shape
        self.dtype = np.dtype(bool) if self._type.kind == "bool" else self._type.dtype
        self.filters: list[tuple[int, tuple[int, ...]]] = (
            self._filters(by_type[_FILTERS][0]) if _FILTERS in by_type else [])
        self._fill = self._fill_value(by_type.get(_FILL, [None])[0])
        self.attrs = Attributes(f, msgs)
        self._layout(by_type[_LAYOUT][0])
        self._chunks: list[ChunkInfo] | None = None

    # -- h5py's properties
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def compression(self) -> str | None:
        return "gzip" if any(fid == DEFLATE for fid, _ in self.filters) else None

    @property
    def compression_opts(self) -> int | None:
        return next((cd[0] for fid, cd in self.filters if fid == DEFLATE and cd), None)

    @property
    def shuffle(self) -> bool:
        return any(fid == SHUFFLE for fid, _ in self.filters)

    @property
    def fletcher32(self) -> bool:
        return any(fid == FLETCHER32 for fid, _ in self.filters)

    # -- messages
    def _filters(self, off: int) -> list[tuple[int, tuple[int, ...]]]:
        f = self.file
        version, n = f._u("BB", off)
        p = off + (8 if version == 1 else 2)
        out = []
        for _ in range(n):
            fid, = f._u("H", p)
            if version == 1 or fid >= 256:
                fid, nlen, _flags, nvals = f._u("HHHH", p)
                p += 8 + (_pad8(nlen) if version == 1 else nlen)
            else:
                fid, _flags, nvals = f._u("HHH", p)
                p += 6
            values = f._u(f"{nvals}I", p)
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (DEFLATE, SHUFFLE, FLETCHER32):
                raise ValueError(f"{f.filename}: {self.name} uses the "
                                 f"{_FILTER_NAMES.get(fid, f'unknown ({fid})')} filter; the "
                                 "subset reads deflate, shuffle and fletcher32")
            out.append((fid, values))
        return out

    def _fill_value(self, off: int | None) -> bytes | None:
        if off is None:
            return None
        f = self.file
        version = f._mm[off]
        if version in (1, 2):
            defined = f._mm[off + 3]
            if version == 2 and not defined:
                return None
            size, = f._u("I", off + 4)
            p = off + 8
        elif version == 3:
            flags = f._mm[off + 1]
            if not flags & 0x20:
                return None
            size, = f._u("I", off + 2)
            p = off + 6
        else:
            raise ValueError(f"{f.filename}: fill value message version {version}")
        return bytes(f._mm[p:p + size]) if size == self._type.size else None

    def _layout(self, off: int) -> None:
        f = self.file
        version = f._mm[off]
        self.data_offset: int | None = None
        self.chunks: tuple[int, ...] | None = None
        self._compact: bytes | None = None
        if version == 3:
            cls = f._mm[off + 1]
            if cls == 0:
                size, = f._u("H", off + 2)
                self._compact = bytes(f._mm[off + 4:off + 4 + size])
            elif cls == 1:
                addr, _size = f._u("QQ", off + 2)
                self.data_offset = None if addr == UNDEF else addr
            elif cls == 2:
                ndims = f._mm[off + 2]
                self._btree, = f._u("Q", off + 3)
                dims = f._u(f"{ndims}I", off + 11)
                self.chunks = tuple(dims[:-1])
            else:
                raise ValueError(f"{f.filename}: {self.name} has a virtual layout")
        elif version in (1, 2):
            ndims, cls = f._mm[off + 1], f._mm[off + 2]
            p = off + 8
            if cls != 0:
                addr, = f._u("Q", p)
                p += 8
            dims = f._u(f"{ndims}I", p)
            p += 4 * ndims
            if cls == 0:
                size, = f._u("I", p)
                self._compact = bytes(f._mm[p + 4:p + 4 + size])
            elif cls == 1:
                self.data_offset = None if addr == UNDEF else addr
            else:
                self._btree = addr
                self.chunks = tuple(dims[:-1])
        else:
            raise ValueError(f"{f.filename}: {self.name} has a data layout message of "
                             f"version {version} (a chunk index other than the v1 "
                             "B-tree); the subset reads versions 1-3")
        if self.chunks is not None and self.shape == ():
            raise ValueError(f"{f.filename}: {self.name} is a chunked scalar")
        if self.filters and self.chunks is None:
            raise ValueError(f"{f.filename}: {self.name} has filters but no chunks")

    # -- chunks
    def chunk_index(self) -> list[ChunkInfo]:
        """Every stored chunk, in B-tree order (row-major chunk order)."""
        if self.chunks is None:
            raise ValueError(f"{self.name} is not chunked")
        if self._chunks is None:
            out: list[ChunkInfo] = []
            if self._btree != UNDEF:
                self._walk_chunks(self._btree, out)
            self._chunks = out
        return self._chunks

    def _walk_chunks(self, node: int, out: list) -> None:
        f = self.file
        if f._mm[node:node + 4] != b"TREE":
            raise ValueError(f"{f.filename}: no v1 B-tree node at {node} ({self.name})")
        ntype, level, used = f._u("BBH", node + 4)
        if ntype != 1:
            raise ValueError(f"{f.filename}: a chunk B-tree node of type {ntype}")
        rank = len(self.shape)
        key = 8 + 8 * (rank + 1)
        p = node + 24
        for _ in range(used):
            size, mask, *offset = f._u(f"II{rank}Q", p)
            child, = f._u("Q", p + key)
            if level == 0:
                out.append(ChunkInfo(tuple(offset), child, size, mask))
            else:
                self._walk_chunks(child, out)
            p += key + 8

    def decode_chunk(self, raw: bytes, filter_mask: int = 0) -> bytes:
        """A stored chunk's bytes with its filters undone (the full chunk,
        edge chunks included)."""
        data = raw
        for i in reversed(range(len(self.filters))):
            if filter_mask & (1 << i):
                continue
            fid, values = self.filters[i]
            if fid == DEFLATE:
                data = zlib.decompress(data)
            elif fid == SHUFFLE:
                data = unshuffle(data, values[0] if values else self._type.size)
            else:
                data = _check_fletcher32(data, self.name)
        return data

    def _chunk_array(self, c: ChunkInfo) -> np.ndarray:
        data = self.decode_chunk(self.file.read_raw(c.addr, c.size), c.filter_mask)
        n = int(np.prod(self.chunks, dtype=np.int64)) * self._type.size
        if len(data) != n:
            raise ValueError(f"{self.file.filename}: a chunk of {self.name} holds "
                             f"{len(data)} bytes, not {n}")
        return np.frombuffer(data, self._storage_dtype).reshape(self.chunks)

    # -- reading
    @property
    def _storage_dtype(self) -> np.dtype:
        return _storage_dtype(self._type)

    def _empty(self, shape) -> np.ndarray:
        dt = self._storage_dtype
        if self._fill is not None:
            return np.full(shape, np.frombuffer(self._fill, dt)[0], dt)
        return np.zeros(shape, dt)

    def _read_rows(self, start: int, stop: int) -> np.ndarray:
        """Rows [start, stop) of axis 0 (the whole of a scalar), as stored."""
        dt = self._storage_dtype
        if self.shape == ():
            shape, count = (), 1
        else:
            shape = (stop - start, *self.shape[1:])
            count = int(np.prod(shape, dtype=np.int64))
        if self._compact is not None:
            whole = np.frombuffer(self._compact, dt, self.size).reshape(self.shape)
            return whole[start:stop] if self.shape else whole
        if self.chunks is None:
            if self.data_offset is None:
                return self._empty(shape)
            row = int(np.prod(self.shape[1:], dtype=np.int64)) * dt.itemsize if self.shape else 0
            raw = self.file.read_raw(self.data_offset + start * row, count * dt.itemsize)
            return np.frombuffer(raw, dt).reshape(shape)
        out = self._empty(shape)
        c0 = self.chunks[0]
        for c in self.chunk_index():
            lo = c.offset[0]
            if lo >= stop or lo + c0 <= start or any(
                    o >= n for o, n in zip(c.offset[1:], self.shape[1:])):
                continue  # outside the rows asked for, or past a shrunk extent
            a, b = max(lo, start), min(lo + c0, stop)
            if self._rows_in_place:
                # an unfiltered chunk as wide as the dataset: its rows are
                # stored in order, so read only those asked for
                row = int(np.prod(self.chunks[1:], dtype=np.int64)) * dt.itemsize
                raw = self.file.read_raw(c.addr + (a - lo) * row, (b - a) * row)
                out[a - start:b - start] = np.frombuffer(raw, dt).reshape(b - a, *self.chunks[1:])
                continue
            arr = self._chunk_array(c)
            dst = [slice(a - start, b - start)]
            src = [slice(a - lo, b - lo)]
            for o, cs, s in zip(c.offset[1:], self.chunks[1:], self.shape[1:]):
                dst.append(slice(o, min(o + cs, s)))
                src.append(slice(0, min(cs, s - o)))
            out[tuple(dst)] = arr[tuple(src)]
        return out

    @property
    def _rows_in_place(self) -> bool:
        return (self.chunks is not None and not self.filters
                and self.chunks[1:] == self.shape[1:])

    def _finish(self, stored: np.ndarray):
        return self.file._values(stored, self._type, as_str=False)

    def __getitem__(self, sel):
        """``[()]`` / ``[...]`` (everything), an int, a slice or a list of rows
        (in any order) on axis 0, optionally followed by basic selections of
        the other axes."""
        if (isinstance(sel, tuple) and not sel) or sel is Ellipsis:
            return self._finish(self._read_rows(0, self.shape[0] if self.shape else 1))
        if self.shape == ():
            raise ValueError(f"{self.name} is scalar: read it with [()]")
        first, rest = (sel[0], sel[1:]) if isinstance(sel, tuple) else (sel, ())
        n = self.shape[0]
        if isinstance(first, (slice, type(Ellipsis))):
            if first is Ellipsis:
                first = slice(None)
            start, stop, step = first.indices(n)
            if step < 1:
                raise ValueError("a slice's step must be at least 1, as in h5py")
            out = self._read_rows(start, max(start, stop))[::step]
        elif isinstance(first, (int, np.integer)):
            i = int(first) + (n if first < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {first} out of range for {self.name} of {n} rows")
            out = self._read_rows(i, i + 1)[0]
        else:
            idx = np.asarray(first, np.int64)
            if idx.ndim != 1:
                raise TypeError(f"unsupported selection {sel!r}")
            if len(idx) and (idx.min() < 0 or idx.max() >= n):
                raise IndexError(f"rows out of range for {self.name} of {n} rows")
            out = self._gather(idx)
        if rest:
            out = out[rest] if isinstance(first, (int, np.integer)) else out[(slice(None),) + rest]
        return self._finish(np.ascontiguousarray(out))

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        """Rows ``idx`` of axis 0 in that order, each stored span read once."""
        out = self._empty((len(idx), *self.shape[1:]))
        if not len(idx):
            return out
        if self.chunks is None or self._rows_in_place:
            # runs of consecutive rows, each read in one call
            order = np.argsort(idx, kind="stable")
            s = idx[order]
            for run in np.split(np.arange(len(s)), np.flatnonzero(np.diff(s) > 1) + 1):
                lo, hi = int(s[run[0]]), int(s[run[-1]]) + 1
                out[order[run]] = self._read_rows(lo, hi)[s[run] - lo]
            return out
        c0 = self.chunks[0]
        which = idx // c0
        for k in np.unique(which):
            pos = np.flatnonzero(which == k)
            lo = int(k) * c0
            out[pos] = self._read_rows(lo, min(lo + c0, self.shape[0]))[idx[pos] - lo]
        return out


def unshuffle(data: bytes, itemsize: int) -> bytes:
    """Undo HDF5's shuffle filter: ``itemsize`` byte planes back to elements
    (bytes past the last whole element stay where they are)."""
    n = len(data) // itemsize
    if itemsize <= 1 or n <= 1:
        return data
    body = np.frombuffer(data, np.uint8, n * itemsize).reshape(itemsize, n).T.tobytes()
    return body + data[n * itemsize:]


def fletcher32_sums(data: bytes) -> tuple[int, int]:
    """HDF5's Fletcher-32 of ``data`` as its two sums mod 65535 (16-bit
    big-endian words; an odd last byte is the high byte of a word).
    ``H5_checksum_fletcher32`` folds the sums as it goes, which keeps them
    equal mod 65535: a checksum is checked against these."""
    n = len(data)
    words = np.frombuffer(data, ">u2", n // 2).astype(np.int64) % 65535
    if n % 2:
        words = np.append(words, np.int64(data[-1]) << 8)
    weights = np.arange(len(words), 0, -1, dtype=np.int64) % 65535
    return int(words.sum()) % 65535, int((words * weights % 65535).sum()) % 65535


def _check_fletcher32(data: bytes, name: str) -> bytes:
    body, stored = data[:-4], struct.unpack("<I", data[-4:])[0]
    s1, s2 = fletcher32_sums(body)
    lo, hi = (stored & 0xFFFF) % 65535, (stored >> 16) % 65535
    if (lo, hi) != (s1, s2) and (hi, lo) != (s1, s2):
        raise ValueError(f"{name}: a chunk fails its Fletcher-32 checksum")
    return body


# ------------------------------------------------------------------ writing
#
# The writer lays down what h5py writes by default: superblock 0 with group
# K 4 (leaf) and 16 (internal) and chunk-index K 32; version 1 object
# headers; dataspace 1, datatype 1, fill value 2, layout 3, filter pipeline
# 1 and attribute 1 messages; B-tree nodes at their full size.

_GROUP_LEAF_K, _GROUP_NODE_K, _CHUNK_K = 4, 16, 32
_SUPERBLOCK_SIZE = 96
_HEAP_FREE_NULL = 1  # a local heap with no free block
_GCOL_MIN = 4096
_GCOL_TARGET = 1 << 16  # bytes of strings a global heap collection takes
_FLUSH_BYTES = 64 << 20  # chunk bytes queued before they are compressed and written
_VLEN_STORED = np.dtype("V16")


def _padded(b: bytes) -> bytes:
    return b + bytes(_pad8(len(b)) - len(b))


class _WType(t.NamedTuple):
    """A datatype to write: 'num', 'bool', 'fixed_str' or 'vlen_str'."""

    kind: str
    dtype: np.dtype

    @property
    def size(self) -> int:
        return 16 if self.kind == "vlen_str" else self.dtype.itemsize

    def encode(self) -> bytes:
        dt = self.dtype
        if self.kind == "vlen_str":  # UTF-8 strings over unsigned 8-bit characters
            return (bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16)
                    + _WType("num", np.dtype("u1")).encode())
        if self.kind == "bool":  # h5py's enum: FALSE = 0, TRUE = 1 over int8
            return (bytes([0x18, 0x02, 0x00, 0x00]) + struct.pack("<I", 1)
                    + _WType("num", np.dtype("i1")).encode()
                    + b"FALSE\0\0\0TRUE\0\0\0\0" + b"\x00\x01")
        if self.kind == "fixed_str":  # null-padded ASCII, as h5py stores numpy 'S'
            return bytes([0x13, 0x01, 0x00, 0x00]) + struct.pack("<I", dt.itemsize)
        order = 1 if dt.byteorder == ">" else 0
        bits = dt.itemsize * 8
        if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
            return (bytes([0x10, order | (0x08 if dt.kind == "i" else 0), 0, 0])
                    + struct.pack("<IHH", dt.itemsize, 0, bits))
        if dt.kind == "f" and dt.itemsize in (2, 4, 8):
            epos, esize, msize, bias = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
                                        8: (52, 11, 52, 1023)}[dt.itemsize]
            return (bytes([0x11, 0x20 | order, bits - 1, 0])
                    + struct.pack("<IHHBBBBI", dt.itemsize, 0, bits, epos, esize, 0, msize, bias))
        raise ValueError(f"the writer has no HDF5 type for numpy {dt}")


def _as_array(value, dtype=None) -> tuple[np.ndarray, _WType]:
    """A value as h5py stores it: ``str`` -> a variable-length string, a list
    of ``str`` -> an array of them, a Python int or float -> 64 bits,
    ``bool`` -> h5py's enum."""
    if isinstance(value, str) or (isinstance(value, (list, tuple)) and value
                                  and all(isinstance(v, str) for v in value)):
        arr = np.empty(() if isinstance(value, str) else len(value), object)
        arr[...] = value
    else:
        arr = np.asarray(value, dtype)
        if arr.dtype.kind == "U":
            arr = arr.astype(object)
    if arr.dtype == object:
        if not all(isinstance(v, str) for v in arr.reshape(-1)):
            raise ValueError("an object array is written only as an array of str")
        return arr, _WType("vlen_str", np.dtype(object))
    if arr.dtype == bool:
        return arr, _WType("bool", np.dtype("i1"))
    if arr.dtype.kind == "S":
        return arr, _WType("fixed_str", arr.dtype)
    typ = _WType("num", arr.dtype)
    typ.encode()  # raises for a type outside the subset
    return arr, typ


def _dataspace(shape: tuple, maxshape: tuple | None = None) -> bytes:
    if not shape:
        return bytes([1, 0, 0, 0, 0, 0, 0, 0])
    maxshape = shape if maxshape is None else maxshape
    return (bytes([1, len(shape), 1, 0, 0, 0, 0, 0]) + struct.pack(f"<{len(shape)}Q", *shape)
            + struct.pack(f"<{len(shape)}Q", *(UNDEF if m is None else m for m in maxshape)))


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _padded(data)
    if len(data) > 0xFFFF:
        raise ValueError(f"a header message of {len(data)} bytes (type {mtype:#x}): an "
                         "attribute that large needs dense storage, outside the subset")
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Strings:
    """Variable-length strings and their global heap collections: ``add``
    gives each string a (collection, index); ``write`` writes the
    collections; ``refs`` then encodes the stored elements."""

    def __init__(self):
        self.collections: list[list[bytes]] = [[]]
        self._size = 0
        self.addrs: list[int] = []

    def add(self, values: t.Iterable[str]) -> np.ndarray:
        out = []
        for v in values:
            b = v.encode("utf-8")
            cur = self.collections[-1]
            if cur and (len(cur) == 0xFFFF or self._size + 16 + _pad8(len(b)) > _GCOL_TARGET):
                self.collections.append([])
                cur, self._size = self.collections[-1], 0
            cur.append(b)
            self._size += 16 + _pad8(len(b))
            out.append((len(self.collections) - 1, len(cur), len(b)))
        return np.array(out, np.int64).reshape(-1, 3)

    def write(self, w: "Writer") -> None:
        for objs in self.collections:
            body = b"".join(struct.pack("<HH4xQ", i + 1, 1, len(o)) + _padded(o)
                            for i, o in enumerate(objs))
            size = max(_GCOL_MIN, 16 + len(body))
            free = size - 16 - len(body)
            # free space: an object 0 whose size counts its own 16-byte header
            tail = (struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16) if free >= 16
                    else bytes(free))
            self.addrs.append(w._append(b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + body + tail))

    def refs(self, ids: np.ndarray) -> np.ndarray:
        out = np.zeros(len(ids), _VLEN_REF)
        out["len"] = ids[:, 2]
        out["addr"] = np.asarray(self.addrs, np.uint64)[ids[:, 0]] if len(ids) else 0
        out["index"] = ids[:, 1]
        return out


class _Attrs(dict):
    """An object's attributes to write, converted as h5py converts them
    (``_as_array``) when they are set."""

    def __setitem__(self, name: str, value) -> None:
        super().__setitem__(name, _as_array(value))

    def _collect(self, strings: _Strings) -> None:
        self._ids = {k: strings.add(arr.reshape(-1)) for k, (arr, typ) in self.items()
                     if typ.kind == "vlen_str"}

    def _messages(self, strings: _Strings) -> list[bytes]:
        out = []
        for name, (arr, typ) in self.items():
            if typ.kind == "vlen_str":
                data = strings.refs(self._ids[name]).tobytes()
            else:
                data = np.ascontiguousarray(arr, np.int8 if typ.kind == "bool" else None).tobytes()
            nm, dt, ds = name.encode("utf-8") + b"\0", typ.encode(), _dataspace(arr.shape)
            out.append(_message(_ATTRIBUTE, struct.pack("<BxHHH", 1, len(nm), len(dt), len(ds))
                                + _padded(nm) + _padded(dt) + _padded(ds) + data))
        return out


class WDataset:
    """A dataset being written. Numbers go to the file as they come (a chunk
    once it is whole, compressed when the dataset is gzipped); strings at
    close, when their heap collections are laid down."""

    def __init__(self, w: "Writer", typ: _WType, shape: tuple, maxshape: tuple | None = None,
                 chunks: tuple | None = None, level: int | None = None):
        self._w, self.type, self.shape, self.maxshape = w, typ, tuple(shape), maxshape
        self.chunks, self.level = chunks, level
        self.attrs = _Attrs()
        self._chunk_list: list[tuple[tuple, int, int]] = []  # (offset, address, stored size)
        self._addr: int | None = None
        self._strings: list[str] | None = [] if typ.kind == "vlen_str" else None
        self._open: np.ndarray | None = None  # an appendable's chunk being filled
        self._open_rows = 0

    # -- data
    def _store(self, data: np.ndarray) -> None:
        if self.chunks is None:
            self._addr = self._w._append(np.ascontiguousarray(data).tobytes())
            return
        grid = [range(0, s, c) for s, c in zip(data.shape, self.chunks)]
        for index in np.ndindex(*(len(g) for g in grid)):
            off = tuple(g[i] for g, i in zip(grid, index))
            self._chunk(off, data[tuple(slice(o, o + c) for o, c in zip(off, self.chunks))])

    def _chunk(self, offset: tuple, block: np.ndarray) -> None:
        """One chunk, padded to the full chunk shape (edge chunks are stored
        whole), written or queued for compression."""
        if block.shape != self.chunks:
            full = np.zeros(self.chunks, block.dtype)
            full[tuple(slice(0, s) for s in block.shape)] = block
            block = full
        self._w._chunk(self, offset, np.ascontiguousarray(block).tobytes())

    def __setitem__(self, sel, value) -> None:
        """Rows of a dataset created with ``shape=`` and no data:
        ``ds[i] = row`` or ``ds[a:b] = rows``."""
        if self._addr is None or self.chunks is not None:
            raise TypeError("only a dataset created with shape= and no data takes rows")
        start = (sel.start or 0) if isinstance(sel, slice) else int(sel)
        rows = np.ascontiguousarray(value, self.type.dtype)
        row_bytes = int(np.prod(self.shape[1:], dtype=np.int64)) * self.type.size
        n = rows.nbytes // row_bytes
        if not 0 <= start <= start + n <= self.shape[0]:
            raise IndexError(f"rows {start}:{start + n} outside {self.shape[0]}")
        self._w._pwrite(rows.tobytes(), self._addr + start * row_bytes)

    def append(self, rows) -> None:
        """Rows appended along axis 0 (a dataset of ``create_appendable``)."""
        if self.maxshape is None or self.maxshape[0] is not None:
            raise TypeError("append needs a dataset of create_appendable")
        if self._strings is not None:
            self._strings.extend(str(v) for v in rows)
            self.shape = (len(self._strings),)
            return
        rows = np.asarray(rows, self.type.dtype)
        if rows.shape[1:] != self.shape[1:]:
            raise ValueError(f"rows of shape {rows.shape[1:]}, not {self.shape[1:]}")
        c0 = self.chunks[0]
        while len(rows):
            if self._open is None:
                self._open, self._open_rows = np.zeros(self.chunks, self.type.dtype), 0
            take = min(c0 - self._open_rows, len(rows))
            self._open[self._open_rows:self._open_rows + take] = rows[:take]
            self._open_rows += take
            self.shape = (self.shape[0] + take, *self.shape[1:])
            rows = rows[take:]
            if self._open_rows == c0:
                self._close_chunk()

    def _close_chunk(self) -> None:
        if self._open is not None and self._open_rows:
            start = self.shape[0] - self._open_rows
            self._chunk((start,) + (0,) * (len(self.shape) - 1), self._open)
        self._open = None

    # -- at close
    def _close_strings(self, strings: _Strings) -> None:
        if self._strings is not None:
            self._store(strings.refs(self._ids).view(_VLEN_STORED).reshape(self.shape))

    def _header(self, strings: _Strings) -> bytes:
        msgs = [_message(_DATASPACE, _dataspace(self.shape, self.maxshape)),
                _message(_DATATYPE, self.type.encode(), flags=1),
                _message(_FILL, bytes([2, 3 if self.chunks else 2,
                                       0 if self._strings is not None else 2, 1, 0, 0, 0, 0]),
                         flags=1)]
        if self.level is not None:
            msgs.append(_message(_FILTERS, bytes([1, 1, 0, 0, 0, 0, 0, 0])
                                 + struct.pack("<HHHH", DEFLATE, 8, 1, 1) + b"deflate\0"
                                 + struct.pack("<I4x", self.level), flags=1))
        if self.chunks is None:
            size = int(np.prod(self.shape, dtype=np.int64)) * self.type.size
            addr = UNDEF if self._addr is None else self._addr
            msgs.append(_message(_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, size)))
        else:
            dims = (*self.chunks, self.type.size)
            msgs.append(_message(_LAYOUT, struct.pack(f"<BBBQ{len(dims)}I", 3, 2, len(dims),
                                                      self._chunk_btree(), *dims)))
        return _object_header(msgs + self.attrs._messages(strings))

    def _chunk_btree(self) -> int:
        """The v1 B-tree over the chunks, written bottom up. Each key is a
        chunk's (stored size, filter mask, offset, 0); a node's last key
        is the bound past its last chunk, as HDF5 writes it."""
        if not self._chunk_list:
            return UNDEF
        chunks = sorted(self._chunk_list)
        last = tuple(o + c for o, c in zip(chunks[-1][0], self.chunks)) + (self.type.size,)
        keys = [(size, (*off, 0)) for off, _, size in chunks] + [(0, last)]
        children = [addr for _, addr, _ in chunks]
        fmt = f"<II{len(self.chunks) + 1}Q"
        per = 2 * _CHUNK_K
        node_size = 24 + (per + 1) * struct.calcsize(fmt) + per * 8
        level = 0
        while True:
            groups = [range(i, min(i + per, len(children))) for i in range(0, len(children), per)]
            base = self._w._eof
            nodes = []
            for j, g in enumerate(groups):
                left = base + (j - 1) * node_size if j else UNDEF
                right = base + (j + 1) * node_size if j + 1 < len(groups) else UNDEF
                body = bytearray(struct.pack("<4sBBHQQ", b"TREE", 1, level, len(g), left, right))
                for i in g:
                    body += struct.pack(fmt, keys[i][0], 0, *keys[i][1])
                    body += struct.pack("<Q", children[i])
                body += struct.pack(fmt, keys[g[-1] + 1][0], 0, *keys[g[-1] + 1][1])
                nodes.append(self._w._append(bytes(body) + bytes(node_size - len(body))))
            if len(nodes) == 1:
                return nodes[0]
            keys = [keys[g[0]] for g in groups] + [keys[-1]]
            children, level = nodes, level + 1


class WGroup:
    """A group being written: members by name, written in byte order."""

    def __init__(self, w: "Writer"):
        self._w = w
        self.attrs = _Attrs()
        self._members: dict[str, WGroup | WDataset] = {}

    def _add(self, name: str, node):
        if not name or "/" in name or "\0" in name:
            raise ValueError(f"a member name must be a non-empty name without '/': {name!r}")
        if name in self._members:
            raise ValueError(f"{name!r} already exists")
        self._members[name] = node
        return node

    def keys(self) -> list[str]:
        """Member names in byte order, as HDF5 keeps them."""
        return sorted(self._members, key=str.encode)

    def create_group(self, name: str) -> "WGroup":
        return self._add(name, WGroup(self._w))

    def require_group(self, name: str) -> "WGroup":
        node = self._members.get(name)
        if node is None:
            return self.create_group(name)
        if not isinstance(node, WGroup):
            raise TypeError(f"{name!r} is a dataset, not a group")
        return node

    def create_dataset(self, name: str, data=None, *, shape=None, dtype=None,
                       chunks: tuple | None = None, compression: str | None = None,
                       compression_opts: int | None = None) -> WDataset:
        """A dataset of ``data`` (numbers, bool or str), contiguous or in
        ``chunks``, gzipped at ``compression_opts`` (default 4) with
        ``compression='gzip'``; or, with ``shape`` and ``dtype`` and no
        data, a contiguous dataset filled by rows (``ds[i] = row``)."""
        if compression not in (None, "gzip"):
            raise ValueError(f"compression {compression!r}: the writer has gzip only")
        level = (4 if compression_opts is None else int(compression_opts)) if compression else None
        if level is not None and chunks is None:
            raise ValueError("a gzipped dataset needs chunks")
        if data is None:
            if shape is None or dtype is None or chunks is not None:
                raise ValueError("a dataset without data needs shape and dtype, and no chunks")
            _, typ = _as_array(np.zeros(0, dtype))
            if typ.kind != "num":
                raise ValueError("a dataset filled by rows holds numbers")
            ds = WDataset(self._w, typ, tuple(shape))
            ds._addr = self._w._reserve(int(np.prod(shape, dtype=np.int64)) * typ.size)
            return self._add(name, ds)
        arr, typ = _as_array(data, dtype)
        if chunks is not None and (len(chunks) != arr.ndim or min(chunks) < 1):
            raise ValueError(f"chunks {chunks} for a dataset of shape {arr.shape}")
        ds = self._add(name, WDataset(self._w, typ, arr.shape, None,
                                      tuple(chunks) if chunks else None, level))
        if typ.kind == "vlen_str":
            ds._strings = list(arr.reshape(-1))
        else:
            ds._store(arr.astype(np.int8) if typ.kind == "bool" else arr)
        return ds

    def create_appendable(self, name: str, row_shape: tuple, dtype, chunk_rows: int,
                          compression: str | None = None) -> WDataset:
        """An empty dataset of rows ``row_shape`` (``dtype`` ``str`` for
        variable-length strings) that ``append`` grows: chunked
        ``(chunk_rows, *row_shape)``, unlimited along axis 0, as a resizable
        h5py dataset; it takes its final size when the file closes."""
        if dtype is str:
            typ = _WType("vlen_str", np.dtype(object))
        else:
            _, typ = _as_array(np.zeros(0, dtype))
        if compression not in (None, "gzip"):
            raise ValueError(f"compression {compression!r}: the writer has gzip only")
        row_shape = tuple(row_shape)
        return self._add(name, WDataset(self._w, typ, (0, *row_shape), (None, *row_shape),
                                        (chunk_rows, *row_shape), 4 if compression else None))

    # -- at close
    def _walk(self) -> t.Iterator:
        yield self
        for m in self._members.values():
            yield from (m._walk() if isinstance(m, WGroup) else [m])

    def _close(self, strings: _Strings) -> tuple[int, int, int]:
        """Members, then this group: (object header, B-tree, local heap)."""
        w = self._w
        names = self.keys()
        entries = []
        for n in names:
            m = self._members[n]
            if isinstance(m, WGroup):
                entries.append((1, *m._close(strings)))
            else:
                entries.append((0, w._append(m._header(strings)), 0, 0))
        heap, offsets = bytearray(8), []
        for n in names:
            offsets.append(len(heap))
            heap += _padded(n.encode("utf-8") + b"\0")
        data = w._append(bytes(heap))
        heap_addr = w._append(b"HEAP\0\0\0\0"
                              + struct.pack("<QQQ", len(heap), _HEAP_FREE_NULL, data))
        per = 2 * _GROUP_LEAF_K
        snods = []
        for i in range(0, len(names), per):
            body = bytearray(b"SNOD\x01\0" + struct.pack("<H", len(names[i:i + per])))
            for off, (cache, hdr, bt, hp) in zip(offsets[i:i + per], entries[i:i + per]):
                body += struct.pack("<QQI4xQQ", off, hdr, cache, bt, hp)
            snods.append(w._append(bytes(body) + bytes(8 + 40 * per - len(body))))
        # leaf keys: "" (offset 0), then each child's last name
        keys = [0] + [offsets[min(i + per, len(names)) - 1] for i in range(0, len(names), per)]
        btree = self._group_btree(snods, keys)
        stab = _message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))
        header = w._append(_object_header([stab] + self.attrs._messages(strings)))
        return header, btree, heap_addr

    def _group_btree(self, children: list[int], keys: list[int]) -> int:
        w = self._w
        per = 2 * _GROUP_NODE_K
        node_size = 24 + (per + 1) * 8 + per * 8
        level = 0
        while True:
            groups = [range(i, min(i + per, len(children))) for i in range(0, len(children), per)] \
                or [range(0)]
            base = w._eof
            nodes = []
            for j, g in enumerate(groups):
                left = base + (j - 1) * node_size if j else UNDEF
                right = base + (j + 1) * node_size if j + 1 < len(groups) else UNDEF
                body = bytearray(struct.pack("<4sBBHQQ", b"TREE", 0, level, len(g), left, right))
                body += struct.pack("<Q", keys[g[0]] if len(g) else 0)
                for i in g:
                    body += struct.pack("<QQ", children[i], keys[i + 1])
                nodes.append(w._append(bytes(body) + bytes(node_size - len(body))))
            if len(nodes) == 1:
                return nodes[0]
            keys = [keys[g[0]] for g in groups] + [keys[-1]]
            children, level = nodes, level + 1


class Writer:
    """A new HDF5 file, written as h5py would write it by default. Use it as
    a context manager, or call ``close``: the metadata is written then."""

    def __init__(self, path):
        self.filename = str(path)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        self._eof = _SUPERBLOCK_SIZE
        self._root = WGroup(self)
        self._queue: list[tuple[WDataset, tuple, bytes]] = []
        self._queued = 0

    # -- the root group's surface
    @property
    def attrs(self) -> _Attrs:
        return self._root.attrs

    def create_group(self, name: str) -> WGroup:
        return self._root.create_group(name)

    def require_group(self, name: str) -> WGroup:
        return self._root.require_group(name)

    def create_dataset(self, name: str, data=None, **kw) -> WDataset:
        return self._root.create_dataset(name, data, **kw)

    def create_appendable(self, name: str, row_shape: tuple, dtype, chunk_rows: int,
                          compression: str | None = None) -> WDataset:
        return self._root.create_appendable(name, row_shape, dtype, chunk_rows, compression)

    # -- bytes
    def _pwrite(self, data: bytes, addr: int) -> None:
        view = memoryview(data)
        while len(view):
            n = os.pwrite(self._fd, view, addr)
            view, addr = view[n:], addr + n

    def _append(self, data: bytes) -> int:
        addr = self._eof
        self._pwrite(data, addr)
        self._eof += len(data)
        return addr

    def _reserve(self, n: int) -> int:
        addr = self._eof
        self._eof += n
        return addr

    def _chunk(self, ds: WDataset, offset: tuple, raw: bytes) -> None:
        if ds.level is None:
            ds._chunk_list.append((offset, self._append(raw), len(raw)))
            return
        self._queue.append((ds, offset, raw))
        self._queued += len(raw)
        if self._queued >= _FLUSH_BYTES:
            self._flush()

    def _flush(self) -> None:
        """Compress the queued chunks (in host threads) and write them."""
        from .fast_inflate import deflate_many

        by_level: dict[int, list[int]] = {}
        for i, (ds, _, _) in enumerate(self._queue):
            by_level.setdefault(ds.level, []).append(i)
        packed: list[bytes] = [b""] * len(self._queue)
        for level, idx in by_level.items():
            for i, z in zip(idx, deflate_many([self._queue[i][2] for i in idx], level)):
                packed[i] = z
        for (ds, offset, _), z in zip(self._queue, packed):
            ds._chunk_list.append((offset, self._append(z), len(z)))
        self._queue, self._queued = [], 0

    def close(self) -> None:
        if self._fd is None:
            return
        try:
            nodes = list(self._root._walk())
            datasets = [n for n in nodes if isinstance(n, WDataset)]
            for ds in datasets:
                ds._close_chunk()
            strings = _Strings()
            for n in nodes:
                n.attrs._collect(strings)
                if isinstance(n, WDataset) and n._strings is not None:
                    n._ids = strings.add(n._strings)
            strings.write(self)
            for ds in datasets:
                ds._close_strings(strings)
            self._flush()
            header, btree, heap = self._root._close(strings)
            os.ftruncate(self._fd, self._eof)
            self._pwrite(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                         + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
                         + struct.pack("<QQQQ", 0, UNDEF, self._eof, UNDEF)
                         + struct.pack("<QQI4xQQ", 0, header, 1, btree, heap), 0)
        finally:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
