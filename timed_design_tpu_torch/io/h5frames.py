"""HDF5 frame datasets: metadata, the flat dataset map, batch streaming and
the tree -> flat conversion. The port of ``timed_design_tpu/io/h5frames.py``
on the port's own HDF5 reader and writer (``io/hdf5.py``): no h5py, no
ml_dtypes.

Two layouts (``voxel/dataset.py::make_frame_dataset`` writes both):
  - tree: aposteriori's ``/<pdb>/<chain>/<residue>`` datasets, one (V, V, V,
    C) frame each with ``label`` and ``encoded_residue`` attributes, mostly
    gzipped (one chunk a frame, or about 32 under h5py's auto-chunking);
  - flat: ``/frames`` (N, V, V, V, C) float32, or bfloat16 as raw uint16
    bits with the ``frame_dtype='bfloat16'`` file attribute, ``/labels``
    and the ``/index_*`` string columns of the dataset map.

``FrameBatchLoader`` yields ``(X, y, n_valid)``: X a (B, V, V, V, C)
tensor, float32 (bfloat16 for a bfloat16 flat file), on the CPU or copied
to a card through reused pinned buffers; y (B, 20) float32 on the host. A
tree file's chunk locations are looked up once per loader, not per frame
and epoch, and its gzip chunks are inflated from host threads
(``io/fast_inflate.py``). Flat frames of another dtype than float32 or
tagged bfloat16 (float16, float64) are cast to float32: the JAX loader
views them through a float32 buffer and reads garbage.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import typing as t
import warnings
from pathlib import Path

import numpy as np
import torch

from ..constants import AA3, AA3_TO_INT, UNCOMMON_RESIDUE_DICT
from . import hdf5
from .datasetmap import DatasetMap, _residue_sort_key
from .fast_inflate import inflate_many


def _str(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def _is_bf16(f: hdf5.File) -> bool:
    return _str(f.attrs.get("frame_dtype", "")) == "bfloat16"


def flat_frame_dtype(f: hdf5.File) -> torch.dtype:
    """Logical dtype of a flat file's ``/frames``: ``torch.bfloat16`` for
    raw bfloat16 bits tagged ``frame_dtype='bfloat16'``, else the stored
    dtype's."""
    if _is_bf16(f):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, f["frames"].dtype)).dtype


def _as_torch(raw: np.ndarray, bf16: bool) -> torch.Tensor:
    """Stored frames as a tensor: uint16 bits viewed as bfloat16, float32 as
    it is, any other dtype cast to float32."""
    if bf16:
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    if raw.dtype != np.float32:
        raw = raw.astype(np.float32)
    return torch.from_numpy(raw)


def read_flat_frames(f: hdf5.File, sel=np.s_[:]) -> torch.Tensor:
    """(A slice of) a flat file's frames in their logical dtype
    (``flat_frame_dtype``)."""
    raw = np.asarray(f["frames"][sel])
    if _is_bf16(f):
        return _as_torch(raw, True)
    return torch.from_numpy(raw)


@dataclasses.dataclass
class FrameDatasetMetadata:
    """Validated dataset attributes (aposteriori's schema)."""

    make_frame_dataset_ver: str
    frame_dims: tuple[int, int, int, int]
    atom_encoder: list[str]
    encode_cb: bool
    atom_filter_fn: str
    residue_encoder: list[str]
    frame_edge_length: float
    voxels_as_gaussian: bool

    COMPATIBLE_MAJOR = "2"  # aposteriori 2.x datasets

    @staticmethod
    def from_file(path: Path) -> "FrameDatasetMetadata":
        with hdf5.File(path) as f:
            a = dict(f.attrs.items())
        meta = FrameDatasetMetadata(
            make_frame_dataset_ver=_str(a["make_frame_dataset_ver"]),
            frame_dims=tuple(int(x) for x in a["frame_dims"]),
            atom_encoder=[_str(x) for x in a["atom_encoder"]],
            encode_cb=bool(a["encode_cb"]),
            atom_filter_fn=_str(a.get("atom_filter_fn", "")),
            residue_encoder=[_str(x) for x in a.get("residue_encoder", [])],
            frame_edge_length=float(a["frame_edge_length"]),
            voxels_as_gaussian=bool(a["voxels_as_gaussian"]),
        )
        major = meta.make_frame_dataset_ver.split(".")[0]
        if major != FrameDatasetMetadata.COMPATIBLE_MAJOR:
            raise ValueError(
                f"Dataset version {meta.make_frame_dataset_ver} is incompatible "
                f"with supported major version {FrameDatasetMetadata.COMPATIBLE_MAJOR}. "
                f"Re-create the dataset."
            )
        return meta


def _is_flat_layout(f: hdf5.File) -> bool:
    return _str(f.attrs.get("layout", "")) == "flat" and "frames" in f


def _standard_label(label: str) -> str:
    """A residue label of the map: uncommon ones remapped with a warning,
    unknown ones refused."""
    if label in AA3:
        return label
    if label in UNCOMMON_RESIDUE_DICT:
        warnings.warn(f"{label} is not a standard residue; converted to "
                      f"{UNCOMMON_RESIDUE_DICT[label]}.")
        return UNCOMMON_RESIDUE_DICT[label]
    raise ValueError(f"Expected natural amino acid, but got {label}.")


def _index_columns(f: hdf5.File, names=("index_pdb", "index_chain", "index_residue",
                                         "index_label")) -> list[list[str]]:
    return [[_str(v) for v in f[c][()]] for c in names]


def create_flat_dataset_map(
    frame_dataset: Path,
    filter_list: t.Sequence[str] = (),
    remove_blacklist_silently: bool = False,
) -> tuple[DatasetMap, set[str]]:
    """The per-residue map of an HDF5 frame dataset and its structure names.

    Tree layout: structures and chains in the file's (byte) order, residues
    by ``_residue_sort_key``. Flat layout: the ``/index_*`` columns in row
    order. Either way uncommon labels are remapped with a warning and
    unknown ones raise; a structure whose 4-letter code is in
    ``filter_list`` raises, or with ``remove_blacklist_silently`` is left
    out with a warning (once per structure)."""
    entries: list[tuple[str, str, str, str]] = []
    pdbs: set[str] = set()
    with hdf5.File(frame_dataset) as f:
        if _is_flat_layout(f):
            filtered_any = False
            warned: set[str] = set()
            for pdb_code, chain, rid, label in zip(*_index_columns(f)):
                if pdb_code[:4] in filter_list:
                    if not remove_blacklist_silently:
                        raise ValueError(f"PDB code {pdb_code} is blacklisted.")
                    filtered_any = True
                    if pdb_code not in warned:
                        warned.add(pdb_code)
                        warnings.warn(f"PDB code {pdb_code} was found in benchmark set; removed.")
                    continue
                entries.append((pdb_code, chain, rid, _standard_label(label)))
                pdbs.add(pdb_code)
            return DatasetMap(
                entries=entries,
                # entry order is row order only when nothing was filtered
                row_identity_for=None if filtered_any else str(Path(frame_dataset).resolve()),
            ), pdbs
        for pdb_code in f:
            if pdb_code[:4] in filter_list:
                if remove_blacklist_silently:
                    warnings.warn(f"PDB code {pdb_code} was found in benchmark set; removed.")
                    continue
                raise ValueError(
                    f"PDB code {pdb_code} is blacklisted. Pass "
                    f"remove_blacklist_silently=True to skip it instead."
                )
            structure = f[pdb_code]
            for chain_id in structure:
                chain = structure[chain_id]
                for rid in sorted(chain.keys(), key=_residue_sort_key):
                    label = _standard_label(_str(chain[rid].attrs["label"]))
                    entries.append((pdb_code, chain_id, str(rid), label))
                    pdbs.add(pdb_code)
    return DatasetMap(entries=entries), pdbs


class _Slot:
    """One pinned buffer of a ``PinnedStaging`` ring: ``free`` is set once
    the consumer has queued its copy to the card, and ``copied`` is the CUDA
    event that copy records."""

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.copied: torch.cuda.Event | None = None
        self.free = threading.Event()
        self.free.set()


class PinnedStaging:
    """A ring of reused pinned host buffers that batches take on their way
    to a card. The loader's thread fills a buffer (``fill``); the consumer
    copies it to the card on a side stream (``to_device``), which the
    consumer's stream then waits for; the buffer is filled again once that
    copy is done. So the host's reading and the copy overlap the device's
    work, and no batch allocates pinned memory. ``depth`` must exceed the
    batches that can be in flight between the two threads."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots = [_Slot() for _ in range(depth)]
        self._k = 0

    def fill(self, shape: tuple, dtype: torch.dtype, cancel: threading.Event) -> _Slot | None:
        """The next slot, its buffer of ``shape`` and ``dtype`` free to
        write; None once ``cancel`` is set."""
        slot = self._slots[self._k % len(self._slots)]
        self._k += 1
        while not slot.free.wait(0.1):
            if cancel.is_set():
                return None
        slot.free.clear()
        if slot.copied is not None:
            slot.copied.synchronize()
        if slot.buf is None or tuple(slot.buf.shape) != tuple(shape) or slot.buf.dtype != dtype:
            slot.buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        return slot

    def to_device(self, slot: _Slot) -> torch.Tensor:
        """The slot's batch on the card, copied on the side stream; the
        current stream waits for the copy."""
        with torch.cuda.stream(self.stream):
            x = slot.buf.to(self.device, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self.stream)
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(self.stream)
        x.record_stream(current)
        slot.free.set()
        return x


class _TreeFrame(t.NamedTuple):
    """Where one tree frame lies: its gzip-only chunks (None when it has
    other filters or none: then it is read through the reader), its shape,
    chunk shape and stored dtype, and its label vector (float64)."""

    key: tuple[str, str, str]
    chunks: list[hdf5.ChunkInfo] | None
    shape: tuple[int, ...]
    chunk_shape: tuple[int, ...] | None
    dtype: np.dtype
    label: np.ndarray


def _tree_frame(chains: dict, f: hdf5.File, pdb: str, chain: str, rid: str,
                label: str) -> _TreeFrame:
    """Where the frame of one map entry lies; ``chains`` caches the chain
    groups met so far."""
    group = chains.get((pdb, chain))
    if group is None:
        group = chains[(pdb, chain)] = f[pdb][chain]
    node = group[rid]
    enc = node.attrs.get("encoded_residue")
    if enc is not None:
        y = np.asarray(enc, np.float64)
    else:
        y = np.zeros(20)
        y[AA3_TO_INT[label]] = 1.0
    gzip_only = (node.chunks is not None and [fid for fid, _ in node.filters] == [hdf5.DEFLATE]
                 and node.dtype.kind in "fiub")
    chunks = None
    if gzip_only:
        chunks = node.chunk_index()
        n_grid = int(np.prod([-(-s // c) for s, c in zip(node.shape, node.chunks)]))
        if len(chunks) != n_grid or any(c.filter_mask for c in chunks):
            chunks = None  # unwritten chunks (fill values) or a skipped filter
    return _TreeFrame((pdb, chain, rid), chunks, node.shape, node.chunks,
                      np.dtype(np.int8) if node.dtype == bool else node.dtype, y)


class FrameBatchLoader:
    """Batches over a per-residue dataset map, read in a background thread
    that stays ``prefetch`` batches ahead.

    Yields ``(X, y, n_valid)``: X a (B, V, V, V, C) tensor, float32 (or
    bfloat16, from a bfloat16 flat file), on the CPU or, with a CUDA
    ``device``, on the card (copied there through ``PinnedStaging``); y (B,
    20) float32 one-hot (or soft) labels on the host. The last batch is
    padded with zero rows past ``n_valid``. ``shuffle=True`` draws a fresh
    permutation of the entries on every ``__iter__`` (every epoch) from one
    ``np.random.default_rng(shuffle_seed)`` made here, the JAX loader's
    order. An error in the reading thread is raised in the consumer."""

    def __init__(
        self,
        dataset_path: Path,
        dmap: DatasetMap,
        batch_size: int,
        start_batch: int = 0,
        prefetch: int = 2,
        shuffle: bool = False,
        shuffle_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        if not dmap.is_old:
            raise ValueError("FrameBatchLoader needs a per-residue dataset map")
        if shuffle and start_batch:
            # the skipped batches would come from a fresh permutation: some
            # frames twice, others never, and not the interrupted epoch
            raise ValueError(
                "start_batch resume is incompatible with shuffle=True: "
                "the skipped batches would come from a new permutation."
            )
        self.dataset_path = Path(dataset_path)
        self.entries = dmap.entries
        self.shuffle = shuffle
        self._shuffle_rng = np.random.default_rng(shuffle_seed)
        self._dmap_identity_for = dmap.row_identity_for
        self.batch_size = batch_size
        self.start_batch = start_batch
        self.prefetch = prefetch
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.meta = FrameDatasetMetadata.from_file(self.dataset_path)
        self.n_batches = -(-len(self.entries) // batch_size)
        self._tree: list[_TreeFrame] | None = None  # per entry, looked up once

    # -- tree layout
    def _tree_index(self, f: hdf5.File) -> list[_TreeFrame]:
        if self._tree is None:
            chains: dict = {}
            self._tree = [_tree_frame(chains, f, *e) for e in self.entries]
        return self._tree

    def _read_batch(self, f: hdf5.File, frames: list[_TreeFrame], index: int,
                    X: np.ndarray | None = None):
        """Batch ``index`` of ``frames``, into ``X`` when given (a reused
        buffer: its padding rows are zeroed here)."""
        batch = frames[index * self.batch_size:(index + 1) * self.batch_size]
        if X is None:
            X = np.zeros((self.batch_size, *self.meta.frame_dims), np.float32)
        else:
            X[len(batch):] = 0
        y = np.zeros((self.batch_size, 20), np.float32)
        srcs: list[bytes] = []
        dsts: list[np.ndarray] = []
        parts: list[tuple[int, _TreeFrame, list]] = []  # frames of several chunks
        for i, fr in enumerate(batch):
            y[i] = fr.label
            if fr.chunks is None:
                X[i] = f[fr.key[0]][fr.key[1]][fr.key[2]][()]
                continue
            whole = len(fr.chunks) == 1 and fr.chunk_shape == fr.shape
            buf = X[i] if whole and fr.dtype == np.float32 else None
            pieces = []
            for c in fr.chunks:
                dst = buf if buf is not None else np.empty(fr.chunk_shape, fr.dtype)
                srcs.append(f.read_raw(c.addr, c.size))
                dsts.append(dst)
                pieces.append((c.offset, dst))
            if buf is None:
                parts.append((i, fr, pieces))
        inflate_many(srcs, dsts)
        for i, fr, pieces in parts:
            # edge chunks are stored whole: copy what lies inside the frame
            for off, arr in pieces:
                dst = tuple(slice(o, min(o + c, s))
                            for o, c, s in zip(off, fr.chunk_shape, fr.shape))
                src = tuple(slice(0, d.stop - d.start) for d in dst)
                X[i][dst] = arr[src]
        return torch.from_numpy(X), y, len(batch)

    # -- flat layout
    def _flat_rows(self, f: hdf5.File) -> np.ndarray:
        """Row index per map entry: the identity when the map came from this
        flat file whole, else a lookup by key (a resumed, reordered or
        blacklist-filtered map)."""
        if (self._dmap_identity_for is not None
                and self._dmap_identity_for == str(self.dataset_path.resolve())
                and len(self.entries) == f["frames"].shape[0]):
            return np.arange(len(self.entries), dtype=np.int64)
        key_to_row = {key: row for row, key in enumerate(zip(*_index_columns(
            f, ("index_pdb", "index_chain", "index_residue"))))}
        return np.array([key_to_row[(p, c, r)] for p, c, r, _ in self.entries], np.int64)

    def _flat_setup(self, f: hdf5.File) -> np.ndarray | None:
        """A copy-on-write memory map over the frames of a contiguous,
        unfiltered ``/frames`` (None otherwise): on the CPU a full in-order
        batch is then a view of the file, with no copy."""
        ds = f["frames"]
        if ds.chunks is None and ds.data_offset is not None and ds.size:
            return np.memmap(self.dataset_path, dtype=ds.dtype, mode="c",
                             offset=ds.data_offset, shape=ds.shape)
        return None

    def _read_batch_flat(self, f: hdf5.File, rows: np.ndarray, index: int,
                         mm: np.ndarray | None, labels: np.ndarray):
        sel = rows[index * self.batch_size:(index + 1) * self.batch_size]
        n = len(sel)
        ds = f["frames"]
        bf16 = _is_bf16(f)
        y = np.zeros((self.batch_size, 20), np.float32)
        y[:n] = labels[sel]
        start = int(sel[0]) if n else 0
        in_order = bool(n) and np.array_equal(sel, np.arange(start, start + n))
        if in_order and mm is not None and n == self.batch_size:
            return _as_torch(mm[start:start + n], bf16), y, n
        X = np.zeros((self.batch_size, *ds.shape[1:]), ds.dtype)
        if in_order:
            X[:n] = mm[start:start + n] if mm is not None else ds[start:start + n]
        elif n:  # any order: a sorted read, then un-sorted
            order = np.argsort(sel, kind="stable")
            X[order] = mm[sel[order]] if mm is not None else ds[sel[order]]
        return _as_torch(X, bf16), y, n

    def __iter__(self):
        # max(1, ...): Queue(maxsize=0) is unbounded, and a prefetch of 0
        # would buffer the whole dataset on the host
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        stop = object()
        cancel = threading.Event()
        perm = self._shuffle_rng.permutation(len(self.entries)) if self.shuffle else None

        def put(item) -> bool:
            # bounded waits, so that an abandoned iterator cannot leave the
            # producer blocked on a full queue with the file open
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        stage = (PinnedStaging(self.device, max(1, self.prefetch) + 2)
                 if self.device.type == "cuda" else None)
        shape = (self.batch_size, *self.meta.frame_dims)

        def staged(item):
            """A host batch into the next pinned buffer (None: cancelled)."""
            X, y, n = item
            slot = stage.fill(shape, X.dtype, cancel)
            if slot is None:
                return None
            slot.buf.copy_(X)
            return slot, y, n

        def producer():
            try:
                with hdf5.File(self.dataset_path) as f:
                    if _is_flat_layout(f):
                        rows = self._flat_rows(f)
                        if perm is not None:
                            rows = rows[perm]
                        mm = self._flat_setup(f)
                        labels = np.asarray(f["labels"][()], np.float32)
                        for index in range(self.start_batch, self.n_batches):
                            item = self._read_batch_flat(f, rows, index, mm, labels)
                            if stage is not None:
                                item = staged(item)
                            if item is None or not put(item):
                                return
                    else:
                        frames = self._tree_index(f)
                        if perm is not None:
                            frames = [frames[i] for i in perm]
                        for index in range(self.start_batch, self.n_batches):
                            slot = None
                            if stage is not None:  # inflate straight into pinned memory
                                slot = stage.fill(shape, torch.float32, cancel)
                                if slot is None:
                                    return
                            X, y, n = self._read_batch(
                                f, frames, index, None if slot is None else slot.buf.numpy())
                            if not put((X, y, n) if slot is None else (slot, y, n)):
                                return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                put(("__producer_error__", e))
                return
            put(stop)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__producer_error__":
                    raise item[1]
                if stage is not None:
                    item = (stage.to_device(item[0]), *item[1:])
                yield item
        finally:
            cancel.set()
            th.join()


def bf16_bits(frames: np.ndarray | torch.Tensor) -> np.ndarray:
    """Float frames rounded to bfloat16 (to nearest even), as uint16 bits."""
    x = torch.as_tensor(frames).to(torch.bfloat16).view(torch.int16)
    return x.cpu().numpy().view(np.uint16)


def convert_to_flat(src: Path, dst: Path, chunk_rows: int = 512,
                    frame_dtype: str = "float32") -> Path:
    """Convert a tree-layout dataset to the flat layout, rows in
    ``create_flat_dataset_map`` order, values exact (``float32``) or
    rounded to bfloat16 and stored as uint16 bits with the ``frame_dtype``
    attribute (``bfloat16``: half the bytes, and the engine's own bf16 cast
    of float32 frames). ``/frames`` is contiguous, so the loader serves full
    in-order batches as views of a memory map; ``chunk_rows`` is kept for
    the JAX signature and has no effect. Labels keep the source's values:
    int8 when every ``encoded_residue`` is integral, else float32 (soft
    labels)."""
    if frame_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"frame_dtype must be 'float32' or 'bfloat16', got {frame_dtype!r}")
    src, dst = Path(src), Path(dst)
    with hdf5.File(src) as f:
        if _is_flat_layout(f):
            raise ValueError(f"{src} is already in the flat layout")
    dmap, _ = create_flat_dataset_map(src)
    loader = FrameBatchLoader(src, dmap, batch_size=512)
    n = len(dmap.entries)
    with hdf5.File(src) as fin, hdf5.Writer(dst) as fout:
        for k, v in fin.attrs.items():
            fout.attrs[k] = v
        fout.attrs["layout"] = "flat"
        if frame_dtype == "bfloat16":
            fout.attrs["frame_dtype"] = "bfloat16"
        frames = fout.create_dataset(
            "frames", shape=(n, *loader.meta.frame_dims),
            dtype=np.uint16 if frame_dtype == "bfloat16" else np.float32)
        row = 0
        for X, _, k in loader:
            X = X[:k].numpy()
            frames[row:row + k] = bf16_bits(X) if frame_dtype == "bfloat16" else X
            row += k
        labels = np.stack([fr.label for fr in loader._tree]) if n else np.zeros((0, 20))
        label_dtype = np.int8 if np.array_equal(labels, np.round(labels)) else np.float32
        fout.create_dataset("labels", data=labels.astype(label_dtype))
        for i, name in enumerate(("index_pdb", "index_chain", "index_residue", "index_label")):
            fout.create_dataset(name, data=np.array([e[i] for e in dmap.entries], object))
    return dst
