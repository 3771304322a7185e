"""Frame datasets: the HDF5 writer of ``td-voxelize``, and the in-memory
frame sets of ``td-predict --voxelize`` and training.

``make_frame_dataset`` is the port of ``timed_design_tpu/voxel/dataset.py``'s
writer: PDB files voxelized on a device into an aposteriori-schema HDF5 file
(tree layout) or the flat layout, through the port's own HDF5 writer
(``io/hdf5.py``). ``io/h5frames.py`` reads such files back.

A ``FrameSet`` holds the frame atoms of every structure (every NMR state
with ``voxelise_all_states``) on the host, and as flat tables on the device;
``FrameBatchSource`` voxelizes the rows of each batch there in one call: the
counterpart of ``io/h5frames.py``'s ``create_flat_dataset_map`` and
``FrameBatchLoader`` with no file in between.

Row order is the JAX package's. Its map comes from iterating the HDF5 tree,
and HDF5 lists group names in byte order: structures by name, chains by id,
both in byte order, then residues by ``_residue_sort_key``. So a structure
written chain B first, or an NMR deposit with 11 or more states (``x_10``
before ``x_2``), has rows in another order than the voxelizer's. Batches
follow the map's entries, looked up by key, whatever map they are given.
"""
from __future__ import annotations

import dataclasses
import typing as t
import warnings
from pathlib import Path

import numpy as np
import torch

from ..constants import AA3, AA3_TO_INT, UNCOMMON_RESIDUE_DICT
from ..io import hdf5
from ..io.datasetmap import DatasetMap, _residue_sort_key
from ..io.h5frames import bf16_bits
from ..ops.matmul_voxelize import voxelize_matmul
from ..structure import Structure, load_pdb
from ..utils import timing
from ..utils.timing import PhaseTimer
from .codec import Codec
from .frames import FrameAtoms, structure_to_frame_atoms
from .voxelize import voxelize_frame_atoms


def voxelize_structure(
    structure: Structure,
    codec: Codec,
    voxels_per_side: int = 21,
    frame_edge_length: float = 21.0,
    gaussian: bool = True,
    encode_cb: bool = True,
    atom_filter: str = "backbone",
    *,
    device: torch.device | str,
) -> tuple[torch.Tensor, FrameAtoms]:
    """Structure -> (frames (R, V, V, V, C) float32 on ``device``, FrameAtoms)."""
    fa = structure_to_frame_atoms(structure, codec, encode_cb=encode_cb, atom_filter=atom_filter)
    frames = voxelize_frame_atoms(
        fa, codec, voxels_per_side=voxels_per_side,
        frame_edge_length=frame_edge_length, gaussian=gaussian, device=device,
    )
    return frames, fa


# the version attribute: aposteriori's major version 2, so that its gate
# (and FrameDatasetMetadata's) accepts the file
FRAME_DATASET_VER = "2.0.0-tpu"


def make_frame_dataset(
    structure_paths: t.Sequence[Path],
    output_path: Path,
    codec: Codec | str = "CNOCACB",
    voxels_per_side: int = 21,
    frame_edge_length: float = 21.0,
    gaussian: bool = True,
    encode_cb: bool = True,
    voxelise_all_states: bool = False,
    compression: bool | None = None,
    atom_filter: str = "backbone",
    layout: str = "tree",
    chunk_rows: int = 512,
    frame_dtype: str = "float32",
    *,
    device: torch.device | str,
    timer: PhaseTimer | None = None,
) -> Path:
    """Voxelize PDB files on ``device`` into an HDF5 frame dataset, the file
    the JAX package's ``make_frame_dataset`` writes for the same arguments.

    ``layout='tree'``: aposteriori's ``/<pdb>/<chain>/<residue>`` datasets,
    one gzipped chunk a frame, with ``label`` and ``encoded_residue``
    attributes. ``layout='flat'``: ``/frames`` in rows of ``chunk_rows``
    (float32, or with ``frame_dtype='bfloat16'`` bfloat16 bits in uint16),
    ``/labels`` and the ``/index_*`` columns. ``compression=None`` is gzip
    for the tree and none for the flat layout. ``voxelise_all_states``
    keeps every NMR state as ``<pdb>_<state>``, the states aligned on the
    residues valid in all of them. ``timer`` gets the phases ``parse``,
    ``voxelize`` (the device's work and the copy to the host) and ``write``
    (gzip and the file)."""
    if isinstance(codec, str):
        codec = Codec.from_string(codec)
    if layout not in ("tree", "flat"):
        raise ValueError(f"layout must be 'tree' or 'flat', got {layout!r}")
    if frame_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"frame_dtype must be 'float32' or 'bfloat16', got {frame_dtype!r}")
    if frame_dtype != "float32" and layout != "flat":
        raise ValueError(
            "frame_dtype='bfloat16' requires layout='flat' (the tree schema "
            "is the aposteriori interop format and stays float-exact)"
        )
    timer = timer if timer is not None else PhaseTimer()
    device = torch.device(device)
    output_path = Path(output_path)
    if compression is None:
        compression = layout == "tree"
    dims = (voxels_per_side,) * 3 + (codec.n_channels,)
    with hdf5.Writer(output_path) as f:
        f.attrs["make_frame_dataset_ver"] = FRAME_DATASET_VER
        f.attrs["frame_dims"] = dims
        f.attrs["atom_encoder"] = list(codec.channels)
        f.attrs["encode_cb"] = bool(encode_cb)
        f.attrs["atom_filter_fn"] = atom_filter
        f.attrs["residue_encoder"] = list(AA3)
        f.attrs["frame_edge_length"] = float(frame_edge_length)
        f.attrs["voxels_as_gaussian"] = bool(gaussian)
        if layout == "flat":
            f.attrs["layout"] = "flat"
            if frame_dtype == "bfloat16":
                f.attrs["frame_dtype"] = "bfloat16"
            writer = _FlatWriter(f, dims, chunk_rows, compression, frame_dtype)
        for path in structure_paths:
            with timer.phase("parse"):
                states = load_pdb(Path(path), all_states=voxelise_all_states)
                if not isinstance(states, list):
                    states = [states]
                fas = [structure_to_frame_atoms(s, codec, encode_cb=encode_cb,
                                                atom_filter=atom_filter) for s in states]
                if len(fas) > 1:
                    fas = _align_states(fas, name=states[0].name)
            for s, fa in zip(states, fas):
                with timer.phase("voxelize"):
                    frames = voxelize_frame_atoms(
                        fa, codec, voxels_per_side=voxels_per_side,
                        frame_edge_length=frame_edge_length, gaussian=gaussian, device=device)
                    host = (bf16_bits(frames) if frame_dtype == "bfloat16"
                            else frames.cpu().numpy())
                with timer.phase("write"):
                    if layout == "flat":
                        writer.append(s.name, host, fa.chain_ids, fa.residue_ids, fa.labels)
                        continue
                    grp = f.require_group(s.name)
                    for i, label in enumerate(fa.labels):
                        d = grp.require_group(fa.chain_ids[i]).create_dataset(
                            str(fa.residue_ids[i]), data=host[i],
                            # one chunk a frame: one raw chunk for the loader to inflate
                            chunks=host[i].shape if compression else None,
                            compression="gzip" if compression else None)
                        d.attrs["label"] = label
                        onehot = np.zeros(20, np.int64)
                        onehot[AA3_TO_INT[label]] = 1
                        d.attrs["encoded_residue"] = onehot
        with timer.phase("write"):
            f.close()
    return output_path


class _FlatWriter:
    """The flat layout written as it comes: ``/frames`` in chunks of
    ``chunk_rows`` rows, ``/labels`` (int8 one-hot) and the string
    ``/index_*`` columns, each unlimited along its rows as the JAX writer's
    resizable datasets; their final size is set when the file closes."""

    def __init__(self, f: hdf5.Writer, dims: tuple, chunk_rows: int,
                 compression: bool = False, frame_dtype: str = "float32"):
        self.frames = f.create_appendable(
            "frames", dims, np.uint16 if frame_dtype == "bfloat16" else np.float32,
            chunk_rows, compression="gzip" if compression else None)
        rows = max(chunk_rows * 16, 4096)
        self.labels = f.create_appendable("labels", (20,), np.int8, rows)
        self.cols = {name: f.create_appendable(name, (), str, rows)
                     for name in ("index_pdb", "index_chain", "index_residue", "index_label")}

    def append(self, pdb_name: str, frames: np.ndarray, chain_ids, residue_ids, labels) -> None:
        """One structure's rows: ``frames`` as stored (float32, or bfloat16
        bits in uint16)."""
        r = len(labels)
        onehot = np.zeros((r, 20), np.int8)
        onehot[np.arange(r), [AA3_TO_INT[l] for l in labels]] = 1
        self.frames.append(frames)
        self.labels.append(onehot)
        for name, values in (("index_pdb", [pdb_name] * r),
                             ("index_chain", [str(c) for c in chain_ids]),
                             ("index_residue", [str(x) for x in residue_ids]),
                             ("index_label", [str(l) for l in labels])):
            self.cols[name].append(values)


def _align_states(fas: list[FrameAtoms], name: str) -> list[FrameAtoms]:
    """Restrict every NMR state's rows to the (chain, residue) keys present
    in ALL states, each state keeping its own order, so that row i of every
    state is the same residue (the consensus averages states by position)."""
    key_sets = [set(zip(fa.chain_ids, fa.residue_ids)) for fa in fas]
    common = set.intersection(*key_sets)
    if all(len(fa.labels) == len(common) for fa in fas):
        return fas
    dropped = sorted(set.union(*key_sets) - common)
    warnings.warn(
        f"{name}: aligning {len(fas)} NMR states on {len(common)} common "
        f"residues; dropping {len(dropped)} residue(s) missing a valid "
        f"frame in some state: "
        + ", ".join(f"{c}{r}" for c, r in dropped[:8])
        + ("..." if len(dropped) > 8 else "")
    )
    out = []
    for fa in fas:
        keep = [i for i, k in enumerate(zip(fa.chain_ids, fa.residue_ids)) if k in common]
        out.append(dataclasses.replace(
            fa,
            ca=fa.ca[keep],
            rot=fa.rot[keep],
            valid=fa.valid[keep],
            labels=[fa.labels[i] for i in keep],
            chain_ids=[fa.chain_ids[i] for i in keep],
            residue_ids=[fa.residue_ids[i] for i in keep],
        ))
    return out


@dataclasses.dataclass
class FrameSet:
    """The frame atoms of a run's structures, by structure name, and their
    codec; frames are 21^3 voxels of 1 A with Gaussian atoms, as
    ``make_frame_dataset`` writes them by default. ``index`` maps each
    (pdb, chain, residue id) key to its (structure, row); ``label_index``
    holds each structure's 20-class labels (the JAX writer's
    ``encoded_residue`` one-hots).

    The atoms of every structure, and every row's frame centre and
    rotation, are also kept as two flat float32 tables, copied to a device
    once, at its first batch: a batch then uploads only indices."""

    structures: list[tuple[str, FrameAtoms]]
    codec: Codec

    def __post_init__(self):
        self.index: dict[tuple[str, str, str], tuple[int, int]] = {}
        self.label_index: list[np.ndarray] = []
        for s, (name, fa) in enumerate(self.structures):
            for r, (chain, rid) in enumerate(zip(fa.chain_ids, fa.residue_ids)):
                key = (name, chain, rid)
                if key in self.index:
                    raise ValueError(
                        f"two frames have the key {key}: structure names "
                        "(file names without .pdb/.gz) must be unique")
                self.index[key] = (s, r)
            self.label_index.append(np.array([AA3_TO_INT[l] for l in fa.labels], np.int64))
        fas = [fa for _, fa in self.structures]
        # per atom: x, y, z, channel (small integers, exact in float32), sigma, property
        self._atoms = np.concatenate([np.zeros((0, 6), np.float32)] + [np.column_stack([
            fa.atoms_xyz, fa.atom_channel, fa.atom_sigma, fa.atom_prop]).astype(np.float32)
            for fa in fas])
        # per row: the frame centre (3) and rotation (9)
        self._frames = np.concatenate([np.zeros((0, 12), np.float32)] + [np.column_stack([
            fa.ca, fa.rot.reshape(-1, 9)]).astype(np.float32) for fa in fas])
        self._atom_count = np.array([len(fa.atom_channel) for fa in fas], np.int64)
        self._atom_start = np.cumsum(self._atom_count) - self._atom_count
        rows = np.array([len(fa.labels) for fa in fas], np.int64)
        self._row_start = np.cumsum(rows) - rows
        self._tables: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def frame_shape(self) -> tuple[int, int, int, int]:
        return (21, 21, 21, self.codec.n_channels)

    def voxelize_rows(self, structure: np.ndarray, row: np.ndarray,
                      device: torch.device) -> torch.Tensor:
        """Frames of row ``row[i]`` of structure ``structure[i]``, in that
        order, on ``device``, in one voxelizer call: each frame sees every
        atom of its own structure, padded to the call's largest structure.
        Only the indices cross to the device, pinned on a card, so the copy
        queues behind the device's work instead of waiting for it. While the
        span recorder is on (``utils/timing.py``) it counts the frame-atom
        pairs computed, frames x the padded atom count, and those of each
        frame's own structure (``voxelize.pairs_computed``,
        ``voxelize.pairs_real``)."""
        if device not in self._tables:
            self._tables[device] = (torch.from_numpy(self._atoms).to(device),
                                    torch.from_numpy(self._frames).to(device))
        atoms, frames = self._tables[device]
        ids, slot = np.unique(structure, return_inverse=True)
        S, n, A = len(ids), len(row), int(self._atom_count[ids].max())
        if timing.is_recording():
            timing.count("voxelize.pairs_real", int(self._atom_count[structure].sum()))
            timing.count("voxelize.pairs_computed", n * A)
        host = torch.from_numpy(np.concatenate([
            self._atom_start[ids], self._atom_count[ids], slot.ravel(),
            self._row_start[structure] + row]))
        if device.type == "cuda":
            host = host.pin_memory()
        start, count, slot, rows = host.to(device, non_blocking=True).split([S, S, n, n])
        j = torch.arange(A, device=device)
        # padding repeats the structure's last atom, dropped (channel -1)
        a = atoms[start[:, None] + torch.minimum(j, count[:, None] - 1)]  # (S, A, 6)
        channel = torch.where(j < count[:, None], a[..., 3], -1.0).to(torch.int32)
        f = frames[rows]
        prop = self.codec.property_channel
        return voxelize_matmul(
            a[..., :3], channel, a[..., 4], a[..., 5], f[:, :3], f[:, 3:].view(n, 3, 3),
            n_channels=self.codec.n_channels,
            prop_channel=self.codec.channels.index(prop) if prop else -1,
            frame_structure=slot,
        )


@timing.traced("frame_set")
def make_frame_set(
    structure_paths: t.Sequence[Path],
    codec: Codec | str = "CNOCACB",
    voxelise_all_states: bool = False,
) -> FrameSet:
    """PDB files -> FrameSet: what ``make_frame_dataset`` writes to HDF5 with
    its default settings (backbone atoms, an imputed CB), kept in memory as
    frame atoms; the frames themselves are made on the device, batch by
    batch. ``voxelise_all_states`` keeps every NMR state as a structure
    ``<pdb>_<state>``, the states aligned on their common residues.

    Spans (``utils/timing.py``): ``frame_set`` around the call,
    ``frame_set.parse`` and ``frame_set.frame_atoms`` for each file,
    ``frame_set.index`` around the ``FrameSet``'s tables."""
    if isinstance(codec, str):
        codec = Codec.from_string(codec)
    structures: list[tuple[str, FrameAtoms]] = []
    for path in structure_paths:
        with timing.span("frame_set.parse"):
            states = load_pdb(Path(path), all_states=voxelise_all_states)
        if not isinstance(states, list):
            states = [states]
        with timing.span("frame_set.frame_atoms"):
            fas = [structure_to_frame_atoms(s, codec) for s in states]
            if len(fas) > 1:
                fas = _align_states(fas, name=states[0].name)
        structures += [(s.name, fa) for s, fa in zip(states, fas)]
    with timing.span("frame_set.index"):
        return FrameSet(structures, codec)


def _byte_order(name: str) -> bytes:
    """HDF5's order of group names."""
    return name.encode()


def create_flat_dataset_map(
    frame_set: FrameSet,
    filter_list: t.Sequence[str] = (),
    remove_blacklist_silently: bool = False,
) -> DatasetMap:
    """The per-residue map of a frame set, in the order the JAX package's
    ``create_flat_dataset_map`` gives for the HDF5 file of the same
    structures: names, then chains, in byte order; residues by
    ``_residue_sort_key`` (ties in byte order). A structure whose 4-letter
    code is in ``filter_list`` is removed with a warning, or raises unless
    ``remove_blacklist_silently``; an uncommon label is remapped with a
    warning, an unknown one raises."""
    by_name: dict[str, dict[str, list[tuple[str, str]]]] = {}
    for name, fa in frame_set.structures:
        chains = by_name.setdefault(name, {})
        for chain, rid, label in zip(fa.chain_ids, fa.residue_ids, fa.labels):
            chains.setdefault(chain, []).append((rid, label))
    entries: list[tuple[str, str, str, str]] = []
    for name in sorted(by_name, key=_byte_order):
        if name[:4] in filter_list:
            if remove_blacklist_silently:
                warnings.warn(f"PDB code {name} was found in benchmark set; removed.")
                continue
            raise ValueError(
                f"PDB code {name} is blacklisted. Pass "
                f"remove_blacklist_silently=True to skip it instead."
            )
        chains = by_name[name]
        for chain in sorted(chains, key=_byte_order):
            residues = sorted(chains[chain], key=lambda e: _byte_order(e[0]))
            for rid, label in sorted(residues, key=lambda e: _residue_sort_key(e[0])):
                if label not in AA3:
                    if label not in UNCOMMON_RESIDUE_DICT:
                        raise ValueError(f"Expected natural amino acid, but got {label}.")
                    warnings.warn(f"{label} is not a standard residue; converted to "
                                  f"{UNCOMMON_RESIDUE_DICT[label]}.")
                    label = UNCOMMON_RESIDUE_DICT[label]
                entries.append((name, chain, rid, label))
    return DatasetMap(entries=entries)


class FrameBatchSource:
    """``(X, y, n_valid)`` batches of ``batch_size`` rows from ``start_batch``
    on, the rows following the map's entries, looked up by key: X (B, V, V,
    V, C) float32 frames voxelized on ``device`` (rows past ``n_valid`` are
    zero), y (B, 20) float32 one-hot labels on the host.

    A batch's rows are voxelized in one call, whatever structures they come
    from (``FrameSet.voxelize_rows``), so the device holds a batch of frames
    at a time, never the whole input, and a shuffled batch over thousands of
    structures costs one call, not one per structure. An entry absent from
    the frame set raises KeyError. The call is a ``voxelize`` device span
    (``utils/timing.py``), its id the batch's index.

    ``shuffle=True`` (training) draws a fresh permutation of the entries on
    every ``__iter__``, that is every epoch, from one
    ``np.random.default_rng(shuffle_seed)`` made here: the order of the JAX
    package's ``FrameBatchLoader(shuffle=True, shuffle_seed=...)``.

    ``rows`` (a slice of each batch's positions) voxelizes only those rows
    and leaves the others zero: a rank of a mesh that predicts its own rows
    of every batch (``engine/predictor.py``) voxelizes no other rank's.
    A row's frame is the same either way, to the rounding of the voxelizer's
    sums over the call's padded atom count."""

    def __init__(self, frame_set: FrameSet, dmap: DatasetMap, batch_size: int,
                 start_batch: int = 0, *, device: torch.device | str,
                 shuffle: bool = False, shuffle_seed: int = 0, rows: slice | None = None):
        if not dmap.is_old:
            raise ValueError("FrameBatchSource needs a per-residue dataset map")
        if shuffle and start_batch:
            # the skipped batches would come from a fresh permutation: some
            # frames twice, others never, and not the interrupted epoch
            raise ValueError(
                "start_batch resume is incompatible with shuffle=True: "
                "the skipped batches would come from a new permutation."
            )
        self.frame_set = frame_set
        self.entries = dmap.entries
        self.batch_size = batch_size
        self.start_batch = start_batch
        self.device = torch.device(device)
        self.n_batches = -(-len(self.entries) // batch_size)
        self.shuffle = shuffle
        self._shuffle_rng = np.random.default_rng(shuffle_seed)
        self.rows = rows

    def _batch(self, entries: list, index: int) -> tuple[torch.Tensor, np.ndarray, int]:
        fs, B = self.frame_set, self.batch_size
        batch = entries[index * B : (index + 1) * B]
        n = len(batch)
        structure, row = np.array([fs.index[(pdb, chain, rid)]
                                   for pdb, chain, rid, _ in batch], np.int64).reshape(n, 2).T
        y = np.zeros((B, 20), np.float32)
        for i, (s, r) in enumerate(zip(structure, row)):
            y[i, fs.label_index[s][r]] = 1.0
        if self.rows is None:
            with timing.device_span("voxelize", index, device=self.device):
                X = fs.voxelize_rows(structure, row, self.device)
            if n < B:
                X = torch.cat([X, X.new_zeros((B - n, *fs.frame_shape))])
            return X, y, n
        lo, hi, _ = self.rows.indices(n)
        X = torch.zeros((B, *fs.frame_shape), device=self.device)
        if hi > lo:
            with timing.device_span("voxelize", index, device=self.device):
                X[lo:hi] = fs.voxelize_rows(structure[lo:hi], row[lo:hi], self.device)
        return X, y, n

    def __iter__(self) -> t.Iterator[tuple[torch.Tensor, np.ndarray, int]]:
        entries = self.entries
        if self.shuffle:
            entries = [entries[i] for i in self._shuffle_rng.permutation(len(entries))]
        for index in range(self.start_batch, self.n_batches):
            yield self._batch(entries, index)
