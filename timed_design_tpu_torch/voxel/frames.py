"""Residue frame construction: local bases, CB imputation, atom arrays.

Host numpy code, the same as ``timed_design_tpu/voxel/frames.py``. Its
tables and PDB structures are the port's own copies (``..constants``,
``..structure``).

Framework-native replacement for aposteriori's `make_frame_dataset` geometry
(reference README.md:84-96, design_utils/utils.py:247): each residue gets a
local orthogonal basis centered on its CA; every (side-chain-stripped)
backbone atom of the whole structure is expressed in that basis and voxelized
into a (V, V, V, C) grid.

Frame basis convention (empirically recovered — see the JAX package's tests/test_voxel.py):
with u = unit(C - CA) and w = unit((N - CA) orthogonalized against u),

    x-axis = w,   y-axis = u,   z-axis = u x w

i.e. the CA->C bond lies along +y and the backbone N pins the +x direction.
Under this convention the per-residue CB positions of real structures cluster
tightly (std ~0.07 A) around the documented imputed-CB offset
``(-0.741287356, -0.53937931, -1.224287356)`` (utils.py:247, the 1QYS average
— our 1UBQ-measured mean lands 0.02 A away), which is how the convention was
identified. CB imputation places a virtual CB at that offset in every
residue's own frame and maps it back to world coordinates so neighboring
frames see it too.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import AA3_TO_AA1, VDW_RADII
from ..structure import Structure, convert_seq_to_property
from ..structure.pdb import distinct_rows
from .codec import Codec

# Imputed CB offset in frame coordinates (reference utils.py:247).
CB_FRAME_OFFSET = np.array([-0.741287356, -0.53937931, -1.224287356])

BACKBONE_FILTER = ("N", "CA", "C", "O")  # side chains stripped (README.md:75)


def frame_bases(bb: dict[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Per-residue frame rotation matrices from backbone arrays.

    Parameters: ``bb`` maps atom name -> (R, 3) world coords (NaN = missing).
    Returns ``(M, valid)`` where ``M[r]`` has rows (x-axis, y-axis, z-axis) so
    frame coords are ``M[r] @ (p - CA[r])``, and ``valid[r]`` is False when
    N/CA/C are missing or degenerate.
    """
    ca, c, n = bb["CA"], bb["C"], bb["N"]
    u = c - ca
    un = np.linalg.norm(u, axis=-1, keepdims=True)
    w = n - ca
    w = w - (w * u).sum(-1, keepdims=True) * u / np.maximum(un**2, 1e-12)
    wn = np.linalg.norm(w, axis=-1, keepdims=True)
    valid = (
        np.isfinite(ca).all(-1)
        & np.isfinite(u).all(-1)
        & np.isfinite(w).all(-1)
        & (un[..., 0] > 1e-6)
        & (wn[..., 0] > 1e-6)
    )
    u = u / np.maximum(un, 1e-12)
    w = w / np.maximum(wn, 1e-12)
    z = np.cross(u, w)
    M = np.stack([w, u, z], axis=-2)  # rows: x, y, z axes
    M = np.where(valid[:, None, None], M, np.eye(3)[None])
    return M.astype(np.float32), valid


@dataclasses.dataclass
class FrameAtoms:
    """Flat device-ready atom arrays for one structure + per-residue frames."""

    atoms_xyz: np.ndarray  # (A, 3) float32 world coords
    atom_channel: np.ndarray  # (A,) int32 codec channel, -1 = dropped
    atom_sigma: np.ndarray  # (A,) float32 vdw radius (Angstrom)
    atom_prop: np.ndarray  # (A,) float32 property value of parent residue
    ca: np.ndarray  # (R, 3) float32
    rot: np.ndarray  # (R, 3, 3) float32
    valid: np.ndarray  # (R,) bool
    labels: list[str]  # three-letter residue labels, length R
    chain_ids: list[str]
    residue_ids: list[str]


def structure_to_frame_atoms(
    structure: Structure,
    codec: Codec,
    encode_cb: bool = True,
    atom_filter: str = "backbone",
) -> FrameAtoms:
    """Flatten a structure to voxelizer atom arrays (frames + channels).

    ``atom_filter`` mirrors aposteriori's filter functions (the dataset attr
    ``atom_filter_fn``, utils.py:248):
      * 'backbone' (default, the design flow): only N/CA/C/O kept — the
        prediction runs on the empty backbone (README.md:84-96) — plus a
        virtual CB imputed at the fixed frame offset (``-cb True``);
      * 'ca': CA atoms only;
      * 'all': every non-H atom incl. side chains (training datasets on
        full structures; real CBs used, no imputation).
    Property channel values (P/Q codecs) derive from residue identities.
    """
    std = [r for r in structure.residues if r.is_standard_aa]
    bb = structure.backbone_arrays()
    M, valid = frame_bases(bb)
    ca = np.nan_to_num(bb["CA"]).astype(np.float32)

    seq = "".join(AA3_TO_AA1.get(r.res_name, "X") for r in std)
    prop_channel = codec.property_channel
    if prop_channel == "P":
        prop_values = np.array(convert_seq_to_property(seq, "polarity"), np.float32)
    elif prop_channel == "Q":
        prop_values = np.array(convert_seq_to_property(seq, "charge"), np.float32)
    else:
        prop_values = np.zeros(len(std), np.float32)

    if atom_filter == "all":
        # every non-H atom of the flat struct-of-arrays (side chains kept);
        # channel and radius a distinct (name, element) at a time
        names, elements = structure.atom_names, structure.elements
        first, pair_of = distinct_rows(names, elements)
        pairs = [(str(names[i]), str(elements[i])) for i in first]
        channel = np.array([codec.atom_channel(n, e) for n, e in pairs], np.int32)[pair_of]
        sigma = np.array([VDW_RADII.get(e, VDW_RADII["C"]) for _, e in pairs],
                         np.float32)[pair_of]
        take = (elements != "H") & (channel >= 0)
        xyz, chan, sigma = structure.coords[take], channel[take], sigma[take]
        prop = prop_values[structure.res_index[take]]
    elif atom_filter == "ca":
        ch = codec.atom_channel("CA", "C")
        take = np.isfinite(bb["CA"]).all(-1) & (ch >= 0)
        xyz, prop = bb["CA"][take], prop_values[take]
        chan = np.full(len(xyz), ch, np.int32)
        sigma = np.full(len(xyz), VDW_RADII["C"], np.float32)
    elif atom_filter == "backbone":
        # one (R, 5) block a residue: N, CA, C, O (element = first letter),
        # then the virtual CB, its frame offset mapped back to world coords
        names = BACKBONE_FILTER + ("CB",)
        elements = [name[0] for name in BACKBONE_FILTER] + ["C"]
        block = np.empty((len(std), 5, 3), np.float32)
        for k, name in enumerate(BACKBONE_FILTER):
            block[:, k] = bb[name]
        block[:, 4] = ca + np.matmul(M.transpose(0, 2, 1), CB_FRAME_OFFSET)
        channels = np.array([codec.atom_channel(n, e) for n, e in zip(names, elements)], np.int32)
        take = np.concatenate(
            [np.isfinite(block[:, :4]).all(-1), (valid & encode_cb)[:, None]], axis=1)
        take &= channels >= 0
        xyz = block[take]
        chan = np.broadcast_to(channels, take.shape)[take]
        sigma = np.broadcast_to(
            np.array([VDW_RADII[e] for e in elements], np.float32), take.shape)[take]
        prop = np.broadcast_to(prop_values[:, None], take.shape)[take]
    else:
        raise ValueError(f"atom_filter {atom_filter!r} not in (backbone, ca, all)")

    labels = [str(r.res_name) for r in std]
    chain_ids = [str(r.chain_id) for r in std]
    residue_ids = [str(r.id) for r in std]
    if not valid.all():
        # residues whose N/CA/C backbone is incomplete/degenerate cannot
        # anchor a frame: drop them as frame CENTERS (aposteriori skips
        # them too) — their present atoms above still contribute to
        # neighboring residues' environments. Without this, an invalid
        # residue got an identity-rotation frame centered at the world
        # origin, silently written with a real label.
        import warnings

        dropped = [
            f"{chain_ids[i]}{residue_ids[i]}({labels[i]})"
            for i in np.nonzero(~valid)[0]
        ]
        warnings.warn(
            f"{structure.name}: skipping {len(dropped)} residue(s) with "
            f"incomplete backbone frames: {', '.join(dropped[:8])}"
            + ("..." if len(dropped) > 8 else "")
        )
        keep = np.nonzero(valid)[0]
        ca, M = ca[keep], M[keep]
        labels = [labels[i] for i in keep]
        chain_ids = [chain_ids[i] for i in keep]
        residue_ids = [residue_ids[i] for i in keep]
        valid = valid[keep]

    return FrameAtoms(
        atoms_xyz=xyz,
        atom_channel=chan,
        atom_sigma=sigma,
        atom_prop=prop,
        ca=ca,
        rot=M,
        valid=valid,
        labels=labels,
        chain_ids=chain_ids,
        residue_ids=residue_ids,
    )
