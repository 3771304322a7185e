"""Plotting: confusion matrices, sequence logos, probability summaries; the
port of ``timed_design_tpu/analyse/plots.py``.

Host-side matplotlib, imported inside each plot function (through
``pyplot``), so the analysis runs where matplotlib is missing and only a
plot call fails there, with a message that names matplotlib and the option
that asked for the plot. The sequence logo draws its letter glyphs itself.
"""
from __future__ import annotations

import typing as t
from pathlib import Path

import numpy as np

from ..constants import AA1, STANDARD_AMINO_ACIDS
from ..constants.rotamers import compress_rotamer_probs

# Chemistry color scheme (logomaker-style classes)
_AA_COLORS = {
    **{a: "#109648" for a in "ST"},          # polar, hydroxyl
    **{a: "#109648" for a in "NQ"},          # polar, amide
    **{a: "#5E239D" for a in "CGP"},         # special
    **{a: "#D62839" for a in "DE"},          # acidic
    **{a: "#255C99" for a in "KRH"},         # basic
    **{a: "#221E22" for a in "AVLIMFWY"},    # hydrophobic
}


def pyplot(flag: str):
    """matplotlib's pyplot on the Agg backend. Where matplotlib is missing
    (the card's machine has none) raises an ImportError that names it and
    ``flag``, the option that asked for the plot."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            f"{flag} draws plots with matplotlib, which is not installed here: "
            f"install matplotlib or leave {flag} out"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def require_pyplot(flag: str) -> None:
    """For an entry point, before any work: exits with ``pyplot``'s message
    (it names matplotlib and ``flag``) where matplotlib is missing."""
    try:
        pyplot(flag)
    except ImportError as e:
        raise SystemExit(str(e)) from e


def plot_cm(
    cm: np.ndarray,
    y_labels: t.Sequence[str],
    x_labels: t.Sequence[str],
    title: str,
    output_path: Path,
    display_colorbar: bool = False,
):
    """Confusion-matrix heatmap saved as ``{title with _}.png``."""
    plt = pyplot("--plot_confusion")

    fig, ax = plt.subplots(
        figsize=(max(len(x_labels) * 0.5, 5), max(len(y_labels) * 0.5, 5))
    )
    im = ax.imshow(cm, interpolation="nearest", aspect="auto", cmap="viridis")
    ax.set_xlabel("Predicted Residue")
    ax.set_xticks(range(len(x_labels)), x_labels, rotation=90)
    ax.set_ylabel("True Residue")
    ax.set_yticks(range(len(y_labels)), y_labels)
    ax.set_title(title)
    if display_colorbar:
        fig.colorbar(im).set_label("Confusion Level (Range 0 - 1)")
    fig.tight_layout()
    out = Path(output_path) / f"{title.replace(' ', '_')}.png"
    fig.savefig(out)
    plt.close(fig)
    return out


def create_rot_cm(
    cm: np.ndarray, rot_categories: t.Sequence[str], mode: str, output_path: Path
):
    """Per-amino-acid rotamer confusion panels: for each residue type, (its
    rotamers x 338), (its rotamers x its rotamers), and (its rotamers x 20
    residues) matrices."""
    rot_categories = np.asarray(rot_categories)
    res_categories = np.array([c.split("_")[0] for c in rot_categories])
    for res in STANDARD_AMINO_ACIDS.values():
        rot_idx = res_categories == res
        curr = rot_categories[rot_idx]
        rot_cm = cm[rot_idx, :]
        denom = max(rot_cm.sum(), 1e-12)
        rot_cm_n = rot_cm / denom
        plot_cm(rot_cm_n, curr, rot_categories, f"{mode} {res} vs all 338 rot", output_path)
        small = cm[rot_idx][:, rot_idx] / denom
        if len(small) > 1:
            plot_cm(small, curr, curr, f"{mode} {res} vs {res} rot", output_path)
        # collapse columns to 20 residues
        rot_res = np.stack(
            [rot_cm_n[:, res_categories == r].sum(axis=1) for r in STANDARD_AMINO_ACIDS.values()],
            axis=1,
        )
        rot_res = rot_res / max(rot_res.sum(), 1e-12)
        plot_cm(rot_res, curr, list(STANDARD_AMINO_ACIDS.values()),
                f"{mode} {res} vs 20 res", output_path)


def create_sequence_logo(prediction_matrix: np.ndarray):
    """Sequence logo from an (n, 20) or (n, 338) probability matrix: letter
    glyphs drawn with matplotlib, height = probability, chemistry color
    scheme."""
    plt = pyplot("--output_analysis")
    from matplotlib.textpath import TextPath
    from matplotlib.patches import PathPatch
    from matplotlib.transforms import Affine2D
    from matplotlib.font_manager import FontProperties

    P = np.asarray(prediction_matrix, np.float64)
    if P.shape[-1] == 338:
        P = compress_rotamer_probs(P)
    n = len(P)
    fig, ax = plt.subplots(figsize=(max(0.12 * n, 10), 2.5))
    fp = FontProperties(weight="bold", family="monospace")
    for pos in range(n):
        order = np.argsort(P[pos])  # stack smallest first
        y0 = 0.0
        for k in order:
            h = P[pos, k]
            if h < 1e-3:
                continue
            letter = AA1[k]
            tp = TextPath((0, 0), letter, size=1.0, prop=fp)
            bb = tp.get_extents()
            scale_x = 0.8 / max(bb.width, 1e-9)
            scale_y = h / max(bb.height, 1e-9)
            tf = (
                Affine2D()
                .translate(-bb.x0, -bb.y0)
                .scale(scale_x, scale_y)
                .translate(pos + 0.1, y0)
            )
            ax.add_patch(
                PathPatch(tp.transformed(tf), facecolor=_AA_COLORS.get(letter, "#222"),
                          edgecolor="none")
            )
            y0 += h
    ax.set_xlim(0, n)
    ax.set_ylim(0, 1.02)
    ax.set_xticks(np.arange(0, n, 5))
    ax.set_ylabel("Probability (%)")
    ax.set_xlabel("Residue Position")
    return fig


def plot_mean_var_probs(prediction_matrix: np.ndarray, title: str, output_path: Path):
    """Histograms of the per-position mean and variance of probabilities."""
    plt = pyplot("--output_analysis")

    P = np.asarray(prediction_matrix)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(P.mean(axis=1), bins=30)
    axes[0].set_title("mean probability")
    axes[1].hist(P.var(axis=1), bins=30)
    axes[1].set_title("probability variance")
    fig.suptitle(title)
    out = Path(output_path) / f"{title.replace(' ', '_')}_mean_var.png"
    fig.savefig(out)
    plt.close(fig)
    return out


def probability_heatmap_fig(
    probs: np.ndarray,
    *,
    native_seq: str | None = None,
    title: str | None = None,
    percent: bool = True,
    figsize: tuple[float, float] | None = None,
):
    """The per-position probability heatmap (viridis = magnitude, amino
    acids on y, optional circles on the native residues). Returns the
    matplotlib Figure (the caller closes it)."""
    plt = pyplot("--output_analysis")

    P = np.asarray(probs)
    L = len(P)
    fig, ax = plt.subplots(
        figsize=figsize or (min(16.0, max(6.0, 3 + L * 0.14)), 5)
    )
    im = ax.imshow(P.T * (100.0 if percent else 1.0), aspect="auto",
                   cmap="viridis", origin="upper", interpolation="nearest")
    ax.set_yticks(range(20), list(AA1))
    ax.set_xlabel("Residue Position")
    ax.set_ylabel("Residue")
    if native_seq is not None:
        aa_index = {a: i for i, a in enumerate(AA1)}
        xs = [i for i, a in enumerate(native_seq) if a in aa_index]
        ys = [aa_index[a] for a in native_seq if a in aa_index]
        ax.scatter(xs, ys, s=18, facecolors="none", edgecolors="red",
                   linewidths=0.8, label="Original residue")
        if xs:
            ax.legend(loc="upper right", fontsize=8)
    fig.colorbar(im, label="Probability (%)" if percent else "Probability")
    if title is not None:
        ax.set_title(title, fontsize=10)
    return fig


def plot_sequence_heatmap(prediction_matrix: np.ndarray, title: str, output_path: Path):
    """Probability heatmap residues x classes (raw probabilities, no
    overlay), drawn by ``probability_heatmap_fig``."""
    plt = pyplot("--output_analysis")

    P = np.asarray(prediction_matrix)
    fig = probability_heatmap_fig(
        P, percent=False, title=title, figsize=(max(0.15 * len(P), 6), 5)
    )
    out = Path(output_path) / f"{title.replace(' ', '_')}_heatmap.png"
    fig.savefig(out)
    plt.close(fig)
    return out


def plot_patterns(
    pdb_to_consensus_prob: dict,
    model_name: str,
    output_path: Path = Path("."),
    prediction_csv: Path | None = None,
) -> list[Path]:
    """Both pattern plots: the whole-run mean/var histograms from
    ``{model}.csv`` plus per-structure consensus-probability heatmaps."""
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    csv = Path(prediction_csv) if prediction_csv else Path(f"{model_name}.csv")
    paths = []
    if csv.exists():
        P = np.genfromtxt(csv, delimiter=",", dtype=np.float16)
        paths.append(plot_mean_var_probs(P, model_name, output_path))
    for pdb, probs in pdb_to_consensus_prob.items():
        paths.append(
            plot_sequence_heatmap(probs, f"{model_name}_{pdb}", output_path)
        )
    return paths


def rotamer_probability_fig(rotamer_probs: np.ndarray, rotamer_categories=None):
    """The design app's per-position chart of all 338 rotamer probabilities
    (in percent, one column a position). Returns the Figure (the caller
    closes it, ``close_figure``)."""
    plt = pyplot("the design app")

    L = len(rotamer_probs)
    fig, ax = plt.subplots(figsize=(min(16, 3 + L * 0.14), 24))
    im = ax.imshow(np.asarray(rotamer_probs).T * 100, aspect="auto",
                   cmap="viridis", origin="upper")
    if rotamer_categories is not None:
        step = max(1, len(rotamer_categories) // 60)
        ax.set_yticks(range(0, len(rotamer_categories), step),
                      rotamer_categories[::step], fontsize=5)
    ax.set_xlabel("Position")
    fig.colorbar(im, label="Probability (%)")
    return fig


def design_confusion_fig(cm: np.ndarray):
    """The design app's 20 x 20 confusion matrix, designed residues against
    native ones. Returns the Figure (the caller closes it)."""
    plt = pyplot("the design app")

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(cm, cmap="viridis", aspect="auto")
    ax.set_xticks(range(20), list(AA1))
    ax.set_yticks(range(20), list(AA1))
    ax.set_xlabel("Designed")
    ax.set_ylabel("Native")
    fig.colorbar(im)
    return fig


def ca_trace_fig(ca: np.ndarray):
    """The CA trace projected on the xy, xz and yz planes, the design app's
    structure view where py3Dmol is missing. Returns the Figure (the caller
    closes it)."""
    plt = pyplot("the design app")

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (i, j, lbl) in zip(axes, [(0, 1, "xy"), (0, 2, "xz"), (1, 2, "yz")]):
        ax.plot(ca[:, i], ca[:, j], "-o", markersize=2, linewidth=1)
        ax.set_title(f"CA trace ({lbl})")
        ax.set_aspect("equal")
    return fig


def close_figure(fig) -> None:
    """Close ONE figure: a server runs sessions on threads of one process,
    and ``close("all")`` would drop another session's figure from pyplot's
    shared registry."""
    pyplot("the design app").close(fig)
