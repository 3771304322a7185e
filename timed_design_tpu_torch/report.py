"""The static HTML design report: one self-contained file per prediction
run; the port of ``timed_design_tpu/report.py``.

Designed against native sequence, sequence metrics, the probability
heatmap, the prediction entropy, the sequence logo and a per-position top-3
table, with the figures inlined as base64 PNGs. The text, the CSS and the
figures are the JAX package's. Host code: the probabilities arrive as numpy
arrays, and matplotlib is imported only through ``analyse/plots.py::pyplot``
(the entry points check for it before any work).
"""
from __future__ import annotations

import base64
import html
import io
from pathlib import Path

import numpy as np

from .analyse.plots import pyplot

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2rem auto; max-width: 1080px; color: #1a1a1a;
       background: #ffffff; }
h1 { font-size: 1.5rem; } h2 { font-size: 1.2rem; margin-top: 2.2rem;
     border-bottom: 1px solid #ddd; padding-bottom: 0.3rem; }
h3 { font-size: 1.0rem; color: #444; }
code, pre.seq { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
                font-size: 0.85rem; }
pre.seq { background: #f6f6f6; padding: 0.6rem; border-radius: 6px;
          overflow-x: auto; line-height: 1.5; }
pre.seq .diff { background: #ffe2a8; }
table { border-collapse: collapse; margin: 0.8rem 0; }
th, td { border: 1px solid #ddd; padding: 0.35rem 0.7rem;
         font-size: 0.85rem; text-align: right; }
th { background: #f2f2f2; text-align: center; }
td:first-child { text-align: left; }
img { max-width: 100%; height: auto; border: 1px solid #eee;
      border-radius: 4px; margin: 0.4rem 0; }
details { margin: 0.6rem 0; }
summary { cursor: pointer; color: #336; }
.meta { color: #666; font-size: 0.85rem; }
"""


_WHAT = "render_design_report"  # names the caller where matplotlib is missing


def _fig_to_b64(fig) -> str:
    plt = pyplot(_WHAT)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _img(fig, alt: str) -> str:
    return (
        f'<img alt="{html.escape(alt)}" '
        f'src="data:image/png;base64,{_fig_to_b64(fig)}">'
    )


def _heatmap_fig(probs20: np.ndarray, native_seq: str, title: str):
    """The probability heatmap of the saved analysis plots."""
    from .analyse.plots import probability_heatmap_fig

    return probability_heatmap_fig(np.asarray(probs20), native_seq=native_seq, title=title)


def _entropy_fig(entropy: np.ndarray, title: str):
    plt = pyplot(_WHAT)
    fig, ax = plt.subplots(figsize=(7.5, 2.6))
    ax.plot(np.asarray(entropy), color="#444444", linewidth=1.6)
    ax.set_xlabel("Position")
    ax.set_ylabel("Shannon entropy (bits)")
    ax.set_title(title, fontsize=10)
    ax.grid(True, color="#eeeeee", linewidth=0.8)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    return fig


def _seq_block(designed: str, native: str) -> str:
    """The designed sequence with the positions that differ from the native
    highlighted; positions past the native's end count as differing."""
    marked = "".join(
        f'<span class="diff">{html.escape(d)}</span>'
        if i >= len(native) or d != native[i]
        else html.escape(d)
        for i, d in enumerate(designed)
    )
    out = f"<h3>Designed sequence</h3><pre class='seq'>{marked}</pre>"
    if native:
        out += (
            f"<h3>Native sequence</h3>"
            f"<pre class='seq'>{html.escape(native)}</pre>"
        )
    return out


def _metrics_table(native_seq: str, designed_seq: str) -> str:
    from .sample.metrics import sequence_metrics

    names = ("Charge @ pH 7.4", "Isoelectric point", "Molecular weight",
             "Molar extinction @ 280 nm")
    real = sequence_metrics(native_seq)
    pred = sequence_metrics(designed_seq)
    rows = "".join(
        f"<tr><td>{n}</td><td>{r:.2f}</td><td>{p:.2f}</td>"
        f"<td>{p - r:+.2f}</td></tr>"
        for n, r, p in zip(names, real, pred)
    )
    return (
        "<table><tr><th>Metric</th><th>Native</th><th>Designed</th>"
        "<th>&Delta;</th></tr>" + rows + "</table>"
    )


def _topk_table(probs20: np.ndarray, native_seq: str, k: int = 3) -> str:
    from .constants import AA1

    aa = np.array(list(AA1))
    order = np.argsort(-np.asarray(probs20), axis=1)[:, :k]
    body = []
    for i, row in enumerate(order):
        cells = "".join(
            f"<td>{aa[j]} ({100 * probs20[i, j]:.1f}%)</td>" for j in row
        )
        nat = native_seq[i] if i < len(native_seq) else ""
        body.append(f"<tr><td>{i + 1}</td><td>{nat}</td>{cells}</tr>")
    head = "".join(f"<th>Top {j + 1}</th>" for j in range(k))
    return (
        "<details><summary>Per-position top-3 table</summary>"
        f"<table><tr><th>Pos</th><th>Native</th>{head}</tr>"
        + "".join(body) + "</table></details>"
    )


def render_design_report(
    pdb_to_sequence: dict[str, str],
    pdb_to_real_sequence: dict[str, str],
    pdb_to_probability: dict[str, np.ndarray],
    model_name: str = "model",
    pdb_to_consensus: dict[str, str] | None = None,
) -> str:
    """The self-contained HTML report document, as a string.

    ``pdb_to_probability`` rows may be 20-class or 338-class (rotamer):
    rotamer rows are summed to the 20 amino acids for the heatmap and the
    top-k table (the logo sums them itself). A native sequence whose length
    differs from the design's gives NaN identity and similarity.
    """
    from .analyse import calculate_prediction_entropy, create_sequence_logo
    from .constants import compress_rotamer_probs, sequence_similarity

    pyplot(_WHAT)  # before any figure, with a message that names matplotlib
    sections = []
    for pdb, designed in pdb_to_sequence.items():
        native = pdb_to_real_sequence.get(pdb, "")
        probs = np.asarray(pdb_to_probability[pdb], np.float64)
        rotamer = probs.shape[1] == 338
        probs20 = np.asarray(compress_rotamer_probs(probs)) if rotamer else probs
        comparable = native and len(native) == len(designed)
        identity = (
            float(np.mean([a == b for a, b in zip(designed, native)]))
            if comparable else float("nan")
        )
        sim = sequence_similarity(native, designed) if comparable else float("nan")
        parts = [f"<h2>{html.escape(pdb)}</h2>"]
        parts.append(
            f"<p class='meta'>{len(designed)} residues &middot; "
            f"{'338-rotamer' if rotamer else '20-residue'} head &middot; "
            f"identity {100 * identity:.1f}% &middot; "
            f"similarity {100 * sim:.1f}%</p>"
        )
        parts.append(_seq_block(designed, native))
        if native:
            parts.append(_metrics_table(native, designed))
        parts.append(
            _img(_heatmap_fig(probs20, native, f"{pdb} probabilities"),
                 f"{pdb} probability heatmap")
        )
        parts.append(
            _img(_entropy_fig(calculate_prediction_entropy(probs20),
                              f"{pdb} prediction entropy"),
                 f"{pdb} prediction entropy")
        )
        parts.append(_img(create_sequence_logo(probs), f"{pdb} sequence logo"))
        parts.append(_topk_table(probs20, native))
        if pdb_to_consensus and pdb in pdb_to_consensus:
            parts.append(
                "<h3>NMR consensus sequence</h3><pre class='seq'>"
                + html.escape(pdb_to_consensus[pdb]) + "</pre>"
            )
        sections.append("\n".join(parts))

    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(model_name)} design report</title>"
        f"<style>{_CSS}</style></head><body>"
        f"<h1>{html.escape(model_name)} design report</h1>"
        f"<p class='meta'>{len(pdb_to_sequence)} chain(s)</p>"
        + "\n".join(sections)
        + "</body></html>"
    )


def write_design_report(
    pdb_to_sequence: dict[str, str],
    pdb_to_real_sequence: dict[str, str],
    pdb_to_probability: dict[str, np.ndarray],
    output_path: Path,
    model_name: str = "model",
    pdb_to_consensus: dict[str, str] | None = None,
    filename: str | None = None,
) -> Path:
    """Render and write one report file (``{model_name}_report.html`` unless
    ``filename`` is given); returns its path."""
    doc = render_design_report(
        pdb_to_sequence, pdb_to_real_sequence, pdb_to_probability,
        model_name=model_name, pdb_to_consensus=pdb_to_consensus,
    )
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    out = output_path / (filename or f"{model_name}_report.html")
    out.write_text(doc)
    return out
