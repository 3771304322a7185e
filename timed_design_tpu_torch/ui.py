"""Streamlit web UI — interactive protein sequence design on the GPU.

The port of ``timed_design_tpu/ui.py``, with the same sections and function
names: upload or name a PDB backbone, pick a model (the `.h5` releases
found in the models folder, then the registry architectures), optionally
pin polar or charged positions (property-constrained design), then
voxelize -> predict -> explore, on the CUDA device unless ``--device cpu``:

  * Design tab: designed sequence, original vs predicted sequence metrics
    with deltas, BLOSUM62 similarity and identity, residue composition, a
    per-position probability heatmap with the native residues marked, a
    per-position probability explorer, prediction entropy, sequence logo,
    CSV download;
  * Performance tab: top-k accuracy, prediction bias, confusion matrix
    against the native sequence;
  * Optimisation tab: Monte-Carlo samples drawn on the device by the port's
    sampler (one launch of the sampling kernel on the card), ranked by the
    summed normalised MAE of their metrics against the native sequence's;
  * NMR flow: every MODEL designed and averaged into the running pairwise
    consensus, on the residues common to all states.

Where it departs from the JAX UI: it starts as a script (absolute imports:
``streamlit run`` runs the file as ``__main__``, outside any package); it
imports neither pandas (charts take a dict of columns, labels named by
``x=``) nor matplotlib (the figures come from ``analyse/plots.py``; where
matplotlib is missing each figure's place holds an error naming it and the
rest of the page draws); the Monte-Carlo draws are the port's Philox draws.

Across cards, as the JAX app splits every batch over all local chips: with
``--device cuda`` and more than one visible card, the app's process is rank
0 of a world of one process per card (``parallel/frontend.py``), started once
per Streamlit process and kept at module level there; every browser session
and every rerun designs through it, under its lock. With one card, or
``--device cpu``, the app is one process.

Run:  streamlit run timed_design_tpu_torch/ui.py -- --path_to_models models/ [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    # run as a script (``streamlit run``, ``python ui.py``): Python put this
    # file's folder first on the path, where the package's own ``io``,
    # ``utils``, ... would shadow top-level modules; the repository root,
    # which holds the package, goes there instead
    _HERE = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
    sys.path.insert(0, str(_HERE.parent))

try:
    import streamlit as st
except ImportError as _e:  # pragma: no cover - exercised via stand-ins in tests
    st = None
    _STREAMLIT_ERR = _e


REGISTRY_UI_MODELS = [
    "TIMED", "TIMED_Deep", "DenseCPD", "DenseNet", "ProDCoNN",
    "TIMED_Charge", "TIMED_Polar",
]
PROPERTY_MODELS = {"TIMED_Charge": "charge", "TIMED_Polar": "polarity"}


def _parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--path_to_models", type=str, default="models")
    p.add_argument("--path_to_pdb", type=str, default=None,
                   help="Optional local PDB mirror (searched for codes)")
    p.add_argument("--allow-fetch", action="store_true", dest="allow_fetch",
                   help="Fetch PDB codes missing from the mirror from RCSB "
                        "into the mirror's sharded layout (default off)")
    p.add_argument("--fetch_base_url", type=str, default=None,
                   help="Override the download base URL (internal mirrors, "
                        "tests)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=512,
                   help="Frames per device batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the models, the sampler and the "
                        "metric passes (default cuda; cpu to run without a card)")
    return p.parse_args(argv)


def discover_models(models_dir: Path) -> dict[str, Path | None]:
    """Model options: every `.h5` in the models dir, then the registry
    architectures without weights (demo mode only)."""
    found: dict[str, Path | None] = {}
    if models_dir.is_dir():
        for h5 in sorted(models_dir.glob("*.h5")):
            found[h5.stem] = h5
    for name in REGISTRY_UI_MODELS:
        found.setdefault(name, None)
    return found


def _nmr_consensus(per_state_probs: list[np.ndarray]) -> np.ndarray:
    """The running pairwise-average consensus of io/decode.py."""
    from timed_design_tpu_torch.io.decode import consensus_running_average

    return consensus_running_average(per_state_probs)


def _aligned_design_outputs(per_state: list) -> tuple[list, str, list[str]]:
    """Align per-state (probs, FrameAtoms) on the residues common to ALL
    states and return (aligned_probs, native_seq, residue_map) built from
    the FRAMES, not the raw structure.

    Residues with incomplete backbones are dropped as frame centres, and
    possibly different ones per NMR state, so (a) raw per-state matrices can
    disagree in length and (b) a structure-derived residue map would shift
    every label after the first dropped residue.
    """
    from timed_design_tpu_torch.constants import AA3_TO_AA1

    keysets = [
        list(zip(fa.chain_ids, fa.residue_ids)) for _, fa in per_state
    ]
    common = set(keysets[0])
    for ks in keysets[1:]:
        common &= set(ks)
    aligned = [
        np.asarray(p)[[i for i, k in enumerate(ks) if k in common]]
        for (p, _), ks in zip(per_state, keysets)
    ]
    fa0 = per_state[0][1]
    idx0 = [i for i, k in enumerate(keysets[0]) if k in common]
    native_seq = "".join(AA3_TO_AA1.get(fa0.labels[i], "X") for i in idx0)
    residue_map = [
        f"{AA3_TO_AA1.get(fa0.labels[i], 'X')}{fa0.residue_ids[i]} "
        f"(Chain {fa0.chain_ids[i]})"
        for i in idx0
    ]
    return aligned, native_seq, residue_map


def _show_figure(draw, *args, what: str) -> bool:
    """``st.pyplot`` of the figure ``draw(*args)`` makes, then closed; where
    matplotlib is missing, one ``st.error`` naming it in its place."""
    from timed_design_tpu_torch.analyse.plots import close_figure

    try:
        fig = draw(*args)
    except ImportError as e:
        if "matplotlib" not in str(e):
            raise
        st.error(f"{what} needs matplotlib, which is not installed here: "
                 "install matplotlib to see it.")
        return False
    st.pyplot(fig)
    close_figure(fig)
    return True


# --------------------------------------------------------------- sections


def _draw_sidebar(model_options: dict):
    with st.sidebar:
        st.title("Design Proteins")
        pdb_code = st.text_input("Enter a PDB Code:", value="",
                                 placeholder="1qys")
        st.write("or")
        uploaded = st.file_uploader(
            "Upload your backbone/PDB of interest",
            type=["pdb", "pdb1", "ent", "gz"],
        )
        model_name = st.selectbox("Choose your Model",
                                  list(model_options.keys()))
        ensemble_models = st.multiselect(
            "Ensemble: average several models (optional)",
            [m for m in model_options if m not in PROPERTY_MODELS],
            help="Pick 2+ same-head models to average their probability "
                 "matrices (overrides the single-model choice above). "
                 "Property-constrained models can't join an ensemble.",
        )
        nmr_all_states = st.checkbox(
            "Design all NMR states (consensus)", value=False,
            help="Voxelise every MODEL in the file and average predictions",
        )
        demo_random = st.checkbox(
            "Demo mode (random weights)", value=False,
            help="Run architectures without released weights — outputs are "
                 "NOT real designs",
        )
        with st.expander("Advanced Settings"):
            do_mc = st.checkbox("Optimize sequences using Monte Carlo",
                                value=False, key="mc")
            sample_n = st.number_input("Number of samples", 10, 5000, 200)
            temperature = st.slider("Temperature", 0.01, 5.0, 0.2)
        run = st.button("Design!", type="primary")
    return dict(pdb_code=pdb_code.lower(), uploaded=uploaded,
                model_name=model_name, ensemble_models=list(ensemble_models),
                nmr_all_states=nmr_all_states,
                demo_random=demo_random, do_mc=do_mc,
                sample_n=int(sample_n), temperature=float(temperature),
                run=run)


def _load_structures(cfg, args):
    """Upload or mirror lookup -> list of state Structures (1 unless NMR)."""
    from timed_design_tpu_torch.structure import load_pdb, parse_pdb_string

    all_states = cfg["nmr_all_states"]
    if cfg["uploaded"] is not None:
        data = cfg["uploaded"].read()
        # memoize the parse on the raw bytes: every widget interaction
        # reruns this script, and re-parsing a multi-MB NMR ensemble per
        # click costs seconds of host time for an identical result
        import hashlib

        parse_key = (
            f"parse::{hashlib.md5(data).hexdigest()}::{all_states}"
        )
        pcache = st.session_state.setdefault("parse_cache", {})
        if parse_key in pcache:
            states = pcache[parse_key]
        else:
            if cfg["uploaded"].name.endswith(".gz"):
                import gzip

                data = gzip.decompress(data)
            states = parse_pdb_string(
                data.decode(), name=cfg["uploaded"].name.split(".")[0],
                all_states=all_states,
            )
            while len(pcache) >= 4:
                pcache.pop(next(iter(pcache)))
            pcache[parse_key] = states
    elif cfg["pdb_code"] and args.path_to_pdb:
        base = Path(args.path_to_pdb)
        # sorted, assemblies first: raw glob order follows the filesystem,
        # so with both 1qys.pdb and 1qys.pdb1.gz present the designed
        # structure would differ between machines
        hits = sorted(
            base.glob(f"**/{cfg['pdb_code']}*.pdb*"),
            key=lambda p: (".pdb1" not in p.name, str(p)),
        )
        if not hits and getattr(args, "allow_fetch", False):
            from timed_design_tpu_torch.io.fetch import RCSB_BASE_URL, make_fetcher

            try:
                fetched = make_fetcher(
                    base,
                    base_url=getattr(args, "fetch_base_url", None)
                    or RCSB_BASE_URL,
                )(cfg["pdb_code"])
                hits = [fetched]
            except Exception as e:  # noqa: BLE001 - report in the UI
                st.error(f"Fetch failed for {cfg['pdb_code']}: {e}")
                return None
        if not hits:
            st.error(f"No structure for code {cfg['pdb_code']} under {base}")
            return None
        states = load_pdb(hits[0], all_states=all_states)
    else:
        st.error("Provide a PDB upload or a code + --path_to_pdb")
        return None
    if not isinstance(states, list):
        states = [states]
    return states


def _draw_property_constraints(native_seq, residue_map, prop):
    """Polar/charge multiselects -> property map.

    Drawn ONCE per run — the same map applies to every NMR state (drawing
    per state would create duplicate widget IDs, which streamlit rejects).
    """
    from timed_design_tpu_torch.structure import convert_seq_to_property

    current = convert_seq_to_property(native_seq, prop)
    st.subheader(f"Constrain {prop}")
    prop_map = np.zeros(len(residue_map), int)
    if prop == "charge":
        pos_sel = st.multiselect(
            "Positive (+1) residues", residue_map,
            [r for r, v in zip(residue_map, current) if v == 1])
        neg_sel = st.multiselect(
            "Negative (-1) residues", residue_map,
            [r for r, v in zip(residue_map, current) if v == -1])
        prop_map[[residue_map.index(r) for r in pos_sel]] = 1
        prop_map[[residue_map.index(r) for r in neg_sel]] = -1
    else:
        pol_sel = st.multiselect(
            "Polar residues", residue_map,
            [r for r, v in zip(residue_map, current) if v == 1])
        prop_map[[residue_map.index(r) for r in pol_sel]] = 1
    return prop_map


def _probability_heatmap(probs20, native_seq, rotamer_probs=None,
                         rotamer_categories=None):
    """Per-position probability heatmap with the native residues circled
    (``analyse/plots.py::probability_heatmap_fig``); with a rotamer head,
    the 338-class chart in an expander."""
    from timed_design_tpu_torch.analyse.plots import (
        probability_heatmap_fig,
        rotamer_probability_fig,
    )

    if _show_figure(lambda p: probability_heatmap_fig(p, native_seq=native_seq),
                    probs20, what="The probability heatmap"):
        st.write('"Red circle" marks the residue in the original sequence.')
    if rotamer_probs is not None:
        with st.expander("See Predicted Probabilities (Very Large Chart)"):
            _show_figure(rotamer_probability_fig, rotamer_probs,
                         rotamer_categories, what="The rotamer chart")


def _position_explorer(probs, residue_map, categories):
    """Selectbox position -> bar chart of that position's distribution."""
    labels = [f"({i}) {r}" for i, r in enumerate(residue_map)]
    option = st.selectbox("Explore probabilities at specific positions:",
                          labels)
    idx = labels.index(option)
    st.subheader(f"Probability Distribution at position {option}")
    values = np.nan_to_num(np.asarray(probs[idx], np.float64), nan=0.0)
    st.bar_chart({"category": list(categories), "Probability": values.tolist()},
                 x="category")


def _residue_composition(native_seq, designed_seq):
    """Native-vs-designed residue composition."""
    from timed_design_tpu_torch.constants import AA1

    rows = {
        "residue": list(AA1),
        "Original": [native_seq.count(a) for a in AA1],
        "Designed": [designed_seq.count(a) for a in AA1],
    }
    st.write("Residue Composition")
    st.bar_chart(rows, x="residue")


def _draw_output_section(model_name, probs, probs20, designed_seq,
                         native_seq, residue_map, rotamer,
                         per_state_seqs=None):
    from timed_design_tpu_torch.analyse import create_sequence_logo
    from timed_design_tpu_torch.analyse.structure_analysis import (
        calculate_prediction_entropy,
    )
    from timed_design_tpu_torch.constants import AA1, ROTAMER_CATEGORIES, sequence_similarity
    from timed_design_tpu_torch.sample.metrics import sequence_metrics

    st.subheader("Designed Sequence")
    st.code(designed_seq, language=None)
    if per_state_seqs and len(per_state_seqs) > 1:
        with st.expander(f"Per-state designs ({len(per_state_seqs)} NMR states)"):
            for i, s in enumerate(per_state_seqs):
                st.code(f"state {i}: {s}", language=None)

    real_m = np.array(sequence_metrics(native_seq))
    pred_m = np.array(sequence_metrics(designed_seq))
    names = ["Charge", "Isoelectric Point", "Molecular Weight",
             "Mol. Ext. Coeff. @ 280 nm"]
    st.write("Original Sequence Metrics")
    for col, name, v in zip(st.columns(4), names, real_m):
        col.metric(name, f"{v:.2f}")
    st.write("Predicted Sequence Metrics")
    for col, name, v, rv in zip(st.columns(4), names, pred_m, real_m):
        col.metric(name, f"{v:.2f}", f"{v - rv:+.2f}")
    identity = float(np.mean([a == b for a, b in zip(native_seq, designed_seq)]))
    c1, _, c3, _ = st.columns(4)
    c1.metric("Sequence Similarity",
              f"{100 * sequence_similarity(native_seq, designed_seq):.2f} %")
    c3.metric("Sequence Identity", f"{100 * identity:.2f} %")

    _residue_composition(native_seq, designed_seq)

    st.write("Predicted Probabilities")
    _probability_heatmap(
        probs20, native_seq,
        rotamer_probs=probs if rotamer else None,
        rotamer_categories=ROTAMER_CATEGORIES if rotamer else None,
    )
    categories = list(ROTAMER_CATEGORIES) if rotamer else list(AA1)
    _position_explorer(probs, residue_map, categories)

    st.subheader("Prediction entropy")
    st.line_chart(calculate_prediction_entropy(probs20))
    st.subheader("Sequence logo")
    _show_figure(create_sequence_logo, probs20, what="The sequence logo")
    st.download_button(
        "Download probabilities CSV",
        "\n".join(",".join(f"{v:.6f}" for v in row) for row in probs),
        file_name=f"{model_name}.csv",
    )


def _draw_performance_section(designed_seq, native_seq, device):
    from timed_design_tpu_torch.analyse import calculate_metrics
    from timed_design_tpu_torch.analyse.plots import design_confusion_fig

    m = calculate_metrics({"design": designed_seq}, {"design": native_seq},
                          device=device)
    st.write({k: v for k, v in m.items()
              if k.startswith("accuracy") or k in ("precision", "recall")})
    st.subheader("Prediction bias")
    st.bar_chart({"residue": list(m["bias"]), "bias": list(m["bias"].values())},
                 x="residue")
    st.subheader("Confusion matrix (design vs native)")
    _show_figure(design_confusion_fig, m["unweighted_cm"],
                 what="The confusion matrix")


def _draw_optimisation_section(cfg, probs, native_seq, rotamer, device):
    from timed_design_tpu_torch.sample.metrics import sequence_metrics
    from timed_design_tpu_torch.sample.sampler import sample_structure

    if not cfg["do_mc"]:
        st.info("Enable 'Optimize sequences using Monte Carlo' in the sidebar.")
        return
    # the temperature is applied on the device, then one launch draws every
    # sample (seed 0, as the JAX UI's key 0; the draws are Philox's)
    samples = sample_structure(probs, cfg["sample_n"], 0, rotamer_mode=rotamer,
                               temperature=cfg["temperature"], device=device)
    ref = np.array(sequence_metrics(native_seq))
    rows = []
    for seq, ch, ip, mw_, ex in samples:
        vals = np.array([ch, ip, mw_, ex])
        mae = np.abs((vals - ref) / np.where(ref == 0, 1, ref)).sum()
        rows.append((seq, ch, ip, mw_, ex, mae))
    rows.sort(key=lambda r: r[-1])
    st.write("Top samples by summed normalized metric MAE vs native "
             "(reference ui.py:641-660):")
    st.dataframe(
        {"sequence": [r[0] for r in rows[:25]],
         "charge": [r[1] for r in rows[:25]],
         "pI": [r[2] for r in rows[:25]],
         "MW": [r[3] for r in rows[:25]],
         "MAE": [r[5] for r in rows[:25]]},
    )


def _draw_structure_view(structure):
    """py3Dmol when installed, the CA trace (matplotlib) otherwise."""
    from timed_design_tpu_torch.analyse.plots import ca_trace_fig

    with st.expander("3D structure", expanded=False):
        try:
            import py3Dmol

            view = py3Dmol.view(width=700, height=450)
            view.addModel(structure.to_pdb(), "pdb")
            view.setStyle({"cartoon": {"color": "spectrum"}})
            view.zoomTo()
            st.components.v1.html(view._make_html(), height=470)
        except ImportError:
            _show_figure(ca_trace_fig, structure.backbone_arrays()["CA"],
                         what="The structure view needs py3Dmol or matplotlib: "
                              "py3Dmol is missing, and the CA trace in its place")


# --------------------------------------------------------------------- main


def main(argv=None):  # noqa: C901 - UI flow
    if st is None:
        raise SystemExit(
            f"streamlit is required for the UI ({_STREAMLIT_ERR}). Install "
            "streamlit, or use the CLI: python -m timed_design_tpu_torch.cli.predict"
        )
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    models_dir = Path(args.path_to_models)

    import torch

    from timed_design_tpu_torch.constants import AA1, compress_rotamer_probs
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.models import MODEL_REGISTRY
    from timed_design_tpu_torch.parallel.frontend import shared_front_end
    from timed_design_tpu_torch.structure import create_residue_map

    st.set_page_config(page_title="TIMED-Design (GPU)", layout="wide")
    st.title("TIMED-Design — protein sequence design on the GPU")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        msg = (f"--device {args.device}: no CUDA device here; pass --device cpu "
               "to run the UI on the CPU")
        st.error(msg)
        raise SystemExit(msg)

    model_options = discover_models(models_dir)
    cfg = _draw_sidebar(model_options)
    # The Design! button is only True on the rerun in which it was clicked;
    # every interaction with a result widget (property multiselects,
    # position explorer, MC checkbox) triggers a rerun with run=False. Gate
    # on a persistent "submitted" flag — and cache the expensive design
    # below — so results survive widget interaction instead of vanishing.
    if cfg["run"]:
        st.session_state["submitted"] = True
    if not st.session_state.get("submitted"):
        st.info("Upload a backbone (or give a PDB code) and press Design!")
        return

    states = _load_structures(cfg, args)
    if states is None:
        return
    structure = states[0]
    # the FULL structure's residue map drives the property-constraint
    # widgets (constraints rewrite structure residues); the post-design
    # sections use the frame-aligned map built below instead
    full_residue_map, full_native_seq = create_residue_map(structure)

    model_name = cfg["model_name"]
    # 2+ picks in the ensemble multiselect override the single-model choice
    # (property models are excluded from its options: their constraint
    # widgets rewrite the structure per model, which cannot be averaged)
    ensemble = cfg.get("ensemble_models") or []
    if len(ensemble) == 1:
        st.error("Ensemble needs at least two models — add another or "
                 "clear the selection.")
        return
    model_list = list(ensemble) if ensemble else [model_name]
    if ensemble:
        model_name = " + ".join(model_list)
    prop = PROPERTY_MODELS.get(model_name)
    if prop is not None:
        import copy

        from timed_design_tpu_torch.structure import modify_structure_with_property

        prop_map = _draw_property_constraints(
            full_native_seq, full_residue_map, prop
        )
        # modify_structure_with_property rewrites IN PLACE, and the parse
        # cache serves these Structure objects again on every rerun:
        # deep-copy first, or constraints would corrupt the cached native
        # structures and compound across widget interactions
        states = [
            modify_structure_with_property(copy.deepcopy(s), prop_map, prop)
            for s in states
        ]
        structure = states[0]

    import hashlib
    import time

    # across cards: every rank builds the session, rank 0 (this process)
    # sends each its rows (None: this process alone)
    front = shared_front_end(device)
    make_session = DesignSession if front is None else front.load
    sessions: list[tuple[str, object]] = []  # (model_arg, DesignSession)
    for name in model_list:
        h5_path = model_options.get(name)
        model_arg = str(h5_path) if h5_path else name
        if h5_path is None and not cfg["demo_random"]:
            st.error(
                f"No weights found for {name} under {models_dir} — place "
                f"{name}.h5 there, or tick 'Demo mode (random weights)'."
            )
            return
        m_spec = MODEL_REGISTRY.get(name)
        session_key = f"session::{model_arg}"
        if session_key not in st.session_state:
            try:
                st.session_state[session_key] = make_session(
                    model_arg, codec=m_spec.codec if m_spec else None,
                    batch_size=args.batch_size, device=device,
                    allow_random_weights=cfg["demo_random"],
                )
            except ValueError as e:
                st.error(str(e))
                return
        sessions.append((model_arg, st.session_state[session_key]))
        if h5_path is None:
            st.warning(f"Demo mode: {name} runs with RANDOM weights — "
                       "outputs are not real designs.")
    session = sessions[-1][1]
    if len({s.n_classes for _, s in sessions}) != 1:
        st.error(
            "Ensemble members must share the output head — mixing "
            "20-residue and 338-rotamer models cannot be averaged."
        )
        return

    # Memoize the design on its actual inputs (model, structure coords,
    # property map) so reruns from widget interaction redraw instantly and
    # only a changed constraint recomputes.
    fp = hashlib.md5()
    for arg, _ in sessions:
        fp.update(str(arg).encode())
    for s in states:
        fp.update(s.name.encode())
        fp.update(s.sequence1().encode())  # property constraints rewrite identities
        fp.update(np.ascontiguousarray(s.coords).tobytes())
    design_key = fp.hexdigest()
    cache = st.session_state.setdefault("design_cache", {})
    t0 = time.perf_counter()
    if design_key in cache:
        per_state_probs, native_seq, residue_map = cache[design_key]
    else:
        per_state = []
        for s in states:
            # ensemble: every member designs the same state (each with its
            # own codec/voxelization) and the float64 mean becomes the
            # state's probability matrix; a single model passes through
            member_ps, fa = [], None
            for _, sess in sessions:
                p, fa = sess.design(s)
                member_ps.append(np.asarray(p, np.float64))
            p = (
                np.mean(member_ps, axis=0).astype(np.float32)
                if len(member_ps) > 1
                else member_ps[0].astype(np.float32)
            )
            per_state.append((p, fa))
        per_state_probs, native_seq, residue_map = _aligned_design_outputs(
            per_state
        )
        while len(cache) >= 4:  # bound memory: drop oldest designs
            cache.pop(next(iter(cache)))
        cache[design_key] = (per_state_probs, native_seq, residue_map)
    probs = _nmr_consensus(per_state_probs)
    t_pred = time.perf_counter() - t0

    rotamer = probs.shape[1] == 338
    probs20 = compress_rotamer_probs(probs) if rotamer else probs
    aa = np.array(list(AA1))
    designed_seq = "".join(aa[probs20.argmax(1)])
    per_state_seqs = [
        "".join(aa[(compress_rotamer_probs(p) if rotamer else p).argmax(1)])
        for p in per_state_probs
    ]
    timings = session.last_timings
    st.success(
        f"Designed {len(designed_seq)} residues"
        + (f" with the {model_name} ensemble" if ensemble else "")
        + (f" over {len(states)} NMR states" if len(states) > 1 else "")
        + f" in {t_pred:.2f}s (last state: voxelisation "
          f"{timings['voxelisation']:.2f}s, prediction "
          f"{timings['prediction']:.2f}s)"
    )

    _draw_structure_view(structure)

    tab_out, tab_perf, tab_opt = st.tabs(["Design", "Performance", "Optimisation"])
    with tab_out:
        _draw_output_section(model_name, probs, probs20, designed_seq,
                             native_seq, residue_map, rotamer,
                             per_state_seqs=per_state_seqs)
    with tab_perf:
        _draw_performance_section(designed_seq, native_seq, device)
    with tab_opt:
        _draw_optimisation_section(cfg, probs, native_seq, rotamer, device)


if __name__ == "__main__":
    main()
