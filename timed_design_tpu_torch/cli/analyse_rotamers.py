"""``td-analyse-rotamers`` on PyTorch: the port of
``timed_design_tpu/cli/analyse_rotamers.py``.

    python -m timed_design_tpu_torch.cli.analyse_rotamers \\
        --path_to_pred_matrix out/TIMED_rotamer_rot.csv \\
        --path_to_datasetmap out/TIMED_rotamer.txt --path_to_pdb pdbs/

Predicted rotamer probabilities scored against (1) the wild-type crystal
rotamers, (2) SCWRL-repacked predicted sequences and (3) SCWRL-repacked
wild-type sequences, each written as ``results_{wt,scwrl_pred,scwrl_real}.txt``,
and the SCWRL energies as ``scwrl_scores.csv``. (2) and (3) need the external
SCWRL4 binary and are skipped with a message without it; ``--plot_confusion``
needs matplotlib and exits with a message that names it where it is missing.
The flags of the JAX package's CLI plus ``--device`` (default ``cuda``: the
metric passes run on the card; without one it exits with a message, and
runs on the CPU only with ``--device cpu``).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Analyse rotamer predictions")
    p.add_argument("--path_to_pred_matrix", type=str, required=True,
                   help="Path to {model}_rot.csv (338-class probabilities)")
    p.add_argument("--path_to_datasetmap", type=str, default="datasetmap.txt")
    p.add_argument("--path_to_pdb", type=str, required=True,
                   help="Directory with PDB structures (local mirror; "
                        "missing codes are fetched only with --allow-fetch)")
    p.add_argument("--allow-fetch", action="store_true", dest="allow_fetch",
                   help="Download structures missing from the mirror into "
                        "its sharded layout (default off: no network)")
    p.add_argument("--fetch_base_url", type=str, default=None,
                   help="Override the download base URL (default RCSB); "
                        "useful for internal mirrors and tests")
    # --output_path / --scwrl_path: the reference's spellings, as aliases
    p.add_argument("--path_to_output", "--output_path", type=str, default=".")
    p.add_argument("--path_to_scwrl", "--scwrl_path", type=str, default=None)
    p.add_argument("--support_old_datasetmap", action="store_true")
    p.add_argument("--plot_confusion", action="store_true")
    p.add_argument("--workers", type=int, default=None,
                   help="Accepted for reference compatibility; tagging is "
                        "vectorized here and needs no process pool")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the metric passes (default cuda; cpu "
                        "only when named)")
    return p


def main(argv=None) -> None:
    from ..analyse import (
        analyse_with_scwrl,
        calculate_rotamer_metrics,
        tag_structures_with_rotamers,
        ScwrlNotFoundError,
    )
    from ..analyse.scwrl import find_scwrl
    from ..constants import ROTAMER_CATEGORIES
    from ..io import extract_sequences, load_datasetmap, load_prediction_matrix

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; "
                         "pass --device cpu to compute the metrics on the CPU")
    if args.plot_confusion:
        from ..analyse.plots import require_pyplot

        require_pyplot("--plot_confusion")
    out = Path(args.path_to_output)
    out.mkdir(parents=True, exist_ok=True)
    pdb_dir = Path(args.path_to_pdb)

    # the matrix is read back as float16, as the reference does: its
    # published metrics are computed on saved-precision probabilities, and
    # top-k tie-breaks depend on it (renormalization then works in float64)
    P = load_prediction_matrix(Path(args.path_to_pred_matrix), dtype=np.float16)
    dmap = load_datasetmap(Path(args.path_to_datasetmap), is_old=args.support_old_datasetmap)
    decoded = extract_sequences(dmap, P, rotamer_categories=ROTAMER_CATEGORIES)

    # Locate structures for every chain key; optionally fetch misses
    from ..analyse.rotamer import resolve_structure_paths

    fetcher = None
    if args.allow_fetch:
        from ..io.fetch import RCSB_BASE_URL, make_fetcher

        fetcher = make_fetcher(
            pdb_dir, base_url=args.fetch_base_url or RCSB_BASE_URL
        )
    pdb_paths = resolve_structure_paths(
        decoded.pdb_to_probability, pdb_dir, fetcher=fetcher
    )
    pdb_paths = {c: p for c, p in pdb_paths.items() if p is not None}
    print(f"Tagging {len(pdb_paths)} structures with crystal rotamers")
    tags, assemblies = tag_structures_with_rotamers(pdb_paths)

    # The new/SRB map format carries no real sequences: rebuild them from
    # the parsed structures, or the wild-type SCWRL analysis would pack
    # empty sequences
    if not dmap.is_old:
        for pdb in decoded.pdb_to_real_sequence:
            asm = assemblies.get(pdb[:4])
            if asm is None:
                # with no rebuilt sequence this chain's wild-type SCWRL
                # analysis is skipped downstream: say so
                print(f"Could not find assembly {pdb[:4]} to rebuild the "
                      f"real sequence for {pdb}; wild-type analysis will "
                      f"skip it")
                continue
            chain = next(
                (c for c in asm.chains if c.chain_id == pdb[4:]), None
            )
            if chain is not None:
                decoded.pdb_to_real_sequence[pdb] = chain.sequence1()
            else:
                print(f"Could not find chain {pdb[4:]} in {pdb[:4]} to "
                      f"rebuild the real sequence for {pdb}; wild-type "
                      f"analysis will skip it")

    # Analysis 1: predictions vs wild-type crystal rotamers
    m1 = calculate_rotamer_metrics(
        decoded.pdb_to_probability, tags, suffix="wt",
        output_path=out, plot_confusion=args.plot_confusion, device=device,
    )
    print(f"[wt] top-1 {m1['accuracy']:.4f}  AUC(ovo) {m1['auc_ovo']:.4f}")

    # Analyses 2+3 need SCWRL4
    try:
        find_scwrl(Path(args.path_to_scwrl) if args.path_to_scwrl else None)
    except ScwrlNotFoundError as e:
        print(f"Skipping SCWRL analyses: {e}")
        return

    scores_pred, _ = analyse_with_scwrl(
        decoded.pdb_to_sequence, assemblies, out, "_pred",
        Path(args.path_to_scwrl) if args.path_to_scwrl else None,
    )
    def tags_from_packed(score_keys, suffix: str) -> dict:
        # each per-chain key ("1abcA") has its OWN packed assembly (its
        # designed sequence broadcast over all chains): take chain A's tags
        # from 1abcA's file, chain B's from 1abcB's — keying one file per
        # pdb[:4] would tag every chain from whichever file came last
        tags = {}
        for pdb in score_keys:
            path = out / f"{pdb}_{suffix}.pdb"
            if not path.exists():
                continue
            t, _ = tag_structures_with_rotamers({pdb[:4]: path})
            if pdb in t:
                tags[pdb] = t[pdb]
        return tags

    tags_pred = tags_from_packed(scores_pred, "_pred")
    if tags_pred:
        m2 = calculate_rotamer_metrics(
            decoded.pdb_to_probability, tags_pred, suffix="scwrl_pred", output_path=out,
            device=device,
        )
        print(f"[scwrl-pred] top-1 {m2['accuracy']:.4f}")
    else:
        print("[scwrl-pred] skipped: SCWRL packed no predicted sequences")

    scores_real, _ = analyse_with_scwrl(
        decoded.pdb_to_real_sequence, assemblies, out, "_real",
        Path(args.path_to_scwrl) if args.path_to_scwrl else None,
    )
    tags_real = tags_from_packed(scores_real, "_real")
    if tags_real:
        m3 = calculate_rotamer_metrics(
            decoded.pdb_to_probability, tags_real, suffix="scwrl_real", output_path=out,
            device=device,
        )
        print(f"[scwrl-real] top-1 {m3['accuracy']:.4f}")
    else:
        print("[scwrl-real] skipped: SCWRL packed no wild-type sequences")

    with open(out / "scwrl_scores.csv", "w") as f:
        f.write("pdb,score_pred,score_real\n")
        for pdb in sorted(set(scores_pred) | set(scores_real)):
            f.write(f"{pdb},{scores_pred.get(pdb, np.nan)},{scores_real.get(pdb, np.nan)}\n")


if __name__ == "__main__":
    main()
