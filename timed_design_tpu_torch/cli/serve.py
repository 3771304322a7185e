"""Sequence design over HTTP, on PyTorch (the port of ``td-serve``).

    python -m timed_design_tpu_torch.cli.serve --model TIMED.h5 --port 8080

The model loads once at startup onto ``--device`` (default ``cuda``; the
server exits with a message when there is no card, and runs on the CPU only
with ``--device cpu``); every request then runs voxelize + predict on that
device, and Monte-Carlo samples are drawn there, on the card by the
``sample_inverse_cdf`` kernel.

API (JSON):
  GET  /healthz   -> {"status": "ok", "model": ..., "n_classes": ...}
  POST /design    body: PDB text, or {"pdb": "...", "n_samples": N,
                  "temperature": T, "seed": S, "model": M} JSON (omit seed
                  for fresh draws per request). Returns the designed
                  sequence, per-residue probabilities, residue ids,
                  timings, the seed used and the samples.
  POST /report    same body; returns the self-contained HTML design report
                  (``report.py``), one section per chain. It draws with
                  matplotlib: where that is missing it answers 422 with a
                  message that names it, before any design work.
  GET  /metrics   Prometheus text: request counts by endpoint and status,
                  latency histograms, batching stats per model.

With several ``--model`` flags a request's "model" field picks one;
``--ensemble`` adds a virtual "ensemble" model averaging every member.
Concurrent requests are coalesced into shared device batches unless
``--no-coalesce``.

Across cards, one process per card, as the JAX server splits every batch
over all local chips: under ``torchrun`` every rank joins the world it
launched, rank 0 binds HTTP and serves, and the others follow it
(``parallel/frontend.py``: rank 0 sends each rank its rows of every batch,
every rank runs the forward on its own, the probabilities gather on rank
0, where Monte-Carlo samples are drawn). Without a launcher, ``--device
cuda`` with more than one visible card starts one follower process for each
further card; with one card, or ``--device cpu``, the server is one process.

    torchrun --nproc_per_node 4 -m timed_design_tpu_torch.cli.serve --model TIMED.h5
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve sequence design over HTTP")
    p.add_argument("--model", type=str, required=True, action="append",
                   help=".h5 weights, Name@checkpoint.npz, or registry name "
                        "with --allow-random-weights. Repeatable: every "
                        "model loads at startup, requests pick one with a "
                        '"model" field (default: the first)')
    p.add_argument("--codec", type=str, default=None)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and the sampler (default "
                        "cuda; cpu only when named)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--quantize", type=str, default=None,
                   choices=["int8", "int8-fake", "w8"],
                   help="serve with quantized convolutions (models/quantize.py): "
                        "int8 = int8 codes convolved with int32 sums (a CUDA kernel "
                        "on the card); int8-fake = the same codes in floating point; "
                        "w8 = weight-only int8")
    p.add_argument("--allow-random-weights", action="store_true",
                   dest="allow_random_weights")
    p.add_argument("--no-coalesce", action="store_true", dest="no_coalesce",
                   help="serialize requests through a lock instead of "
                        "batching concurrent requests together")
    p.add_argument("--coalesce_window_ms", type=float, default=0.0,
                   help="wait this long for more requests before running a "
                        "batch (default 0: run with whatever is queued)")
    p.add_argument("--ensemble", action="store_true",
                   help='also serve a virtual "ensemble" model that averages '
                        "every loaded model's probabilities (needs >=2 "
                        "--model with the same head)")
    return p


MAX_SAMPLES_PER_REQUEST = 10_000  # one request must not exhaust the device
MAX_BODY_BYTES = 64 * 1024 * 1024  # a 50k-atom PDB is ~4 MB of text

# pyplot's figure registry is not thread-safe, and each /report runs on its
# own handler thread, so renders are serialized; /design does not take it.
_RENDER_LOCK = threading.Lock()


class ServerMetrics:
    """Thread-safe request counters and latency histograms, rendered in the
    Prometheus text exposition format (GET /metrics)."""

    BUCKETS = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 30.0, 120.0)

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: dict[tuple[str, int], int] = {}
        self._hist: dict[str, list[int]] = {}
        self._sum: dict[str, float] = {}
        self._count: dict[str, int] = {}

    def observe(self, endpoint: str, status: int, seconds: float):
        with self._lock:
            key = (endpoint, status)
            self._requests[key] = self._requests.get(key, 0) + 1
            if endpoint not in self._hist:
                self._hist[endpoint] = [0] * (len(self.BUCKETS) + 1)
                self._sum[endpoint] = 0.0
                self._count[endpoint] = 0
            buckets = self._hist[endpoint]
            for i, le in enumerate(self.BUCKETS):
                if seconds <= le:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self._sum[endpoint] += seconds
            self._count[endpoint] += 1

    @staticmethod
    def _label(value) -> str:
        """Escape a label value (backslash, double quote, newline)."""
        return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    def render(self, designers: dict) -> str:
        esc = self._label
        lines = [
            "# HELP td_requests_total HTTP requests by endpoint and status.",
            "# TYPE td_requests_total counter",
        ]
        with self._lock:
            for (ep, status), n in sorted(self._requests.items()):
                lines.append(f'td_requests_total{{endpoint="{ep}",status="{status}"}} {n}')
            lines += [
                "# HELP td_request_duration_seconds Request wall time.",
                "# TYPE td_request_duration_seconds histogram",
            ]
            for ep in sorted(self._hist):
                cum = 0
                for le, n in zip(self.BUCKETS, self._hist[ep]):
                    cum += n
                    lines.append(
                        f'td_request_duration_seconds_bucket{{endpoint="{ep}",le="{le}"}} {cum}')
                cum += self._hist[ep][-1]
                lines.append(
                    f'td_request_duration_seconds_bucket{{endpoint="{ep}",le="+Inf"}} {cum}')
                lines.append(
                    f'td_request_duration_seconds_sum{{endpoint="{ep}"}} {self._sum[ep]:.6f}')
                lines.append(
                    f'td_request_duration_seconds_count{{endpoint="{ep}"}} {self._count[ep]}')
        lines += [
            "# HELP td_coalescer_stat Designer batching stats by model.",
            "# TYPE td_coalescer_stat gauge",
        ]
        for name, d in sorted(designers.items()):
            for k, v in dict(d.stats).items():
                lines.append(f'td_coalescer_stat{{model="{esc(name)}",stat="{esc(k)}"}} {v}')
        lines += [
            "# HELP td_model_n_classes Output classes per served model.",
            "# TYPE td_model_n_classes gauge",
        ]
        for name, d in sorted(designers.items()):
            lines.append(f'td_model_n_classes{{model="{esc(name)}"}} {d.session.n_classes}')
        return "\n".join(lines) + "\n"


def _design_core(designer, pdb_text: str):
    """Parse -> design -> decode, behind /design and /report: (probs,
    probs20, designed sequence, frame atoms, timings)."""
    from ..constants import AA1, compress_rotamer_probs
    from ..structure import parse_pdb_string

    t0 = time.perf_counter()
    structure = parse_pdb_string(pdb_text, name="query")[0]
    dt_parse = time.perf_counter() - t0
    probs, fa, timings = designer.design(structure)
    probs20 = compress_rotamer_probs(probs) if probs.shape[1] == 338 else probs
    seq = "".join(np.array(list(AA1))[probs20.argmax(1)])
    return probs, probs20, seq, fa, {"parse": dt_parse, **timings}


def _design_payload(designer, pdb_text: str, n_samples: int = 0,
                    temperature: float = 0.2, seed: int | None = None) -> dict:
    """The design, plus ``n_samples`` Monte-Carlo samples drawn on the
    designer's device."""
    from ..sample.sampler import apply_temperature, sample_structure

    probs, probs20, seq, fa, timings = _design_core(designer, pdb_text)
    rotamer = probs.shape[1] == 338
    out = {
        "sequence": seq,
        "n_residues": len(seq),
        "rotamer_head": rotamer,
        "residues": [f"{c}{r}" for c, r in zip(fa.chain_ids, fa.residue_ids)],
        "probabilities": np.asarray(probs20).round(6).tolist(),
        "timings_s": {k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in timings.items()},
    }
    if n_samples > 0:
        if seed is None:  # fresh draws per request; pass "seed" to reproduce
            seed = int.from_bytes(os.urandom(4), "little")
        t0 = time.perf_counter()
        p = apply_temperature(
            torch.as_tensor(probs, device=designer.session.device), float(temperature)
        )
        samples = sample_structure(p, int(n_samples), seed, rotamer_mode=rotamer)
        out["timings_s"]["sampling"] = round(time.perf_counter() - t0, 4)
        out["seed"] = seed
        out["samples"] = [
            {"sequence": s, "charge": round(c, 4),
             "isoelectric_point": round(pi, 4),
             "molecular_weight": round(mw, 2),
             "molar_extinction": round(ex, 1)}
            for s, c, pi, mw, ex in samples
        ]
    return out


def _report_document(designer, pdb_text: str, model_name: str) -> str:
    """The HTML design report of one backbone, one section per chain; the
    native sequence is the uploaded structure's own residues. Raises
    ImportError, naming matplotlib, before any design work where it is
    missing."""
    from ..analyse.plots import pyplot
    from ..constants import AA3_TO_AA1
    from ..report import render_design_report

    pyplot("/report")
    probs, _, designed, fa, _ = _design_core(designer, pdb_text)
    native = "".join(AA3_TO_AA1.get(label, "X") for label in fa.labels)
    chains = list(dict.fromkeys(fa.chain_ids))
    if not chains:
        designed_d, native_d, probs_d = {"query": designed}, {"query": native}, {"query": probs}
    else:
        designed_d, native_d, probs_d = {}, {}, {}
        for ch in chains:
            idx = [i for i, c in enumerate(fa.chain_ids) if c == ch]
            key = f"query{ch}"
            designed_d[key] = "".join(designed[i] for i in idx)
            native_d[key] = "".join(native[i] for i in idx)
            probs_d[key] = probs[idx]
    with _RENDER_LOCK:
        return render_design_report(designed_d, native_d, probs_d, model_name=model_name)


def make_server(designer, host: str, port: int, model_name: str,
                extra_designers: dict | None = None):
    """``designer``/``model_name``: the default model. ``extra_designers``:
    {name: designer} picked by a request's "model" field; each model has
    its own worker and queue, so mixed traffic never packs two heads."""
    session = designer.session
    designers = {model_name: designer, **(extra_designers or {})}
    metrics = ServerMetrics()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            self._record(code)

        def _send_html(self, doc: str):
            body = doc.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            self._record(200)

        def _record(self, code: int):
            t0 = getattr(self, "_t0", None)
            if t0 is not None:
                ep = (self.path if self.path in ("/design", "/report", "/healthz", "/metrics")
                      else "other")
                metrics.observe(ep, code, time.perf_counter() - t0)
                self._t0 = None  # one observation per request

        def log_message(self, fmt, *args):  # one line per request
            print(f"{self.address_string()} {fmt % args}")

        def do_GET(self):
            self._t0 = time.perf_counter()
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": model_name,
                                 "models": {name: d.session.n_classes
                                            for name, d in designers.items()},
                                 "n_classes": session.n_classes,
                                 "device": str(session.device),
                                 "coalescer": dict(designer.stats)})
            elif self.path == "/metrics":
                body = metrics.render(designers).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                self._record(200)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            self._t0 = time.perf_counter()
            if self.path not in ("/design", "/report"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send(400, {"error": "malformed Content-Length"})
                return
            if length < 0:  # rfile.read(-1) would block until the client closes
                self._send(400, {"error": "malformed Content-Length"})
                return
            if length > MAX_BODY_BYTES:
                self._send(413, {"error": f"request body too large "
                                          f"({length} > {MAX_BODY_BYTES} bytes)"})
                return
            try:
                raw = self.rfile.read(length).decode()
            except UnicodeDecodeError:
                self._send(400, {"error": "request body must be UTF-8 text "
                                          "(PDB or JSON); got binary data"})
                return
            n_samples, temperature, seed = 0, 0.2, None
            req_model = model_name
            pdb_text = raw
            if raw.lstrip()[:1] in ("{", "["):  # PDB text cannot start with these
                try:
                    req = json.loads(raw)
                    pdb_text = req["pdb"]
                    if not isinstance(pdb_text, str):
                        raise TypeError("'pdb' must be a string")
                    ns = req.get("n_samples")
                    n_samples = 0 if ns is None else int(ns)
                    t = req.get("temperature")
                    temperature = 0.2 if t is None else float(t)
                    seed = req.get("seed")
                    seed = None if seed is None else int(seed)
                    # only an absent or null "model" means the default
                    m = req.get("model")
                    req_model = model_name if m is None else m
                    if not isinstance(req_model, str):
                        raise TypeError("'model' must be a string")
                except (ValueError, KeyError, TypeError, OverflowError) as e:
                    # OverflowError: int(float("inf")) from {"n_samples": 1e400}
                    self._send(400, {"error": f"bad JSON request: {e}"})
                    return
            if not 0 <= n_samples <= MAX_SAMPLES_PER_REQUEST:
                self._send(400, {"error": f"n_samples must be in "
                                          f"[0, {MAX_SAMPLES_PER_REQUEST}]"})
                return
            if not temperature >= 0:  # also rejects NaN
                self._send(400, {"error": "temperature must be >= 0"})
                return
            d = designers.get(req_model)
            if d is None:
                self._send(400, {"error": f"unknown model {req_model!r}; "
                                          f"serving: {sorted(designers)}"})
                return
            try:
                if self.path == "/report":
                    self._send_html(_report_document(d, pdb_text, req_model))
                    return
                payload = _design_payload(d, pdb_text, n_samples, temperature, seed)
            except Exception as e:  # noqa: BLE001 - surfaced as HTTP 422
                self._send(422, {"error": str(e)})
                return
            payload["model"] = req_model
            self._send(200, payload)

    return ThreadingHTTPServer((host, port), Handler)


def _add_ensemble(designers: dict) -> None:
    """--ensemble: register the virtual averaging model, failing at startup
    on fewer than two models or a head/codec mismatch."""
    from ..engine.coalescer import EnsembleDesigner

    if "ensemble" in designers:
        raise SystemExit('a model is already named "ensemble" — cannot add '
                         "the virtual ensemble designer")
    try:
        designers["ensemble"] = EnsembleDesigner(list(designers.values()))
    except ValueError as e:
        raise SystemExit(f"--ensemble: {e}") from None


def build_designers(args, front=None) -> dict:
    """One designer per ``--model`` (plus the ensemble), in flag order; each
    session over ``front``'s world (``parallel.frontend.FrontEnd``) when
    one is given, else on ``--device`` alone."""
    from ..engine import DesignSession
    from ..engine.coalescer import CoalescingDesigner, SerialDesigner

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; "
                         "pass --device cpu to serve on the CPU")
    make_session = DesignSession if front is None else front.load
    designers: dict = {}
    for model in args.model:
        session = make_session(
            model, codec=args.codec, batch_size=args.batch_size,
            device=device, compute_dtype=args.compute_dtype,
            allow_random_weights=args.allow_random_weights, quantize=args.quantize,
        )
        d = (SerialDesigner(session) if args.no_coalesce
             else CoalescingDesigner(session, window_ms=args.coalesce_window_ms))
        if session.model_name in designers:
            raise SystemExit(f"duplicate model name {session.model_name!r}")
        designers[session.model_name] = d
    if args.ensemble:
        _add_ensemble(designers)
    return designers


def serve(args, front=None) -> None:
    """Build the designers (over ``front``'s world when given), bind HTTP
    and serve until interrupted; then close the designers."""
    designers = build_designers(args, front)
    default_name = next(iter(designers))
    server = make_server(
        designers[default_name], args.host, args.port, default_name,
        extra_designers={k: v for k, v in designers.items() if k != default_name},
    )
    host, port = server.server_address[:2]
    mode = "serial" if args.no_coalesce else "coalescing"
    where = str(designers[default_name].session.device)
    if front is not None:
        where += f", {front.n_ranks} rank{'s' if front.n_ranks > 1 else ''}"
    print(f"Serving {', '.join(designers)} (default {default_name}, {mode}, "
          f"{where}) on http://{host}:{port}  "
          "(POST /design, POST /report, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        for d in designers.values():
            d.close()


def main(argv=None) -> None:
    """``td-serve``: rank 0 of the world ``parallel.frontend.lead`` gives it
    serves, the other ranks follow."""
    from ..parallel.frontend import lead

    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; "
                         "pass --device cpu to serve on the CPU")
    lead(args.device, lambda front: serve(args, front))


if __name__ == "__main__":
    main()
