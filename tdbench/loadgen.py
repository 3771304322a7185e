"""The open-loop client of the ``/design`` cells, run as a child process so
that its interpreter lock does not pace the server.

``python -m tdbench.loadgen <plan.json> <results.json>``: builds every
request body of the plan (PDB text from ``structures.backbone_text`` with
each request's own seed), prints ``ready``, waits for ``go <t0>`` on its
standard input (``t0`` on the system's monotonic clock, shared with the
server's process), then sends request i at ``t0 + at[i]`` whatever the
earlier ones are doing, and times it from that moment to the last byte of
its response. It writes, per request, the due time, how late it was sent,
the latency, the status, the response's ``timings_s`` and, for the
requests the plan keeps, the whole response."""
from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import structures


def request_text(seed: int, index: int, length: int, noise: float, spacing: float,
                 chain=None) -> str:
    """Request ``index``'s PDB text: its own generator from (seed, index)."""
    rng = np.random.default_rng([seed, 2, index])
    return structures.backbone_text(rng, length, noise, spacing, chain)


def request_body(plan: dict, index: int, chain=None) -> bytes:
    length, req_seed = plan["lengths"][index], plan["request_seeds"][index]
    return json.dumps({"pdb": request_text(plan["seed"], index, length, plan["noise"],
                                           plan["spacing"], chain),
                       "n_samples": plan["n_samples"], "temperature": plan["temperature"],
                       "seed": req_seed}).encode()


def send(host: str, port: int, body: bytes, timeout: float) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/design", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main(plan_path: str, out_path: str) -> int:
    plan = json.loads(open(plan_path).read())
    chain = structures.chain_atoms()
    bodies = [request_body(plan, i, chain) for i in range(len(plan["at"]))]
    keep = set(plan["keep"])
    results: list = [None] * len(bodies)
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "go":
        return 2
    t0 = float(line[1])

    def one(i: int, due: float) -> None:
        sent = time.monotonic()
        try:
            status, raw = send(plan["host"], plan["port"], bodies[i], plan["timeout_s"])
        except OSError as e:
            results[i] = {"due": due - t0, "late": sent - due, "latency": None,
                          "status": 0, "error": str(e)}
            return
        done = time.monotonic()
        r = {"due": due - t0, "late": sent - due, "latency": done - due, "status": status}
        if status == 200:
            payload = json.loads(raw)
            r["timings_s"] = payload["timings_s"]
            r["n_residues"] = payload["n_residues"]
            if i in keep:
                r["response"] = payload
        results[i] = r

    with ThreadPoolExecutor(max_workers=plan["max_in_flight"]) as pool:
        futures = []
        for i, at in enumerate(plan["at"]):
            due = t0 + at
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(one, i, due))
        for f in futures:
            f.result()
    late = sorted(r["late"] for r in results)
    print(f"loadgen: {len(results)} requests, sent late by median "
          f"{late[len(late) // 2] * 1e3:.3f} ms, most {late[-1] * 1e3:.3f} ms",
          file=sys.stderr, flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    threading.current_thread().name = "loadgen"
    sys.exit(main(sys.argv[1], sys.argv[2]))
