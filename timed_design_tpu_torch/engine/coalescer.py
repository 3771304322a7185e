"""Request coalescing: pack concurrent design requests into shared batches.

The port of ``timed_design_tpu/engine/coalescer.py``. Each request thread
voxelizes its own structure on the device; one worker thread drains every
request queued when the device frees up, copies their frames into one
preallocated device buffer, runs the predictor's fixed batches over it and
hands each request its rows through a future. An idle server runs each
request at once (no timer unless ``window_ms`` > 0).
"""
from __future__ import annotations

import queue
import threading
import time
import typing as t
from concurrent.futures import Future

import numpy as np
import torch

_CLOSE = object()


class CoalescingDesigner:
    """Thread-safe front of a :class:`DesignSession` that batches concurrent
    ``design`` calls.

    ``max_group_residues``: stop draining the queue once a group holds this
    many frame rows (default 8x the predictor's batch). ``window_ms``: wait
    this long for more requests before running a group (default 0).
    """

    def __init__(self, session, max_group_residues: int | None = None,
                 window_ms: float = 0.0):
        self.session = session
        self.max_group_residues = max_group_residues or 8 * session.predictor.batch_size
        self.window_s = window_ms / 1e3
        # bounded: queued items hold device frames, so a full queue blocks
        # callers (backpressure) instead of filling device memory
        self._queue: queue.Queue = queue.Queue(maxsize=32)
        # the closed-check and the enqueue happen together, so no request
        # can land behind the close sentinel and wait forever
        self._close_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "groups": 0,
                      "max_group_requests": 0, "max_group_residues": 0}
        self._buf: torch.Tensor | None = None  # packing buffer, worker-owned
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="coalescer")
        self._thread.start()

    def design(self, structure) -> tuple[np.ndarray, t.Any, dict]:
        """Blocking: Structure -> (probs, FrameAtoms, timings). Voxelization
        runs on the calling thread; ``timings`` carries it, the prediction
        time of the group this request rode in, and the group's size."""
        t0 = time.perf_counter()
        frames, fa = self.session.voxelize(structure)
        return self.submit_frames(frames, fa, time.perf_counter() - t0).result()

    def submit_frames(self, frames, fa, dt_vox: float = 0.0) -> Future:
        """Enqueue voxelized frames; the future resolves to what ``design``
        returns."""
        fut: Future = Future()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("CoalescingDesigner is closed")
            self._queue.put((frames, fa, fut, dt_vox))
        return fut

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_CLOSE)
        self._thread.join(timeout=10)

    def _drain_group(self) -> list | None:
        """Block for the first request, then take everything already queued
        (and whatever arrives inside the optional window)."""
        first = self._queue.get()
        if first is _CLOSE:
            return None
        group = [first]
        residues = int(first[0].shape[0])
        deadline = time.perf_counter() + self.window_s
        while residues < self.max_group_residues:
            try:
                timeout = deadline - time.perf_counter()
                item = (self._queue.get(timeout=timeout) if timeout > 0
                        else self._queue.get_nowait())
            except queue.Empty:
                break
            if item is _CLOSE:
                self._queue.put(_CLOSE)  # re-post so the loop exits next
                break
            group.append(item)
            residues += int(item[0].shape[0])
        return group

    def _loop(self) -> None:
        while True:
            group = self._drain_group()
            if group is None:
                return
            try:
                self._run_group(group)
            except BaseException as e:  # noqa: BLE001 - the worker must survive
                for _, _, fut, _ in group:
                    if not fut.done():
                        fut.set_exception(e)

    def _run_group(self, group: list) -> None:
        t1 = time.perf_counter()
        parts = [frames for frames, _, _, _ in group]
        if len(parts) == 1:
            probs = self.session.predictor.predict_probs(parts[0])
        else:
            probs = self._predict_packed(parts)
        dt_predict = time.perf_counter() - t1
        n_res = int(sum(p.shape[0] for p in parts))
        with self._stats_lock:
            s = self.stats
            s["requests"] += len(group)
            s["groups"] += 1
            s["max_group_requests"] = max(s["max_group_requests"], len(group))
            s["max_group_residues"] = max(s["max_group_residues"], n_res)
        offset = 0
        for frames, fa, fut, dt_vox in group:
            r = int(frames.shape[0])
            timings = {"voxelisation": dt_vox, "prediction": dt_predict,
                       "group_requests": len(group), "group_residues": n_res}
            fut.set_result((probs[offset : offset + r], fa, timings))
            offset += r

    def _predict_packed(self, parts: list) -> np.ndarray:
        """Copy the requests' frames into one preallocated device buffer,
        rounded up to whole batches, and stream it through the predictor.

        The buffer is reused across groups and grows only when a group needs
        more rows, so every forward sees the same batch shape. Rows past the
        group's last frame are never read back."""
        predictor = self.session.predictor
        B = predictor.batch_size
        total = sum(int(p.shape[0]) for p in parts)
        if total == 0:
            return np.zeros((0, predictor.n_classes), np.float32)
        rows = -(-total // B) * B
        shape = (rows, *parts[0].shape[1:])
        if (self._buf is None or self._buf.shape[0] < rows
                or self._buf.shape[1:] != shape[1:]):
            self._buf = torch.zeros(shape, dtype=predictor.dtype, device=predictor.device)
        offset = 0
        for p in parts:
            self._buf[offset : offset + p.shape[0]].copy_(p)
            offset += int(p.shape[0])
        chunks = ((self._buf[s : s + B], min(B, total - s)) for s in range(0, total, B))
        return np.concatenate(list(predictor.predict_stream(chunks)))


class SerialDesigner:
    """Lock-serialized designer with the CoalescingDesigner interface, for
    ``--no-coalesce``."""

    def __init__(self, session):
        self.session = session
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "groups": 0,
                      "max_group_requests": 1, "max_group_residues": 0}

    def _count(self, n_res: int) -> None:
        self.stats["requests"] += 1
        self.stats["groups"] += 1
        self.stats["max_group_residues"] = max(self.stats["max_group_residues"], n_res)

    def design(self, structure):
        with self._lock:
            probs, fa = self.session.design(structure)
            timings = dict(self.session.last_timings)
            timings["group_requests"] = 1
            timings["group_residues"] = int(probs.shape[0])
            self._count(int(probs.shape[0]))
            return probs, fa, timings

    def submit_frames(self, frames, fa, dt_vox: float = 0.0) -> Future:
        """Runs at once under the lock; returns a resolved future."""
        fut: Future = Future()
        try:
            t0 = time.perf_counter()
            with self._lock:
                probs = self.session.predictor.predict_probs(frames)
                self._count(int(probs.shape[0]))
            fut.set_result((probs, fa, {
                "voxelisation": dt_vox,
                "prediction": time.perf_counter() - t0,
                "group_requests": 1,
                "group_residues": int(probs.shape[0]),
            }))
        except BaseException as e:  # noqa: BLE001 - delivered to the waiter
            fut.set_exception(e)
        return fut

    def close(self) -> None:
        pass


class EnsembleDesigner:
    """A virtual designer that averages several same-head designers.

    ``design`` voxelizes once (members share codec and Gaussian mode), hands
    the device frames to every member, waits on all of them and returns the
    float64-accumulated mean. Members are not owned: ``close`` does nothing.
    """

    def __init__(self, members: list):
        members = list(members)
        if len(members) < 2:
            raise ValueError("ensemble needs at least two member models to average")
        heads = {m.session.n_classes for m in members}
        if len(heads) != 1:
            raise ValueError(
                "ensemble requires models with matching heads; got class "
                f"counts {sorted(heads)} — mixing 20-residue and 338-rotamer "
                "models cannot be averaged"
            )
        specs = {(m.session.codec, m.session.gaussian) for m in members}
        if len(specs) != 1:
            raise ValueError(
                "ensemble members must share the voxel spec (codec + "
                f"gaussian); got {sorted(map(str, specs))}"
            )
        self.members = members
        self.session = members[0].session
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "members": len(members)}

    def design(self, structure) -> tuple[np.ndarray, t.Any, dict]:
        t0 = time.perf_counter()
        frames, fa = self.session.voxelize(structure)
        dt_vox = time.perf_counter() - t0
        results = [f.result() for f in
                   [m.submit_frames(frames, fa, dt_vox) for m in self.members]]
        probs = np.mean(
            np.stack([np.asarray(p, np.float64) for p, _, _ in results]), axis=0
        ).astype(np.float32)
        timings = {
            "voxelisation": dt_vox,
            "prediction": max(tm["prediction"] for _, _, tm in results),
            "ensemble_members": len(self.members),
            "group_requests": max(tm["group_requests"] for _, _, tm in results),
            "group_residues": max(tm["group_residues"] for _, _, tm in results),
        }
        with self._stats_lock:
            self.stats["requests"] += 1
        return probs, fa, timings

    def close(self) -> None:
        pass
