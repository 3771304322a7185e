"""A frame set's per-file work, and the pool of host worker processes that
does it for ``make_frame_set`` (``voxel/dataset.py``).

``file_frame_atoms`` is one file's work: read, scan and build its
structures, then their frame atoms. It is Python that holds the
interpreter lock, so a call on many files spreads it over worker processes
(``FramePool``), each file's work independent of the others'.

This module imports no torch, and neither does anything it imports: the
workers are forks of one fresh interpreter (so safe to start where CUDA is
up) that imports this module alone, in a fraction of the seconds ``import
torch`` takes. Workers never touch a device.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import pickle
import selectors
import signal
import subprocess
import sys
import threading
import time
import typing as t
import warnings
from pathlib import Path

from ..structure.pdb import read_pdb_file, scan_pdb_text, structures_from_fields
from .codec import Codec
from .frames import FrameAtoms, structure_to_frame_atoms

MAX_WORKERS = 16  # bounds the processes of one caller on a host of many cores
# A call on fewer files stays in process: a pool already up saves it 40 ms
# or less, and a first call on them would start the workers for nothing
MIN_FILES = 8


class FileFrameAtoms(t.NamedTuple):
    """One file's structures as (name, FrameAtoms), what its scan returned,
    and the ``perf_counter_ns`` start and end of its two parts, a clock
    that every process on Linux reads alike."""

    structures: list[tuple[str, FrameAtoms]]
    atoms: int  # atom records the scan returned
    python_scan: bool  # the Python scanner read it: the C++ one was not built
    parse_ns: tuple[int, int]
    frame_atoms_ns: tuple[int, int]


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


def file_frame_atoms(path: Path, codec: Codec, all_states: bool) -> FileFrameAtoms:
    """One PDB file's work for a frame set, in whichever process calls it:
    its structures (every NMR state with ``all_states``, aligned on their
    common residues) and their frame atoms."""
    t0 = time.perf_counter_ns()
    text, name = read_pdb_file(path)
    fields, native = scan_pdb_text(text)
    states = structures_from_fields(fields, name, all_states=all_states)
    t1 = time.perf_counter_ns()
    fas = [structure_to_frame_atoms(s, codec) for s in states]
    if len(fas) > 1:
        fas = _align_states(fas, name=states[0].name)
    t2 = time.perf_counter_ns()
    return FileFrameAtoms([(s.name, fa) for s, fa in zip(states, fas)],
                          len(fields["coords"]), not native, (t0, t1), (t1, t2))


def frame_atoms_in_worker(paths: list[Path], codec: Codec, all_states: bool) -> list:
    """A chunk of files in a worker: for each file its ``FileFrameAtoms``
    and the warnings it raised as (message, category), for the caller to
    raise again."""
    out = []
    for path in paths:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            done = file_frame_atoms(path, codec, all_states)
        out.append((done, [(str(w.message), w.category) for w in caught]))
    return out


def workers_for(n_files: int, cores: int, local_world_size: int) -> int:
    """Worker processes for a call on ``n_files`` files, 0 to stay in
    process: this process's share of the host's ``cores`` (one process a
    card under torchrun), less one for the caller, at most ``MAX_WORKERS``;
    none below 2 workers or ``MIN_FILES`` files. A chunk holds one file at
    least, so a call keeps no more workers busy than it has files."""
    n = min(cores // max(local_world_size, 1) - 1, MAX_WORKERS)
    return n if n >= 2 and n_files >= MIN_FILES else 0


def pool_workers(n_files: int) -> int:
    """``workers_for`` on what this process observes: its usable cores and
    torchrun's ``LOCAL_WORLD_SIZE``."""
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    return workers_for(n_files, cores, int(os.environ.get("LOCAL_WORLD_SIZE") or 1))


def chunks(order: list[int], workers: int) -> list[list[int]]:
    """``order`` (files, largest first) cut into about four chunks a
    worker, so that the largest files go out first and none finishes last
    alone."""
    size = max(1, -(-len(order) // (4 * workers)))
    return [order[i:i + size] for i in range(0, len(order), size)]


class WorkerLost(Exception):
    """A worker process died."""


def _serve(inp: t.BinaryIO, out: t.BinaryIO) -> None:
    """A worker's loop: its pid out first, then (function, arguments) in,
    (True, result) or (False, the exception it raised) out, until ``inp``
    ends."""
    pickle.dump(os.getpid(), out)
    out.flush()
    while True:
        try:
            fn, args = pickle.load(inp)
        except EOFError:
            return
        try:
            answer = (True, fn(*args))
        except Exception as e:  # the caller raises it, as it was raised here
            try:
                pickle.dumps(e)
                answer = (False, e)
            except Exception:
                answer = (False, RuntimeError(f"{type(e).__name__}: {e}"))
        pickle.dump(answer, out, protocol=pickle.HIGHEST_PROTOCOL)
        out.flush()


def _fork_workers(pipes: list[tuple[int, int]]) -> None:
    """The interpreter that starts the workers, with this module and the C++
    scanner loaded: one forked worker a (read, write) pair of pipe ends,
    each keeping its own pair alone, then every worker reaped."""
    from ..structure._native import native_available

    native_available()
    os.dup2(2, 1)  # what else the work prints goes to stderr
    pids = []
    for k, (inp, out) in enumerate(pipes):
        pid = os.fork()
        if pid == 0:
            for j, pair in enumerate(pipes):
                if j != k:
                    os.close(pair[0])
                    os.close(pair[1])
            try:
                _serve(os.fdopen(inp, "rb"), os.fdopen(out, "wb"))
            finally:
                os._exit(0)
        pids.append(pid)
    for pair in pipes:  # a worker's death then ends its pipes for the caller
        os.close(pair[0])
        os.close(pair[1])
    for _ in pids:
        os.wait()


class Workers:
    """``size`` worker processes, forked from one fresh interpreter that
    imports this module alone (``_fork_workers``): not the caller's main
    module, as ``multiprocessing``'s workers would, and so not torch; and
    once, not once a worker. It and the workers run at the lowest priority
    (``os.nice(19)``) with one BLAS thread each, so that their start takes no
    core from a caller's thread that wants one. They see the caller's
    ``sys.path``, and end when their pipe from the caller does, with it."""

    def __init__(self, size: int, generation: int = 0):
        self.generation = generation  # of the FramePool that started them
        self.pids: list[int] = []
        self.proc: subprocess.Popen | None = None
        to_worker = [os.pipe() for _ in range(size)]
        from_worker = [os.pipe() for _ in range(size)]
        self.ins = [os.fdopen(w, "wb") for _, w in to_worker]
        self.outs = [os.fdopen(r, "rb") for r, _ in from_worker]
        theirs = [(r, w) for (r, _), (_, w) in zip(to_worker, from_worker)]
        code = (f"import os; os.nice(19); import sys; "
                f"sys.path[:0] = {[p for p in sys.path if p]!r}; "
                f"from {__name__} import _fork_workers; _fork_workers({theirs!r})")
        env = {**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
        try:
            try:
                self.proc = subprocess.Popen(
                    [sys.executable, "-c", code], stdin=subprocess.DEVNULL, env=env,
                    pass_fds=[fd for pair in theirs for fd in pair], start_new_session=True)
            finally:  # the workers' ends, theirs alone: a dead worker's pipe then ends
                for pair in theirs:
                    os.close(pair[0])
                    os.close(pair[1])
            self.pids = [self._answer(k) for k in range(size)]
        except (OSError, WorkerLost):
            self.close()
            raise

    def _answer(self, k: int):
        try:
            return pickle.load(self.outs[k])
        except (EOFError, pickle.UnpicklingError) as e:
            raise WorkerLost(f"worker {k} ended") from e

    def run(self, fn: t.Callable, tasks: list[tuple]) -> t.Iterator[tuple[int, int, bool, t.Any]]:
        """``fn(*task)`` of every task over the workers, one task a worker at
        a time: (task index, worker pid, whether it returned, its result or
        exception) as each ends. A dead worker raises ``WorkerLost``. Left
        early, it waits for the tasks in flight, so no answer is left
        unread."""
        todo = list(reversed(range(len(tasks))))
        idle = list(range(len(self.pids)))
        with selectors.DefaultSelector() as sel:
            try:
                while todo or sel.get_map():
                    while idle and todo:
                        k, i = idle.pop(), todo.pop()
                        try:
                            pickle.dump((fn, tasks[i]), self.ins[k])
                            self.ins[k].flush()
                        except OSError as e:
                            raise WorkerLost(f"worker {k} ended") from e
                        sel.register(self.outs[k], selectors.EVENT_READ, (k, i))
                    for key, _ in sel.select():
                        k, i = key.data
                        sel.unregister(self.outs[k])
                        ok, value = self._answer(k)
                        idle.append(k)
                        yield i, self.pids[k], ok, value
            finally:
                for key in list(sel.get_map().values()):
                    try:
                        self._answer(key.data[0])
                    except WorkerLost:
                        pass

    def close(self) -> None:
        for f in self.ins:
            try:
                f.close()
            except BrokenPipeError:  # a dead worker, with a task half sent
                pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                for pid in self.pids:
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                self.proc.kill()
                self.proc.wait()
        for f in self.outs:
            f.close()


class FramePool:
    """A persistent set of ``Workers``, started at the first request in a
    thread of its own and never waited on: ``acquire`` answers None until
    every worker is up, or while another call holds them, and the caller
    works in process meanwhile.

    Workers given back as lost are started once more; after a second loss,
    or where processes cannot be started, calls stay in process. ``close``
    ends the workers (at exit too)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._workers: Workers | None = None  # up and free
        self._size = 0  # workers up, starting or held
        self._generation = 0
        self._restarts = 1
        self._off = False

    def acquire(self, size: int) -> Workers | None:
        """``size`` workers, held until ``release``, if they are up and
        free; else None, starting them if they are not starting yet."""
        with self._lock:
            if self._off:
                return None
            if size != self._size:
                self._shut_locked()
                self._size = size
                self._start_locked()
            workers, self._workers = self._workers, None
            return workers

    def release(self, workers: Workers, lost: bool = False) -> None:
        """Give ``workers`` back; ``lost``: one of them died, so end them and
        start new ones, once."""
        with self._lock:
            current = workers.generation == self._generation
            if lost or not current:
                workers.close()
            else:
                self._workers = workers
            if lost and current:
                if self._restarts:
                    self._restarts -= 1
                    self._generation += 1
                    self._start_locked()
                else:
                    self._off = True

    def close(self) -> None:
        with self._lock:
            self._shut_locked()
            self._size = 0

    def _shut_locked(self) -> None:
        self._generation += 1  # a start still running ends its workers
        if self._workers is not None:
            self._workers.close()
            self._workers = None

    def _start_locked(self) -> None:
        threading.Thread(target=self._start, args=(self._size, self._generation),
                         name="frame_set pool start", daemon=True).start()

    def _start(self, size: int, generation: int) -> None:
        from ..structure._native import native_available

        native_available()  # build or load the C++ scanner here, before any worker looks for it
        try:
            workers = Workers(size, generation)
        except (OSError, WorkerLost):  # no processes here: stay in process
            with self._lock:
                if generation == self._generation:
                    self._off = True
            return
        with self._lock:
            if generation == self._generation:
                self._workers = workers
                return
        workers.close()


POOL = FramePool()
atexit.register(POOL.close)
