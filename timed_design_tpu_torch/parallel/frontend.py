"""The rank-0 front end: ``td-serve`` and the design app across cards.

An HTTP server and a Streamlit script are one process, and NCCL takes one
process per card. So rank 0 is that process: it takes every request, and for
each forward it tells the other ranks (the followers) what to run and sends
each its rows of the batch; every rank then runs the same forward of its
``Predictor(mesh=)``, whose ``all_gather`` over the data axis brings the
whole batch's probabilities back. The designers (``CoalescingDesigner``,
``SerialDesigner``, ``EnsembleDesigner``) run unchanged on rank 0: the front
end hooks into the Predictor (``LeaderPredictor``), not into them.

The protocol. Rank 0 broadcasts a header of ``HEADER`` int64 over a gloo
group of its own (the control group): the operation, a session's index and
the padded batch's shape. What follows each operation:
  - ``LOAD``: the ``DesignSession`` keywords (``broadcast_object_list``);
    every rank builds ``DesignSession(mesh=mesh, **keywords)`` from them, in
    the same order, so that sessions have the same index everywhere. The
    weights are no one's to carry: every rank resolves the same model
    argument, and the Predictor broadcasts rank 0's weights once (random
    weights are seeded besides);
  - ``FORWARD``: the device rows of the batch in the compute dtype (sent
    as bytes), rank 0's packed batch cut by ``scatter`` over the data group,
    each rank's share to it; then every rank runs ``run_device_batch`` on its
    rows;
  - ``BEAT``: nothing; ``STOP``: the followers leave.

Idle time: a heartbeat. The followers wait for the next header in the
control group's broadcast, never in an NCCL collective, and rank 0
broadcasts ``BEAT`` every ``CONTROL_TIMEOUT_S / 6`` seconds, so a world that
sits idle for hours never reaches a timeout. A follower leaves when it
receives ``STOP``, and also when rank 0's process is gone: its socket closes
and the broadcast fails at once, or no header comes within
``CONTROL_TIMEOUT_S``; it then exits non-zero.

Threads: one lock on rank 0. A header and every collective behind it (the
scatter, the forward's, the gather) are issued by one thread at a time, so
the coalescer's worker, request threads (``--no-coalesce``, the ensemble)
and every browser session of the app never interleave collectives on one
communicator.

Starting the world: under ``torchrun`` the world it launched (``lead``);
else ``start_followers`` starts one process a further card, each with
torchrun's environment, running this module as ``__main__``:

    python -m timed_design_tpu_torch.parallel.frontend --device cuda

No fallback: a follower that fails to start or to join makes the caller
raise; nothing goes on quietly on one card.
"""
from __future__ import annotations

import argparse
import atexit
import functools
import os
import subprocess
import sys
import threading
import traceback
import typing as t
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from ..engine.predictor import Predictor
from .distributed import initialize_distributed
from .mesh import Mesh, make_mesh

# The control group's timeout: a follower that hears nothing from rank 0 for
# this long leaves (rank 0 beats at a sixth of it)
CONTROL_TIMEOUT_S = 60.0
HEADER = 8  # int64: operation, session index, then the batch's shape (B, D, H, W, C)
STOP, LOAD, FORWARD, BEAT = range(4)

T = t.TypeVar("T")


def control_group(mesh: Mesh):
    """The gloo group over the mesh's ranks that carries the headers, with
    ``CONTROL_TIMEOUT_S``; every rank of the world calls it, in the same
    order as its other groups."""
    return dist.new_group(list(mesh.ranks), backend="gloo",
                          timeout=timedelta(seconds=CONTROL_TIMEOUT_S))


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes (uint8), which NCCL and gloo both send
    whatever the compute dtype (gloo has no bfloat16)."""
    return x.view(torch.uint8)


class LeaderPredictor(Predictor):
    """Rank 0's Predictor in a front end: ``to_device`` places the whole
    padded batch on rank 0's card, and each ``run_device_batch`` sends every
    rank its rows (under the front end's lock) before running rank 0's.
    Built by ``FrontEnd.load`` through ``DesignSession(predictor_cls=)``."""

    def __init__(self, *args, front: "FrontEnd", index: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.front, self.index = front, index

    def local_rows(self) -> tuple[int, int]:
        return 0, self.batch_size

    def run_device_batch(self, x: torch.Tensor):
        return self.front.forward(self.index, x, super().run_device_batch)


class FrontEnd:
    """Rank 0's side of a world of followers: ``load`` builds a session on
    every rank, its predictor's forwards reach every rank, ``close`` stops
    the followers (and, for a world ``start_followers`` made, waits for them
    and leaves it)."""

    def __init__(self, mesh: Mesh, control, followers: t.Sequence[subprocess.Popen] = (),
                 owns_world: bool = False):
        if mesh.rank != mesh.ranks[0]:
            raise ValueError("the front end runs on the mesh's first rank")
        self.mesh = mesh
        self.control = control
        self.followers = list(followers)
        self.owns_world = owns_world
        self.lock = threading.Lock()
        self._sessions: dict = {}
        self._count = 0
        self._closed = False
        self.broken: BaseException | None = None
        self._stop_beat = threading.Event()
        self._beat = threading.Thread(target=self._beat_loop, args=(CONTROL_TIMEOUT_S / 6,),
                                      name="front-end-heartbeat", daemon=True)
        self._beat.start()

    @property
    def n_ranks(self) -> int:
        return len(self.mesh.ranks)

    def _header(self, op: int, index: int = 0, shape: t.Sequence[int] = ()) -> None:
        if self.broken is not None:
            raise RuntimeError(f"the world of the front end is broken: {self.broken}")
        if self._closed:
            raise RuntimeError("the front end is closed")
        h = torch.zeros(HEADER, dtype=torch.int64)
        h[0], h[1] = op, index
        h[2 : 2 + len(shape)] = torch.tensor(list(shape), dtype=torch.int64)
        try:
            dist.broadcast(h, src=self.mesh.ranks[0], group=self.control)
        except RuntimeError as e:
            self.broken = e
            raise

    def _beat_loop(self, every_s: float) -> None:
        while not self._stop_beat.wait(every_s):
            with self.lock:
                if self._closed or self.broken is not None:
                    return
                try:
                    self._header(BEAT)
                except RuntimeError:
                    return

    def load(self, model, **keywords):
        """The ``DesignSession`` of ``model`` over the mesh, built on every
        rank (once per distinct arguments: a second call returns the first
        session). ``device``, where given, must be the mesh's kind of
        device: each rank runs on its own."""
        from ..engine import DesignSession

        device = keywords.pop("device", None)
        if device is not None and torch.device(device).type != self.mesh.device.type:
            raise ValueError(f"a front end over {self.mesh.device.type} ranks cannot run a "
                             f"session on {torch.device(device).type}")
        keywords["model"] = model
        key = repr(sorted((k, str(v)) for k, v in keywords.items()))
        with self.lock:
            if key in self._sessions:
                return self._sessions[key]
            self._header(LOAD, self._count)
            dist.broadcast_object_list([keywords], src=self.mesh.ranks[0], group=self.control)
            session = DesignSession(mesh=self.mesh, predictor_cls=functools.partial(
                LeaderPredictor, front=self, index=self._count), **keywords)
            self._sessions[key] = session
            self._count += 1
            return session

    def forward(self, index: int, x: torch.Tensor, run: t.Callable):
        """Session ``index``'s forward of the padded batch ``x`` (rank 0's
        device, compute dtype) on every rank; ``run`` is rank 0's
        ``Predictor.run_device_batch`` of its own rows."""
        with self.lock:
            self._header(FORWARD, index, x.shape)
            mine = torch.empty((x.shape[0] // self.mesh.shape["data"], *x.shape[1:]),
                               dtype=x.dtype, device=x.device)
            parts = [_wire(p) for p in x.chunk(self.mesh.shape["data"])]
            dist.scatter(_wire(mine), parts, src=self.mesh.ranks[0], group=self.mesh.data_group)
            return run(mine)

    def close(self) -> None:
        """Stop the followers: ``STOP``, then (for a world ``start_followers``
        made) wait for their processes, kill any left after 30 s, and leave
        the world."""
        with self.lock:
            if self._closed:
                return
            try:
                if self.broken is None:
                    self._header(STOP)
            except RuntimeError:
                pass
            self._closed = True
        self._stop_beat.set()
        self._beat.join(timeout=10)
        for p in self.followers:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()


def follow(mesh: Mesh, control) -> None:
    """The loop of every rank but the first: receive each header from rank 0
    and take part in what it announces, until ``STOP``. A session that fails
    to build here failed on rank 0 too (the same arguments): it is skipped
    with its traceback, and the indices stay in step. Raises RuntimeError
    when rank 0 is gone (its socket closed, or no header within the control
    group's timeout)."""
    from ..engine import DesignSession

    sessions = []
    header = torch.zeros(HEADER, dtype=torch.int64)
    src = mesh.ranks[0]
    while True:
        try:
            dist.broadcast(header, src=src, group=control)
        except RuntimeError as e:
            raise RuntimeError(f"rank {mesh.rank}: rank 0 is gone ({e})") from e
        op, index, *shape = (int(v) for v in header)
        if op == STOP:
            return
        if op == LOAD:
            box = [None]
            dist.broadcast_object_list(box, src=src, group=control)
            try:
                sessions.append(DesignSession(mesh=mesh, **box[0]))
            except Exception:  # noqa: BLE001 - rank 0 raised the same, before any collective
                traceback.print_exc()
        elif op == FORWARD:
            predictor = sessions[index].predictor
            rows = shape[0] // mesh.shape["data"]
            x = torch.empty((rows, *shape[1:5]), dtype=predictor.dtype, device=predictor.device)
            dist.scatter(_wire(x), None, src=src, group=mesh.data_group)
            Predictor.fetch(predictor.run_device_batch(x), 0)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(address: str, world: int, device: torch.device,
          followers: list[subprocess.Popen]) -> None:
    """Join as rank 0 while watching the followers: one that exits before the
    world is joined makes this raise (instead of waiting out the timeout)."""
    failure: list[BaseException] = []

    def join():
        try:
            initialize_distributed(address, world, 0, device=device)
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller's thread
            failure.append(e)

    th = threading.Thread(target=join, name="front-end-join", daemon=True)
    th.start()
    while th.is_alive():
        th.join(timeout=0.2)
        dead = [(i + 1, p.returncode) for i, p in enumerate(followers) if p.poll() is not None]
        if dead and th.is_alive():
            raise RuntimeError(f"follower rank {dead[0][0]} exited with code {dead[0][1]} "
                               "before it joined the world")
    if failure:
        raise failure[0]


def start_followers(n: int, device: torch.device | str) -> FrontEnd:
    """Start ``n`` follower processes (ranks 1..n, cards 1..n under CUDA),
    each with torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) running this module;
    join the world with them as rank 0 and return the front end over every
    rank on the data axis. ``n`` may be 0: a world of this process alone.
    A follower that exits before joining, or a join that fails, raises,
    with every follower stopped."""
    device = torch.device(device)
    port = _free_port()
    root = str(Path(__file__).resolve().parents[2])
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(n + 1), "PYTHONPATH": path + os.pathsep + root if path else root}
    procs = []
    try:
        for rank in range(1, n + 1):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "timed_design_tpu_torch.parallel.frontend",
                 "--device", device.type],
                env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}))
            print(f"front end: started follower rank {rank} (pid {procs[-1].pid})", flush=True)
        _join(f"127.0.0.1:{port}", n + 1, device, procs)
        mesh = make_mesh()
        return FrontEnd(mesh, control_group(mesh), procs, owns_world=True)
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        raise


def _start(device: torch.device | str, followers: int | None) -> FrontEnd | None:
    """``start_followers(followers)``; with None, one follower a further
    visible card for a CUDA device, and no world at all (None) where that
    is none, as on the CPU."""
    if followers is None:
        followers = torch.cuda.device_count() - 1 if torch.device(device).type == "cuda" else 0
        if followers < 1:
            return None
    return start_followers(followers, device)


def lead(device: torch.device | str, run: t.Callable[[FrontEnd | None], T],
         followers: int | None = None) -> T | None:
    """Run ``run(front)`` on rank 0 of this process's world and return what
    it returns; the front end is closed after it (the followers stop).

    Under ``torchrun`` (``WORLD_SIZE`` set) the world it launched: rank 0
    runs ``run``, every other rank follows until rank 0 stops it and
    returns None. Else ``followers`` more processes started here
    (``start_followers``; default one a further visible card, and with
    none ``run(None)``: the one-process path, no world joined)."""
    from .mesh import launched_mesh

    if "WORLD_SIZE" in os.environ:
        with launched_mesh(device) as mesh:
            control = control_group(mesh)
            if mesh.rank != mesh.ranks[0]:
                follow(mesh, control)
                return None
            front = FrontEnd(mesh, control)
            try:
                return run(front)
            finally:
                front.close()
    front = _start(device, followers)
    try:
        return run(front)
    finally:
        if front is not None:
            front.close()


_SHARED: dict = {}
_SHARED_LOCK = threading.Lock()


def shared_front_end(device: torch.device | str,
                     followers: int | None = None) -> FrontEnd | None:
    """This process's front end over ``device``'s kind of card, started at
    the first call and kept for the process (the design app: every browser
    session and every rerun shares it, under its lock; closed at exit).
    ``followers`` as in ``lead``; None where that means one process."""
    kind = torch.device(device).type
    with _SHARED_LOCK:
        if kind not in _SHARED:
            _SHARED[kind] = front = _start(device, followers)
            if front is not None:
                atexit.register(front.close)
        return _SHARED[kind]


def main(argv=None) -> int:
    """A follower started by ``start_followers`` (or any launcher that sets
    torchrun's environment): join the world, follow rank 0 until it stops,
    leave. Exits 1 when rank 0 is gone."""
    p = argparse.ArgumentParser(description="A follower rank of the design front end")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    initialize_distributed(device=args.device)
    try:
        mesh = make_mesh()
        follow(mesh, control_group(mesh))
    except RuntimeError as e:
        print(f"front end follower: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
