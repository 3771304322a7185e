"""Batched prediction: frames -> per-residue probabilities (PyTorch).

The port of ``Predictor``, ``_resolve_model``, ``load_dataset_and_predict``
and ``predict_structure`` (timed_design_tpu/engine/predictor.py). The batch
is fixed (the last one is padded); up to ``max_in_flight`` batches are
queued on the device before the oldest result is fetched, each result
copied once into a pinned host buffer (``predict_pipeline``, which
``Predictor.predict_stream`` and ``load_dataset_and_predict`` share).
``load_dataset_and_predict`` takes
its frames from an in-memory ``FrameSet`` (PDB files, voxelized on the
device batch by batch) or from an HDF5 frame dataset, tree or flat layout
(``io/h5frames.py``).

Over a mesh (``parallel/``, one process per card) every rank sees the same
global batch, runs the forward on its own rows of it and gathers the
probabilities over the data axis on the device, so every rank holds the
whole batch's; ``load_dataset_and_predict`` writes on process index 0 only.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import sys
import threading
import typing as t
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..constants import ROTAMER_CATEGORIES, ROTAMER_TO_AA_ONEHOT
from ..io import (
    DatasetMap,
    FrameBatchLoader,
    hdf5,
    extract_sequences,
    get_pdb_keys_to_filter,
    load_datasetmap,
    load_prediction_matrix,
    save_consensus_probs,
    save_datasetmap,
    save_dict_to_fasta,
    save_srb_datasetmap,
    write_int_csv,
    write_prediction_rows,
)
from ..io.h5frames import _index_columns, _is_flat_layout
from ..io.h5frames import create_flat_dataset_map as h5_dataset_map
from ..models import (
    KerasH5Model,
    ModelSpec,
    get_model_spec,
    load_checkpoint_build_kwargs,
    load_checkpoint_params,
    load_model,
    quantized_convs,
)
from ..models.quantize import check_mode
from ..parallel import barrier, replicate
from ..parallel.distributed import process_index
from ..parallel.mesh import Mesh, batch_over
from ..utils import PhaseTimer
from ..utils.timing import device_span, span, traced
from ..voxel.dataset import FrameBatchSource, FrameSet, create_flat_dataset_map


def default_device() -> torch.device:
    """The CUDA device. The port runs on the card; the CPU only when the
    caller names it (``device="cpu"``), never as a silent fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: torch.device | str | None, mesh: Mesh | None = None) -> torch.device:
    """``device``; else the device of ``mesh``'s collectives; else the card
    (``default_device``)."""
    if device is None and mesh is not None:
        device = mesh.device
    return torch.device(device) if device is not None else default_device()


class Predictor:
    """Fixed-batch forward pass of one model on one device, or over a
    mesh's data axis."""

    def __init__(self, model: nn.Module, batch_size: int = 512,
                 device: torch.device | str | None = None, quantize: str | None = None,
                 mesh: Mesh | None = None):
        """``model``: a module whose forward maps (B, 21, 21, 21, C) frames
        to (B, n_classes) float32 probabilities and that names its
        ``compute_dtype`` (the frames' dtype on the device). ``quantize``:
        None, or a mode of ``models/quantize.py`` ('int8', 'int8-fake',
        'w8') that every forward runs in.

        ``mesh`` (``parallel.make_mesh``): ``batch_size`` rounds up to a
        multiple of the data axis, the weights are broadcast from the
        mesh's first rank (replicated, as the JAX Predictor replicates
        them: the model axis is training's only), each rank runs its rows
        of every batch and the outputs gather over the data axis. The
        device defaults to the mesh's; a device the mesh's collectives
        cannot run on raises (NCCL takes CUDA tensors, gloo CPU ones)."""
        check_mode(quantize)
        self.quantize = quantize
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        if mesh is not None and mesh.device is not None and mesh.device.type != self.device.type:
            raise ValueError(f"a mesh whose collectives run on {mesh.device.type} cannot "
                             f"gather a predictor's outputs on {self.device.type}")
        self.model = model.to(self.device).eval()
        if mesh is not None:
            replicate(self.model, mesh)
        n_data = 1 if mesh is None else mesh.shape["data"]
        # round up so the batch splits evenly across the data axis
        self.batch_size = -(-batch_size // n_data) * n_data
        self.n_classes = model.n_classes
        self.dtype = model.compute_dtype
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # cuDNN convolutions default to TF32; the float32 path means float32
            torch.backends.cudnn.allow_tf32 = False

    def to_device(self, chunk) -> torch.Tensor:
        """Pad to the batch, place on the device, cast to the compute dtype;
        over a mesh, this rank's rows of the padded batch only.

        Accepts host (numpy) or device (torch) frames; host frames go through
        pinned memory so the copy is asynchronous."""
        lo, batch_size = self.local_rows()
        chunk = chunk[lo : lo + batch_size]
        if isinstance(chunk, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(chunk))
            if self.device.type == "cuda":
                x = x.pin_memory()
            chunk = x
        x = chunk.to(self.device, non_blocking=True).to(self.dtype)
        n = x.shape[0]
        if n < batch_size:
            padded = x.new_zeros((batch_size, *x.shape[1:]))
            padded[:n] = x
            x = padded
        return x

    def local_rows(self) -> tuple[int, int]:
        """(first row, rows) of the padded batch that ``to_device`` places:
        the whole batch, or over a mesh this rank's share of it."""
        if self.mesh is None:
            return 0, self.batch_size
        rows = self.batch_size // self.mesh.shape["data"]
        return self.mesh.data_index * rows, rows

    def run_device_batch(self, x: torch.Tensor):
        """Queue the forward of a batch already placed by ``to_device`` (of
        this predictor or any other with the same device, batch and compute
        dtype, so that several models share one device batch) and the copy
        of its result to a pinned host buffer. Returns the handle ``fetch``
        waits on. The quantize mode and the mesh are entered here, on the
        thread that runs the forward (a coalescer's worker, td-predict's
        loop). Over a mesh the outputs gather over the data axis on the
        device, queued behind the forward, so every rank holds the whole
        batch's."""
        with torch.inference_mode(), quantized_convs(self.quantize), batch_over(self.mesh):
            out = self.model(x)
            group = None if self.mesh is None else self.mesh.data_group
            if group is not None:
                parts = [torch.empty_like(out) for _ in range(self.mesh.shape["data"])]
                dist.all_gather(parts, out, group=group)
                out = torch.cat(parts)
        if self.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def fetch(handle, n_valid: int) -> np.ndarray:
        """Wait for a ``run_device_batch`` result; its first ``n_valid`` rows."""
        host, done = handle
        if done is not None:
            done.synchronize()
        return host[:n_valid].numpy()

    def predict_stream(
        self, batches: t.Iterable[tuple[t.Any, int]], max_in_flight: int = 8,
    ) -> t.Iterator[np.ndarray]:
        """Pipelined prediction over (frames, n_valid) pairs
        (``predict_pipeline`` of this predictor alone). Yields (n_valid,
        n_classes) float32 arrays in input order."""
        tagged = ((frames, n_valid, i) for i, (frames, n_valid) in enumerate(batches))
        for (out,), _, _ in predict_pipeline([self], tagged, max_in_flight):
            yield out

    def predict_probs(self, frames) -> np.ndarray:
        """Predict (N, n_classes) for any N; pads to the batch."""
        B = self.batch_size
        N = frames.shape[0]
        chunks = ((frames[s : s + B], min(B, N - s)) for s in range(0, N, B))
        parts = list(self.predict_stream(chunks))
        return np.concatenate(parts) if parts else np.empty((0, self.n_classes), np.float32)


def predict_pipeline(
    predictors: t.Sequence[Predictor], batches: t.Iterable[tuple[t.Any, int, t.Any]],
    max_in_flight: int = 8,
) -> t.Iterator[tuple[list[np.ndarray], int, t.Any]]:
    """The in-flight pipeline: for each (frames, n_valid, tag), place the
    batch once (``predictors[0].to_device``; the predictors share its
    device, batch and compute dtype) and queue every predictor's forward on
    it inside a ``forward`` device span; with ``max_in_flight`` batches
    queued, wait for the oldest inside a ``fetch_wait`` span. Yields
    (each predictor's (n_valid, n_classes) rows, n_valid, tag) in input
    order; the spans take the tag as their id. The wait stays on the
    caller's thread: it throttles the launches."""
    pending: collections.deque = collections.deque()

    def oldest_while(more_than: int):
        while len(pending) > more_than:
            handles, n_valid, tag = pending.popleft()
            with span("fetch_wait", tag):
                outs = [Predictor.fetch(h, n_valid) for h in handles]
            yield outs, n_valid, tag

    first = predictors[0]
    for frames, n_valid, tag in batches:
        x = first.to_device(frames)
        with device_span("forward", tag, device=first.device):
            handles = [p.run_device_batch(x) for p in predictors]
        pending.append((handles, n_valid, tag))
        yield from oldest_while(max_in_flight - 1)
    yield from oldest_while(0)


def _resolve_model(m, compute_dtype: torch.dtype | None = None,
                   allow_random_weights: bool = False) -> tuple[nn.Module, str]:
    """Module -> itself (a ``KerasH5Model`` named by its file's stem); a
    Keras ``.h5``/``.hdf5`` path -> the graph it stores, in
    ``compute_dtype`` (float32 when None), named by the file's stem;
    "Name@ckpt.npz" -> the registry architecture with the checkpoint's
    weights, converted by its family's converter (``ModelSpec.convert``);
    bare registry name -> random weights, refused unless
    ``allow_random_weights`` (benchmarks and tests only: random predictions
    cannot be told from real ones)."""
    if isinstance(m, nn.Module):
        return m, getattr(m, "name", None) or "model"
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    if "@" in str(m):
        name, ckpt = str(m).split("@", 1)
        spec = get_model_spec(name)
        module = spec.build(**load_checkpoint_build_kwargs(ckpt), **kw)
        sd = spec.convert(load_checkpoint_params(ckpt))
        module.load_state_dict(sd)
        return module, spec.name
    resolved = load_model(m, compute_dtype=compute_dtype)
    if isinstance(resolved, KerasH5Model):
        return resolved, resolved.name
    spec: ModelSpec = resolved
    if not allow_random_weights:
        raise ValueError(
            f"model {str(m)!r} resolves to registry architecture "
            f"{spec.name!r} with NO weights — predictions would be random "
            "garbage. Pass a .h5 weights file, a 'Name@checkpoint.npz', or set "
            "allow_random_weights=True (--allow-random-weights on the CLI) "
            "for benchmarking."
        )
    print(
        f"WARNING: using RANDOMLY INITIALIZED weights for {spec.name} — "
        "outputs are not real designs (benchmark mode).",
        file=sys.stderr,
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = spec.build(**kw)
    return module, spec.name


@dataclasses.dataclass
class PredictionResult:
    """What ``load_dataset_and_predict`` returns: the map, the last model's
    decoded maps (the ensemble's with ``ensemble``) and the phase times."""

    flat_dataset_map: DatasetMap
    pdb_to_sequence: dict[str, str]
    pdb_to_probability: dict[str, np.ndarray]
    pdb_to_real_sequence: dict[str, str]
    pdb_to_consensus: dict[str, str] | None
    pdb_to_consensus_prob: dict[str, np.ndarray] | None
    timings: dict[str, float] = dataclasses.field(default_factory=dict)
    # of the predict phase, the seconds the loop waited for the next batch
    # (its ``next_batch`` phase)
    loader_wait_s: float = 0.0


def _datasetmap_matches_frames(dmap: DatasetMap, frame_set: FrameSet) -> bool:
    """Does a loaded map describe this frame set? Every entry must name one
    of its frames (a blacklist-filtered map is a subset). The JAX package
    tests the first and last entries against the HDF5 file; here every key
    is a set lookup, so a map with a stale entry anywhere is regenerated."""
    return bool(dmap.entries) and all(
        (pdb, chain, rid) in frame_set.index for pdb, chain, rid, _ in dmap.entries)


def _datasetmap_matches_dataset(dmap: DatasetMap, dataset_path: Path) -> bool:
    """Does a loaded map describe this HDF5 dataset? The JAX package's check:
    flat layout, the row count and the first and last rows' keys (or, for a
    map of fewer rows, as a blacklist-filtered one is, the first and last
    entries among the rows); tree layout, the first and last entries'
    datasets exist."""
    if not dmap.entries:
        return False
    ends = [dmap.entries[0][:3], dmap.entries[-1][:3]]
    try:
        with hdf5.File(dataset_path) as f:
            if _is_flat_layout(f):
                rows = list(zip(*_index_columns(f, ("index_pdb", "index_chain",
                                                     "index_residue"))))
                if len(rows) == len(dmap.entries):
                    return [rows[0], rows[-1]] == ends
                keys = set(rows)
                return all(k in keys for k in ends)
            return all(f"{pdb}/{chain}/{rid}" in f for pdb, chain, rid in ends)
    except (OSError, ValueError):
        return False


@traced("td_predict")
def load_dataset_and_predict(
    models: list,
    dataset: FrameSet | Path | str,
    batch_size: int = 512,
    start_batch: int = 0,
    dataset_map_path: Path = Path("datasetmap.txt"),
    blacklist: Path | None = None,
    predict_rotamers: bool = False,
    is_consensus: bool = False,
    path_to_output: Path | None = None,
    device: torch.device | str | None = None,
    compute_dtype: torch.dtype | None = None,
    allow_random_weights: bool = False,
    ensemble: bool = False,
    quantize: str | None = None,
    mesh: Mesh | None = None,
) -> PredictionResult | None:
    """Run every model over ``dataset`` and write the JAX package's artifact
    set into ``path_to_output`` (default: the working directory).

    ``dataset``: a ``FrameSet``, each batch voxelized on ``device``; or the
    path of an HDF5 frame dataset (tree or flat layout, float32 or bfloat16
    frames), read by ``FrameBatchLoader``, whose batches reach a card
    through reused pinned buffers. Every model runs on the one device
    batch. Per model: ``{model}.csv`` (float16), or in rotamer mode
    ``{model}_rot.csv`` (the 338-class matrix, full precision) and the
    argmax-collapsed one-hot ``{model}.csv`` (float16); the SRB map
    ``{model}.txt``; ``{model}.fasta`` decoded from the matrix cast to
    float16 (argmax ties break as a reader of the CSV would); with
    ``is_consensus`` the NMR consensus fasta, csv and txt. Once:
    ``encoded_labels.csv``, ``dataset.fasta`` and the per-residue map.

    The map: ``dataset_map_path`` when it exists (or exists under
    ``path_to_output``), is per-residue and describes this dataset (every
    entry a frame of the set; for an HDF5 file, the JAX package's check);
    else made in the JAX package's row order (``create_flat_dataset_map``,
    blacklisted codes removed with a warning) and saved under the requested
    file name in ``path_to_output``. Batches follow the map. The result's
    ``loader_wait_s`` is the time the loop waited for the next batch.

    Spans (``utils/timing.py``): ``td_predict`` around the call; its phases
    (``timings``); a batch's ``next_batch`` (the loader), ``forward`` (a
    device span around the models' forwards), ``fetch_wait`` (this thread
    blocked on the batch's results) and ``write_batch`` (on the
    ``csv-writer`` thread), each with the batch's index as its id; inside
    ``write_batch`` in rotamer mode, ``write.rot_csv`` around each model's
    full-precision ``_rot.csv`` rows.

    ``start_batch`` resumes: the CSVs are appended from that batch on, then
    read back whole for decoding, and the one-hot ``{model}.csv`` is
    regenerated from the read-back matrix. ``ensemble`` averages the models'
    CSV-precision rows in one float64 running sum (so a resumed run gives
    the same bytes) and writes the artifact set as ``ensemble``; the models
    must share a head. ``quantize``: every model's convolutions in that mode
    of ``models/quantize.py`` (None: unquantized).

    ``mesh``: every model's ``Predictor`` over it. Every rank runs every
    batch (each its rows, and from a ``FrameSet`` voxelizes only those);
    process index 0 alone writes, and settles the map before the other
    ranks read it. The other ranks return None.
    """
    timer, waits = PhaseTimer(), PhaseTimer()
    path_to_output = Path.cwd() if path_to_output is None else Path(path_to_output)
    device = resolve_device(device, mesh)
    filter_list = get_pdb_keys_to_filter(blacklist) if blacklist else []
    from_frames = isinstance(dataset, FrameSet)
    writer = process_index() == 0
    if not writer:
        barrier("datasetmap")  # process 0 settles (and saves) the map first

    with timer.phase("datasetmap"):
        dataset_map_path = Path(dataset_map_path)
        if (
            not dataset_map_path.exists()
            and not dataset_map_path.is_absolute()
            and (path_to_output / dataset_map_path).exists()
        ):
            # a previous run with this output directory saved the map there
            dataset_map_path = path_to_output / dataset_map_path
        dmap = None
        if dataset_map_path.exists():
            head = dataset_map_path.read_text(errors="replace")[:64]
            if head.startswith("ignore_uncommon"):
                raise ValueError(
                    f"{dataset_map_path} is an SRB/new-format datasetmap "
                    "(count rows, no residue labels); prediction needs the "
                    "per-residue map. Delete it to regenerate, or point "
                    "dataset_map_path elsewhere."
                )
            dmap = load_datasetmap(dataset_map_path, is_old=True)
            if not (_datasetmap_matches_frames(dmap, dataset) if from_frames
                    else _datasetmap_matches_dataset(dmap, Path(dataset))):
                print(f"# {dataset_map_path} does not match the input "
                      f"{'structures' if from_frames else dataset} "
                      "(stale map from another dataset?) — regenerating")
                dmap = None
        if dmap is None:
            if from_frames:
                dmap = create_flat_dataset_map(dataset, filter_list,
                                               remove_blacklist_silently=True)
            else:
                dmap, _ = h5_dataset_map(Path(dataset), filter_list,
                                         remove_blacklist_silently=True)
            if writer:
                save_datasetmap(dmap, path_to_output / dataset_map_path.name)
    if writer:
        barrier("datasetmap")

    if not models:
        raise ValueError("no models given")
    resolved_models: list[tuple[nn.Module, str]] = []
    for m in models:
        model, model_name = _resolve_model(
            m, compute_dtype=compute_dtype, allow_random_weights=allow_random_weights)
        resolved_models.append((model, model_name))
    predictors = [Predictor(model, batch_size=batch_size, device=device, quantize=quantize,
                            mesh=mesh)
                  for model, _ in resolved_models]
    if len({p.dtype for p in predictors}) != 1:
        raise ValueError("the models compute in different dtypes "
                         f"{sorted(str(p.dtype) for p in predictors)}; they share one device batch")
    if ensemble:
        if len(predictors) < 2:
            raise ValueError("ensemble=True needs at least two models to average")
        heads = {p.n_classes for p in predictors}
        if len(heads) != 1:
            raise ValueError(
                "ensemble requires models with matching heads; got class "
                f"counts {sorted(heads)} — mixing 20-residue and 338-rotamer "
                "models cannot be averaged"
            )
    # the artifact format is per run: every head must match predict_rotamers
    for p, (_, name) in zip(predictors, resolved_models):
        if predict_rotamers and p.n_classes != 338:
            raise ValueError(
                f"predict_rotamers=True but model {name!r} has a "
                f"{p.n_classes}-class head (expected 338). Run 20-class "
                "models in a separate invocation without --predict_rotamers."
            )
        if not predict_rotamers and p.n_classes == 338:
            raise ValueError(
                f"model {name!r} has a 338-rotamer head; pass "
                "--predict_rotamers (or run it separately from 20-class "
                "models — the artifact format is per-run)."
            )

    resuming = start_batch > 0
    if from_frames:
        rows = None
        if mesh is not None:  # voxelize this rank's rows only (Predictor.to_device's)
            b = predictors[0].batch_size // mesh.shape["data"]
            rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        source = FrameBatchSource(dataset, dmap, predictors[0].batch_size, start_batch,
                                  device=device, rows=rows)
    else:
        source = FrameBatchLoader(Path(dataset), dmap, predictors[0].batch_size, start_batch,
                                  device=device)
    # host memory: each model's float16 decode matrix, plus one float64
    # running sum with ensemble; the probability CSVs stream to disk
    n_models = len(predictors)
    n_classes = predictors[0].n_classes
    decode_parts: list[list[np.ndarray]] = [[] for _ in predictors]
    ens_sum: np.ndarray | None = None
    ens_off = 0
    if ensemble and not resuming and writer:
        ens_sum = np.zeros((dmap.n_residues, n_classes), np.float64)

    class _ModelCSVStream:
        """Per-model append writer: the matrix (full precision in rotamer
        mode, float16 otherwise) and, in rotamer mode, the argmax one-hots."""

        def __init__(self, model_name: str, append: bool = resuming):
            mode = "ab" if append else "wb"
            self.main_path = path_to_output / (
                f"{model_name}_rot.csv" if predict_rotamers else f"{model_name}.csv")
            self.onehot_path = path_to_output / f"{model_name}.csv"
            self._main = open(self.main_path, mode)
            self._onehot = open(self.onehot_path, mode) if predict_rotamers else None

        def write(self, rows: np.ndarray) -> None:
            if predict_rotamers:
                with span("write.rot_csv"):
                    write_prediction_rows(self._main, rows, float16=False)
                onehot = ROTAMER_TO_AA_ONEHOT[rows.argmax(axis=1)]
                write_prediction_rows(self._onehot, onehot, float16=True)
            else:
                write_prediction_rows(self._main, rows, float16=True)

        def close(self) -> None:
            self._main.close()
            if self._onehot is not None:
                self._onehot.close()

    streams = [_ModelCSVStream(name) for _, name in resolved_models] if writer else []
    labels_file = (open(path_to_output / "encoded_labels.csv", "ab" if resuming else "wb")
                   if writer else None)
    try:
        with timer.phase("predict"):
            max_in_flight = max(2, 8 // n_models)
            # one writer thread drains a bounded queue in order, so the
            # append order (and resume, and the bytes) are the serial path's
            write_q: queue.Queue = queue.Queue(maxsize=4)
            writer_err: list[BaseException] = []
            stop = object()

            def _write_batch(outs_np, y, n):
                nonlocal ens_off
                y_int = y[:n].astype(np.int64)
                if not write_int_csv(labels_file, y_int):
                    np.savetxt(labels_file, y_int, delimiter=",", fmt="%i")
                for i, rows in enumerate(outs_np):
                    streams[i].write(rows)
                    decode_parts[i].append(rows.astype(np.float16))
                    if ens_sum is not None:
                        # what the streamed CSV holds, so that a resumed run
                        # (which reads the CSVs back) sums the same values
                        ens_sum[ens_off : ens_off + n] += (
                            rows if predict_rotamers else rows.astype(np.float16))
                ens_off += n

            def _writer():
                while True:
                    item = write_q.get()
                    try:
                        if item is stop:
                            return
                        if not writer_err:  # after an error, drain without writing
                            *batch, index = item
                            with span("write_batch", index):
                                _write_batch(*batch)
                    except BaseException as e:  # noqa: BLE001 - re-raised on the caller's thread
                        writer_err.append(e)
                    finally:
                        write_q.task_done()

            writer_th = threading.Thread(target=_writer, name="csv-writer", daemon=True)
            writer_th.start()

            batches = iter(source)
            labels: dict[int, np.ndarray] = {}  # batch index -> its labels, until written

            def _frames():
                for index in range(start_batch, source.n_batches):
                    with waits.phase("next_batch", index):
                        X, labels[index], n_valid = next(batches)
                    yield X, n_valid, index

            try:
                for outs_np, n, index in predict_pipeline(predictors, _frames(), max_in_flight):
                    if writer_err:
                        raise writer_err[0]
                    y = labels.pop(index)
                    if writer:
                        write_q.put((outs_np, y, n, index))
            finally:
                batches.close()
                write_q.put(stop)
                writer_th.join()
            if writer_err:
                raise writer_err[0]
    finally:
        if labels_file is not None:
            labels_file.close()
        for st in streams:
            st.close()
    if not writer:
        return None

    def _emit_outputs(probs, model_name, *, read_back, write_csv=False, main_csv=None):
        """Decode one model's matrix and write its artifacts other than the
        streamed CSVs (``write_csv``: the ensemble's CSVs too). Returns
        (decoded, full matrix), the full matrix read back from the CSV on a
        resumed run."""
        with timer.phase("write"):
            if write_csv:
                st = _ModelCSVStream(model_name, append=False)
                st.write(probs)
                st.close()
                main_csv = st.main_path
            save_srb_datasetmap(dmap, model_name, path_to_output)

        with timer.phase("decode"):
            if read_back:
                probs = load_prediction_matrix(main_csv, dtype=np.float64)
                if probs.shape[0] != dmap.n_residues:
                    raise ValueError(
                        f"Resume mismatch: {main_csv} holds {probs.shape[0]} "
                        f"rows but the dataset map has {dmap.n_residues} "
                        "residues — was --start_batch consistent with the "
                        "previous run's batch size?"
                    )
                if predict_rotamers:
                    # the appended one-hot file may be a batch off after a
                    # crash: regenerate it from the validated matrix
                    onehot20 = ROTAMER_TO_AA_ONEHOT[probs.argmax(axis=1)]
                    with open(path_to_output / f"{model_name}.csv", "wb") as f:
                        write_prediction_rows(f, onehot20, float16=True)
            # decoded from float16, as a reader of the float16 CSV would,
            # the NMR consensus's (prev + cur) / 2 included
            decoded = extract_sequences(
                dmap, probs.astype(np.float16),
                rotamer_categories=ROTAMER_CATEGORIES if predict_rotamers else None,
                is_consensus=is_consensus,
            )

        with timer.phase("write"):
            save_dict_to_fasta(decoded.pdb_to_sequence, model_name, path_to_output)
            save_dict_to_fasta(decoded.pdb_to_real_sequence, "dataset", path_to_output)
            if decoded.pdb_to_consensus:
                save_dict_to_fasta(decoded.pdb_to_consensus, model_name + "_consensus",
                                   path_to_output)
                save_consensus_probs(decoded.pdb_to_consensus_prob, model_name, path_to_output)
        return decoded, probs

    loader_wait_s = waits.phases.get("next_batch", 0.0)
    result: PredictionResult | None = None
    for model_i, (predictor, (_, model_name)) in enumerate(zip(predictors, resolved_models)):
        probs = (np.concatenate(decode_parts[model_i]) if decode_parts[model_i]
                 else np.zeros((0, predictor.n_classes), np.float16))
        decode_parts[model_i] = []  # freed as each model is decoded
        decoded, full_probs = _emit_outputs(
            probs, model_name, read_back=resuming, main_csv=streams[model_i].main_path)
        if ensemble and resuming:
            # the read-back matrices are the whole run's
            m = np.asarray(full_probs, dtype=np.float64)
            ens_sum = m if ens_sum is None else ens_sum + m
        result = PredictionResult(dmap, *decoded.astuple(), timings=timer.summary(),
                                  loader_wait_s=loader_wait_s)

    if ensemble:
        decoded, _ = _emit_outputs(ens_sum / n_models, "ensemble", read_back=False,
                                   write_csv=True)
        result = PredictionResult(dmap, *decoded.astuple(), timings=timer.summary(),
                                  loader_wait_s=loader_wait_s)
    return result


def _structure_model_key(model) -> tuple:
    """Identity of a ``predict_structure`` model argument: paths key on
    (string, mtime, size) so an updated checkpoint is re-resolved; modules
    on their id, kept valid by the cache entry's strong reference."""
    if isinstance(model, (str, Path)):
        s = str(model)
        p = Path(s.split("@", 1)[1]) if "@" in s else Path(s)
        try:
            st = p.stat()
            return ("path", s, st.st_mtime_ns, st.st_size)
        except OSError:
            return ("name", s)  # bare registry name
    return ("obj", id(model))


# (model key, batch size, device, mesh, random-weight opt-in) -> (Predictor,
# model name, the model argument). A bounded LRU so callers looping
# structures through predict_structure keep their models loaded; the lock
# covers lookup, insert and eviction for concurrent callers.
_STRUCTURE_PREDICTOR_CACHE: collections.OrderedDict = collections.OrderedDict()
_STRUCTURE_PREDICTOR_CAPACITY = 4
_STRUCTURE_PREDICTOR_LOCK = threading.Lock()


def predict_structure(
    structure_or_path,
    model,
    codec=None,
    gaussian: bool = True,
    batch_size: int = 512,
    device: torch.device | str | None = None,
    allow_random_weights: bool = False,
    mesh: Mesh | None = None,
):
    """PDB -> frames -> probabilities, voxelizer and CNN back to back on the
    device (over ``mesh``'s data axis when given: each rank runs its rows,
    and returns every row). Returns (probs (R, n_classes), FrameAtoms)."""
    from ..models import MODEL_REGISTRY
    from ..structure import Structure, load_pdb
    from ..voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    if not isinstance(structure_or_path, Structure):
        structure_or_path = load_pdb(Path(structure_or_path))
    device = resolve_device(device, mesh)
    # the mesh by identity, as the JAX package keys it: a cached entry holds
    # the mesh, so its id is not reused while the entry lives
    key = (_structure_model_key(model), batch_size, str(device),
           None if mesh is None else id(mesh), bool(allow_random_weights))
    with _STRUCTURE_PREDICTOR_LOCK:
        hit = _STRUCTURE_PREDICTOR_CACHE.get(key)
        if hit is not None:
            _STRUCTURE_PREDICTOR_CACHE.move_to_end(key)
    if hit is not None:
        predictor, model_name = hit[0], hit[1]
    else:
        resolved, model_name = _resolve_model(
            model, allow_random_weights=allow_random_weights
        )
        predictor = Predictor(resolved, batch_size=batch_size, device=device, mesh=mesh)
        with _STRUCTURE_PREDICTOR_LOCK:
            _STRUCTURE_PREDICTOR_CACHE[key] = (predictor, model_name, model)
            while len(_STRUCTURE_PREDICTOR_CACHE) > _STRUCTURE_PREDICTOR_CAPACITY:
                _STRUCTURE_PREDICTOR_CACHE.popitem(last=False)
    if codec is None:
        spec = MODEL_REGISTRY.get(model_name)
        codec = Codec.from_string(spec.codec) if spec else Codec.CNOCACB()
    elif isinstance(codec, str):
        codec = Codec.from_string(codec)
    fa = structure_to_frame_atoms(structure_or_path, codec)
    frames = voxelize_frame_atoms(fa, codec, gaussian=gaussian, device=device)
    return predictor.predict_probs(frames), fa
