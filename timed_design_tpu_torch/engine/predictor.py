"""Batched prediction: frames -> per-residue probabilities (PyTorch).

The port of ``Predictor``, ``_resolve_model`` and ``predict_structure``
(timed_design_tpu/engine/predictor.py). The batch is fixed (the last one is
padded); up to ``max_in_flight`` batches are queued on the device before
the oldest result is fetched, each result copied once into a pinned host
buffer. ``load_dataset_and_predict`` (HDF5) is not ported yet.
"""
from __future__ import annotations

import collections
import sys
import threading
import typing as t
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..models import (
    ModelSpec,
    get_model_spec,
    load_checkpoint_build_kwargs,
    load_checkpoint_params,
    load_model,
)


def default_device() -> torch.device:
    """The CUDA device. The port runs on the card; the CPU only when the
    caller names it (``device="cpu"``), never as a silent fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    return torch.device("cuda")


class Predictor:
    """Fixed-batch forward pass of one model on one device."""

    def __init__(self, model: nn.Module, batch_size: int = 512,
                 device: torch.device | str | None = None):
        """``model``: a module whose forward maps (B, 21, 21, 21, C) frames
        to (B, n_classes) float32 probabilities and that names its
        ``compute_dtype`` (the frames' dtype on the device)."""
        self.device = torch.device(device) if device is not None else default_device()
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.n_classes = model.n_classes
        self.dtype = model.compute_dtype
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # cuDNN convolutions default to TF32; the float32 path means float32
            torch.backends.cudnn.allow_tf32 = False

    def to_device(self, chunk) -> torch.Tensor:
        """Pad to the batch, place on the device, cast to the compute dtype.

        Accepts host (numpy) or device (torch) frames; host frames go through
        pinned memory so the copy is asynchronous."""
        if isinstance(chunk, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(chunk))
            if self.device.type == "cuda":
                x = x.pin_memory()
            chunk = x
        x = chunk.to(self.device, non_blocking=True).to(self.dtype)
        n = x.shape[0]
        if n < self.batch_size:
            padded = x.new_zeros((self.batch_size, *x.shape[1:]))
            padded[:n] = x
            x = padded
        return x

    def _launch(self, frames, n_valid: int):
        """Queue one batch's forward and the copy of its result to a pinned
        host buffer; returns what ``_fetch`` needs to wait for it."""
        with torch.inference_mode():
            out = self.model(self.to_device(frames))
        if self.device.type != "cuda":
            return out, None, n_valid
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, n_valid

    @staticmethod
    def _fetch(host: torch.Tensor, done, n_valid: int) -> np.ndarray:
        if done is not None:
            done.synchronize()
        return host[:n_valid].numpy()

    def predict_stream(
        self, batches: t.Iterable[tuple[t.Any, int]], max_in_flight: int = 8,
    ) -> t.Iterator[np.ndarray]:
        """Pipelined prediction over (frames, n_valid) pairs: queues up to
        ``max_in_flight`` batches before waiting on the oldest. Yields
        (n_valid, n_classes) float32 arrays in input order."""
        pending: collections.deque = collections.deque()
        for frames, n_valid in batches:
            pending.append(self._launch(frames, n_valid))
            if len(pending) >= max_in_flight:
                yield self._fetch(*pending.popleft())
        while pending:
            yield self._fetch(*pending.popleft())

    def predict_probs(self, frames) -> np.ndarray:
        """Predict (N, n_classes) for any N; pads to the batch."""
        B = self.batch_size
        N = frames.shape[0]
        chunks = ((frames[s : s + B], min(B, N - s)) for s in range(0, N, B))
        parts = list(self.predict_stream(chunks))
        return np.concatenate(parts) if parts else np.empty((0, self.n_classes), np.float32)


def _resolve_model(m, compute_dtype: torch.dtype | None = None,
                   allow_random_weights: bool = False) -> tuple[nn.Module, str]:
    """Module -> itself; "Name@ckpt.npz" -> the registry architecture with
    the checkpoint's weights, converted by its family's converter
    (``ModelSpec.convert``); bare registry name -> random weights, refused
    unless ``allow_random_weights`` (benchmarks and tests only: random
    predictions cannot be told from real ones)."""
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
    spec: ModelSpec = load_model(m)
    if not allow_random_weights:
        raise ValueError(
            f"model {str(m)!r} resolves to registry architecture "
            f"{spec.name!r} with NO weights — predictions would be random "
            "garbage. Pass a 'Name@checkpoint.npz', or set "
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


# (model key, batch size, device, random-weight opt-in) -> (Predictor,
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
):
    """PDB -> frames -> probabilities, voxelizer and CNN back to back on the
    device. Returns (probs (R, n_classes), FrameAtoms)."""
    from ..models import MODEL_REGISTRY
    from ..structure import Structure, load_pdb
    from ..voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    if not isinstance(structure_or_path, Structure):
        structure_or_path = load_pdb(Path(structure_or_path))
    device = torch.device(device) if device is not None else default_device()
    key = (_structure_model_key(model), batch_size, str(device),
           bool(allow_random_weights))
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
        predictor = Predictor(resolved, batch_size=batch_size, device=device)
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
