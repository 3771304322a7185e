"""Training on PyTorch: the port of ``timed_design_tpu/train/train.py``.

Softmax cross-entropy on float32 logits against one-hot labels (optionally
class-weighted), top-1 and top-3 accuracy, Adam (``optax.adam``'s defaults)
with the learning rate of an optax schedule set before every step,
BatchNorm with Flax's statistics (``models/layers.py::BatchNorm3d``) and
dropout drawn from one ``torch.Generator`` per run. Eval metrics are summed
over each batch's valid rows; early stopping restores the best epoch's
weights. Checkpoints are the JAX package's npz, in Flax names and layouts,
so ``Name@ckpt.npz`` loads a checkpoint written here in either package.

The module owns its parameters: the train step updates it and its optimizer
in place. Everything runs on the card unless the caller names the CPU.

Without a mesh a batch is cut to its valid rows and never padded. Over a
mesh (``parallel/``, one process per card) every rank sees the same global
batch, filled up to a multiple of the data axis with repeats of its valid
rows as the JAX package fills it, and takes its own rows: each rank's loss
is its share of the global mean, BatchNorm takes the global batch's
statistics, the gradients and metrics are summed over the data group, and
Adam steps the same on every rank. Over a model axis the layers
``param_shardings`` marks run split (``parallel/tensor_parallel.py``), and a
checkpoint gathers them whole.
"""
from __future__ import annotations

import dataclasses
import json
import math
import typing as t

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine.predictor import resolve_device
from ..parallel import replicate, shard_batch
from ..parallel.distributed import process_index
from ..parallel.mesh import Mesh, NamedSharding, all_reduce, batch_over
from ..parallel.tensor_parallel import gather_state_dict, shard_model_axis
from ..models import (
    TIMED,
    DenseNet3D,
    ProDCoNN,
    densenet_variables_to_state_dict,
    flax_variables_to_state_dict,
    load_checkpoint_build_kwargs,  # noqa: F401  (re-exported: the npz reader)
    load_checkpoint_params,  # noqa: F401  (re-exported: the npz reader)
    prodconn_variables_to_state_dict,
    state_dict_to_densenet_variables,
    state_dict_to_flax_variables,
    state_dict_to_prodconn_variables,
)
from ..utils.timing import device_span, span, traced

# family -> (state_dict -> Flax variables, Flax variables -> state_dict)
_LAYOUTS = (
    (TIMED, state_dict_to_flax_variables, flax_variables_to_state_dict),
    (ProDCoNN, state_dict_to_prodconn_variables, prodconn_variables_to_state_dict),
    (DenseNet3D, state_dict_to_densenet_variables, densenet_variables_to_state_dict),
)


@dataclasses.dataclass
class TrainState:
    """A module in training, its optimizer and the count of steps taken."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _layout(module: nn.Module) -> tuple[t.Callable, t.Callable]:
    for cls, to_flax, from_flax in _LAYOUTS:
        if isinstance(module, cls):
            return to_flax, from_flax
    raise TypeError(f"no Flax layout for {type(module).__name__}")


def flax_variables(module: nn.Module) -> dict:
    """The module's weights as the JAX package's ``{"params",
    "batch_stats"}`` tree of numpy arrays; the layers split over a model
    axis gathered whole (a collective over the model group)."""
    return _layout(module)[0](gather_state_dict(module, module.state_dict()))


def param_shardings(params: dict, mesh: Mesh) -> dict:
    """The tensor-parallel layout of a Flax-named ``params`` tree (the JAX
    package's ``param_shardings``): the output-channel (last) axis of any
    ``kernel`` of rank >= 2 whose size divides the ``model`` axis on
    ``"model"``; everything else replicated. ``shard_model_axis`` splits
    exactly these layers."""
    n_model = mesh.shape["model"]

    def rule(key: str, x) -> NamedSharding:
        shape = np.shape(x)
        if n_model > 1 and len(shape) >= 2 and shape[-1] % n_model == 0 and key == "kernel":
            return NamedSharding(mesh, (None,) * (len(shape) - 1) + ("model",))
        return NamedSharding(mesh, ())

    def walk(tree: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict) else rule(k, v) for k, v in tree.items()}

    return walk(params)


def balanced_class_weights(labels, n_classes: int) -> np.ndarray:
    """Inverse-frequency class weights, sklearn ``compute_class_weight(
    'balanced')`` convention: ``n_samples / (n_present_classes * count_c)``
    for each class present in ``labels``; absent classes get weight 0."""
    counts = np.bincount(np.asarray(labels, np.int64), minlength=n_classes)
    counts = counts.astype(np.float64)
    present = counts > 0
    if not present.any():
        raise ValueError("no labels to balance")
    w = np.zeros(n_classes, np.float64)
    w[present] = counts.sum() / (present.sum() * counts[present])
    return w


def _softmax_cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row ``-sum(y * log_softmax(logits))``, as optax computes it."""
    return -(y * F.log_softmax(logits, dim=-1)).sum(-1)


def _hits(logits: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-1 and top-3 hits (float32 0/1) of the logits on the
    one-hot labels."""
    labels = y.argmax(-1)
    top1 = (logits.argmax(-1) == labels).float()
    top3 = (logits.topk(3, dim=-1).indices == labels[:, None]).any(-1).float()
    return top1, top3


def _sum_grads(module: nn.Module, group) -> None:
    """Every parameter's gradient summed over ``group``, in one collective
    over one flat buffer."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(module: nn.Module, optimizer: torch.optim.Optimizer, class_weights=None,
                    mesh: Mesh | None = None):
    """One optimizer step at the optimizer's current learning rate:
    ``(x, y, generator=None) -> {"loss", "top1", "top3"}``.

    ``x`` (B, 21, 21, 21, C) frames and ``y`` (B, n_classes) one-hot float32
    labels on the module's device; ``generator`` draws the dropout masks.
    The module runs in training mode (batch statistics, dropout). The
    metrics are 0-d tensors left on the device: reading one waits for the
    step. ``class_weights`` ((n_classes,)) weights each row's loss by its
    label's weight, normalised by the batch's total weight; top-1 and top-3
    stay unweighted. After the step each parameter's ``.grad`` holds its
    gradient.

    Over ``mesh``, ``x`` and ``y`` are this rank's rows of a global batch
    split over the data axis (``shard_batch``): the loss is this rank's
    share of the global mean (with class weights, over the global weight
    sum), the gradients are summed over the data group before the step
    (``.grad`` then holds the global batch's gradient), and the metrics
    are the global batch's."""
    cw = None
    if class_weights is not None:
        device = next(module.parameters()).device
        cw = torch.as_tensor(np.asarray(class_weights), dtype=torch.float32).to(device)

    group = None if mesh is None else mesh.data_group
    n_data = 1 if mesh is None else mesh.shape["data"]

    def train_step(x: torch.Tensor, y: torch.Tensor,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        module.train()
        optimizer.zero_grad(set_to_none=True)
        with batch_over(mesh):
            logits = module(x, logits=True, generator=generator)
        ce = _softmax_cross_entropy(logits, y)
        n = x.shape[0] * n_data
        if cw is None:
            loss = ce.sum() / n
        else:
            w = y @ cw
            total = all_reduce(w.sum().reshape(1), group)[0]
            loss = (ce * w).sum() / total.clamp_min(1e-9)
        loss.backward()
        if group is not None:
            _sum_grads(module, group)
        optimizer.step()
        with torch.no_grad():
            top1, top3 = _hits(logits, y)
            m = all_reduce(torch.stack([loss.detach(), top1.sum(), top3.sum()]), group)
        return {"loss": m[0], "top1": m[1] / n, "top3": m[2] / n}

    return train_step


def make_eval_step(module: nn.Module, mesh: Mesh | None = None):
    """The eval step ``(x, y, n_valid) -> sums`` over the first ``n_valid``
    rows: ``loss_sum``, ``top1_sum``, ``top3_sum`` and the row count ``n``,
    0-d float32 tensors on the device. Evaluation mode: running BatchNorm
    statistics, no dropout. Over ``mesh``, ``x`` and ``y`` are this rank's
    rows of a global batch split over the data axis, masked by their global
    row index against ``n_valid``, and the sums are summed over the data
    group."""

    def eval_step(x: torch.Tensor, y: torch.Tensor, n_valid: int) -> dict[str, torch.Tensor]:
        module.eval()
        if mesh is not None:
            # this rank's rows start at data_index * rows of the global batch
            n_valid = min(max(n_valid - mesh.data_index * x.shape[0], 0), x.shape[0])
        with torch.inference_mode(), batch_over(mesh):
            logits = module(x, logits=True)[:n_valid]
            y = y[:n_valid]
            top1, top3 = _hits(logits, y)
            sums = torch.stack([_softmax_cross_entropy(logits, y).sum(), top1.sum(),
                                top3.sum(), torch.tensor(float(n_valid), device=logits.device)])
            if mesh is not None:
                all_reduce(sums, mesh.data_group)
            return dict(zip(("loss_sum", "top1_sum", "top3_sum", "n"), sums))

    return eval_step


def _to_device(a, device: torch.device) -> torch.Tensor:
    """Host (numpy) or device frames and labels -> float32 on ``device``."""
    return torch.as_tensor(a).to(device, torch.float32, non_blocking=True)


def _concat(a, b):
    """Rows of ``b`` after ``a``'s: numpy or torch, as ``a`` is."""
    return torch.cat([a, torch.as_tensor(b, device=a.device)]) if isinstance(a, torch.Tensor) \
        else np.concatenate([a, b])


def _zero_rows(a, n: int):
    """``n`` zero rows shaped as ``a``'s."""
    if isinstance(a, torch.Tensor):
        return a.new_zeros((n, *a.shape[1:]))
    return np.zeros((n, *np.shape(a)[1:]), np.asarray(a).dtype)


def fill_batch(X, y, n_valid: int, n_data: int = 1):
    """A batch's rows for a train step over ``n_data`` data ranks, as the
    JAX package's ``fit`` fills them: the loader's padding dropped (zero
    frames would pollute the BatchNorm statistics), then ``max(n_data,
    ceil(n_valid / n_data) * n_data)`` rows, the valid ones followed by
    repeats of them in order. At ``n_data`` 1 that is the valid rows."""
    keep = max(n_data, -(-n_valid // n_data) * n_data)
    if n_valid == X.shape[0] and keep == n_valid:
        return X, y
    src = np.arange(keep - n_valid) % n_valid
    return _concat(X[:n_valid], X[src]), _concat(y[:n_valid], y[src])


def evaluate(module: nn.Module, loader: t.Iterable, step_fn=None,
             mesh: Mesh | None = None) -> dict:
    """Evaluation-mode metrics over a loader of ``(X, y, n_valid)`` batches,
    on the device that holds the module: ``{"loss", "top1", "top3", "n"}``
    averaged over the valid rows only. Sums stay on the device, in float64,
    and are read once. An empty loader gives NaN metrics and ``n`` 0, never
    a perfect 0.0 loss that early stopping would keep as its best.

    Over ``mesh`` each batch is zero-padded to a multiple of the data axis
    (the mask by global row index leaves those rows out), each rank runs
    its rows and the sums are the global batch's."""
    device = next(module.parameters()).device
    step_fn = step_fn if step_fn is not None else make_eval_step(module, mesh)
    keys = ("loss_sum", "top1_sum", "top3_sum", "n")
    totals = torch.zeros(len(keys), dtype=torch.float64, device=device)
    for X, y, n_valid in loader:
        if mesh is not None:
            n_data = mesh.shape["data"]
            pad = -X.shape[0] % n_data
            if pad:
                X, y = _concat(X, _zero_rows(X, pad)), _concat(y, _zero_rows(y, pad))
            X, y = shard_batch(X, mesh), shard_batch(y, mesh)
        out = step_fn(_to_device(X, device), _to_device(y, device), n_valid)
        totals += torch.stack([out[k] for k in keys]).double()
    loss_sum, top1_sum, top3_sum, n = totals.tolist()
    if n == 0:
        return {"loss": float("nan"), "top1": float("nan"), "top3": float("nan"), "n": 0}
    return {"loss": loss_sum / n, "top1": top1_sum / n, "top3": top3_sum / n, "n": int(n)}


def make_lr_schedule(name: str, base_lr: float, total_steps: int, warmup_steps: int = 0):
    """The learning rate of optax's schedule at each step, a callable
    ``step -> lr`` (steps count from 0): ``constant`` (with a linear warmup
    from 0 over ``warmup_steps``, so step 0 has lr 0), or ``cosine``, a
    cosine decay to 0 over ``total_steps - warmup_steps`` steps after the
    warmup (``optax.warmup_cosine_decay_schedule(decay_steps=total_steps)``
    with a warmup, ``optax.cosine_decay_schedule(base_lr, total_steps)``
    without)."""

    def linear(step: int) -> float:  # optax.linear_schedule(0, base_lr, warmup_steps)
        frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
        return (0.0 - base_lr) * frac + base_lr

    if name == "constant":
        if warmup_steps:
            return linear
        return lambda step: base_lr
    if name == "cosine":
        if warmup_steps >= total_steps:
            raise ValueError(
                f"warmup_steps={warmup_steps} must be < total training "
                f"steps ({total_steps}) for a cosine schedule — nothing "
                f"would be left to decay over"
            )
        decay_steps = max(1, total_steps - warmup_steps)

        def cosine(step: int) -> float:  # optax.cosine_decay_schedule(base_lr, decay_steps)
            count = min(step, decay_steps)
            return base_lr * (0.5 * (1.0 + math.cos(math.pi * count / decay_steps)))

        if warmup_steps:
            return lambda step: linear(step) if step < warmup_steps else cosine(step - warmup_steps)
        return cosine
    raise ValueError(f"unknown lr schedule {name!r} (constant | cosine)")


def _flatten(tree: dict, prefix: str = "") -> dict[str, t.Any]:
    """Nested dict -> {"a/b/leaf": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _check_tree_shapes(fresh: dict, given: dict, what: str) -> None:
    """A warm-start tree against the module's own: the same leaves, each of
    the same shape, or a ValueError that names the leaf."""
    fresh_flat, given_flat = _flatten(fresh), _flatten(given)
    if set(given_flat) != set(fresh_flat):
        missing = sorted(set(fresh_flat) - set(given_flat))[:4]
        extra = sorted(set(given_flat) - set(fresh_flat))[:4]
        raise ValueError(
            f"init_weights {what} tree does not match the model: "
            f"missing={missing} extra={extra} — wrong architecture for "
            f"this warm start?"
        )
    for key in sorted(fresh_flat):
        got, want = tuple(np.shape(given_flat[key])), tuple(np.shape(fresh_flat[key]))
        if got != want:
            raise ValueError(
                f"init_weights {what}[{key}] has shape {got}, model "
                f"expects {want} (e.g. a different head size or input channel count)"
            )


def init_train_state(
    module: nn.Module,
    learning_rate: float = 1e-3,
    init_weights: dict | None = None,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> TrainState:
    """The module on ``device`` (the card unless the caller names the CPU)
    and a ``torch.optim.Adam`` over its parameters (b1 0.9, b2 0.999, eps
    1e-8: ``optax.adam``'s update).

    ``init_weights``, a ``{"params", "batch_stats"}`` tree in Flax layout
    (``load_checkpoint_params``), warm-starts the module: each leaf is
    checked against the module's own tree and a mismatch raises naming the
    leaf. Without ``batch_stats`` the module keeps its running statistics.
    On the card in float32, cuDNN's TF32 is turned off, as the predictor
    does.

    ``mesh``: the device defaults to the mesh's; the weights are broadcast
    from the mesh's first rank, so every rank starts equal, and then the
    layers ``param_shardings`` puts on the model axis are cut to this
    rank's slice (``shard_model_axis``) before the optimizer is built."""
    device = resolve_device(device, mesh)
    if init_weights is not None:
        to_flax, from_flax = _layout(module)
        fresh = to_flax(module.state_dict())
        given_p = init_weights.get("params")
        if given_p is None:
            raise ValueError("init_weights must contain a 'params' tree")
        _check_tree_shapes(fresh["params"], given_p, "params")
        variables = {"params": given_p, "batch_stats": fresh["batch_stats"]}
        given_bs = init_weights.get("batch_stats")
        if fresh["batch_stats"] and given_bs:
            _check_tree_shapes(fresh["batch_stats"], given_bs, "batch_stats")
            variables["batch_stats"] = given_bs
        module.load_state_dict(from_flax(variables))
    module.to(device)
    if mesh is not None:
        shard_model_axis(replicate(module, mesh), mesh)
    if device.type == "cuda" and module.compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
    return TrainState(module, torch.optim.Adam(module.parameters(), lr=learning_rate))


@traced("train.fit")
def fit(
    module: nn.Module,
    loader: t.Iterable,
    n_classes: int,
    input_channels: int = 5,
    learning_rate: float = 1e-3,
    epochs: int = 1,
    seed: int = 0,
    log_every: int = 10,
    val_loader: t.Iterable | None = None,
    patience: int | None = None,
    min_delta: float = 0.0,
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    init_weights: dict | None = None,
    class_weights=None,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> TrainState:
    """Train ``module`` in place over a loader of ``(X, y, n_valid)``
    batches (a ``FrameBatchSource``, or host arrays) for ``epochs`` epochs
    on ``device`` (the card unless the caller names the CPU).

    Each batch is cut to its ``n_valid`` rows: padding frames would pollute
    the BatchNorm statistics. The step's metrics are read, and a ``step k:``
    line printed, every ``log_every`` steps only. ``seed`` seeds the
    generator of the dropout masks; the module's initial weights are its
    own, or ``init_weights`` (see ``init_train_state``). ``class_weights``
    weights the training loss; validation stays unweighted.

    With ``val_loader``, evaluation-mode metrics run after every epoch; with
    ``patience`` as well, training stops after that many epochs without a
    ``min_delta`` improvement of the validation loss, and copies of the best
    epoch's weights are loaded back. ``lr_schedule='cosine'`` decays over
    ``epochs * loader.n_batches`` steps after ``warmup_steps`` of linear
    warmup.

    ``mesh`` (``parallel.make_mesh``): data- and tensor-parallel training
    over it, every rank fed the same batches. Each batch is filled up to a
    multiple of the data axis with repeats of its valid rows
    (``fill_batch``) and each rank steps on its rows; the dropout masks
    come from a generator per data index (``seed * n_data + data_index``),
    shared by a data row's model ranks.

    Spans (``utils/timing.py``), each with the step number as its id:
    ``train.fit`` around the call, ``train.next_batch`` (the loader's
    ``next``), ``train.step`` (the batch to the device and the step's
    launch), ``train.log`` (the metrics read every ``log_every`` steps,
    which waits for the device) and the device span ``train.step_device``
    (forward, backward and Adam on the card).
    """
    if patience is not None and val_loader is None:
        raise ValueError("patience requires a val_loader to monitor")
    n_batches = getattr(loader, "n_batches", None)
    if lr_schedule != "constant" and n_batches is None:
        raise ValueError("a decaying lr_schedule needs loader.n_batches to size the decay")
    lr = make_lr_schedule(lr_schedule, learning_rate, (n_batches or 1) * epochs, warmup_steps)
    state = init_train_state(module, learning_rate, init_weights, device, mesh)
    device = next(module.parameters()).device
    n_data = 1 if mesh is None else mesh.shape["data"]
    data_index = 0 if mesh is None else mesh.data_index
    generator = torch.Generator(device=device).manual_seed(seed * n_data + data_index)
    on_mesh = {} if mesh is None else {"mesh": mesh}
    step_fn = make_train_step(module, state.optimizer, class_weights, **on_mesh)
    eval_step = make_eval_step(module, **on_mesh) if val_loader is not None else None
    best_val = float("inf")
    best_weights = None
    epochs_since_best = 0
    for epoch in range(epochs):
        batches = iter(loader)
        while True:
            with span("train.next_batch", state.step):
                batch = next(batches, None)
            if batch is None:
                break
            X, y, n_valid = batch
            if state.step == 0:
                if y.shape[1] != n_classes:
                    raise ValueError(
                        f"loader yields {y.shape[1]}-class labels but "
                        f"n_classes={n_classes} — wrong dataset for this head?"
                    )
                if X.shape[-1] != input_channels:
                    raise ValueError(
                        f"loader yields {X.shape[-1]}-channel frames but "
                        f"input_channels={input_channels}"
                    )
            with span("train.step", state.step):
                for group in state.optimizer.param_groups:
                    group["lr"] = lr(state.step)
                X, y = fill_batch(X, y, n_valid, n_data)
                if mesh is not None:
                    X, y = shard_batch(X, mesh), shard_batch(y, mesh)
                X, y = _to_device(X, device), _to_device(y, device)
                with device_span("train.step_device", state.step, device=device):
                    metrics = step_fn(X, y, generator)
            if state.step % log_every == 0:
                with span("train.log", state.step):
                    m = {k: float(v) for k, v in metrics.items()}
                print(f"step {state.step}: loss={m['loss']:.4f} top1={m['top1']:.3f} "
                      f"top3={m['top3']:.3f}")
            state.step += 1
        if val_loader is not None:
            vm = evaluate(module, val_loader, step_fn=eval_step, **on_mesh)
            print(
                f"epoch {epoch}: val_loss={vm['loss']:.4f} "
                f"val_top1={vm['top1']:.3f} val_top3={vm['top3']:.3f} "
                f"({vm['n']} residues)"
            )
            if vm["loss"] < best_val - min_delta:
                best_val = vm["loss"]
                epochs_since_best = 0
                if patience is not None:
                    best_weights = {k: v.detach().clone() for k, v in module.state_dict().items()}
            else:
                epochs_since_best += 1
                if patience is not None and epochs_since_best >= patience:
                    # NaN divergence means no epoch ever improved on inf:
                    # there is nothing to restore, and saying "restoring
                    # best" while returning the diverged weights would lie
                    restored = (
                        f"restoring best (val_loss={best_val:.4f})"
                        if best_weights is not None
                        else "no finite val_loss ever recorded — keeping "
                             "final weights (training diverged?)"
                    )
                    print(
                        f"early stop at epoch {epoch}: no val_loss "
                        f"improvement > {min_delta} for {patience} "
                        f"epoch(s); {restored}"
                    )
                    break
    if best_weights is not None:
        module.load_state_dict(best_weights)
    return state


def save_checkpoint(state: TrainState, path, build_kwargs=None) -> None:
    """The JAX package's npz checkpoint of the module: flat
    ``params/...`` and ``batch_stats/...`` entries in Flax names and layouts,
    and ``build_kwargs`` (architecture overrides, such as ``filters``) as a
    JSON ``__build_kwargs__`` entry, so that ``Name@ckpt.npz`` rebuilds the
    module in either package. Layers split over a model axis are gathered
    whole first, so under a world every rank calls it; process index 0
    writes."""
    variables = flax_variables(state.module)
    if process_index() != 0:
        return
    flat = {}
    for prefix in ("params", "batch_stats"):
        for key, leaf in sorted(_flatten(variables[prefix]).items()):
            flat[f"{prefix}/{key}"] = leaf
    if build_kwargs:
        flat["__build_kwargs__"] = np.asarray(json.dumps(build_kwargs))
    np.savez(path, **flat)
