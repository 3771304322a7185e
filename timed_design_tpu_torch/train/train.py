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
in place. One device, so no mesh: a batch is cut to its valid rows and never
padded. Everything runs on the card unless the caller names the CPU.
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

from ..engine.predictor import default_device
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
    "batch_stats"}`` tree of numpy arrays."""
    return _layout(module)[0](module.state_dict())


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


def make_train_step(module: nn.Module, optimizer: torch.optim.Optimizer, class_weights=None):
    """One optimizer step at the optimizer's current learning rate:
    ``(x, y, generator=None) -> {"loss", "top1", "top3"}``.

    ``x`` (B, 21, 21, 21, C) frames and ``y`` (B, n_classes) one-hot float32
    labels on the module's device; ``generator`` draws the dropout masks.
    The module runs in training mode (batch statistics, dropout). The
    metrics are 0-d tensors left on the device: reading one waits for the
    step. ``class_weights`` ((n_classes,)) weights each row's loss by its
    label's weight, normalised by the batch's total weight; top-1 and top-3
    stay unweighted. After the step each parameter's ``.grad`` holds its
    gradient."""
    cw = None
    if class_weights is not None:
        device = next(module.parameters()).device
        cw = torch.as_tensor(np.asarray(class_weights), dtype=torch.float32).to(device)

    def train_step(x: torch.Tensor, y: torch.Tensor,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        module.train()
        optimizer.zero_grad(set_to_none=True)
        logits = module(x, logits=True, generator=generator)
        ce = _softmax_cross_entropy(logits, y)
        if cw is None:
            loss = ce.mean()
        else:
            w = y @ cw
            loss = (ce * w).sum() / w.sum().clamp_min(1e-9)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            top1, top3 = _hits(logits, y)
        return {"loss": loss.detach(), "top1": top1.mean(), "top3": top3.mean()}

    return train_step


def make_eval_step(module: nn.Module):
    """The eval step ``(x, y, n_valid) -> sums`` over the first ``n_valid``
    rows: ``loss_sum``, ``top1_sum``, ``top3_sum`` and the row count ``n``,
    0-d float32 tensors on the device. Evaluation mode: running BatchNorm
    statistics, no dropout."""

    def eval_step(x: torch.Tensor, y: torch.Tensor, n_valid: int) -> dict[str, torch.Tensor]:
        module.eval()
        with torch.inference_mode():
            logits = module(x, logits=True)[:n_valid]
            y = y[:n_valid]
            top1, top3 = _hits(logits, y)
            return {"loss_sum": _softmax_cross_entropy(logits, y).sum(),
                    "top1_sum": top1.sum(), "top3_sum": top3.sum(),
                    "n": torch.tensor(float(n_valid), device=logits.device)}

    return eval_step


def _to_device(a, device: torch.device) -> torch.Tensor:
    """Host (numpy) or device frames and labels -> float32 on ``device``."""
    return torch.as_tensor(a).to(device, torch.float32, non_blocking=True)


def evaluate(module: nn.Module, loader: t.Iterable, step_fn=None) -> dict:
    """Evaluation-mode metrics over a loader of ``(X, y, n_valid)`` batches,
    on the device that holds the module: ``{"loss", "top1", "top3", "n"}``
    averaged over the valid rows only. Sums stay on the device, in float64,
    and are read once. An empty loader gives NaN metrics and ``n`` 0, never
    a perfect 0.0 loss that early stopping would keep as its best."""
    device = next(module.parameters()).device
    step_fn = step_fn if step_fn is not None else make_eval_step(module)
    keys = ("loss_sum", "top1_sum", "top3_sum", "n")
    totals = torch.zeros(len(keys), dtype=torch.float64, device=device)
    for X, y, n_valid in loader:
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
) -> TrainState:
    """The module on ``device`` (the card unless the caller names the CPU)
    and a ``torch.optim.Adam`` over its parameters (b1 0.9, b2 0.999, eps
    1e-8: ``optax.adam``'s update).

    ``init_weights``, a ``{"params", "batch_stats"}`` tree in Flax layout
    (``load_checkpoint_params``), warm-starts the module: each leaf is
    checked against the module's own tree and a mismatch raises naming the
    leaf. Without ``batch_stats`` the module keeps its running statistics.
    On the card in float32, cuDNN's TF32 is turned off, as the predictor
    does."""
    device = torch.device(device) if device is not None else default_device()
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
    if device.type == "cuda" and module.compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
    return TrainState(module, torch.optim.Adam(module.parameters(), lr=learning_rate))


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
    """
    if patience is not None and val_loader is None:
        raise ValueError("patience requires a val_loader to monitor")
    n_batches = getattr(loader, "n_batches", None)
    if lr_schedule != "constant" and n_batches is None:
        raise ValueError("a decaying lr_schedule needs loader.n_batches to size the decay")
    lr = make_lr_schedule(lr_schedule, learning_rate, (n_batches or 1) * epochs, warmup_steps)
    state = init_train_state(module, learning_rate, init_weights, device)
    device = next(module.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    step_fn = make_train_step(module, state.optimizer, class_weights)
    eval_step = make_eval_step(module) if val_loader is not None else None
    best_val = float("inf")
    best_weights = None
    epochs_since_best = 0
    for epoch in range(epochs):
        for X, y, n_valid in loader:
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
            for group in state.optimizer.param_groups:
                group["lr"] = lr(state.step)
            metrics = step_fn(_to_device(X[:n_valid], device), _to_device(y[:n_valid], device),
                              generator)
            if state.step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {state.step}: loss={m['loss']:.4f} top1={m['top1']:.3f} "
                      f"top3={m['top3']:.3f}")
            state.step += 1
        if val_loader is not None:
            vm = evaluate(module, val_loader, step_fn=eval_step)
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
    module in either package."""
    variables = flax_variables(state.module)
    flat = {}
    for prefix in ("params", "batch_stats"):
        for key, leaf in sorted(_flatten(variables[prefix]).items()):
            flat[f"{prefix}/{key}"] = leaf
    if build_kwargs:
        flat["__build_kwargs__"] = np.asarray(json.dumps(build_kwargs))
    np.savez(path, **flat)
