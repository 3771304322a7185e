"""Weights carried across from the JAX package.

One converter per model family maps a Flax variable tree (numpy leaves) onto
the PyTorch module's ``state_dict``: TIMED
(``flax_variables_to_state_dict``), ProDCoNN and DenseNet/DenseCPD. Conv
kernels go from DHWIO to OIDHW, Dense kernels from (in, out) to (out, in),
BatchNorm ``scale/bias/mean/var`` to ``weight/bias/running_mean/
running_var``. The inverse converters (``state_dict_to_*``) map a
``state_dict`` back to Flax's names and layouts, for the checkpoints the
port's trainer writes. The npz readers are the counterparts of
``load_checkpoint_params`` / ``load_checkpoint_build_kwargs``
(timed_design_tpu/train/train.py), reimplemented because that module imports
JAX; they read the same flat ``params/...`` and ``batch_stats/...`` files.
"""
from __future__ import annotations

import json

import numpy as np
import torch


def _kernel(k) -> torch.Tensor:
    """Flax conv kernel DHWIO -> PyTorch OIDHW."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2))))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, prefix: str, node: dict) -> None:
    sd[prefix + "weight"] = _kernel(node["kernel"])
    sd[prefix + "bias"] = _t(node["bias"])


def _dense(sd: dict, prefix: str, node: dict) -> None:
    sd[prefix + "weight"] = _t(np.asarray(node["kernel"]).T)
    sd[prefix + "bias"] = _t(node["bias"])


def _bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[prefix + "weight"] = _t(params["scale"])
    sd[prefix + "bias"] = _t(params["bias"])
    sd[prefix + "running_mean"] = _t(stats["mean"])
    sd[prefix + "running_var"] = _t(stats["var"])
    sd[prefix + "num_batches_tracked"] = torch.tensor(0)


def flax_variables_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Flax TIMED ``{"params", "batch_stats"}`` -> TIMED ``state_dict``.

    Flax names ``ConvBlock_i/Conv_0`` and ``ConvBlock_i/BatchNorm_0`` become
    ``blocks.i.conv`` and ``blocks.i.bn``; the top-level ``Conv_0`` is the
    1x1x1 ``head``.
    """
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    i = 0
    while f"ConvBlock_{i}" in params:
        block = params[f"ConvBlock_{i}"]
        _conv(sd, f"blocks.{i}.conv.", block["Conv_0"])
        _bn(sd, f"blocks.{i}.bn.", block["BatchNorm_0"], stats[f"ConvBlock_{i}"]["BatchNorm_0"])
        i += 1
    _conv(sd, "head.", params["Conv_0"])
    return sd


def prodconn_variables_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Flax ProDCoNN ``{"params"}`` -> ProDCoNN ``state_dict``: ``Conv_i``
    becomes ``convs.i`` and ``Dense_i`` ``dense.i``. The module flattens in
    the Flax (NDHWC) order, so ``Dense_0``'s rows stay as they are."""
    params = variables["params"]
    sd: dict[str, torch.Tensor] = {}
    for i in range(4):
        _conv(sd, f"convs.{i}.", params[f"Conv_{i}"])
    for i in range(2):
        _dense(sd, f"dense.{i}.", params[f"Dense_{i}"])
    return sd


def densenet_variables_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Flax DenseNet3D (DenseNet, DenseCPD) -> ``DenseNet3D`` ``state_dict``.

    ``Conv_0`` is the ``stem``; ``_DenseLayer_k/{BatchNorm_0, Conv_0,
    BatchNorm_1, Conv_1}``, numbered across the blocks, become
    ``layers.k.{bn0, conv0, bn1, conv1}``; ``_Transition_i/{BatchNorm_0,
    Conv_0}`` become ``transitions.i.{bn, conv}``; the last ``BatchNorm_0``
    and ``Dense_0`` are ``bn`` and ``head``.
    """
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "stem.", params["Conv_0"])
    k = 0
    while f"_DenseLayer_{k}" in params:
        node, st = params[f"_DenseLayer_{k}"], stats[f"_DenseLayer_{k}"]
        for j in range(2):
            _bn(sd, f"layers.{k}.bn{j}.", node[f"BatchNorm_{j}"], st[f"BatchNorm_{j}"])
            _conv(sd, f"layers.{k}.conv{j}.", node[f"Conv_{j}"])
        k += 1
    i = 0
    while f"_Transition_{i}" in params:
        node, st = params[f"_Transition_{i}"], stats[f"_Transition_{i}"]
        _bn(sd, f"transitions.{i}.bn.", node["BatchNorm_0"], st["BatchNorm_0"])
        _conv(sd, f"transitions.{i}.conv.", node["Conv_0"])
        i += 1
    _bn(sd, "bn.", params["BatchNorm_0"], stats["BatchNorm_0"])
    _dense(sd, "head.", params["Dense_0"])
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _conv_to_flax(sd: dict, prefix: str) -> dict:
    """PyTorch OIDHW weight -> Flax DHWIO kernel, and the bias."""
    k = sd[prefix + "weight"].detach().cpu().numpy()
    return {"kernel": np.ascontiguousarray(np.transpose(k, (2, 3, 4, 1, 0))),
            "bias": _np(sd[prefix + "bias"])}


def _dense_to_flax(sd: dict, prefix: str) -> dict:
    return {"kernel": np.ascontiguousarray(_np(sd[prefix + "weight"]).T),
            "bias": _np(sd[prefix + "bias"])}


def _bn_to_flax(sd: dict, prefix: str) -> tuple[dict, dict]:
    """(params {scale, bias}, batch_stats {mean, var})."""
    return ({"scale": _np(sd[prefix + "weight"]), "bias": _np(sd[prefix + "bias"])},
            {"mean": _np(sd[prefix + "running_mean"]), "var": _np(sd[prefix + "running_var"])})


def state_dict_to_flax_variables(sd: dict) -> dict:
    """TIMED ``state_dict`` -> Flax ``{"params", "batch_stats"}`` (numpy
    leaves): the inverse of ``flax_variables_to_state_dict``."""
    params: dict = {}
    stats: dict = {}
    i = 0
    while f"blocks.{i}.conv.weight" in sd:
        bn_p, bn_s = _bn_to_flax(sd, f"blocks.{i}.bn.")
        params[f"ConvBlock_{i}"] = {"Conv_0": _conv_to_flax(sd, f"blocks.{i}.conv."),
                                    "BatchNorm_0": bn_p}
        stats[f"ConvBlock_{i}"] = {"BatchNorm_0": bn_s}
        i += 1
    params["Conv_0"] = _conv_to_flax(sd, "head.")
    return {"params": params, "batch_stats": stats}


def state_dict_to_prodconn_variables(sd: dict) -> dict:
    """ProDCoNN ``state_dict`` -> Flax ``{"params", "batch_stats"}`` (no
    BatchNorm, so ``batch_stats`` is empty): the inverse of
    ``prodconn_variables_to_state_dict``."""
    params = {f"Conv_{i}": _conv_to_flax(sd, f"convs.{i}.") for i in range(4)}
    params.update({f"Dense_{i}": _dense_to_flax(sd, f"dense.{i}.") for i in range(2)})
    return {"params": params, "batch_stats": {}}


def state_dict_to_densenet_variables(sd: dict) -> dict:
    """``DenseNet3D`` ``state_dict`` -> Flax ``{"params", "batch_stats"}``:
    the inverse of ``densenet_variables_to_state_dict``."""
    params: dict = {"Conv_0": _conv_to_flax(sd, "stem.")}
    stats: dict = {}
    k = 0
    while f"layers.{k}.conv0.weight" in sd:
        node, st = params.setdefault(f"_DenseLayer_{k}", {}), stats.setdefault(f"_DenseLayer_{k}", {})
        for j in range(2):
            node[f"BatchNorm_{j}"], st[f"BatchNorm_{j}"] = _bn_to_flax(sd, f"layers.{k}.bn{j}.")
            node[f"Conv_{j}"] = _conv_to_flax(sd, f"layers.{k}.conv{j}.")
        k += 1
    i = 0
    while f"transitions.{i}.conv.weight" in sd:
        bn_p, bn_s = _bn_to_flax(sd, f"transitions.{i}.bn.")
        params[f"_Transition_{i}"] = {"BatchNorm_0": bn_p,
                                      "Conv_0": _conv_to_flax(sd, f"transitions.{i}.conv.")}
        stats[f"_Transition_{i}"] = {"BatchNorm_0": bn_s}
        i += 1
    params["BatchNorm_0"], stats["BatchNorm_0"] = _bn_to_flax(sd, "bn.")
    params["Dense_0"] = _dense_to_flax(sd, "head.")
    return {"params": params, "batch_stats": stats}


def load_checkpoint_params(path) -> dict:
    """Read a flat checkpoint npz back into nested {params, batch_stats}."""
    out: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            if key.startswith("__"):  # metadata entries, not weight leaves
                continue
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return out


def load_checkpoint_build_kwargs(path) -> dict:
    """Architecture overrides stored beside the weights (``filters``, ...);
    empty for checkpoints trained with registry defaults. JSON lists come
    back as tuples."""
    with np.load(path) as flat:
        if "__build_kwargs__" not in flat.files:
            return {}
        kw = json.loads(str(flat["__build_kwargs__"]))
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
