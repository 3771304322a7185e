"""Weights carried across from the JAX package.

``flax_variables_to_state_dict`` maps a Flax TIMED variable tree (numpy
leaves) onto the PyTorch TIMED's ``state_dict``. The npz readers are the
counterparts of ``load_checkpoint_params`` / ``load_checkpoint_build_kwargs``
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


def flax_variables_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Flax TIMED ``{"params", "batch_stats"}`` -> TIMED ``state_dict``.

    Flax names ``ConvBlock_i/Conv_0`` and ``ConvBlock_i/BatchNorm_0`` become
    ``blocks.i.conv`` and ``blocks.i.bn``; the top-level ``Conv_0`` is the
    1x1x1 ``head``. BatchNorm ``scale/bias/mean/var`` become
    ``weight/bias/running_mean/running_var``.
    """
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    i = 0
    while f"ConvBlock_{i}" in params:
        conv = params[f"ConvBlock_{i}"]["Conv_0"]
        bn = params[f"ConvBlock_{i}"]["BatchNorm_0"]
        bs = stats[f"ConvBlock_{i}"]["BatchNorm_0"]
        p = f"blocks.{i}."
        sd[p + "conv.weight"] = _kernel(conv["kernel"])
        sd[p + "conv.bias"] = _t(conv["bias"])
        sd[p + "bn.weight"] = _t(bn["scale"])
        sd[p + "bn.bias"] = _t(bn["bias"])
        sd[p + "bn.running_mean"] = _t(bs["mean"])
        sd[p + "bn.running_var"] = _t(bs["var"])
        sd[p + "bn.num_batches_tracked"] = torch.tensor(0)
        i += 1
    sd["head.weight"] = _kernel(params["Conv_0"]["kernel"])
    sd["head.bias"] = _t(params["Conv_0"]["bias"])
    return sd


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
