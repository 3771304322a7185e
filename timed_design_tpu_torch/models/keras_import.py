"""Keras ``.h5`` models on PyTorch: the stored graph run as a module, no TF.

The port of ``timed_design_tpu/models/keras_import.py``. The reference ships
its model zoo only as Keras ``.h5`` releases; this module reads one through
the port's own HDF5 reader (``io/hdf5.py``; the card's machine has no h5py)
and compiles its ``model_config`` JSON graph into a topologically ordered
list of PyTorch ops with the stored weights as buffers, in either
serialization: Keras 3 (``tf.keras``) and the Keras 2 layout of the releases
(``tf_keras``: nested ``layer/layer/kernel:0`` weight names, the old
inbound-node JSON).

Tensors keep Keras's layout between layers (NDHWC; NHWC and NLC for 2D and
1D layers), so every ``axis``, ``Flatten``, ``Reshape`` and ``Concatenate``
means what it means in Keras. Each convolution and pooling op sees an
NCDHW view of channels-last memory, as the zoo's modules do; 1D and 2D
layers run as 3D ones with unit dims. The dataflow is the JAX importer's:
a Conv or Dense casts its input to the compute dtype, takes its output to
float32, adds the float32 bias, then the activation; BatchNorm runs in
float32 from the moving statistics, in one ``F.batch_norm`` pass (its
``axis`` is taken to be the last, as the JAX importer takes it). Every
convolution goes through ``models/layers.py::conv3d``, so ``--quantize``
covers the whole graph; its bias is added after the convolution, in
float32, as the JAX package adds it after its quantized convolution.

Where the JAX importer departs from Keras the port does what Keras does:
a Softmax over several axes normalises over all of them, not the first;
ReLU with a threshold keeps ``x > threshold`` (Keras), not ``>=``; the
``"gelu"`` activation is the exact erf form (Keras's default), not the tanh
approximation; a global pooling with ``keepdims`` keeps its unit dims.

``import_timed_params`` maps a TIMED-shaped file onto the Flax parameter
tree that ``td-train --init_from`` warm-starts from.
"""
from __future__ import annotations

import dataclasses
import json
import math
import typing as t
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..io import hdf5
from .layers import at_least_float32, conv3d
from .quantize import pad_channels_last


def _to_tuple(v, n=3):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _activation_fn(name: str | None) -> t.Callable:
    table = {
        None: lambda x: x,
        "linear": lambda x: x,
        "relu": torch.relu,
        "elu": F.elu,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "gelu": F.gelu,  # Keras's default: approximate=False
        "softplus": F.softplus,
        "selu": F.selu,
        "swish": F.silu,
    }
    if name not in table:
        raise NotImplementedError(f"Activation {name!r} not supported")
    return table[name]


@dataclasses.dataclass
class _Node:
    name: str
    fn: t.Callable  # (the layer's weights, [input tensors]) -> tensor
    inputs: list[str]


class KerasH5Model(nn.Module):
    """An imported Keras model: ``forward`` maps (B, ...) inputs in Keras's
    layout (NDHWC frames for the zoo) to the graph's output, float32 rows
    (float64 for a float64 model). The stored weights are float32 buffers,
    cast to ``compute_dtype`` at each convolution and Dense layer.
    ``n_classes`` is the output width of the last layer with a kernel;
    ``name`` the file's stem."""

    def __init__(self, nodes: list[_Node], input_name: str, output_name: str,
                 weights: dict[str, dict[str, torch.Tensor]], n_classes: int,
                 compute_dtype: torch.dtype = torch.float32, name: str = ""):
        super().__init__()
        self._nodes = nodes
        self._input = input_name
        self._output = output_name
        self.n_classes = n_classes
        self.compute_dtype = compute_dtype
        self.name = name
        # buffers w0, w1, ... (Keras names are not attribute names)
        self._wmap: dict[str, dict[str, str]] = {}
        for lname, layer_w in weights.items():
            for short, tensor in layer_w.items():
                buf = f"w{len(self._buffers)}"
                self.register_buffer(buf, tensor)
                self._wmap.setdefault(lname, {})[short] = buf

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        env: dict[str, torch.Tensor] = {self._input: x}
        for node in self._nodes:
            if node.name in env:
                continue
            weights = {short: getattr(self, buf)
                       for short, buf in self._wmap.get(node.name, {}).items()}
            env[node.name] = node.fn(weights, [env[i] for i in node.inputs])
        return at_least_float32(env[self._output])

    @staticmethod
    def load(path: Path, compute_dtype: torch.dtype = torch.float32) -> "KerasH5Model":
        path = Path(path)
        config, weights = _read_file(path)
        return _build(config, weights, compute_dtype, name=path.stem)


def _read_file(path: Path) -> tuple[dict, dict[str, dict[str, np.ndarray]]]:
    """(model config, weights) of a Keras ``.h5`` file."""
    with hdf5.File(path) as f:
        config_raw = f.attrs.get("model_config")
        if config_raw is None:
            raise ValueError(f"{path} has no model_config attr (not a Keras h5?)")
        if isinstance(config_raw, bytes):
            config_raw = config_raw.decode()
        return json.loads(config_raw), _read_weights(f)


def _read_weights(f) -> dict[str, dict[str, np.ndarray]]:
    """{layer: {short weight name: array}} from ``model_weights/`` or the
    root (a weights-only file), in each layer's ``weight_names`` order;
    ``conv3d/kernel:0`` is ``kernel``."""
    out: dict[str, dict[str, np.ndarray]] = {}
    mw = f["model_weights"] if "model_weights" in f else f
    for layer_name in mw:
        grp = mw[layer_name]
        wn = grp.attrs.get("weight_names", [])
        layer_w: dict[str, np.ndarray] = {}
        for name in wn:
            name = name.decode() if isinstance(name, bytes) else str(name)
            short = name.split("/")[-1].split(":")[0]
            layer_w[short] = np.asarray(grp[name][()])
        if layer_w:
            out[layer_name] = layer_w
    return out


def _build(config: dict, weights: dict, compute_dtype: torch.dtype, name="") -> KerasH5Model:
    cls = config.get("class_name")
    cfg = config.get("config", {})
    prepared: dict[str, dict[str, torch.Tensor]] = {}

    def layer(lc: dict) -> t.Callable:
        lname = lc["config"]["name"]
        fn, tensors = _layer_fn(lc["class_name"], lc["config"], lname, compute_dtype,
                                weights.get(lname, {}))
        if tensors:
            prepared[lname] = tensors
        return fn

    if cls == "Sequential":
        nodes: list[_Node] = []
        prev = "__input__"
        for lc in cfg["layers"]:
            if lc["class_name"] == "InputLayer":
                continue
            nodes.append(_Node(lc["config"]["name"], layer(lc), [prev]))
            prev = lc["config"]["name"]
        input_name, output_name = "__input__", prev
    elif cls in ("Functional", "Model"):
        input_name = _endpoint_name(cfg["input_layers"])
        output_name = _endpoint_name(cfg["output_layers"])
        nodes = []
        for lc in cfg["layers"]:
            if lc["class_name"] == "InputLayer":
                continue
            inputs = _parse_inbound(lc.get("inbound_nodes", []))
            nodes.append(_Node(lc["config"]["name"], layer(lc), inputs))
        nodes = _toposort(nodes, input_name)
    else:
        raise NotImplementedError(f"Model class {cls!r} not supported")
    return KerasH5Model(nodes, input_name, output_name, prepared,
                        _infer_n_classes(config, weights), compute_dtype, name)


def _infer_n_classes(config: dict, weights: dict) -> int:
    """Output class count from the last kernel-bearing layer in the config."""
    layers = config["config"]["layers"]
    for lc in reversed(layers):
        lname = lc["config"]["name"]
        if lname in weights and "kernel" in weights[lname]:
            return int(weights[lname]["kernel"].shape[-1])
    return 20


def _endpoint_name(spec) -> str:
    """First layer name from input_layers/output_layers, any nesting style:
    Keras 2 ``[["name", 0, 0]]`` / ``[[["name", 0, 0]]]``, Keras 3 legacy h5
    ``["name", 0, 0]``."""
    node = spec
    while isinstance(node, list) and node and isinstance(node[0], list):
        node = node[0]
    return node[0]


def _parse_inbound(inbound) -> list[str]:
    """Handle both legacy list-format and keras>=2.13 node formats."""
    if not inbound:
        return []
    node = inbound[0]
    names = []
    if isinstance(node, list):
        for item in node:
            if isinstance(item, list):
                names.append(item[0])
            elif isinstance(item, dict):  # keras-3 style args
                names.extend(_extract_history(item))
    elif isinstance(node, dict):
        names.extend(_extract_history(node))
    return names


def _extract_history(obj) -> list[str]:
    out = []
    if isinstance(obj, dict):
        if "keras_history" in obj:
            out.append(obj["keras_history"][0])
        else:
            for v in obj.values():
                out.extend(_extract_history(v))
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            out.extend(_extract_history(v))
    return out


def _toposort(nodes: list[_Node], input_name: str) -> list[_Node]:
    by_name = {n.name: n for n in nodes}
    done: set[str] = {input_name}
    ordered: list[_Node] = []

    def visit(n: _Node, stack: set[str]):
        if n.name in done:
            return
        if n.name in stack:
            raise ValueError(f"Cycle at layer {n.name}")
        stack.add(n.name)
        for i in n.inputs:
            if i in by_name:
                visit(by_name[i], stack)
        stack.discard(n.name)
        done.add(n.name)
        ordered.append(n)

    for n in nodes:
        visit(n, set())
    return ordered


# ----------------------------------------------------------------- the layers

def _add_bias(y: torch.Tensor, w: dict, use_bias: bool) -> torch.Tensor:
    """A Conv or Dense output taken to float32 (float64 stays), plus the
    float32 bias: one pass, the cast done as the bias is added."""
    if not use_bias:
        return at_least_float32(y)
    return y + w["bias"].to(torch.promote_types(y.dtype, torch.float32))


def _as_3d(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B, *spatial, C) with ``ndim`` spatial dims -> (B, D, H, W, C), unit
    dims in front."""
    for _ in range(3 - ndim):
        x = x.unsqueeze(1)
    return x


def _from_3d(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape[0], *x.shape[4 - ndim:])


def _same_pads(sizes, window, strides) -> tuple[tuple[int, int], ...]:
    """XLA's (and Keras's) 'SAME': ``out = ceil(n / s)``, the padding
    ``max((out - 1) s + k - n, 0)`` split with the smaller half in front."""
    pairs = []
    for n, k, s in zip(sizes, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pairs.append((total // 2, total - total // 2))
    return tuple(pairs)


def _check_channels_last(class_name: str, cfg: dict, lname: str) -> None:
    if cfg.get("data_format", "channels_last") not in (None, "channels_last"):
        raise NotImplementedError(
            f"{class_name} {lname!r}: data_format {cfg['data_format']!r}; only "
            "channels_last graphs are supported")


def _conv_fn(class_name: str, cfg: dict, lname: str, dt: torch.dtype, raw: dict):
    ndim = int(class_name[4])
    _check_channels_last(class_name, cfg, lname)
    if int(cfg.get("groups", 1)) != 1:
        raise NotImplementedError(f"{class_name} {lname!r}: groups={cfg['groups']} not supported")
    unit = (1,) * (3 - ndim)
    strides = unit + _to_tuple(cfg.get("strides", 1), ndim)
    dilation = unit + _to_tuple(cfg.get("dilation_rate", 1), ndim)
    padding = cfg.get("padding", "valid").lower()
    if padding not in ("same", "valid"):
        raise NotImplementedError(f"{class_name} {lname!r}: padding {padding!r} not supported")
    use_bias = cfg.get("use_bias", True)
    act = _activation_fn(cfg.get("activation"))
    tensors = {}
    if "kernel" in raw:
        k = np.asarray(raw["kernel"], np.float32).reshape(unit + raw["kernel"].shape)
        tensors["kernel"] = torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))
    if use_bias and "bias" in raw:
        tensors["bias"] = torch.from_numpy(np.asarray(raw["bias"], np.float32))

    def fn(w, args):
        (x,) = args
        x = _as_3d(x.to(dt), ndim)
        kernel = w["kernel"]
        if padding == "same":
            window = [(k - 1) * d + 1 for k, d in zip(kernel.shape[2:], dilation)]
            pads = _same_pads(x.shape[1:4], window, strides)
        else:
            pads = 0
        y = conv3d(x.permute(0, 4, 1, 2, 3), kernel, None, pads, strides, dilation, lname)
        return act(_add_bias(_from_3d(y.permute(0, 2, 3, 4, 1), ndim), w, use_bias))

    return fn, tensors


def _dense_fn(cfg: dict, dt: torch.dtype, raw: dict):
    use_bias = cfg.get("use_bias", True)
    act = _activation_fn(cfg.get("activation"))
    tensors = {}
    if "kernel" in raw:
        tensors["kernel"] = torch.from_numpy(np.asarray(raw["kernel"], np.float32))
    if use_bias and "bias" in raw:
        tensors["bias"] = torch.from_numpy(np.asarray(raw["bias"], np.float32))

    def fn(w, args):
        (x,) = args
        return act(_add_bias(torch.matmul(x.to(dt), w["kernel"].to(dt)), w, use_bias))

    return fn, tensors


def _batch_norm_fn(cfg: dict, raw: dict):
    eps = float(cfg.get("epsilon", 1e-3))
    scale = cfg.get("scale", True)
    center = cfg.get("center", True)
    tensors = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in raw.items()}

    def fn(w, args):
        x = at_least_float32(args[0])
        ws = [w["moving_mean"], w["moving_variance"], w["gamma"] if scale else None,
              w["beta"] if center else None]
        ws = [None if a is None else a.to(x.dtype) for a in ws]
        # channels on axis 1 (a view of the channels-last memory), in one pass
        y = F.batch_norm(x.movedim(-1, 1), *ws, False, 0.0, eps)
        return y.movedim(1, -1)

    return fn, tensors


def _relu_fn(cfg: dict):
    """Keras's ReLU: ``x * (x > threshold)`` (or plain ``relu`` at threshold
    0), clipped to [0, max_value], minus ``negative_slope * relu(threshold -
    x)``; with a slope, no max and threshold 0, ``leaky_relu``."""
    max_value = cfg.get("max_value")
    neg = float(cfg.get("negative_slope") or 0.0)
    thr = float(cfg.get("threshold") or 0.0)

    def fn(w, args):
        x = args[0]
        if neg != 0.0 and max_value is None and thr == 0.0:
            return F.leaky_relu(x, neg)
        y = x * (x > thr).to(x.dtype) if thr != 0.0 else torch.relu(x)
        if max_value is not None:
            y = y.clamp(0.0, float(max_value))
        if neg != 0.0:
            y = y - neg * torch.relu(thr - x)
        return y

    return fn


def _softmax_fn(cfg: dict):
    axis = cfg.get("axis", -1)
    axes = [int(a) for a in axis] if isinstance(axis, (list, tuple)) else [int(axis)]

    def fn(w, args):
        x = args[0]
        if len(axes) == 1:
            return torch.softmax(x, dim=axes[0])
        return torch.exp(x - torch.logsumexp(x, dim=axes, keepdim=True))

    return fn


def _pool_fn(class_name: str, cfg: dict, lname: str):
    ndim = 3 if "3D" in class_name else 2
    _check_channels_last(class_name, cfg, lname)
    unit = (1,) * (3 - ndim)
    pool = unit + _to_tuple(cfg.get("pool_size", 2), ndim)
    strides = unit + _to_tuple(cfg.get("strides") or cfg.get("pool_size", 2), ndim)
    same = cfg.get("padding", "valid").lower() == "same"
    is_max = class_name.startswith("Max")

    def fn(w, args):
        x = _as_3d(args[0], ndim)
        pads = _same_pads(x.shape[1:4], pool, strides) if same else ((0, 0),) * 3
        padded = any(lo or hi for lo, hi in pads)
        if is_max:
            if padded:
                x = pad_channels_last(x, pads, -math.inf)
            y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), pool, strides)
        else:
            xp = pad_channels_last(x, pads) if padded else x
            summed = F.avg_pool3d(xp.permute(0, 4, 1, 2, 3), pool, strides, divisor_override=1)
            if padded:  # divided by the count of real cells in each window
                ones = pad_channels_last(x.new_ones((1, *x.shape[1:4], 1)), pads)
                y = summed / F.avg_pool3d(ones.permute(0, 4, 1, 2, 3), pool, strides,
                                          divisor_override=1)
            else:
                y = summed / math.prod(pool)
        return _from_3d(y.permute(0, 2, 3, 4, 1), ndim)

    return fn


def _global_pool_fn(class_name: str, cfg: dict, lname: str):
    ndim = 3 if "3D" in class_name else 2
    _check_channels_last(class_name, cfg, lname)
    axes = tuple(range(1, 1 + ndim))
    keep = bool(cfg.get("keepdims", False))
    if class_name.startswith("GlobalAverage"):
        return lambda w, args: args[0].mean(dim=axes, keepdim=keep)
    return lambda w, args: args[0].amax(dim=axes, keepdim=keep)


def _pairs3(v) -> list[tuple[int, int]]:
    if isinstance(v, int):
        return [(v, v)] * 3
    return [tuple(p) if isinstance(p, (list, tuple)) else (p, p) for p in v]


def _product(args):
    out = args[0]
    for a in args[1:]:
        out = out * a
    return out


def _layer_fn(class_name: str, cfg: dict, lname: str, dt: torch.dtype,
              raw: dict) -> tuple[t.Callable, dict[str, torch.Tensor]]:
    """(fn, tensors) of one Keras layer: ``fn(weights, [inputs]) -> output``
    with ``weights`` the layer's prepared ``tensors`` (on the module's
    device), made from its stored arrays ``raw``."""
    if class_name in ("Conv3D", "Conv2D", "Conv1D"):
        return _conv_fn(class_name, cfg, lname, dt, raw)
    if class_name == "Dense":
        return _dense_fn(cfg, dt, raw)
    if class_name == "BatchNormalization":
        return _batch_norm_fn(cfg, raw)
    if class_name == "PReLU":
        tensors = {"alpha": torch.from_numpy(np.asarray(raw["alpha"], np.float32))}
        return (lambda w, args: torch.where(args[0] >= 0, args[0],
                                            w["alpha"].to(args[0].dtype) * args[0])), tensors
    if class_name == "Activation":
        act = _activation_fn(cfg.get("activation"))
        return (lambda w, args: act(args[0])), {}
    if class_name == "ELU":
        alpha = float(cfg.get("alpha", 1.0))
        return (lambda w, args: F.elu(args[0], alpha)), {}
    if class_name == "ReLU":
        return _relu_fn(cfg), {}
    if class_name == "LeakyReLU":
        # Keras 3 names the slope 'negative_slope', Keras 2 'alpha'
        alpha = float(cfg.get("negative_slope", cfg.get("alpha", 0.3)))
        return (lambda w, args: F.leaky_relu(args[0], alpha)), {}
    if class_name == "Softmax":
        return _softmax_fn(cfg), {}
    if class_name in ("Dropout", "SpatialDropout3D", "SpatialDropout2D",
                      "SpatialDropout1D", "GaussianNoise", "AlphaDropout"):
        return (lambda w, args: args[0]), {}  # inference: identity
    if class_name in ("GlobalAveragePooling3D", "GlobalAveragePooling2D",
                      "GlobalMaxPooling3D", "GlobalMaxPooling2D"):
        return _global_pool_fn(class_name, cfg, lname), {}
    if class_name in ("MaxPooling3D", "AveragePooling3D", "MaxPooling2D",
                      "AveragePooling2D"):
        return _pool_fn(class_name, cfg, lname), {}
    if class_name == "Flatten":
        return (lambda w, args: args[0].reshape(args[0].shape[0], -1)), {}
    if class_name == "Reshape":
        target = tuple(int(d) for d in cfg["target_shape"])
        return (lambda w, args: args[0].reshape(args[0].shape[0], *target)), {}
    if class_name == "Add":
        return (lambda w, args: sum(args[1:], args[0])), {}
    if class_name == "Average":
        return (lambda w, args: sum(args[1:], args[0]) / len(args)), {}
    if class_name == "Multiply":
        return (lambda w, args: _product(args)), {}
    if class_name == "Concatenate":
        axis = int(cfg.get("axis", -1))
        return (lambda w, args: torch.cat(args, dim=axis)), {}
    if class_name == "ZeroPadding3D":
        pads = tuple(_pairs3(cfg.get("padding", 1)))
        return (lambda w, args: pad_channels_last(args[0], pads)), {}
    if class_name == "Cropping3D":
        crops = _pairs3(cfg.get("cropping", 1))

        def crop(w, args):
            x = args[0]
            sl = tuple(slice(c0, x.shape[d + 1] - c1 if c1 else None)
                       for d, (c0, c1) in enumerate(crops))
            return x[(slice(None), *sl, slice(None))]

        return crop, {}
    if class_name == "UpSampling3D":
        size = _to_tuple(cfg.get("size", 2), 3)

        def upsample(w, args):
            x = args[0]
            for d, rep in enumerate(size):
                x = x.repeat_interleave(rep, dim=d + 1)
            return x

        return upsample, {}
    raise NotImplementedError(f"Keras layer {class_name!r} not supported")


def load_keras_model(path: Path, compute_dtype: torch.dtype = torch.float32) -> KerasH5Model:
    """Load a Keras ``.h5`` release file as a module (on the CPU; move it
    with ``.to(device)``, as ``engine.Predictor`` does)."""
    return KerasH5Model.load(path, compute_dtype=compute_dtype)


_TIMED_PASSTHROUGH_LAYERS = {
    "InputLayer", "ELU", "Activation", "SpatialDropout3D", "Dropout",
    "GlobalAveragePooling3D", "Softmax",
}


def import_timed_params(path: Path) -> dict:
    """Keras ``.h5`` -> the Flax TIMED ``{"params", "batch_stats"}`` tree,
    numpy float32 leaves: the inverse of ``keras_export.export_timed_to_h5``,
    for ``td-train --init_from``. Takes any linear Conv3D/ELU/BatchNorm chain
    ending in a projection Conv3D (the TIMED family) in either serialization;
    another graph raises a ``ValueError`` naming the layer that does not fit
    (it still loads for inference through ``load_keras_model``)."""
    path = Path(path)
    config, weights = _read_file(path)

    convs: list[str] = []
    bns: list[str] = []
    for lc in config["config"]["layers"]:
        cn = lc["class_name"]
        name = lc["config"]["name"]
        if cn == "Conv3D":
            convs.append(name)
        elif cn == "BatchNormalization":
            bns.append(name)
        elif cn not in _TIMED_PASSTHROUGH_LAYERS:
            raise ValueError(
                f"layer {name!r} ({cn}) is not part of a linear TIMED "
                f"conv/BN chain — this h5 cannot map onto the Flax TIMED "
                f"parameter tree (use load_keras_model for inference)"
            )
    if len(convs) != len(bns) + 1:
        raise ValueError(
            f"expected one projection conv after {len(bns)} conv/BN blocks, "
            f"found {len(convs)} Conv3D layers — not a TIMED-shaped chain"
        )

    def f32(a) -> np.ndarray:
        return np.asarray(a, np.float32)

    def conv_params(lname: str) -> dict:
        w = weights.get(lname, {})
        if "kernel" not in w or "bias" not in w:
            raise ValueError(
                f"conv layer {lname!r} is missing kernel/bias weights "
                f"(found {sorted(w)}) — use_bias=False convs cannot map "
                f"onto the Flax TIMED tree"
            )
        return {"kernel": f32(w["kernel"]), "bias": f32(w["bias"])}

    params: dict = {}
    batch_stats: dict = {}
    for i, (cname, bname) in enumerate(zip(convs, bns)):
        bw = weights.get(bname, {})
        missing = {"gamma", "beta", "moving_mean", "moving_variance"} - set(bw)
        if missing:
            raise ValueError(f"BN layer {bname!r} is missing {sorted(missing)}")
        params[f"ConvBlock_{i}"] = {
            "Conv_0": conv_params(cname),
            "BatchNorm_0": {"scale": f32(bw["gamma"]), "bias": f32(bw["beta"])},
        }
        batch_stats[f"ConvBlock_{i}"] = {
            "BatchNorm_0": {"mean": f32(bw["moving_mean"]), "var": f32(bw["moving_variance"])}
        }
    params["Conv_0"] = conv_params(convs[-1])
    return {"params": params, "batch_stats": batch_stats}
