"""Export trained TIMED models to Keras ``.h5`` (the reference's release
format), through the port's own HDF5 writer (``io/hdf5.py``; no h5py).

The port of ``timed_design_tpu/models/keras_export.py``: the same
``model_config`` JSON (a Sequential graph: Conv3D/ELU/BatchNormalization
blocks, SpatialDropout3D, the projection Conv3D, GlobalAveragePooling3D,
Softmax), the same root attributes, ``weight_names`` and ``layer_names`` as
``S64`` arrays, and the weights at ``model_weights/<layer>/<layer>/<w>:0``
(the Keras 2 layout of the releases). The file loads in TF's Keras, in the
JAX package's importer and in ``keras_import.load_keras_model``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..io import hdf5


def _layer(class_name: str, name: str, **config) -> dict:
    return {"class_name": class_name, "config": {"name": name, **config}}


def export_timed_to_h5(
    params: dict,
    batch_stats: dict,
    path: Path,
    n_classes: int = 20,
    input_channels: int = 5,
    dropout_rate: float = 0.1,
) -> Path:
    """Write a TIMED Flax params/batch_stats tree as a Keras Sequential h5.

    Takes the layout of ``models/convert.py::state_dict_to_flax_variables``:
    ``ConvBlock_i`` holding ``Conv_0`` and ``BatchNorm_0``, then the
    projection ``Conv_0``; leaves are arrays (numpy or anything
    ``np.asarray`` takes)."""
    path = Path(path)
    conv_blocks = sorted(
        (k for k in params if k.startswith("ConvBlock_")),
        key=lambda k: int(k.split("_")[1]),
    )

    layers = [
        _layer("InputLayer", "input_frames",
               batch_input_shape=[None, 21, 21, 21, input_channels],
               dtype="float32")
    ]
    weight_map: dict[str, dict[str, np.ndarray]] = {}
    for i, block in enumerate(conv_blocks):
        conv = params[block]["Conv_0"]
        bn_p = params[block]["BatchNorm_0"]
        bn_s = batch_stats[block]["BatchNorm_0"]
        conv_name, elu_name, bn_name = f"conv3d_{i}", f"elu_{i}", f"batch_norm_{i}"
        layers.append(
            _layer("Conv3D", conv_name,
                   filters=int(np.shape(conv["kernel"])[-1]),
                   kernel_size=[3, 3, 3], strides=[1, 1, 1], padding="same",
                   data_format="channels_last", activation="linear",
                   use_bias=True, dtype="float32")
        )
        layers.append(_layer("ELU", elu_name, alpha=1.0, dtype="float32"))
        layers.append(
            _layer("BatchNormalization", bn_name, axis=[4], momentum=0.99,
                   epsilon=1e-3, center=True, scale=True, dtype="float32")
        )
        weight_map[conv_name] = {
            f"{conv_name}/kernel:0": np.asarray(conv["kernel"], np.float32),
            f"{conv_name}/bias:0": np.asarray(conv["bias"], np.float32),
        }
        weight_map[bn_name] = {
            f"{bn_name}/gamma:0": np.asarray(bn_p["scale"], np.float32),
            f"{bn_name}/beta:0": np.asarray(bn_p["bias"], np.float32),
            f"{bn_name}/moving_mean:0": np.asarray(bn_s["mean"], np.float32),
            f"{bn_name}/moving_variance:0": np.asarray(bn_s["var"], np.float32),
        }

    layers.append(
        _layer("SpatialDropout3D", "spatial_dropout", rate=dropout_rate,
               dtype="float32")
    )
    head = params["Conv_0"]
    layers.append(
        _layer("Conv3D", "conv3d_head", filters=n_classes,
               kernel_size=[1, 1, 1], strides=[1, 1, 1], padding="same",
               data_format="channels_last", activation="linear",
               use_bias=True, dtype="float32")
    )
    weight_map["conv3d_head"] = {
        "conv3d_head/kernel:0": np.asarray(head["kernel"], np.float32),
        "conv3d_head/bias:0": np.asarray(head["bias"], np.float32),
    }
    layers.append(
        _layer("GlobalAveragePooling3D", "gap", data_format="channels_last",
               keepdims=False, dtype="float32")
    )
    layers.append(_layer("Softmax", "softmax", axis=-1, dtype="float32"))

    model_config = {
        "class_name": "Sequential",
        "config": {"name": "TIMED", "layers": layers},
    }
    # Keras lists a layer's weights in layer.weights order
    order = ["kernel", "bias", "gamma", "beta", "moving_mean", "moving_variance"]

    with hdf5.Writer(path) as f:
        f.attrs["model_config"] = json.dumps(model_config)
        f.attrs["backend"] = "tensorflow"
        f.attrs["keras_version"] = "2.13.1"
        mw = f.create_group("model_weights")
        all_names = []
        for lc in layers:
            lname = lc["config"]["name"]
            grp = mw.create_group(lname)
            weights = weight_map.get(lname, {})
            names = sorted(
                weights,
                key=lambda n: order.index(n.split("/")[-1].split(":")[0]),
            )
            grp.attrs["weight_names"] = np.array([n.encode() for n in names], dtype="S64")
            if names:
                # the writer takes no '/' in a name: the inner group by hand
                inner = grp.create_group(lname)
                for n in names:
                    inner.create_dataset(n.split("/", 1)[1], data=weights[n])
            all_names.append(lname.encode())
        mw.attrs["layer_names"] = np.array(all_names, dtype="S64")
    return path
