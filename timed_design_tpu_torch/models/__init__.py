"""The 3D-CNN zoo in PyTorch (TIMED, ProDCoNN, DenseNet, DenseCPD), its
registry and weight conversion, quantized convolutions, TIMED's
BatchNorm folding, and Keras ``.h5`` release files (import and export)."""
from .convert import (  # noqa: F401
    densenet_variables_to_state_dict,
    flax_variables_to_state_dict,
    load_checkpoint_build_kwargs,
    load_checkpoint_params,
    prodconn_variables_to_state_dict,
    state_dict_to_densenet_variables,
    state_dict_to_flax_variables,
    state_dict_to_prodconn_variables,
)
from .densenet import DenseNet3D, densecpd, densenet  # noqa: F401
from .keras_export import export_timed_to_h5  # noqa: F401
from .layers import ConvBlock, global_average_pool_3d, spatial_dropout_3d  # noqa: F401
from .keras_import import KerasH5Model, import_timed_params, load_keras_model  # noqa: F401
from .optimize import fold_timed_bn, timed_inference_apply  # noqa: F401
from .prodconn import ProDCoNN, prodconn  # noqa: F401
from .quantize import MODES, quantize_fn, quantized_conv3d, quantized_convs  # noqa: F401
from .registry import MODEL_REGISTRY, ModelSpec, get_model_spec, load_model  # noqa: F401
from .timed import (  # noqa: F401
    TIMED,
    timed,
    timed_deep,
    timed_rotamer,
    timed_rotamer_deep,
    timed_rotamer_not_so_deep,
)
