"""TIMED 3D-CNN zoo in PyTorch, its registry and weight conversion."""
from .convert import (  # noqa: F401
    flax_variables_to_state_dict,
    load_checkpoint_build_kwargs,
    load_checkpoint_params,
)
from .registry import MODEL_REGISTRY, ModelSpec, get_model_spec, load_model  # noqa: F401
from .timed import (  # noqa: F401
    TIMED,
    timed,
    timed_deep,
    timed_rotamer,
    timed_rotamer_deep,
    timed_rotamer_not_so_deep,
)
