"""Training on PyTorch: the port of ``timed_design_tpu/train/`` (its npz
checkpoints and the mesh's data and model axes included; orbax checkpoints
are not ported)."""
from .train import (  # noqa: F401
    TrainState,
    balanced_class_weights,
    evaluate,
    fit,
    init_train_state,
    load_checkpoint_build_kwargs,
    load_checkpoint_params,
    make_eval_step,
    make_lr_schedule,
    make_train_step,
    param_shardings,
    save_checkpoint,
)
