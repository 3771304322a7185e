"""Training on PyTorch: the port of ``timed_design_tpu/train/`` (its npz
checkpoints included; orbax checkpoints and tensor-parallel layouts are not
ported)."""
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
    save_checkpoint,
)
