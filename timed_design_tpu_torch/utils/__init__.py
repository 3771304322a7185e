"""Phase timing and the typed configurations of ``td-predict`` and
``td-voxelize``."""
from .config import PredictConfig, VoxelizeConfig  # noqa: F401


def __getattr__(name: str):
    # ``timing`` imports torch, which the frame-set workers
    # (``voxel/frame_pool.py``) do without: it is imported at first use
    if name == "PhaseTimer":
        from .timing import PhaseTimer

        return PhaseTimer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
