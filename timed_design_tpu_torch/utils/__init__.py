"""Phase timing and the typed configurations of ``td-predict`` and
``td-voxelize``."""
from .config import PredictConfig, VoxelizeConfig  # noqa: F401
from .timing import PhaseTimer  # noqa: F401
