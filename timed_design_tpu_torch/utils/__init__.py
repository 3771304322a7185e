"""Phase timing and the typed configuration of ``td-predict``."""
from .config import PredictConfig  # noqa: F401
from .timing import PhaseTimer  # noqa: F401
