"""Prediction engine: batched forward, design sessions, request coalescing."""
from .predictor import Predictor, predict_structure  # noqa: F401
from .session import DesignSession  # noqa: F401
