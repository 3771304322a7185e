"""Prediction engine: batched forward, td-predict's engine, design sessions,
request coalescing."""
from .predictor import (  # noqa: F401
    PredictionResult,
    Predictor,
    load_dataset_and_predict,
    predict_structure,
)
from .session import DesignSession  # noqa: F401
