"""Monte-Carlo sampling and sequence metrics."""
from .metrics import batched_metrics_from_counts, counts_from_codes, sequence_metrics  # noqa: F401
from .sampler import (  # noqa: F401
    apply_temperature,
    sample_sequences_with_metrics,
    sample_structure,
)
