"""Monte-Carlo sampling, sequence metrics and the ``td-sample`` flow."""
from .metrics import batched_metrics_from_counts, counts_from_codes, sequence_metrics  # noqa: F401
from .run import SampleConfig, main_sample  # noqa: F401
from .sampler import (  # noqa: F401
    apply_temperature,
    sample_all_structures,
    sample_sequences_with_metrics,
    sample_structure,
)
