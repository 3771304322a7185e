"""Monte-Carlo sampling, sequence metrics and the ``td-sample`` flow."""
from .metrics import (  # noqa: F401
    batched_metrics_from_counts,
    calculate_seq_metrics,
    counts_from_codes,
    sequence_charge,
    sequence_isoelectric_point,
    sequence_metrics,
    sequence_molar_extinction_280,
    sequence_molecular_weight,
)
from .run import SampleConfig, main_sample  # noqa: F401
from .sampler import (  # noqa: F401
    apply_temperature,
    sample_all_structures,
    sample_sequences_with_metrics,
    sample_structure,
)
