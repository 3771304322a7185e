"""Analysis layer: metrics, rotamer evaluation, structure analyses, plots,
the SCWRL4, AlphaFold2 and NetSolP adapters and the sweeps; the port of
``timed_design_tpu/analyse`` with its export list. The metric passes run on
the device of their tensors; matplotlib is imported only when a plot is
drawn."""
from .af2 import (  # noqa: F401
    GDT_CUTOFFS,
    RefoldResult,
    analyse_af2_folder,
    analyse_cherrypicked,
    analyse_refold,
    combined_property_table,
    make_af2_slurm_script,
    partition_fastas,
    read_fasta,
    rename_af2_outputs,
)
from .metrics import (  # noqa: F401
    accuracy,
    calculate_metrics,
    classification_report,
    confusion,
    precision_recall_f1,
    prediction_bias,
    roc_auc_ovo_macro,
    roc_auc_ovr_macro,
    sequences_to_labels,
    top_k_accuracy,
)
from .rotamer import (  # noqa: F401
    calculate_rotamer_metrics,
    renormalize_float16_rows,
    tag_structures_with_rotamers,
)
from .scwrl import (  # noqa: F401
    ScwrlNotFoundError,
    analyse_with_scwrl,
    pack_side_chains_scwrl,
    parse_scwrl_score,
)
from .structure_analysis import (  # noqa: F401
    atom_packing_density,
    calculate_prediction_entropy,
    extract_bfactor_from_structure,
    extract_packdensity_from_structure,
    extract_prediction_entropy_to_dict,
    structure_packing_density,
)
from .plots import (  # noqa: F401
    create_rot_cm,
    create_sequence_logo,
    plot_cm,
    plot_mean_var_probs,
    plot_patterns,
    plot_sequence_heatmap,
)
from .netsolp import (  # noqa: F401
    NetSolPNotFoundError,
    annotate_samples_with_netsolp,
    run_netsolp,
)
from .sweeps import (  # noqa: F401
    DEFAULT_TEMPERATURES,
    SweepPoint,
    plot_metric_vs_temperature,
    plot_models_comparison,
    plot_scwrl_scores,
    run_model_benchmark,
    run_temperature_sweep,
)
