"""The port's io: datasetmaps, prediction decoding and the writers of the
sampling path. HDF5-free: nothing here imports h5py (the card's machine
has none), so the HDF5 frame reader of ``timed_design_tpu/io/h5frames.py``
has no counterpart yet."""
from .datasetmap import DatasetMap, load_datasetmap, save_datasetmap  # noqa: F401
from .decode import DecodedPredictions, extract_sequences  # noqa: F401
from .writers import (  # noqa: F401
    load_prediction_matrix,
    save_dict_to_fasta,
    save_prediction_csv,
    save_sampled,
)
