"""The port's io: datasetmaps, prediction decoding, the writers of
``td-predict`` and ``td-sample`` (with the native ``%.18e`` formatter), the
RCSB fetcher of ``td-analyse-rotamers --allow-fetch`` (``fetch.py``), and
HDF5 frame datasets (``h5frames.py``) on the port's own HDF5 reader and
writer (``hdf5.py``): nothing here imports h5py, which the card's machine
lacks."""
from .datasetmap import (  # noqa: F401
    SRB_HEADER,
    DatasetMap,
    get_pdb_keys_to_filter,
    load_datasetmap,
    save_datasetmap,
    save_srb_datasetmap,
    split_dataset_map,
)
from .decode import DecodedPredictions, consensus_running_average, extract_sequences  # noqa: F401
from .fast_fmt import native_available, write_e18_csv  # noqa: F401
from .fast_inflate import deflate_many, inflate_many  # noqa: F401
from .h5frames import (  # noqa: F401
    FrameBatchLoader,
    FrameDatasetMetadata,
    convert_to_flat,
    create_flat_dataset_map,
    flat_frame_dtype,
    read_flat_frames,
)
from .writers import (  # noqa: F401
    load_prediction_matrix,
    save_consensus_probs,
    save_dict_to_fasta,
    save_encoded_labels,
    save_prediction_csv,
    save_sampled,
    write_float16_csv,
    write_int_csv,
    write_prediction_rows,
)
