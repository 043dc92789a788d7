"""Input pipelines and the point sets (counterpart of
``gddim_tpu/data/__init__.py``, every name it exports)."""

from gddim_torch.data.pipelines import (
    get_data_inverse_scaler,
    get_data_scaler,
    get_data_shape,
    get_dataset,
    load_tfrecord_images,
    preprocess_corpus,
    write_tfrecord_images,
)
from gddim_torch.data.pointset import olympic_generate_sample
