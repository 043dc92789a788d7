"""FID, IS and KID, the proxy extractor and InceptionV3 (counterpart of
``gddim_tpu/evals/__init__.py``). Of its names the port has all but
``run_features_sharded`` (features over a device mesh): on one card it is
``run_features``, exported here beside the others."""

from gddim_torch.evals.features import get_feature_extractor, run_features
from gddim_torch.evals.fid import (
    activation_stats,
    frechet_distance,
    inception_score,
    kernel_distance,
    load_dataset_stats,
)
