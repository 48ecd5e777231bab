from gan_discovery_pso_tpu_torch.ops.conv import conv2d, conv_transpose2d
from gan_discovery_pso_tpu_torch.ops.knn import (
    knn_battery_posterior,
    knn_predict_proba,
    pairwise_sq_dists,
)
from gan_discovery_pso_tpu_torch.ops.norm import batch_norm_eval, batch_norm_train
from gan_discovery_pso_tpu_torch.ops.pool import adaptive_max_pool2d, max_pool2d
from gan_discovery_pso_tpu_torch.ops.precision import (
    cast_model,
    fp32_parity,
    tf32_enabled,
    tf32_math,
)
from gan_discovery_pso_tpu_torch.ops.rescale import (
    adjust_dynamic_range,
    postprocess_uint8,
    rescale01_per_sample,
)
from gan_discovery_pso_tpu_torch.ops.sqrtm import sqrtm_psd, trace_sqrt_product

__all__ = [
    "adaptive_max_pool2d",
    "adjust_dynamic_range",
    "batch_norm_eval",
    "batch_norm_train",
    "cast_model",
    "conv2d",
    "conv_transpose2d",
    "fp32_parity",
    "knn_battery_posterior",
    "knn_predict_proba",
    "max_pool2d",
    "pairwise_sq_dists",
    "postprocess_uint8",
    "rescale01_per_sample",
    "sqrtm_psd",
    "tf32_enabled",
    "tf32_math",
    "trace_sqrt_product",
]
