"""GAN evaluation of the port: the KNN classifier battery, the FID on CAE
embeddings and the per-epoch metrics (counterpart of
`gan_discovery_pso_tpu/evaluation/`)."""

from gan_discovery_pso_tpu_torch.evaluation.classifiers import (
    KnnBattery,
    assign_labels,
    compute_posterior,
    error_reject_points,
    load_battery,
    save_battery,
    train_classifier_battery,
)
from gan_discovery_pso_tpu_torch.evaluation.fid import (
    fid_from_features,
    frechet_distance,
    mean_and_cov,
)
from gan_discovery_pso_tpu_torch.evaluation.gan_eval import (
    GanEvalResult,
    denoise_recon_loss,
    encode,
    evaluate_gan_epoch,
    inception_score,
    posterior_energy,
    posterior_variance,
)

__all__ = [
    "GanEvalResult",
    "KnnBattery",
    "assign_labels",
    "compute_posterior",
    "denoise_recon_loss",
    "encode",
    "error_reject_points",
    "evaluate_gan_epoch",
    "fid_from_features",
    "frechet_distance",
    "inception_score",
    "load_battery",
    "mean_and_cov",
    "posterior_energy",
    "posterior_variance",
    "save_battery",
    "train_classifier_battery",
]
