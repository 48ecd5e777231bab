from gan_discovery_pso_tpu_torch.data.medical import (
    ClipSpec,
    crop_box,
    normalize01,
    prepare_patient_dataset,
    preprocess_ct_slice,
    square_box,
)
from gan_discovery_pso_tpu_torch.data.mnist import (
    ImageDataset,
    epoch_batches,
    load_mnist,
    train_val_split,
)
from gan_discovery_pso_tpu_torch.data.synthetic_digits import synth_digits

__all__ = ["ClipSpec", "ImageDataset", "crop_box", "epoch_batches", "load_mnist",
           "normalize01", "prepare_patient_dataset", "preprocess_ct_slice", "square_box",
           "synth_digits", "train_val_split"]
