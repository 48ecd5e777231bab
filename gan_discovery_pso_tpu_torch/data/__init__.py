from gan_discovery_pso_tpu_torch.data.mnist import (
    ImageDataset,
    epoch_batches,
    load_mnist,
    train_val_split,
)
from gan_discovery_pso_tpu_torch.data.synthetic_digits import synth_digits

__all__ = ["ImageDataset", "epoch_batches", "load_mnist", "synth_digits", "train_val_split"]
