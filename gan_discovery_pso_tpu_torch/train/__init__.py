"""Training loops of the port: the assessor's (`cnn.py`), the CAE's
(`cae.py`), the DCGAN's step and the GAN evaluation's sampler
(`dcgan.py`), the inverter's steps and gradient inversions
(`inverter.py`) and the VQ-VAE's (`vqvae.py`), on the optimizers, losses
and label smoothing of `common.py`."""

from gan_discovery_pso_tpu_torch.train.dcgan import (
    GanTrainState,
    gan_init,
    make_gan_train_scan_step,
    make_gan_train_step,
    make_sampler,
)

__all__ = ["GanTrainState", "gan_init", "make_gan_train_scan_step", "make_gan_train_step",
           "make_sampler"]
