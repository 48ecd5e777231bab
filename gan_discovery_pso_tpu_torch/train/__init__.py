"""Training loops of the port: the assessor's (`cnn.py`), the CAE's
(`cae.py`), the DCGAN's step and the GAN evaluation's sampler
(`dcgan.py`), the inverter's steps and gradient inversions
(`inverter.py`) and the VQ-VAE's (`vqvae.py`), on the optimizers, losses
and label smoothing of `common.py`."""
