"""Training loops of the port: the assessor's (`cnn.py`), the CAE's
(`cae.py`), the inverter's steps and gradient inversions (`inverter.py`),
on the optimizers, losses and label smoothing of `common.py`; and the GAN
evaluation's sampler (`dcgan.py`)."""
