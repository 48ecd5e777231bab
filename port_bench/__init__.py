"""The benchmark of the PyTorch/CUDA port `gan_discovery_pso_tpu_torch`
(see README.md)."""
