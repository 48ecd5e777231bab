"""Command-line entry point of the port: `python -m gan_discovery_pso_tpu_torch.cli`."""
