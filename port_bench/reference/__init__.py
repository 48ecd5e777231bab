"""The plain reference of the benchmark's configurations: PyTorch only, in
float32 with TF32 off, importing nothing of the measured program."""
