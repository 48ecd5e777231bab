"""PyTorch/CUDA port of `gan_discovery_pso_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package imports
neither it nor JAX. Module paths mirror the JAX package's:

- `core/`: config (`PsoConfig`, `DataConfig`), the device policy (CUDA
  unless the caller names another device), named random streams
  (`prng.py`), run dirs, logging, and flax-msgpack checkpoints read and
  written without flax (`checkpoint.py`);
- `ops/`: convs, eval and train BN, pools, the plain rescale, the drange
  map, the precision modes, and `ops/kernels/` — the hand-written CUDA
  kernels (`csrc/*.cu`) that replace the JAX package's two Pallas TPU
  kernels, each beside its plain version;
- `models/`: the DCGAN generator and discriminator, the plain and AttGAN
  encoders and the ResNet assessors as `nn.Module`s;
- `data/`: MNIST idx files or the synthetic digits, as tensors on the
  stage's device; the CLARO CT chain (`medical.py`: box crop, resize on
  the device, clip, normalise), TIFF and xlsx read and written without
  PIL or openpyxl (`tiff.py`, `xlsx.py`), and the batched augmentation
  (`augment.py`);
- `train/`: the optimizers, the GAN losses, the assessor's training loop,
  and the inverter's training steps and gradient inversions;
- `pso/`: discovery and hybrid-inversion fitness, swarm, the batched
  discovery runner (the main path), the inverter runner, and the particle
  artifacts (`io.py`);
- `compat/weights.py`: JAX parameter trees and reference checkpoints into
  the port's state dicts, and back;
- `analysis/`: PCA, k-means and the Gaussian mixture in torch after
  scikit-learn's rules (`cluster.py`), UMAP (`umap_impl.py`), the
  latent analyses (`latent.py`) and the report writers (`reporting.py`);
- `parallel/`: ranks with `torch.distributed` (process groups, meshes,
  the rank launcher), the sharded swarm with B1's split halves around the
  global-best collective, the class x swarm and multi-swarm runners; the
  data-parallel GAN step lives in `train/dcgan.py`;
- `pipelines/`, `cli/`: every stage of the JAX package but `sweep` and the
  export and conversion commands, and their command line
  (`python -m gan_discovery_pso_tpu_torch.cli <stage>`).
"""

from gan_discovery_pso_tpu_torch import parallel
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.pso.runner import (
    make_batched_discovery_runner,
    make_discovery_runner,
)

__all__ = ["PsoConfig", "make_batched_discovery_runner", "make_discovery_runner",
           "parallel"]
