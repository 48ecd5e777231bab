"""Named, counted random streams from one experiment seed (counterpart of
`gan_discovery_pso_tpu/core/prng.py`: `seed_all` :22, `KeyChain` :35-80
with `peek` :61,
the FNV stream hash `_h` :83).

The JAX package derives `jax.random` keys by folding stream names and
counters into a root key. Torch cannot reproduce threefry, and this module
does not try. What carries over is the addressing: a stream is named by
(seed, child names, stream name, counter), and its `torch.Generator` seed is
a hash of exactly that tuple. So class c's swarm, drawn from
`keys.child(f"class_{c}")("pso")`, depends on (seed, "class_c", "pso")
alone: the batched and the sequential stage give it the same draws, and
adding a consumer elsewhere reshuffles nothing.

The stages' streams: `pso` (a child per class in discovery), `rehead`,
`epoch_{e}` (batch order, peeked), the CAE's `cae` (the init, then the
denoising noise) and `cae_img_loss`, the assessors' `cnn_{label}`/`init`
(a child per class) and `cnn_multi`, and the inverter's `enc`, `disc`,
`inv_fixed_noise`, `inv_step` (each adversarial train step's labels),
`inv_eval` (each eval batch's) and `invert_bn` (the initial weights); the
DCGAN's `gan` (G and D init), `fixed_noise` (the 32 z of the per-epoch
superimage), `gan_step` (each train step's noise and labels) and
`gan_eval` (each epoch's evaluation z and denoising noise); the VQ-VAE's
`vqvae` (its init) and `vqvae_fixed_noise`; the PixelCNN prior's
`pixelcnn` (its init) and `pix_ep_{e}` (epoch e's batch order, peeked).

`gan_step` and `gan_eval` are addressed by the ABSOLUTE (epoch, step) and
epoch, not by a consumed counter (`KeyChain.fold`, the JAX package's
`jax.random.fold_in(keys.peek(...), epoch)`): a run killed after epoch e
and resumed from its checkpoint draws, from epoch e + 1 on, exactly what
the single-shot run drew, so the two end bit-equal.
"""

from __future__ import annotations

import random

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def seed_all(seed: int) -> "KeyChain":
    """Seed the host RNGs (python, numpy) and return the KeyChain; device
    randomness flows only through the chain's generators."""
    random.seed(seed)
    np.random.seed(seed)
    return KeyChain(seed)


class KeyChain:
    """Named, counted `torch.Generator` streams derived from one root seed.

    >>> keys = KeyChain(42)
    >>> g1 = keys("swarm_init")      # first generator of the stream
    >>> g2 = keys("swarm_init")      # next one, never the same seed
    >>> kc = keys.child("class_3")   # independent subtree
    """

    def __init__(self, seed_or_root: int, _name: str = ""):
        self._root = int(seed_or_root) & _MASK64
        self._name = _name
        self._counters: dict[str, int] = {}

    def seed(self, stream: str, counter: int) -> int:
        """The 63-bit generator seed of `stream`'s draw number `counter`."""
        return _mix(_mix(self._root, _h(stream)), counter) >> 1

    def __call__(self, stream: str, device=None) -> torch.Generator:
        n = self._counters.get(stream, 0)
        self._counters[stream] = n + 1
        return self._generator(stream, n, device)

    def peek(self, stream: str, device=None) -> torch.Generator:
        """The stream's next generator, without consuming it (the JAX
        package's per-epoch data order, `pipelines/context.py:115`)."""
        return self._generator(stream, self._counters.get(stream, 0), device)

    def fold(self, stream: str, *indices: int, device=None) -> torch.Generator:
        """The stream's next generator (not consumed, as `peek`) with each
        of `indices` mixed into its seed in turn: draw (epoch, step) of a
        stream whatever ran before it in this process."""
        seed = self.seed(stream, self._counters.get(stream, 0))
        for i in indices:
            seed = _mix(seed, int(i)) >> 1
        g = torch.Generator(device=device if device is not None else "cpu")
        return g.manual_seed(seed)

    def child(self, name: str) -> "KeyChain":
        """Independent subtree (one per IiD class / OoD patient)."""
        return KeyChain(_mix(self._root, _h(name)), _name=name)

    def _generator(self, stream: str, counter: int, device) -> torch.Generator:
        g = torch.Generator(device=device if device is not None else "cpu")
        return g.manual_seed(self.seed(stream, counter))


def _h(s: str) -> int:
    """Stable 31-bit hash of a stream name (Python's hash() is salted)."""
    h = 2166136261
    for b in s.encode():
        h = ((h ^ b) * 16777619) & 0x7FFFFFFF
    return h


def _mix(a: int, b: int) -> int:
    """splitmix64 of (a, b): a 64-bit value that changes with either."""
    z = (a * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)
