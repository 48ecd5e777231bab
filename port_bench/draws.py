"""The traffic generator: every input of every call, drawn from the seed.

One general generator reads a traffic file (`traffic/<name>.json`) and the
configuration's sizes. Calls are closed-loop and all of one size, so a seed
changes the values drawn and never the work. Call k of a discovery mix
scores `swarms_per_call` swarms whose classes run on from call k-1's, over
the configuration's classes in turn; every call of a patient mix is one
new patient: `n_particles` source slices. Each swarm starts as the
reference's Particle does: positions N(0, 1) (a patient's swarm: its
encoder's latents), velocities (N(0, 1) - 0.5) / 10, and r1, r2 U[0, 1)
per particle and iteration.

The draws come from a `torch.Generator` on the run's device, seeded from
`--seed` (any whole number below 2**63) and kept apart from the weights'
stream.
"""

from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15  # splits the seed's streams
_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for `stream` of a run's `seed`."""
    return (seed * _MIX + stream * 0xBF58476D1CE4E5B9) & _MASK


class Draws:
    """calls(k) → the inputs of call k, drawn in call order."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.rng = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
        pso = cfg["pso"]
        self.n, self.d, self.t = pso["n_particles"], pso["dim_space"], pso["n_iterations"]
        self.patients = "patients_per_call" in traffic
        if self.patients and traffic["patients_per_call"] != 1:
            raise ValueError("a patient mix scores one patient a call")
        self.b = 1 if self.patients else int(traffic["swarms_per_call"])

    def _normal(self, shape):
        return torch.randn(shape, generator=self.rng, device=self.device)

    def _uniform(self, shape):
        return torch.rand(shape, generator=self.rng, device=self.device)

    def call(self, k: int) -> dict:
        b, n, d, t = self.b, self.n, self.d, self.t
        out = {}
        if self.patients:
            img = self.cfg["image"]
            out["source"] = self._uniform((n, img["channels"], img["size"], img["size"])) * 2 - 1
            out["class_idx"] = int(self.cfg["target_class"])
        else:
            n_cls = len(self.cfg["iid_classes"])
            out["classes"] = [(k * b + j) % n_cls for j in range(b)]
            out["positions"] = self._normal((b, n, d))
        out["velocities"] = (self._normal((b, n, d)) - 0.5) / 10.0
        out["r1"] = self._uniform((t, b, n))
        out["r2"] = self._uniform((t, b, n))
        return out

    @property
    def evals_per_call(self) -> int:
        return self.b * self.n * self.t

    @property
    def encoded_per_call(self) -> int:
        return self.n if self.patients else 0
