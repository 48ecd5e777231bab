"""Swarm artifact IO: the reference's pickle/DataFrame contract plus a
native npz (counterpart of `gan_discovery_pso_tpu/pso/io.py:24-117`).

Downstream stages read the discovery pickles directly: the VQ-VAE codebook
init (reference src/training/vq_vae.py:30-57), the latent analyses
(src/pso/util_pso_analysis.py:16-34) and `invert_bn`'s statistics
(src/inverter/utils_ae/util_inverter_statistics.py:466-474). So the
dict-of-DataFrames layout (`particle_{i}` → [iters+1, d] frame,
util_pso.py:159-165) and the file names are the JAX package's, including
the reader/writer typo pair: the writer emits
`particles_position_iid_class_{label}.pkl` (pso_discovery.py:239) while two
readers look for `iic` (vq_vae.py:45, util_inverter_statistics.py:469), so
both names are written. pandas is imported only where a frame is built or
read.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def save_particle_histories(
    interim_dir: str | Path,
    label,
    trajectories: np.ndarray,
    velocity_trajectories: np.ndarray,
    kind: str = "iid",
    pickles: bool = True,
) -> list[Path]:
    """trajectories [iters+1, N, d] → the reference's pickle contract:

      particles_position_{kind}_class_{label}.pkl   (+ the `iic` alias)
      particles_velocity_{kind}_class_{label}.pkl
      particles_{kind}_class_{label}.npz            (native dense format)

    pickles=False writes the npz alone (a host without pandas)."""
    interim_dir = Path(interim_dir)
    interim_dir.mkdir(parents=True, exist_ok=True)
    written = []
    if pickles:
        import pandas as pd

        n = trajectories.shape[1]
        hist_pos = {f"particle_{i}": pd.DataFrame(trajectories[:, i, :]) for i in range(n)}
        hist_vel = {f"particle_{i}": pd.DataFrame(velocity_trajectories[:, i, :])
                    for i in range(n)}
        names = [f"particles_position_{kind}_class_{label}.pkl"]
        if kind == "iid":
            names.append(f"particles_position_iic_class_{label}.pkl")  # reader typo alias
        for name in names:
            p = interim_dir / name
            with open(p, "wb") as f:
                pickle.dump(hist_pos, f)
            written.append(p)
        pv = interim_dir / f"particles_velocity_{kind}_class_{label}.pkl"
        with open(pv, "wb") as f:
            pickle.dump(hist_vel, f)
        written.append(pv)

    pz = interim_dir / f"particles_{kind}_class_{label}.npz"
    np.savez_compressed(pz, positions=trajectories, velocities=velocity_trajectories)
    written.append(pz)
    return written


def load_final_particle_positions(
    interim_dir: str | Path, label, kind: str = "iid",
    n_particles: int | None = None, dim_space: int | None = None,
) -> np.ndarray:
    """Final-iteration positions [N, d], what the VQ-VAE codebook init reads
    (reference vq_vae.py:35-57); n_particles/dim_space, when given, validate
    the artifact's shape."""
    pos = load_particle_trajectories(interim_dir, label, kind)[-1]
    if n_particles is not None and pos.shape[0] != n_particles:
        raise ValueError(
            f"class {label}: artifact has {pos.shape[0]} particles, "
            f"expected {n_particles}")
    if dim_space is not None and pos.shape[1] != dim_space:
        raise ValueError(
            f"class {label}: artifact has dim_space={pos.shape[1]}, "
            f"expected {dim_space}")
    return pos


def load_particle_trajectories(interim_dir: str | Path, label, kind: str = "iid") -> np.ndarray:
    """[iters+1, N, d] full trajectories (reference
    util_pso_analysis.py:16-34). Prefers the npz, falls back to either
    pickle spelling (the `iic` alias included)."""
    interim_dir = Path(interim_dir)
    npz = interim_dir / f"particles_{kind}_class_{label}.npz"
    if npz.exists():
        return np.load(npz)["positions"]
    for stem in (f"particles_position_{kind}_class_{label}.pkl",
                 f"particles_position_iic_class_{label}.pkl"):
        p = interim_dir / stem
        if p.exists():
            with open(p, "rb") as f:
                hist = pickle.load(f)
            mats = [hist[k].to_numpy(np.float32) for k in hist]
            return np.stack(mats, axis=1)
    have = sorted(
        {p.stem.rsplit("_", 1)[-1] for p in interim_dir.glob(f"particles_{kind}_class_*.npz")}
    )
    raise FileNotFoundError(
        f"no particle artifact for class {label} in {interim_dir} "
        f"(classes present: {have or 'none'}) — if this is a vqvae/analysis "
        "stage, its config's data.iid_classes must match the discovery run's "
        "(the reference's vqvae.yaml and dcgan_mnist.yaml ship with "
        "different splits)"
    )
