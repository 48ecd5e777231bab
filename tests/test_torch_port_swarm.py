"""The port's optimize against the JAX package's on analytic.sphere, with
the draws JAX made injected into the port: the key derivation of
gan_discovery_pso_tpu/pso/swarm.py:optimize is reproduced here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_discovery_pso_tpu.core.config import PsoConfig as JPsoConfig
from gan_discovery_pso_tpu.pso import analytic, make_analytic_fitness
from gan_discovery_pso_tpu.pso import last_iteration as jax_last_iteration
from gan_discovery_pso_tpu.pso import optimize as jax_optimize
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.pso import (
    SwarmResult,
    last_iteration,
    mean_pairwise_distance,
    optimize,
    state_from_positions,
)


def jax_draws(key, n, d, iters):
    """What jax optimize draws: split → (init, iter) keys; init → split →
    normal positions, (normal − 0.5)/10 velocities; iteration i (1-based) →
    fold_in(iter_key, i) → split → uniforms r1, r2."""
    init_key, iter_key = jax.random.split(key)
    kp, kv = jax.random.split(init_key)
    pos = jax.random.normal(kp, (n, d), jnp.float32)
    vel = (jax.random.normal(kv, (n, d), jnp.float32) - 0.5) / 10.0
    r1, r2 = [], []
    for it in range(1, iters + 1):
        k1, k2 = jax.random.split(jax.random.fold_in(iter_key, it))
        r1.append(jax.random.uniform(k1, (n,), jnp.float32))
        r2.append(jax.random.uniform(k2, (n,), jnp.float32))
    t = lambda x: torch.from_numpy(np.array(x))
    return t(pos), t(vel), t(jnp.stack(r1)), t(jnp.stack(r2))


def sphere(positions):  # [B, N, d] → [B, N]
    return (positions * positions).sum(dim=-1)


@pytest.mark.parametrize("early_stopping,schedule_inertia", [(False, False), (True, True)])
def test_optimize_matches_jax_history(early_stopping, schedule_inertia):
    kw = dict(n_iterations=25, n_particles=12, dim_space=3, tolerance=1e-2,
              early_stopping=early_stopping, schedule_inertia=schedule_inertia)
    key = jax.random.key(11)
    j_final, j_hist, _ = jax_optimize(key, make_analytic_fitness(analytic.sphere), JPsoConfig(**kw))
    hp = PsoConfig(**kw)
    pos, vel, r1, r2 = jax_draws(key, 12, 3, 25)
    init = state_from_positions(pos[None], vel[None], hp.w_inertia)
    final, hist, init_out = optimize(sphere, hp, init, r1[:, None], r2[:, None])
    assert init_out is init

    j_active = np.asarray(j_hist.active)
    assert early_stopping == (not j_active.all())  # the stop does happen
    np.testing.assert_array_equal(hist.active[0].numpy(), j_active)
    close = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hist.g_best_val[0].numpy(), np.asarray(j_hist.g_best_val), **close)
    np.testing.assert_allclose(hist.g_best_dummy[0].numpy(), np.asarray(j_hist.g_best_dummy), **close)
    np.testing.assert_allclose(hist.mean_mse[0].numpy(), np.asarray(j_hist.mean_mse),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hist.positions[0].numpy(), np.asarray(j_hist.positions), **close)
    np.testing.assert_allclose(hist.velocities[0].numpy(), np.asarray(j_hist.velocities), **close)
    np.testing.assert_allclose(hist.fitness[0].numpy(), np.asarray(j_hist.fitness), **close)
    if early_stopping:  # NaN diagnostics after the stop, on both sides
        assert np.isnan(hist.mean_mse[0].numpy()[~j_active]).all()
        assert np.isnan(hist.g_best_dummy[0].numpy()[~j_active]).all()
    assert int(final.g_improvements[0]) == int(j_final.g_improvements)
    assert bool(final.done[0]) == bool(j_final.done)
    np.testing.assert_allclose(float(final.w_inertia[0]), float(j_final.w_inertia), rtol=1e-6)
    assert last_iteration(hist, final.done) == [
        jax_last_iteration(j_hist, done=j_final.done)]

    res = SwarmResult(final, hist, init, hp)
    assert res.particle_trajectories(0).shape == (int(j_active.sum()) + 1, 12, 3)
    assert len(res.history_dict(0)["global_best_val"]) == int(j_active.sum())


def test_optimize_batches_independent_swarms():
    """Two swarms in one batch give what each gives alone."""
    hp = PsoConfig(n_iterations=6, n_particles=5, dim_space=2)
    g = torch.Generator().manual_seed(0)
    pos, vel = torch.randn(2, 5, 2, generator=g), torch.randn(2, 5, 2, generator=g)
    r1, r2 = torch.rand(6, 2, 5, generator=g), torch.rand(6, 2, 5, generator=g)
    both = optimize(sphere, hp, state_from_positions(pos, vel, hp.w_inertia), r1, r2)[1]
    for b in range(2):
        one = optimize(sphere, hp, state_from_positions(pos[b:b + 1], vel[b:b + 1], hp.w_inertia),
                       r1[:, b:b + 1], r2[:, b:b + 1])[1]
        for x, y in zip(both, one):
            assert torch.equal(x[b], y[0])


def test_mean_pairwise_distance_matches_direct():
    x = torch.randn(3, 7, 4, generator=torch.Generator().manual_seed(1))
    direct = torch.stack([torch.pdist(xb).mean() for xb in x])
    torch.testing.assert_close(mean_pairwise_distance(x), direct, rtol=1e-5, atol=1e-5)
