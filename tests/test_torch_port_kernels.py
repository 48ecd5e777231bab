"""The plain versions beside the port's CUDA kernels against the JAX
package's Pallas kernels (interpret mode, as tests/test_pallas.py runs them)
and its pso_iteration. The CUDA kernels themselves run only on the card,
where chip_smoke.py holds each against its plain version bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_discovery_pso_tpu.core.config import PsoConfig
from gan_discovery_pso_tpu.ops.pallas.rescale import rescale01_per_sample_pallas, rescale01_rows
from gan_discovery_pso_tpu.ops.pallas.swarm_update import pso_update_pallas
from gan_discovery_pso_tpu.pso import analytic, make_analytic_fitness, pso_iteration, swarm_init
from gan_discovery_pso_tpu_torch.ops.kernels import (
    _build,
    rescale01_rows as port_rescale01_rows,
    rescale01_rows_plain,
    swarm_update,
    swarm_update_plain,
)

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _port_update(states, fitness, r1, r2, w, hp):
    """Batched port update from per-swarm JAX states (lists, one per swarm)."""
    stack = lambda f: torch.stack([_t(getattr(s, f)) for s in states])
    return swarm_update_plain(
        stack("positions"), stack("velocities"), stack("p_best_pos"),
        stack("p_best_val"), torch.stack([_t(f) for f in fitness]),
        torch.stack([_t(r) for r in r1]), torch.stack([_t(r) for r in r2]),
        stack("g_best_pos"), stack("g_best_val"), stack("g_prev_val"),
        torch.full((len(states),), w), hp.w_cognitive, hp.w_social)


def _assert_matches(out, b, ref, pallas):
    """Port output of swarm b == JAX pso_iteration `ref` == Pallas `pallas`."""
    names = ("positions", "velocities", "p_best_pos", "p_best_val",
             "g_best_pos", "g_best_val", "g_prev_val")
    for i, name in enumerate(names):
        got = out[i][b].numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(ref, name)), **TOL, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(pallas[i]), **TOL, err_msg=name)
    assert bool(out.g_appended[b]) == bool(pallas[7])


def _pallas(state, fitness, r1, r2, hp):
    return pso_update_pallas(
        state.positions, state.velocities, state.p_best_pos, state.p_best_val,
        fitness, r1, r2, state.g_best_pos, state.g_best_val, state.g_prev_val,
        hp.w_inertia, hp.w_cognitive, hp.w_social, interpret=True)


def test_swarm_update_plain_matches_jax_over_iterations():
    """32 particles x 10 dims, 5 chained iterations (test_pallas.py case)."""
    hp = PsoConfig(n_particles=32, dim_space=10)
    state = swarm_init(jax.random.key(0), 32, 10, hp.w_inertia)
    fit_fn = make_analytic_fitness(analytic.sphere)
    rng = np.random.RandomState(0)
    for _ in range(5):
        r1 = jnp.asarray(rng.rand(32), jnp.float32)
        r2 = jnp.asarray(rng.rand(32), jnp.float32)
        fitness = fit_fn(state.positions)
        ref = pso_iteration(state, fitness, r1, r2, hp)
        out = _port_update([state], [fitness], [r1], [r2], hp.w_inertia, hp)
        _assert_matches(out, 0, ref, _pallas(state, fitness, r1, r2, hp))
        state = ref


def test_swarm_update_plain_unpadded_sizes():
    """13 particles x 7 dims: neither a multiple of a TPU tile."""
    hp = PsoConfig(n_particles=13, dim_space=7)
    state = swarm_init(jax.random.key(1), 13, 7, hp.w_inertia)
    fitness = make_analytic_fitness(analytic.cosine_mixture)(state.positions)
    r1, r2 = jnp.linspace(0, 1, 13), jnp.linspace(1, 0, 13)
    ref = pso_iteration(state, fitness, r1, r2, hp)
    out = _port_update([state], [fitness], [r1], [r2], hp.w_inertia, hp)
    _assert_matches(out, 0, ref, _pallas(state, fitness, r1, r2, hp))


def test_swarm_update_plain_batch_of_swarms():
    """4 independent swarms in one call (the JAX class vmap)."""
    hp = PsoConfig(n_particles=16, dim_space=6)
    keys = jax.random.split(jax.random.key(2), 4)
    states = [swarm_init(k, 16, 6, hp.w_inertia) for k in keys]
    fit_fn = make_analytic_fitness(analytic.sphere)
    fitness = [fit_fn(s.positions) for s in states]
    rng = np.random.RandomState(3)
    r1 = [jnp.asarray(rng.rand(16), jnp.float32) for _ in states]
    r2 = [jnp.asarray(rng.rand(16), jnp.float32) for _ in states]
    out = _port_update(states, fitness, r1, r2, hp.w_inertia, hp)
    for b, s in enumerate(states):
        ref = pso_iteration(s, fitness[b], r1[b], r2[b], hp)
        _assert_matches(out, b, ref, _pallas(s, fitness[b], r1[b], r2[b], hp))


@pytest.mark.parametrize("case", ["ties", "all_inf"])
def test_swarm_update_plain_ties_and_inf_start(case):
    """Exact fitness ties (a saturated posterior gives eps for many
    particles: the first index must win) and an all-inf start (no
    improvement, g_best_pos untouched), over two chained iterations."""
    hp = PsoConfig(n_particles=9, dim_space=5)
    state = swarm_init(jax.random.key(4), 9, 5, hp.w_inertia)
    first_winner = np.asarray(state.positions)[3]
    rng = np.random.RandomState(5)
    for it in range(2):
        if case == "ties":
            f = np.full(9, 0.5, np.float32)
            f[[3, 5, 7]] = 0.1  # tie at the minimum; index 3 must win
            f[[1, 2]] = 0.1 if it else 0.3
        else:
            f = np.full(9, np.inf, np.float32)
        fitness = jnp.asarray(f)
        r1 = jnp.asarray(rng.rand(9), jnp.float32)
        r2 = jnp.asarray(rng.rand(9), jnp.float32)
        ref = pso_iteration(state, fitness, r1, r2, hp)
        out = _port_update([state], [fitness], [r1], [r2], hp.w_inertia, hp)
        _assert_matches(out, 0, ref, _pallas(state, fitness, r1, r2, hp))
        if case == "ties":  # a later equal value does not replace the best
            np.testing.assert_array_equal(out.g_best_pos[0].numpy(), first_winner)
        else:
            assert np.isinf(float(out.g_best_val[0]))
            np.testing.assert_array_equal(out.g_best_pos[0].numpy(), np.zeros(5))
        state = ref


def test_swarm_update_wrapper_takes_plain_on_cpu():
    g = torch.Generator().manual_seed(0)
    b, n, d = 2, 5, 3
    args = [torch.randn(s, generator=g) for s in
            ((b, n, d), (b, n, d), (b, n, d), (b, n), (b, n), (b, n), (b, n), (b, d))]
    args += [torch.full((b,), torch.inf), torch.full((b,), torch.inf), torch.full((b,), 0.7)]
    before = swarm_update.launches
    got = swarm_update(*args, 1.496, 1.496)
    want = swarm_update_plain(*args, 1.496, 1.496)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert swarm_update.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("shape", [(13, 1, 28, 28), (9, 300)])
def test_rescale_rows_plain_bit_equal_to_pallas(shape):
    """fp32 bit-equal, bf16 equal to cast-after; F=300 is unaligned; one
    constant row gives NaN on both sides."""
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    x[4] = -0.5  # constant row
    rows = x.reshape(shape[0], -1)
    if len(shape) == 2:
        want32 = np.asarray(rescale01_rows(jnp.asarray(rows)))
        want16 = np.asarray(rescale01_rows(jnp.asarray(rows), out_dtype=jnp.bfloat16))
    else:
        want32 = np.asarray(rescale01_per_sample_pallas(jnp.asarray(x))).reshape(rows.shape)
        want16 = np.asarray(rescale01_per_sample_pallas(
            jnp.asarray(x), out_dtype=jnp.bfloat16)).reshape(rows.shape)
    got32 = rescale01_rows_plain(torch.from_numpy(rows))
    np.testing.assert_array_equal(got32.numpy(), want32)
    assert np.isnan(want32[4]).all()
    got16 = rescale01_rows_plain(torch.from_numpy(rows), torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), want16.astype(np.float32))
    np.testing.assert_array_equal(got16.float().numpy(), got32.bfloat16().float().numpy())
    # the wrapper takes the plain version on the CPU and launches nothing
    before = port_rescale01_rows.launches
    assert torch.equal(port_rescale01_rows(torch.from_numpy(rows), torch.bfloat16)
                       .float().nan_to_num(7.0), got16.float().nan_to_num(7.0))
    assert port_rescale01_rows.launches == before


def test_kernel_modules_import_without_cuda_nvcc_or_triton():
    """Importing builds nothing; the wrappers refuse devices they do not
    serve instead of falling back."""
    assert _build._lib is None
    assert _build.library_path().parent == _build.BUILD_DIR
    with pytest.raises(ValueError):
        port_rescale01_rows(torch.empty((2, 3), device="meta"))
    with pytest.raises(ValueError):
        swarm_update(*(torch.empty((1, 1, 1), device="meta") for _ in range(11)), 1.0, 1.0)
