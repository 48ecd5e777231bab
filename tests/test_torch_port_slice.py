"""The port's main path — the batched discovery runner — against the JAX
package's make_batched_discovery_runner with the same weights (carried by
compat/weights.py) and the same draws: 2 classes x 4 particles x 3
iterations, z=8, G f=16, ResNet-50 with 8 classes. One JAX ResNet-50
compile for the file."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_discovery_pso_tpu.core.config import PsoConfig as JPsoConfig
from gan_discovery_pso_tpu.models import (
    GeneratorDef as JGeneratorDef,
    ResNetDef as JResNetDef,
    generator_init,
    resnet_init,
)
from gan_discovery_pso_tpu.pso import make_batched_discovery_runner as jax_runner
from gan_discovery_pso_tpu_torch.compat import generator_state_dict, resnet_state_dict, to_tensors
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef, ResNet, ResNetDef
from gan_discovery_pso_tpu_torch.pso import (
    OPTIMIZE_OUT,
    make_batched_discovery_runner,
    make_discovery_runner,
    state_from_positions,
)

CLASSES = (0, 2, 3, 4, 6, 7, 8, 9)
HP = dict(n_iterations=3, n_particles=4, dim_space=8)
CLASS_IDXS = [1, 6]
EPS = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs: the suite runs six
    workers on shared cores, and torch's default of one thread per core
    oversubscribes them (measured: 20x slower under the parallel suite)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _draws(keys, n, d, iters):
    """The draws of jax optimize for each class's key (see
    test_torch_port_swarm.jax_draws), stacked on the swarm axis."""
    pos, vel, r1, r2 = [], [], [], []
    for key in keys:
        init_key, iter_key = jax.random.split(key)
        kp, kv = jax.random.split(init_key)
        pos.append(jax.random.normal(kp, (n, d), jnp.float32))
        vel.append((jax.random.normal(kv, (n, d), jnp.float32) - 0.5) / 10.0)
        ks = [jax.random.split(jax.random.fold_in(iter_key, it)) for it in range(1, iters + 1)]
        r1.append(jnp.stack([jax.random.uniform(k[0], (n,), jnp.float32) for k in ks]))
        r2.append(jnp.stack([jax.random.uniform(k[1], (n,), jnp.float32) for k in ks]))
    t = lambda xs, axis: torch.from_numpy(np.array(jnp.stack(xs, axis=axis)))
    return t(pos, 0), t(vel, 0), t(r1, 1), t(r2, 1)


@pytest.fixture(scope="module")
def both():
    """(JAX result, port models, port draws) for the shared configuration."""
    gdef = JGeneratorDef(z_dim=8, features_g=16)
    rdef = JResNetDef("ResNet50", 1, 8, CLASSES)
    gp, gs = jax.jit(lambda k: generator_init(k, gdef))(jax.random.key(0))
    rp, rs = jax.jit(lambda k: resnet_init(k, rdef, init="glorot_normal"))(jax.random.key(1))
    keys = jax.random.split(jax.random.key(2), len(CLASS_IDXS))
    run = jax_runner(rdef, JPsoConfig(**HP), control=OPTIMIZE_OUT, eps=EPS)
    finals, hist, _ = run(keys, gp, gs, rp, rs, jnp.asarray(CLASS_IDXS, jnp.int32))

    gen = Generator(GeneratorDef(8, 1, 16))
    gen.load_state_dict(to_tensors(generator_state_dict(gp, gs)), strict=True)
    net = ResNet(ResNetDef("ResNet50", 1, 8))
    net.load_state_dict(to_tensors(resnet_state_dict(rp, rs)), strict=True)
    draws = _draws(keys, HP["n_particles"], HP["dim_space"], HP["n_iterations"])
    return (finals, hist), (gen.eval(), net.eval()), draws


def _run(models, draws, **kw):
    hp = PsoConfig(**HP)
    pos, vel, r1, r2 = draws
    run = make_batched_discovery_runner(hp, control=OPTIMIZE_OUT, eps=EPS, device="cpu", **kw)
    init = state_from_positions(pos, vel, hp.w_inertia)
    return run(*models, CLASS_IDXS, init_state=init, r1=r1, r2=r2)


def test_batched_runner_matches_jax(both):
    (j_final, j_hist), models, draws = both
    final, hist, _ = _run(models, draws)
    # fp32 conv sums run in another order on XLA:CPU and oneDNN
    np.testing.assert_allclose(hist.fitness.numpy(), np.asarray(j_hist.fitness), rtol=1e-5)
    np.testing.assert_allclose(final.g_best_val.numpy(), np.asarray(j_final.g_best_val), atol=1e-5)
    np.testing.assert_allclose(hist.g_best_val.numpy(), np.asarray(j_hist.g_best_val), atol=1e-5)
    np.testing.assert_allclose(hist.positions.numpy(), np.asarray(j_hist.positions),
                               rtol=1e-4, atol=1e-5)
    f = hist.fitness.numpy()
    assert np.isfinite(f).all() and (f >= EPS).all() and (f <= 1 + EPS).all()


def test_fitness_chunk_gives_identical_values(both):
    _, models, draws = both
    whole = _run(models, draws)[1]
    chunked = _run(models, draws, fitness_chunk=2)[1]
    for name, x, y in zip(whole._fields, whole, chunked):
        assert torch.equal(x.nan_to_num(-1.0), y.nan_to_num(-1.0)), name


def test_stack_and_single_swarm_runners_repeat_the_batched_run(both):
    """stack=2 folds into the swarm axis (member s = swarms s·C..s·C+C-1);
    the one-swarm runner reproduces one class of the batch."""
    _, models, (pos, vel, r1, r2) = both
    base = _run(models, (pos, vel, r1, r2))[1]
    stacked = _run(models, (pos.repeat(2, 1, 1), vel.repeat(2, 1, 1),
                            r1.repeat(1, 2, 1), r2.repeat(1, 2, 1)), stack=2)[1]
    c = len(CLASS_IDXS)
    torch.testing.assert_close(stacked.fitness[c:], base.fitness, rtol=1e-6, atol=1e-7)
    hp = PsoConfig(**HP)
    one = make_discovery_runner(hp, eps=EPS, device="cpu")(
        *models, CLASS_IDXS[1], init_state=state_from_positions(pos[1:], vel[1:], hp.w_inertia),
        r1=r1[:, 1:], r2=r2[:, 1:])[1]
    torch.testing.assert_close(one.fitness[0], base.fitness[1], rtol=1e-6, atol=1e-7)


def test_bf16_mode_stays_within_the_gate(both):
    """The bf16 mode (bf16 model copies, fp32 swarm math) against fp32 on
    the same draws: the repo's gate |g_best fp32 − bf16| ≤ 1e-3."""
    _, models, draws = both
    g32 = _run(models, draws)[0].g_best_val
    g16 = _run(models, draws, dtype=torch.bfloat16)[0].g_best_val
    assert models[0].gen[2].weight.dtype == torch.float32  # the caller's models stay fp32
    assert float((g32 - g16).abs().max()) <= 1e-3
