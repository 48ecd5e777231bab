"""Both runners, whose forwards fold the assessor's eval BatchNorm into its
convs, against the JAX package's runners, which run the BN, on a ResNet-50
whose BNs carry drawn statistics: γ in [0.5, 1.5] (halved in each block's
last BN), β and μ N(0, 0.5), σ² in [0.5, 2]. A fresh `resnet_init` (γ 1,
β 0, μ 0, σ² 1) leaves the fold nearly an identity, so the runners' parity
tests cannot see it. The convs are He-initialised and the last BN of each
block halved so that the drawn network's output still depends on its
input: with Glorot convs the drawn β and μ swamp the shrinking signal, the
fitness is the same for every particle and the swarms' argmins become
ties that rounding decides.

The tolerances of the runners' parity tests: fitness rtol 1e-5, g_best
atol 1e-5, trajectories rtol 1e-4 atol 1e-5. Sizes as
`test_torch_port_slice.py`: 2 classes x 4 particles x 3 iterations, z 8,
G f 16, ResNet-50 with 8 classes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gan_discovery_pso_tpu_torch.models.resnet as resnet_mod
from gan_discovery_pso_tpu.core.config import PsoConfig as JPsoConfig
from gan_discovery_pso_tpu.models import (
    GeneratorDef as JGeneratorDef,
    ResNetDef as JResNetDef,
    generator_init,
    resnet_init,
)
from gan_discovery_pso_tpu.ops.norm import BatchNormStats
from gan_discovery_pso_tpu.pso import make_batched_discovery_runner as jax_batched_runner
from gan_discovery_pso_tpu.pso import make_inverter_runner as jax_inverter_runner
from gan_discovery_pso_tpu_torch.compat import generator_state_dict, resnet_state_dict, to_tensors
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef, ResNet, ResNetDef
from gan_discovery_pso_tpu_torch.ops.kernels import rescale01_per_sample
from gan_discovery_pso_tpu_torch.pso import (
    OPTIMIZE_OUT,
    make_batched_discovery_runner,
    make_inverter_runner,
    state_from_positions,
    swarm_init_from_positions,
)
from tests.test_torch_port_slice import CLASS_IDXS, CLASSES, EPS, HP, _draws

N, D, ITERS = HP["n_particles"], HP["dim_space"], HP["n_iterations"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (six workers share
    the cores, as in test_torch_port_slice.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bn_draws(params, state, rs: np.random.RandomState, gain: float = 1.0):
    """(params, state) with every BN's scale (times `gain`, 0.5 in a
    block's `bn3`), bias, mean and var drawn; convs and the head as they
    were."""
    if isinstance(state, BatchNormStats):
        c = state.mean.shape[0]
        scale, bias = gain * (0.5 + rs.rand(c)), 0.5 * rs.randn(c)
        mean, var = 0.5 * rs.randn(c), 0.5 + 1.5 * rs.rand(c)
        f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        return {**params, "scale": f32(scale), "bias": f32(bias)}, BatchNormStats(f32(mean),
                                                                                   f32(var))
    if isinstance(state, dict):
        new_p, new_s = dict(params), {}
        for k in state:
            new_p[k], new_s[k] = _bn_draws(params[k], state[k], rs, 0.5 if k == "bn3" else 1.0)
        return new_p, new_s
    pairs = [_bn_draws(p, s, rs) for p, s in zip(params, state)]
    return type(params)(p for p, _ in pairs), type(state)(s for _, s in pairs)


@pytest.fixture(scope="module")
def models():
    """The JAX trees and their port modules. G takes torch's default init,
    whose images vary with z (DCGAN's N(0, 0.02) gives images 3e-4 wide,
    which the rescale stretches 4,000 times), and the head's bias centres
    each class's logit over 64 of G's images, so that no class's posterior
    sits at 0 or 1."""
    gp, gs = jax.jit(lambda k: generator_init(k, JGeneratorDef(z_dim=D, features_g=16),
                                              dcgan_init=False))(jax.random.key(0))
    rdef = JResNetDef("ResNet50", 1, len(CLASSES), CLASSES)
    rp, rs = jax.jit(lambda k: resnet_init(k, rdef, init="he_normal"))(jax.random.key(1))
    rp, rs = _bn_draws(rp, rs, np.random.RandomState(11))

    gen = Generator(GeneratorDef(D, 1, 16))
    gen.load_state_dict(to_tensors(generator_state_dict(gp, gs)), strict=True)
    net = ResNet(ResNetDef("ResNet50", 1, len(CLASSES)))
    net.load_state_dict(to_tensors(resnet_state_dict(rp, rs)), strict=True)
    z = torch.randn((64, D, 1, 1), generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        centre = net.eval()(rescale01_per_sample(gen.eval()(z))).mean(0)
        net.fc.bias.sub_(centre)
    rp = {**rp, "fc": {**rp["fc"], "b": jnp.asarray(net.fc.bias.detach().numpy())}}
    return {"jax": (gp, gs, rp, rs), "rdef": rdef, "port": (gen, net)}


def test_the_drawn_statistics_reach_the_port(models):
    """Every BN of the port's ResNet-50 carries the draws, far from a
    fresh init's."""
    bns = [bn for _, bn in resnet_mod._conv_bn_pairs(models["port"][1])]
    assert len(bns) == 53
    for bn in map(lambda m: {k: v.detach() for k, v in m.state_dict().items()}, bns):
        assert float((bn["running_var"] - 1).abs().max()) > 0.2
        assert float((bn["weight"] - 1).abs().max()) > 0.2
        assert float(bn["running_mean"].abs().max()) > 0.2 and float(bn["bias"].abs().max()) > 0.2


@pytest.fixture
def folds(monkeypatch):
    """The number of `fold_batch_norm` calls, so each test shows that the
    port's runner ran folded."""
    calls, real = [], resnet_mod.fold_batch_norm
    monkeypatch.setattr(resnet_mod, "fold_batch_norm", lambda *a: calls.append(1) or real(*a))
    return calls


def _assert_swarms_match(final, hist, j_final, j_hist, swarms=slice(None)):
    """The port's swarms `swarms` against the JAX result."""
    port = lambda t: t[swarms].numpy()  # noqa: E731
    np.testing.assert_allclose(port(hist.fitness), np.asarray(j_hist.fitness), rtol=1e-5)
    np.testing.assert_allclose(port(final.g_best_val), np.asarray(j_final.g_best_val),
                               atol=1e-5)
    np.testing.assert_allclose(port(hist.g_best_val), np.asarray(j_hist.g_best_val),
                               atol=1e-5)
    np.testing.assert_allclose(port(hist.positions), np.asarray(j_hist.positions),
                               rtol=1e-4, atol=1e-5)


def _assert_no_ties(fitness):
    """Any two particles of a swarm and iteration differ by more than 20
    times the fitness tolerance, so no argmin is left to rounding."""
    f = np.sort(np.asarray(fitness), axis=-1)
    assert (np.diff(f, axis=-1) > 20 * 1e-5 * np.abs(f[..., 1:])).all(), f


def test_folded_batched_runner_matches_jax(models, folds):
    keys = jax.random.split(jax.random.key(2), len(CLASS_IDXS))
    j_final, j_hist, _ = jax_batched_runner(models["rdef"], JPsoConfig(**HP),
                                            control=OPTIMIZE_OUT, eps=EPS)(
        keys, *models["jax"], jnp.asarray(CLASS_IDXS, jnp.int32))
    pos, vel, r1, r2 = _draws(keys, N, D, ITERS)
    hp = PsoConfig(**HP)
    run = make_batched_discovery_runner(hp, control=OPTIMIZE_OUT, eps=EPS, device="cpu")
    final, hist, _ = run(*models["port"], CLASS_IDXS,
                         init_state=state_from_positions(pos, vel, hp.w_inertia), r1=r1, r2=r2)
    assert folds == [1]
    _assert_swarms_match(final, hist, j_final, j_hist)
    _assert_no_ties(j_hist.fitness)


def test_folded_inverter_runner_matches_jax(models, folds):
    """One encoder-seeded swarm, each particle scored against its own
    source slice, for class 1; the JAX stage's velocity and uniform
    draws."""
    rs = np.random.RandomState(6)
    init_pos = rs.randn(N, D).astype(np.float32)
    src = rs.uniform(-1, 1, (N, 1, 28, 28)).astype(np.float32)
    key = jax.random.key(3)
    j_final, j_hist, _ = jax_inverter_runner(models["rdef"], JPsoConfig(**HP))(
        key, *models["jax"], 1, jnp.asarray(src), jnp.asarray(init_pos))

    init_key, _ = jax.random.split(key)
    vel = (jax.random.normal(init_key, (N, D), jnp.float32) - 0.5) / 10.0
    _, _, r1, r2 = _draws([key], N, D, ITERS)
    hp = PsoConfig(**HP)
    init = swarm_init_from_positions(None, torch.tensor(init_pos)[None], hp.w_inertia,
                                     torch.tensor(np.asarray(vel))[None])
    final, hist, _ = make_inverter_runner(hp, device="cpu")(
        *models["port"], 1, src, None, init_state=init, r1=r1, r2=r2)
    assert folds == [1]
    _assert_swarms_match(final, hist, j_final, j_hist, swarms=0)
    _assert_no_ties(j_hist.fitness)
