"""The port's generator and ResNet-50 against the JAX package's forwards,
with weights carried across by the port's compat/weights.py, at
tests/test_models_parity.py's tolerances. One JAX ResNet-50 compile."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_discovery_pso_tpu.compat.torch_export import export_generator, export_resnet
from gan_discovery_pso_tpu.models import (
    GeneratorDef as JGeneratorDef,
    ResNetDef as JResNetDef,
    generator_forward,
    generator_init,
    resnet_apply,
    resnet_features,
    resnet_init,
)
from gan_discovery_pso_tpu_torch.compat import (
    generator_state_dict,
    load_reference_checkpoint,
    resnet_state_dict,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.models import (
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    dcgan_init_,
    glorot_normal_init_,
)

CLASSES = (0, 2, 3, 4, 6, 7, 8, 9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs: the suite runs six
    workers on shared cores, and torch's default of one thread per core
    oversubscribes them (measured: 20x slower under the parallel suite)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_gen():
    return jax.jit(lambda k: generator_init(k, JGeneratorDef(z_dim=8, features_g=16)))(
        jax.random.key(0))


@pytest.fixture(scope="module")
def jax_resnet():
    d = JResNetDef("ResNet50", 1, 8, CLASSES)
    params, state = jax.jit(lambda k: resnet_init(k, d, init="glorot_normal"))(
        jax.random.key(6))
    # non-trivial running statistics, so the BN names are exercised
    rng = np.random.RandomState(7)
    state = jax.tree.map(lambda s: jnp.asarray(
        rng.uniform(0.5, 1.5, s.shape).astype(np.float32)), state)
    return d, params, state


def _load(module, sd):
    module.load_state_dict(to_tensors(sd), strict=True)
    return module.eval()


def test_generator_forward_matches_jax(jax_gen):
    params, state = jax_gen
    z = np.random.RandomState(0).randn(6, 8, 1, 1).astype(np.float32)
    want = np.asarray(generator_forward(params, state, jnp.asarray(z)))
    gen = _load(Generator(GeneratorDef(8, 1, 16)), generator_state_dict(params, state))
    with torch.inference_mode():
        got = gen(torch.from_numpy(z)).numpy()
    assert got.shape == (6, 1, 28, 28)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_resnet50_forward_and_features_match_jax(jax_resnet):
    d, params, state = jax_resnet
    x = np.random.RandomState(1).rand(4, 1, 28, 28).astype(np.float32)

    @jax.jit
    def both(p, s, xx):
        return resnet_apply(p, s, xx, d)[0], resnet_features(p, s, xx, d)

    want_logits, want_feat = (np.asarray(a) for a in both(params, state, jnp.asarray(x)))
    net = _load(ResNet(ResNetDef("ResNet50", 1, 8)), resnet_state_dict(params, state))
    with torch.inference_mode():
        logits = net(torch.from_numpy(x)).numpy()
        feat = net.features(torch.from_numpy(x)).numpy()
    assert logits.shape == (4, 8) and feat.shape == (4, 2048)
    np.testing.assert_allclose(logits, want_logits, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(feat, want_feat, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("model", ["generator", "resnet50"])
def test_weights_equal_jax_export_key_for_key(model, jax_gen, jax_resnet):
    if model == "generator":
        params, state = jax_gen
        want, got = export_generator(params, state), generator_state_dict(params, state)
    else:
        _, params, state = jax_resnet
        want, got = export_resnet(params, state), resnet_state_dict(params, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bn_stats_forms_and_reference_checkpoints(jax_gen, tmp_path):
    """BN stats as an object, a dict or a tuple give the same state dict;
    .tar and .pt files load back into the port's generator strictly."""
    params, state = jax_gen
    as_obj = generator_state_dict(params, state)
    for form in (lambda s: {"mean": s.mean, "var": s.var}, lambda s: (s.mean, s.var)):
        other = generator_state_dict(params, {k: form(v) for k, v in state.items()})
        for k in as_obj:
            np.testing.assert_array_equal(other[k], as_obj[k])
    sd = to_tensors(as_obj)
    torch.save({"epoch": 3, "model_state_dict": sd, "loss": 0.5}, tmp_path / "g.tar")
    torch.save(sd, tmp_path / "g.pt")
    for name in ("g.tar", "g.pt"):
        gen = Generator(GeneratorDef(8, 1, 16))
        gen.load_state_dict(load_reference_checkpoint(tmp_path / name), strict=True)
        assert torch.equal(gen.gen[2].weight, sd["gen.2.weight"])


def test_seeded_inits_are_reproducible_and_scaled():
    def build(seed):
        g = torch.Generator().manual_seed(seed)
        return (dcgan_init_(Generator(GeneratorDef(8, 1, 16)), g),
                glorot_normal_init_(ResNet(ResNetDef("ResNet50", 1, 8)), g))

    with torch.no_grad():
        (g1, r1), (g2, r2) = build(3), build(3)
    for a, b in ((g1, g2), (r1, r2)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert abs(float(g1.gen[1][0].weight.detach().std()) - 0.02) < 2e-3
    assert abs(float(g1.gen[0][1].weight.detach().std()) - 0.02) < 0.01
    w = r1.layer3[0].conv2.weight.detach()  # xavier normal: std sqrt(2/(fan_in+fan_out))
    assert abs(float(w.std()) / np.sqrt(2.0 / (2 * 256 * 9)) - 1.0) < 0.05
    assert torch.equal(r1.layer1[0].bn1.weight, torch.ones(64))
