"""The port's inverter training and gradient inversion against the JAX
package's on the CPU: the discriminator, R1 and its D-gradient, the AttGAN
encoder, the pix_rec and pix_fea_rec_adv steps (fed the JAX package's label
draws), `invert` and `invert_bn` (fed its initial weights), the GAN losses,
and the uint8 post-processing. Tiny sizes: G z=8 f=8, the plain encoder,
the AttGAN encoder and D at f=8, ResNet-50 with the 8 IiD classes, batches
of 4. G and the plain encoder take torch's default init (a DCGAN-init G's
images are flat in z).

Tolerances: forwards and losses rtol 1e-5; updated weights within 5e-6
absolute (0.5 % of one Adam step of lr 1e-3: optax and torch apply the bias
correction in other orders, so they agree to rounding, not bit for bit,
and Adam's normalised step magnifies a gradient's rounding where the
gradient is small); the inversions as each test states."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_discovery_pso_tpu.compat.torch_export import export_discriminator
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.models import (
    DiscriminatorDef as JDiscriminatorDef,
    EncoderAttGANDef as JEncoderAttGANDef,
    ResNetDef as JResNetDef,
    discriminator_apply,
    discriminator_init,
    discriminator_logits,
    encoder_attgan_apply,
    encoder_attgan_init,
)
from gan_discovery_pso_tpu.models.encoder import EncoderDef as JEncoderDef
from gan_discovery_pso_tpu.models.encoder import encoder_init
from gan_discovery_pso_tpu.ops import postprocess_uint8 as jax_postprocess_uint8
from gan_discovery_pso_tpu.ops.norm import BatchNormStats
from gan_discovery_pso_tpu.train import common as jcommon
from gan_discovery_pso_tpu.train import inverter as jinv
from gan_discovery_pso_tpu_torch.compat import (
    discriminator_state_dict,
    discriminator_tree,
    encoder_attgan_state_dict,
    encoder_attgan_tree,
    encoder_state_dict,
    encoder_tree,
    generator_tree,
    resnet_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core import AdamConfig
from gan_discovery_pso_tpu_torch.core.checkpoint import msgpack_serialize
from gan_discovery_pso_tpu_torch.models import (
    Discriminator,
    DiscriminatorDef,
    Encoder,
    EncoderAttGAN,
    EncoderAttGANDef,
    EncoderDef,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    glorot_normal_init_,
)
from gan_discovery_pso_tpu_torch.ops import postprocess_uint8
from gan_discovery_pso_tpu_torch.train.common import (
    bce_from_logits,
    bce_on_probs,
    smooth_negative,
    smooth_positive,
)
from gan_discovery_pso_tpu_torch.train.inverter import (
    frozen,
    invert,
    invert_bn,
    make_pix_fea_rec_adv_step,
    make_pix_rec_step,
    r1_penalty,
)

Z = 8
IID = (0, 2, 3, 4, 6, 7, 8, 9)
# trainer_inverter's encoder/discriminator optimizers of the shipped config
ADAM = dict(lr=1e-3, beta1=0.5, beta2=0.99, epsilon=1e-8)
STEP_ATOL = 5e-6
METRIC_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bn_stats(node):
    """A state tree's {mean, var} leaves as the JAX package's BatchNormStats."""
    if isinstance(node, dict) and set(node) == {"mean", "var"}:
        return BatchNormStats(jnp.asarray(node["mean"]), jnp.asarray(node["var"]))
    if isinstance(node, dict):
        return {k: _bn_stats(v) for k, v in node.items()}
    return [_bn_stats(v) for v in node]


def _host(tree):
    """A copy on the host: trees taken from a module alias its storage,
    which the port's optimizers update in place."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _dev(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """JAX trees of every net the steps use: G and ResNet-50 from seeded
    port modules, the plain encoder (torch-default init), D (DCGAN init)
    and the AttGAN encoder from the JAX package's initialisers."""
    torch.manual_seed(0)
    gen = Generator(GeneratorDef(Z, 1, 8)).eval()
    gp, gs = _host(generator_tree(gen.state_dict()))
    cnn = glorot_normal_init_(ResNet(ResNetDef("ResNet50", 1, len(IID), IID)),
                              torch.Generator().manual_seed(1)).eval()
    rp, rs = _host(resnet_tree(cnn.state_dict()))
    ep, _ = encoder_init(jax.random.key(2), JEncoderDef(Z, 1, 8), dcgan_init=False)
    dp, _ = discriminator_init(jax.random.key(6), JDiscriminatorDef(1, 8))
    ap, ast = encoder_attgan_init(jax.random.key(30), JEncoderAttGANDef(Z, 1, 8))
    return {"gen": gen, "cnn": cnn, "gp": _dev(gp), "gs": _bn_stats(gs), "rp": _dev(rp),
            "rs": _bn_stats(rs), "ep": ep, "dp": dp, "ap": ap, "as": ast,
            "real": np.random.RandomState(8).rand(4, 1, 28, 28).astype(np.float32) * 2 - 1}


def _encoder(ep):
    enc = Encoder(EncoderDef(Z, 1, 8))
    enc.load_state_dict(to_tensors(encoder_state_dict(_host(ep))), strict=True)
    return enc


def _attgan(ap, ast):
    enc = EncoderAttGAN(EncoderAttGANDef(Z, 1, 8))
    enc.load_state_dict(to_tensors(encoder_attgan_state_dict(_host(ap), _host(ast))),
                        strict=True)
    return enc


def _disc(dp, f=8):
    disc = Discriminator(DiscriminatorDef(1, f))
    disc.load_state_dict(to_tensors(discriminator_state_dict(_host(dp))), strict=True)
    return disc


def _attgan_apply(p, st, x, train):
    return encoder_attgan_apply(p, st, x, train=train)


def _assert_tree_close(got, want, atol, what):
    leaves_got, leaves_want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(leaves_got) == len(leaves_want) > 0, what
    for a, b in zip(leaves_got, leaves_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("features", [8, 16])
def test_discriminator_matches_jax(features):
    """Sigmoid forward and logits within rtol 1e-5; the JAX package's
    `export_discriminator` state dict loads with strict=True; the weights
    round-trip byte-equal."""
    dp, _ = discriminator_init(jax.random.key(features), JDiscriminatorDef(1, features))
    x = np.random.RandomState(features).randn(5, 1, 28, 28).astype(np.float32)
    want, _ = discriminator_apply(dp, {}, jnp.asarray(x))
    want_logits = discriminator_logits(dp, jnp.asarray(x))
    for sd in (discriminator_state_dict(dp), export_discriminator(dp, {})):
        disc = Discriminator(DiscriminatorDef(1, features))
        disc.load_state_dict(to_tensors({k: np.asarray(v) for k, v in sd.items()}), strict=True)
        with torch.no_grad():
            got, got_logits = disc(torch.tensor(x)), disc.logits(torch.tensor(x))
        assert got.shape == (5, 1, 1, 1) and got_logits.shape == (5,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-5,
                                   atol=1e-6)
    assert msgpack_serialize({"params": discriminator_tree(disc.state_dict())}) == \
        msgpack_serialize({"params": jax.tree.map(np.asarray, dp)})


def test_r1_penalty_and_its_d_gradient_match_jax(nets):
    """R1 within rtol 1e-5, dR1/dW of every D weight within 1e-4 of the
    tensor's largest (a gradient of a gradient: the double backward sums in
    other orders)."""
    real = nets["real"]
    want = jinv.r1_penalty(nets["dp"], jnp.asarray(real))
    want_grads = jax.grad(lambda p: jinv.r1_penalty(p, jnp.asarray(real)))(nets["dp"])
    disc = _disc(nets["dp"])
    r1 = r1_penalty(disc, torch.tensor(real))
    np.testing.assert_allclose(float(r1.detach()), float(want), rtol=1e-5)
    grads = torch.autograd.grad(r1, list(disc.parameters()))
    got = discriminator_tree({k: g for (k, _), g in zip(disc.named_parameters(), grads)})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_grads)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_attgan_encoder_matches_jax(nets, train):
    """z within rtol 1e-4 (train-mode BN over 4 values a channel at the
    last block), the running statistics after a train-mode forward within
    rtol 1e-5, unchanged in eval mode; the weights and statistics
    round-trip byte-equal."""
    x = np.random.RandomState(31).rand(4, 1, 28, 28).astype(np.float32) * 2 - 1
    want, want_state = encoder_attgan_apply(nets["ap"], nets["as"], jnp.asarray(x), train=train)
    enc = _attgan(nets["ap"], nets["as"]).train(train)
    with torch.no_grad():
        got = enc(torch.tensor(x))
    assert got.shape == (4, Z, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    params, state = encoder_attgan_tree(enc.state_dict())
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(want_state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)
    assert msgpack_serialize({"params": params}) == msgpack_serialize(
        {"params": jax.tree.map(np.asarray, nets["ap"])})
    if not train:
        assert msgpack_serialize(state) == msgpack_serialize(
            _host({k: {"mean": v.mean, "var": v.var} for k, v in nets["as"].items()}))


@pytest.mark.parametrize("variant", ["plain", "attgan"])
def test_two_pix_rec_steps_match_jax(nets, variant):
    """Two steps on one batch: the loss of each within rtol 1e-5, the
    updated E (and the AttGAN's running statistics, which move once a step)
    within STEP_ATOL; the eval loss after them within rtol 1e-5."""
    real = jnp.asarray(nets["real"])
    adam = JAdamConfig(**ADAM)
    tx = jcommon.make_optimizer(adam)
    if variant == "plain":
        jstep, jeval = jinv.make_pix_rec_step(nets["gp"], nets["gs"], adam)
        jstate = jinv.PixRecState(nets["ep"], tx.init(nets["ep"]), jnp.asarray(0))
        enc = _encoder(nets["ep"])
    else:
        jstep, jeval = jinv.make_pix_rec_step_stateful(nets["gp"], nets["gs"], adam,
                                                       _attgan_apply)
        jstate = jinv.PixRecStatefulState(nets["ap"], nets["as"], tx.init(nets["ap"]),
                                          jnp.asarray(0))
        enc = _attgan(nets["ap"], nets["as"])
    step, evaluate = make_pix_rec_step(nets["gen"], enc, AdamConfig(**ADAM))
    for _ in range(2):
        jstate, jloss = jstep(jstate, real)
        loss = step(torch.tensor(nets["real"]))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=METRIC_RTOL)
        if variant == "plain":
            _assert_tree_close(encoder_tree(enc.state_dict()), jstate.enc_params, STEP_ATOL, "E")
        else:
            params, state = encoder_attgan_tree(enc.state_dict())
            _assert_tree_close(params, jstate.enc_params, STEP_ATOL, "E")
            _assert_tree_close(state, jstate.enc_state, 1e-6, "E state")
    np.testing.assert_allclose(float(evaluate(torch.tensor(nets["real"]))),
                               float(jeval(jstate, real)), rtol=METRIC_RTOL)
    assert all(p.grad is None for p in nets["gen"].parameters())


def _jax_draws(step):
    """The label draws of the JAX train step under key(100 + step)."""
    kp, kn = jax.random.split(jax.random.key(100 + step))
    return (np.asarray(jcommon.smooth_positive(kp, (4,))),
            np.asarray(jcommon.smooth_negative(kn, (4,))))


@pytest.mark.parametrize("variant", ["plain", "attgan"])
def test_two_pix_fea_rec_adv_steps_match_jax(nets, variant):
    """Two adversarial steps fed the JAX package's smoothing draws: all
    seven metrics within rtol 1e-5 (R1 included), the updated E and D
    within STEP_ATOL, the AttGAN's running statistics (moved once a step)
    within 1e-6; then the eval step's four metrics within rtol 1e-5."""
    real = jnp.asarray(nets["real"])
    adam = JAdamConfig(**ADAM)
    tx = jcommon.make_optimizer(adam)
    jdef = JResNetDef("ResNet50", 1, len(IID), IID)
    args = (nets["gp"], nets["gs"], nets["rp"], nets["rs"], jdef, adam, adam)
    dp = nets["dp"]
    if variant == "plain":
        jstep, jeval = jinv.make_pix_fea_rec_adv_step(*args)
        jstate = jinv.PixFeaRecAdvState(nets["ep"], dp, tx.init(nets["ep"]), tx.init(dp),
                                        jnp.asarray(0))
        enc = _encoder(nets["ep"])
    else:
        jstep, jeval = jinv.make_pix_fea_rec_adv_step_stateful(*args, _attgan_apply)
        jstate = jinv.PixFeaRecAdvStatefulState(nets["ap"], nets["as"], dp,
                                                tx.init(nets["ap"]), tx.init(dp),
                                                jnp.asarray(0))
        enc = _attgan(nets["ap"], nets["as"])
    disc = _disc(dp)
    step, evaluate = make_pix_fea_rec_adv_step(nets["gen"], enc, disc, nets["cnn"],
                                               AdamConfig(**ADAM), AdamConfig(**ADAM))
    for i in range(2):
        jstate, jm = jstep(jstate, real, jax.random.key(100 + i))
        m = step(torch.tensor(nets["real"]), tuple(torch.tensor(t) for t in _jax_draws(i)))
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=METRIC_RTOL, err_msg=k)
        _assert_tree_close(discriminator_tree(disc.state_dict()), jstate.disc_params,
                           STEP_ATOL, "D")
        if variant == "plain":
            _assert_tree_close(encoder_tree(enc.state_dict()), jstate.enc_params, STEP_ATOL, "E")
        else:
            params, state = encoder_attgan_tree(enc.state_dict())
            _assert_tree_close(params, jstate.enc_params, STEP_ATOL, "E")
            _assert_tree_close(state, jstate.enc_state, 1e-6, "E state")
    key = jax.random.key(200)
    jm = jeval(jstate, real, key)
    m = evaluate(torch.tensor(nets["real"]),
                 torch.tensor(np.asarray(jcommon.smooth_positive(key, (4,)))))
    assert m.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=METRIC_RTOL, err_msg=k)


def test_adversarial_step_keeps_only_the_d_loss_in_d_grad(nets):
    """After a step D's `.grad` is the gradient of the D loss (BCE + R1·γ/2)
    at the pre-step weights, within rtol 1e-6: R1 reaches it and the E
    step's backward adds nothing. G and the assessor get no gradient and
    keep requires_grad; E's BN statistics move once."""
    enc, disc = _attgan(nets["ap"], nets["as"]), _disc(nets["dp"])
    enc0, disc0 = copy.deepcopy(enc), copy.deepcopy(disc)
    real = torch.tensor(nets["real"])
    y_real, y_fake = (torch.tensor(t) for t in _jax_draws(0))
    step, _ = make_pix_fea_rec_adv_step(nets["gen"], enc, disc, nets["cnn"],
                                        AdamConfig(**ADAM), AdamConfig(**ADAM))
    step(real, (y_real, y_fake))
    with torch.no_grad():
        fake = nets["gen"](enc0.train()(real))
    loss_d = ((bce_from_logits(disc0.logits(real), y_real)
               + bce_from_logits(disc0.logits(fake), y_fake)) / 2.0
              + r1_penalty(disc0, real) * 5.0)
    want = torch.autograd.grad(loss_d, list(disc0.parameters()))
    for p, g in zip(disc.parameters(), want):
        torch.testing.assert_close(p.grad, g, rtol=1e-6, atol=0)
    for net in (nets["gen"], nets["cnn"]):
        assert all(p.grad is None and p.requires_grad for p in net.parameters())
    for (name, a), b in zip(enc0.named_buffers(), enc.buffers()):
        if "running" in name:  # enc0's one forward above is the step's one forward
            torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_frozen_restores_requires_grad():
    net = torch.nn.Linear(2, 2)
    net.bias.requires_grad_(False)
    x = torch.ones(1, 2, requires_grad=True)
    with frozen(net):
        assert not any(p.requires_grad for p in net.parameters())
        (g,) = torch.autograd.grad(net(x).sum(), x)  # gradients still flow through
    assert torch.equal(g, net.weight.detach().sum(0, keepdim=True))
    assert net.weight.requires_grad and not net.bias.requires_grad


def _images(n, seed=9):
    return np.random.RandomState(seed).rand(n, 1, 28, 28).astype(np.float32) * 2 - 1


def test_invert_matches_jax(nets):
    """3 images x 25 iterations (26 steps, the history rows before each
    update): z and every z recorded after an update within rtol 1e-4 atol
    1e-5, the history within rtol 1e-4."""
    x = _images(3)
    z_want, h_want = jinv.invert(jnp.asarray(x), nets["gp"], nets["gs"], nets["ep"],
                                 iterations=25, record_z=True)
    z, hist = invert(torch.tensor(x), nets["gen"], _encoder(nets["ep"]), iterations=25,
                     record_z=True)
    assert z.shape == (3, Z, 1, 1) and hist["z"].shape == (26, 3, Z, 1, 1)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), rtol=1e-4, atol=1e-5)
    assert hist.keys() == h_want.keys()
    for k in h_want:
        assert hist[k].shape == h_want[k].shape == ((26,) if k != "z" else (26, 3, Z, 1, 1))
        np.testing.assert_allclose(hist[k], h_want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert hist["loss"][-1] < hist["loss"][0]


def _particles():
    return np.random.RandomState(11).randn(4, 32, Z).astype(np.float32)


def test_invert_bn_matches_jax(nets):
    """3 images x 15 iterations (the JAX package's own test) fed its w0: z
    (the final pass's mix) and w (that pass's weights) within 1e-4
    absolute, the history within rtol 1e-5. The mix divides by Σ_c w_c,
    which magnifies rounding: the two packages' z are 1e-7 apart after one
    step and the gap doubles about every 5 (3e-5 at 15 steps, 1.5e-4 at
    25), while the losses stay within 2e-6."""
    x, parts, key = _images(3), _particles(), jax.random.key(27)
    w0 = np.asarray(jax.random.normal(key, (3, 4), jnp.float32))  # invert_bn's own draw
    z_want, w_want, h_want = jinv.invert_bn(jnp.asarray(x), nets["gp"], nets["gs"],
                                            nets["ep"], jnp.asarray(parts), iterations=15,
                                            key=key)
    z, w, hist = invert_bn(torch.tensor(x), nets["gen"], _encoder(nets["ep"]), parts,
                           iterations=15, w0=w0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_want), rtol=0, atol=1e-4)
    assert hist.keys() == h_want.keys() == {"loss", "loss_pix"}
    for k in h_want:
        assert hist[k].shape == (16,)
        np.testing.assert_allclose(hist[k], h_want[k], rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="dim_space"):
        invert_bn(torch.tensor(x), nets["gen"], _encoder(nets["ep"]), parts[..., :3],
                  iterations=1)


def test_invert_batched_equals_per_image(nets):
    """The loss sums per-image means, so each image's z from the batched run
    equals its own one-image run within atol 1e-5 (conv batching rounds
    differently)."""
    x = torch.tensor(_images(3, seed=22))
    enc = _encoder(nets["ep"])
    batched, _ = invert(x, nets["gen"], enc, iterations=25)
    for i in range(3):
        alone, _ = invert(x[i:i + 1], nets["gen"], enc, iterations=25)
        torch.testing.assert_close(batched[i], alone[0], rtol=0, atol=1e-5)


def test_invert_bn_batched_equals_per_image(nets):
    """Per-image weight vectors and summed per-image losses: each image's z
    and w from the batched run equal its one-image run (fed its row of w0)
    within atol 1e-5."""
    x = torch.tensor(_images(2, seed=25))
    parts, enc = _particles(), _encoder(nets["ep"])
    w0 = torch.randn((2, 4), generator=torch.Generator().manual_seed(27))
    zb, wb, _ = invert_bn(x, nets["gen"], enc, parts, iterations=15, w0=w0)
    for i in range(2):
        z1, w1, _ = invert_bn(x[i:i + 1], nets["gen"], enc, parts, iterations=15,
                              w0=w0[i:i + 1])
        torch.testing.assert_close(zb[i], z1[0], rtol=0, atol=1e-5)
        torch.testing.assert_close(wb[i], w1[0], rtol=0, atol=1e-5)
    # drawn from the generator when w0 is not given
    g = lambda: torch.Generator().manual_seed(27)  # noqa: E731
    _, w_drawn, _ = invert_bn(x, nets["gen"], enc, parts, iterations=0, generator=g())
    torch.testing.assert_close(w_drawn, torch.randn((2, 4), generator=g()), rtol=0, atol=0)


def test_gan_losses_and_smoothing_match_jax():
    """BCE from logits with soft targets up to 1.2 and BCE on probabilities
    within rtol 1e-6; the smoothed labels lie in U[0.7, 1.2] and U[0, 0.3]."""
    rs = np.random.RandomState(4)
    logits = (rs.randn(64) * 4).astype(np.float32)
    targets = rs.uniform(0, 1.2, 64).astype(np.float32)
    np.testing.assert_allclose(
        float(bce_from_logits(torch.tensor(logits), torch.tensor(targets))),
        float(jcommon.bce_from_logits(jnp.asarray(logits), jnp.asarray(targets))), rtol=1e-6)
    probs = rs.uniform(0, 1, 64).astype(np.float32)
    probs[:2] = (0.0, 1.0)
    np.testing.assert_allclose(
        float(bce_on_probs(torch.tensor(probs), torch.tensor(targets.clip(0, 1)))),
        float(jcommon.bce_on_probs(jnp.asarray(probs), jnp.asarray(targets.clip(0, 1)))),
        rtol=1e-6)
    np.testing.assert_allclose(  # optax's form of the same loss
        float(bce_from_logits(torch.tensor(logits), torch.tensor(targets))),
        float(jnp.mean(optax.sigmoid_binary_cross_entropy(logits, targets))), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    pos, neg = smooth_positive(g, (4096,)), smooth_negative(g, (4096,))
    assert 0.7 <= float(pos.min()) and float(pos.max()) < 1.2 and abs(float(pos.mean()) - 0.95) < 0.01
    assert 0.0 <= float(neg.min()) and float(neg.max()) < 0.3 and abs(float(neg.mean()) - 0.15) < 0.01


def test_postprocess_uint8_matches_jax():
    x = np.concatenate([np.linspace(-1.2, 1.2, 257), [-1.0, 1.0, 0.0]]).astype(np.float32)
    got = postprocess_uint8(torch.tensor(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_postprocess_uint8(jnp.asarray(x))))
