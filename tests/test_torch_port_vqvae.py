"""The port's VQ-VAE family against the JAX package's on the CPU: the
nearest-code lookup and the straight-through gradients (the codebook's
segment sum), the three variants' forwards on converted weights, the frozen
decoder, one `train_vqvae` epoch on injected batches and the empty-OoD
fallback, the PixelCNN's loss, causality and sampling, the codebook read
from a port-written pso-discovery dir, the dimension diagnosis, and `vqvae`
and `pixelcnn-prior` through both CLIs on JAX-written files. Tiny sizes:
embedding 8, 16-64 codes, G and the encoder at f=8, 200 idx train and 80
test images, batches of 16.

Tolerances: indices equal (the inputs hold no near-tie: the nearest and
second-nearest squared distances differ by more than 1e-5 relative);
forwards rtol 1e-5 (atol 1e-6; train-mode BN over a batch of 4 at rtol
1e-4); gradients rtol 1e-6; the epoch as its test states (optax and torch
apply Adam's bias correction in other orders, and a conv bias before a BN
moves by ±lr whatever rounding gives its gradient's sign)."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.cli.main import main as jax_cli_main
from gan_discovery_pso_tpu.core.checkpoint import load_pytree as jax_load_pytree
from gan_discovery_pso_tpu.core.checkpoint import save_pytree as jax_save_pytree
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.models import pixelcnn as jpix
from gan_discovery_pso_tpu.models import vqvae as jvq
from gan_discovery_pso_tpu.models.dcgan import GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.models.dcgan import generator_init
from gan_discovery_pso_tpu.pso.io import (
    load_final_particle_positions as jax_load_final_positions,
)
from gan_discovery_pso_tpu.pso.io import save_particle_histories as jax_save_particles
from gan_discovery_pso_tpu.train import vqvae as jtrain
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import (
    generator_state_dict,
    pixelcnn_state_dict,
    to_tensors,
    vqvae_state_dict,
    vqvae_tree,
)
from gan_discovery_pso_tpu_torch.core import AdamConfig, load_config
from gan_discovery_pso_tpu_torch.models import (
    Generator,
    GeneratorDef,
    PixelCNN,
    PixelCNNDef,
    VQVAEGan,
    VQVAEGanDef,
    codebook_from_pso,
    get_vqvae,
    load_frozen_decoder,
    pixelcnn_generate,
    pixelcnn_loss,
    vq_indices,
    vq_straight_through,
)
from gan_discovery_pso_tpu_torch.pipelines import StageContext, load_gan, load_vqvae, run_vqvae
from gan_discovery_pso_tpu_torch.pso import load_final_particle_positions, save_particle_histories
from gan_discovery_pso_tpu_torch.train.vqvae import VqvaeTrainState, train_vqvae

CFG = "configs/vqvae.yaml"
D, K, F_ = 8, 16, 8
ADAM = dict(lr=2e-4)  # the shipped trainer.optimizer
VQ_IID = (0, 1, 2, 3, 6, 7, 8, 9)  # configs/vqvae.yaml


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(tree):
    """A writable host copy; the JAX package's BN stats as {mean, var}."""
    def plain(node):
        if hasattr(node, "_fields"):  # BatchNormStats
            return {"mean": np.array(node.mean, copy=True), "var": np.array(node.var, copy=True)}
        if isinstance(node, dict):
            return {k: plain(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [plain(v) for v in node]
        return np.array(node, copy=True)
    return plain(tree)


def _near_ties(z_nhwc, codebook, rtol=1e-5) -> int:
    """Positions whose two nearest codes lie within rtol of each other."""
    flat = np.asarray(z_nhwc, np.float64).reshape(-1, codebook.shape[1])
    dist = ((flat[:, None, :] - np.asarray(codebook, np.float64)[None]) ** 2).sum(-1)
    s = np.sort(dist, axis=1)
    return int((s[:, 1] - s[:, 0] <= rtol * s[:, 1]).sum())


# -- vector quantisation ----------------------------------------------------------


def test_vq_indices_and_straight_through_gradients_match_jax():
    """The indices equal; d/dz_e of Σ3·z_q_st + Σ2·z_q_bar is 3 everywhere
    (straight through) and d/dcodebook is 2 x each code's use count (the
    segment sum), both within rtol 1e-6 of the JAX package's
    (tests/test_models_parity.py:319); the vq terms match within rtol
    1e-6."""
    z_e = np.asarray(jax.random.normal(jax.random.key(7), (2, 4, 3, 3)))
    codebook = np.asarray(jax.random.normal(jax.random.key(8), (6, 4)))
    assert _near_ties(np.moveaxis(z_e, 1, -1), codebook) == 0

    def jloss(z, cb):
        z_q_st, z_q_bar, idx = jvq.vq_straight_through(z, cb)
        return jnp.sum(z_q_st * 3.0) + jnp.sum(z_q_bar * 2.0), idx

    (_, jidx), (jg_z, jg_cb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z_e), jnp.asarray(codebook))
    z = torch.tensor(z_e, requires_grad=True)
    cb = torch.tensor(codebook, requires_grad=True)
    z_q_st, z_q_bar, idx = vq_straight_through(z, cb)
    (torch.sum(z_q_st * 3.0) + torch.sum(z_q_bar * 2.0)).backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        vq_indices(torch.tensor(np.moveaxis(z_e, 1, -1)), torch.tensor(codebook)).numpy(),
        np.asarray(jvq.vq_indices(jnp.moveaxis(jnp.asarray(z_e), 1, -1), jnp.asarray(codebook))))
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg_z), rtol=1e-6)
    np.testing.assert_allclose(cb.grad.numpy(), np.asarray(jg_cb), rtol=1e-6)
    counts = np.bincount(idx.numpy().ravel(), minlength=6).astype(np.float32)
    np.testing.assert_allclose(cb.grad.numpy(), 2.0 * counts[:, None] * np.ones((6, 4)))
    x, xt = (np.random.RandomState(s).rand(2, 1, 4, 4).astype(np.float32) for s in (1, 2))
    from gan_discovery_pso_tpu_torch.models import vq_loss_terms

    got = vq_loss_terms(torch.tensor(x), torch.tensor(xt), z, z_q_bar, 0.25)
    want = jvq.vq_loss_terms(jnp.asarray(x), jnp.asarray(xt), jnp.asarray(z_e),
                             jnp.take(jnp.asarray(codebook), jidx, axis=0).transpose(0, 3, 1, 2),
                             0.25)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-6)


_VARIANTS = {"vqvae": dict(embedded_dim=D, num_embedding=K),
             "vqvae_mnist": dict(embedded_dim=D, num_embedding=K, num_hiddens=8),
             "vqvae_dcgan": dict(embedded_dim=D, num_embedding=K, features_g=F_, features_d=F_)}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_variant_forwards_match_jax(variant):
    """Each variant on the JAX package's init, converted: x̃, z_e, z_q_bar
    and the indices in eval mode within rtol 1e-5 (atol 1e-6), in train mode
    within rtol 1e-4 (atol 1e-5) with the BN statistics after one update
    within 1e-6 (tests/test_models_parity.py:342,358); vqvae_dcgan with its
    decoder frozen and not; `vqvae_tree` gives the JAX tree back."""
    JDef, jinit, japply = jvq.get_vqvae(variant)
    jd = JDef(**_VARIANTS[variant])
    params, state = jinit(jax.random.key(20), jd)
    Def, Module = get_vqvae(variant)
    x = np.random.RandomState(1).rand(4, 1, 28, 28).astype(np.float32) * 2 - 1
    for frozen in ((False, True) if variant == "vqvae_dcgan" else (False,)):
        model = Module(Def(**_VARIANTS[variant]))
        model.load_state_dict(to_tensors(vqvae_state_dict(_host(params), _host(state),
                                                          variant)), strict=True)
        kw = {"frozen_decoder": frozen} if variant == "vqvae_dcgan" else {}
        if frozen:
            load_frozen_decoder(model, model.decoder)
        for train, (rtol, atol) in ((False, (1e-5, 1e-6)), (True, (1e-4, 1e-5))):
            want = jax.jit(lambda p, st, xx: japply(p, st, xx, jd, train=train, **kw))(
                params, state, jnp.asarray(x))
            with torch.no_grad():
                got = model.train(train)(torch.tensor(x))
            assert got[0].shape == (4, 1, 28, 28)
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
            _p, new_state = vqvae_tree(model.state_dict(), variant)
            for a, b in zip(jax.tree.leaves(new_state), jax.tree.leaves(_host(want[4]))):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            model.load_state_dict(to_tensors(vqvae_state_dict(_host(params), _host(state),
                                                              variant)), strict=True)
    p, _s = vqvae_tree(model.state_dict(), variant)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(_host(params))):
        np.testing.assert_array_equal(a, b)


# -- training -------------------------------------------------------------------------


def _gen(seed=14):
    """A G (z=D, f=8, torch-default init) and its JAX trees."""
    gp, gs = generator_init(jax.random.key(seed), JGeneratorDef(D, 1, F_), dcgan_init=False)
    gen = Generator(GeneratorDef(D, 1, F_))
    gen.load_state_dict(to_tensors(generator_state_dict(_host(gp), _host(gs))), strict=True)
    return gen.eval(), gp, gs


def _jax_vqvae(data_pso, gp, gs, seed=15):
    jd = jvq.VQVAEGanDef(1, D, K, F_, F_)
    state, _ = jtrain.vqvae_init(jax.random.key(seed), jd, JAdamConfig(**ADAM),
                                 data_pso=data_pso, frozen_gen=(gp, gs))
    return jd, state


def _port_vqvae(jstate, gen):
    model = VQVAEGan(VQVAEGanDef(1, D, K, F_, F_))
    model.load_state_dict(to_tensors(vqvae_state_dict(_host(jstate.params),
                                                      _host(jstate.model_state))), strict=True)
    load_frozen_decoder(model, gen)
    from gan_discovery_pso_tpu_torch.train.common import make_optimizer

    return VqvaeTrainState(model, make_optimizer(
        AdamConfig(**ADAM), [p for p in model.parameters() if p.requires_grad]))


def test_frozen_decoder_stays_frozen():
    """tests/test_train.py:321 on the port: three train steps move the
    encoder and the codebook, leave the decoder's weights and BN statistics
    bit-equal to G's, give it no gradient, and Adam holds no state for it."""
    gen, gp, gs = _gen()
    data_pso = np.random.RandomState(5).randn(K, D).astype(np.float32)
    _jd, jstate = _jax_vqvae(data_pso, gp, gs)
    state = _port_vqvae(jstate, gen)
    np.testing.assert_array_equal(state.model.codebook.detach().numpy(), data_pso)
    from gan_discovery_pso_tpu_torch.train.vqvae import make_vqvae_steps

    train_step, _ = make_vqvae_steps(state)
    x = torch.tensor(np.random.RandomState(12).rand(8, 1, 28, 28).astype(np.float32) * 2 - 1)
    for _ in range(3):
        assert np.isfinite(float(train_step(x)["loss"]))
    for k, v in gen.state_dict().items():
        assert torch.equal(state.model.decoder.state_dict()[k], v), k
    assert all(p.grad is None and not p.requires_grad for p in state.model.decoder.parameters())
    assert not any(p in state.opt.state for p in state.model.decoder.parameters())
    assert not np.allclose(state.model.codebook.detach().numpy(), data_pso)
    assert not state.model.decoder.training and state.model.train().decoder.training is False


def test_one_train_vqvae_epoch_matches_jax():
    """One epoch of `train_vqvae` on the same injected batches (3 train, 1
    val IiD, 1 val OoD): the train losses within rtol 1e-5 of the JAX
    package's, the same best epoch, the codebook and the encoder within
    5e-6, and the decoder equal to G. encoder.conv2's bias feeds a BN: its
    gradient is 0 but for rounding, so Adam moves it by ±lr a step with
    either sign (within 2 x 3 steps x lr of the JAX package's), which the
    batch statistics cancel in train mode but the running statistics do not
    in eval mode: the val losses within rtol 1e-3."""
    gen, gp, gs = _gen()
    data_pso = np.random.RandomState(6).randn(K, D).astype(np.float32)
    jd, jstate = _jax_vqvae(data_pso, gp, gs)
    state = _port_vqvae(jstate, gen)
    rs = np.random.RandomState(9)
    batches = [rs.rand(8, 1, 28, 28).astype(np.float32) * 2 - 1 for _ in range(5)]

    def feed(sel, wrap):
        return lambda _e: [(wrap(b), None) for b in sel]

    jout, jhist, jbest = jtrain.train_vqvae(
        jstate, jd, JAdamConfig(**ADAM), feed(batches[:3], jnp.asarray),
        feed(batches[3:4], jnp.asarray), feed(batches[4:], jnp.asarray), num_epochs=1)
    out, hist, best = train_vqvae(state, feed(batches[:3], torch.tensor),
                                  feed(batches[3:4], torch.tensor),
                                  feed(batches[4:], torch.tensor), num_epochs=1)
    assert best == jbest and hist.keys() == jhist.keys()
    for k in jhist:  # the eval-mode losses see encoder.conv2's bias, below
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-5 if k.startswith("train") else
                                   1e-3, err_msg=k)
    params, _state = vqvae_tree(out.model.state_dict())
    want = _host(jout.params)
    for part in ("encoder", "codebook"):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params[part]),
                                jax.tree.leaves(want[part])):
            bias_before_bn = jax.tree_util.keystr(path) == "['conv2']['b']"
            np.testing.assert_allclose(a, b, rtol=0, atol=6 * ADAM["lr"] if bias_before_bn
                                       else 5e-6, err_msg=f"{part}{path}")
    for a, b in zip(jax.tree.leaves(params["decoder"]), jax.tree.leaves(_host(gp))):
        np.testing.assert_array_equal(a, b)


def test_train_vqvae_empty_val_ood_falls_back_to_val_iid():
    """tests/test_train.py:340 on the port: with no OoD batch every val-OoD
    loss is NaN, and the best epoch is chosen by the val-IiD loss, not left
    at the initial weights."""
    gen, gp, gs = _gen()
    _jd, jstate = _jax_vqvae(None, gp, gs)
    state = _port_vqvae(jstate, gen)
    enc0 = [p.detach().clone() for p in state.model.encoder.parameters()]
    x = torch.tensor(np.random.RandomState(12).rand(8, 1, 28, 28).astype(np.float32) * 2 - 1)
    out, history, best = train_vqvae(state, lambda _e: [(x, None)], lambda _e: [(x, None)],
                                     lambda _e: [], num_epochs=3)
    assert all(np.isnan(v) for v in history["val_ood_loss"])
    assert best == int(np.argmin(history["val_iid_loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(enc0, out.model.encoder.parameters()))


# -- the PixelCNN prior ----------------------------------------------------------------


@pytest.fixture(scope="module")
def pixel():
    d = jpix.PixelCNNDef(input_dim=8, dim=8, n_layers=3, n_classes=2)
    params = jpix.pixelcnn_init(jax.random.key(2), d)
    model = PixelCNN(PixelCNNDef(*d))
    model.load_state_dict(to_tensors(pixelcnn_state_dict(_host(params))), strict=True)
    return d, params, model


def test_pixelcnn_logits_and_loss_match_jax(pixel):
    """Logits within rtol 1e-5 (atol 1e-5), the loss within rtol 1e-5, and
    the loss's gradient of the embedding within rtol 1e-4 (atol 1e-6) of
    the JAX package's."""
    d, params, model = pixel
    idx = np.random.RandomState(3).randint(0, 8, (4, 5, 5))
    label = np.array([0, 1, 1, 0])
    want = jpix.pixelcnn_apply(params, d, jnp.asarray(idx), jnp.asarray(label))
    got = model(torch.tensor(idx), torch.tensor(label))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, i, y: jpix.pixelcnn_loss(p, d, i, y)))(
        params, jnp.asarray(idx), jnp.asarray(label))
    loss = pixelcnn_loss(model, torch.tensor(idx), torch.tensor(label))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    (g,) = torch.autograd.grad(loss, [model.embedding])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["embedding"]), rtol=1e-4, atol=1e-6)


def test_pixelcnn_is_causal_and_its_mask_leaves_the_weights(pixel):
    """tests/test_pixelcnn_augment.py:32 on the port: the logits at (2, 2) and
    before it in raster order ignore the inputs at (2, 2) and after; a later
    position does change; the forward leaves the first layer's stored
    weights as they were (the mask multiplies, it does not write)."""
    _d, _params, model = pixel
    before = model.layers[0].vert.weight.detach().clone()
    idx = np.random.RandomState(3).randint(0, 8, (1, 5, 5))
    label = torch.tensor([0])
    with torch.no_grad():
        base = model(torch.tensor(idx), label).numpy()
        idx2 = idx.copy()
        idx2[0, 2, 2:] = (idx2[0, 2, 2:] + 1) % 8
        idx2[0, 3:, :] = (idx2[0, 3:, :] + 3) % 8
        out2 = model(torch.tensor(idx2), label).numpy()
    np.testing.assert_allclose(out2[0, :, :2, :], base[0, :, :2, :], atol=1e-5)
    np.testing.assert_allclose(out2[0, :, 2, :3], base[0, :, 2, :3], atol=1e-5)
    assert np.abs(out2[0, :, 3, 3] - base[0, :, 3, 3]).max() > 1e-6
    assert torch.equal(model.layers[0].vert.weight, before) and float(before[:, :, -1].abs().sum())


def test_pixelcnn_generate_shape(pixel):
    _d, _params, model = pixel
    samp = pixelcnn_generate(model, torch.tensor([0, 1]), shape=(4, 4),
                             generator=torch.Generator().manual_seed(0))
    assert samp.shape == (2, 4, 4) and int(samp.min()) >= 0 and int(samp.max()) < 8


# -- the stages ------------------------------------------------------------------------


def _write_idx(raw, n_train=200, n_test=80):
    raw.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(0)
    for split, n in (("train", n_train), ("t10k", n_test)):
        images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = (np.arange(n) % 10).astype(np.uint8)
        rs.shuffle(labels)
        (raw / f"{split}-images-idx3-ubyte").write_bytes(
            struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
        (raw / f"{split}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 0x801, n) + labels.tobytes())


def test_codebook_from_a_port_pso_dir_equals_jax(tmp_path):
    """The final particles the port's `save_particle_histories` wrote, read
    by each package and stacked over the classes, are the same codebook bit
    for bit."""
    rs = np.random.RandomState(4)
    for c in VQ_IID:
        traj = rs.randn(3, 8, D).astype(np.float32)
        save_particle_histories(tmp_path, c, traj, np.zeros_like(traj), pickles=False)
    mine = codebook_from_pso(np.concatenate(
        [load_final_particle_positions(tmp_path, c, "iid") for c in VQ_IID]))
    theirs = jvq.codebook_from_pso(np.concatenate(
        [jax_load_final_positions(tmp_path, c, "iid") for c in VQ_IID]))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert mine.shape == (64, D)


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """Files the JAX package wrote: G (z=8, f=8) as best_g, a pso-discovery
    interim dir with 8 final particles of each IiD class of vqvae.yaml, idx
    data. Then `vqvae --tiny` through both CLIs, and `pixelcnn-prior` through
    each on the OTHER package's vqvae run."""
    root = tmp_path_factory.mktemp("vqvae")
    _write_idx(root / "data" / "MNIST" / "raw")
    gp, gs = generator_init(jax.random.key(14), JGeneratorDef(D, 1, F_), dcgan_init=False)
    gan = root / "up" / "gan"
    jax_save_pytree(gan / "best_g.msgpack",
                    {"epoch": 0, "state": {"gen_params": gp, "gen_state": gs}, "loss": 0.5})
    pso = root / "up" / "pso"
    rs = np.random.RandomState(4)
    for c in VQ_IID:
        traj = rs.randn(3, 8, D).astype(np.float32)
        jax_save_particles(pso, c, traj, np.zeros_like(traj))
    out = {"root": root, "gan": gan, "pso": pso}
    mains = (("jax", jax_cli_main, []), ("port", cli_main, ["--device", "cpu"]))
    for who, main, device in mains:
        assert main(["vqvae", "--cfg", CFG, "--tiny", *device, "--path-gan", str(gan),
                     "--path-pso", str(pso), *_sets(root, f"{who}_vq")]) == 0
        out[f"{who}_vq"] = _run_dirs(root, f"{who}_vq", "vqvae")
    for (who, main, device), other in zip(mains, ("port", "jax")):
        assert main(["pixelcnn-prior", "--cfg", CFG, "--tiny", *device, "--path-vqvae",
                     str(out[f"{other}_vq"]["model"]), *_sets(root, f"{who}_pix")]) == 0
        out[f"{who}_pix"] = _run_dirs(root, f"{who}_pix", "pixelcnn_prior")
    return out


def _sets(root, name, **extra):
    sets = {"data.data_dir": str(root / "data"), "trainer.batch_size": 16,
            **{f"data.{k}_dir": str(root / name / k) for k in ("reports", "model", "interim")},
            **extra}
    return ["--set", *(f"{k}={v}" for k, v in sets.items())]


def _run_dirs(root, name, module):
    return {k: root / name / k / "mnist" / f"00001--{module}"
            for k in ("reports", "model", "interim")}


def _names(d):
    return sorted(p.relative_to(d).as_posix() for p in d.rglob("*") if p.is_file())


def test_cli_vqvae_and_pixelcnn_prior_write_the_jax_artifacts(upstream):
    """Both CLIs' vqvae and pixelcnn-prior runs hold the same file names in
    every run dir (tests/test_pipeline_e2e.py:346,699); the codebook at
    model_1 came from the particles; the port's decoder is G bit for bit; a
    finite history; each package's pixelcnn.msgpack has its def's K = 64."""
    for stage in ("vq", "pix"):
        for part in ("reports", "model", "interim"):
            names = [_names(upstream[f"{who}_{stage}"][part]) for who in ("jax", "port")]
            assert names[0] == names[1], (stage, part)
    codes = np.concatenate([jax_load_final_positions(upstream["pso"], c, "iid") for c in VQ_IID])
    for who in ("jax", "port"):
        for stage, name in (("vq", "history_vqvae.jsonl"), ("pix", "history_pixelcnn.jsonl")):
            rows = (upstream[f"{who}_{stage}"]["reports"] / name).read_text().splitlines()
            assert len(rows) == 1 and np.isfinite(json.loads(rows[0])["train_loss"])
        model = load_vqvae(upstream[f"{who}_vq"]["model"], load_config(CFG, overrides={
            "model_gan.network.units_gen": F_, "model_gan.network.units_disc": F_}),
            device="cpu")
        assert tuple(model.codebook.shape) == (64, D)
        pix = jax_load_pytree(upstream[f"{who}_pix"]["model"] / "pixelcnn.msgpack")
        assert int(pix["def"]["input_dim"]) == 64
    gen = load_gan(upstream["gan"], device="cpu")
    port = load_vqvae(upstream["port_vq"]["model"], load_config(CFG, overrides={
        "model_gan.network.units_gen": F_, "model_gan.network.units_disc": F_}), device="cpu")
    for k, v in gen.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(port.decoder.state_dict()[k], v), k
    first = jax_load_pytree(upstream["port_vq"]["model"] / "model_1.msgpack")
    assert not np.array_equal(np.asarray(first["params"]["codebook"]), codes)  # trained
    assert np.abs(np.asarray(first["params"]["codebook"]) - codes).max() < 0.05


def test_vqvae_diagnoses_dim_mismatch(upstream):
    """tests/test_pipeline_e2e.py:432 on the port: an embedding_dim other
    than the particles' is refused, naming embedding_dim, before training."""
    root = upstream["root"]
    cfg = load_config(CFG, overrides={
        "data.data_dir": str(root / "data"), "model.latent_space.embedding_dim": 100,
        "model_gan.network.units_gen": F_, "model_gan.network.units_disc": F_,
        **{f"data.{k}_dir": str(root / "mismatch" / k) for k in ("reports", "model",
                                                                 "interim")}})
    ctx = StageContext.create(cfg, "vq_vae", device="cpu")
    with pytest.raises(ValueError, match="embedding_dim"):
        run_vqvae(ctx, load_gan(upstream["gan"], device="cpu"), pso_interim_dir=upstream["pso"],
                  epochs=1)


def test_cli_refuses_fast_math_on_the_vqvae_stages(capsys, tmp_path):
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    for stage in ("vqvae", "pixelcnn-prior"):
        assert cli_main([stage, "--cfg", CFG, "--fast-math", "--device", "cpu", "--set",
                         *roots]) == 2
        assert "ROADMAP A18" in capsys.readouterr().err
    assert not (tmp_path / "reports").exists()
