"""The port's evaluation layer against the JAX package's (and sklearn's and
scipy's) on the CPU: the KNN battery and its ties, the error-reject sweep,
the matrix square root and the FID, the inception score and the posterior
statistics, the CAE (forward, two train steps, the denoising loss), the
sampler and `evaluate_gan_epoch` fed the JAX package's draws, the
`classifiers.msgpack` bytes, the encoded-samples CSV text, and the `cae`
and `classifiers` stages through both CLIs on each other's files. Tiny
sizes: 100 idx train images and 40 test images, latent 6, batch 16."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from sklearn.neighbors import KNeighborsClassifier

from gan_discovery_pso_tpu.cli.main import main as jax_cli_main
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.evaluation import compute_posterior as jax_compute_posterior
from gan_discovery_pso_tpu.evaluation import denoise_recon_loss as jax_denoise_recon_loss
from gan_discovery_pso_tpu.evaluation import evaluate_gan_epoch as jax_evaluate_gan_epoch
from gan_discovery_pso_tpu.evaluation import fid_from_features as jax_fid
from gan_discovery_pso_tpu.evaluation import inception_score as jax_inception_score
from gan_discovery_pso_tpu.evaluation import load_battery as jax_load_battery
from gan_discovery_pso_tpu.evaluation import posterior_energy as jax_energy
from gan_discovery_pso_tpu.evaluation import posterior_variance as jax_variance
from gan_discovery_pso_tpu.evaluation import save_battery as jax_save_battery
from gan_discovery_pso_tpu.evaluation import train_classifier_battery as jax_train_battery
from gan_discovery_pso_tpu.evaluation.classifiers import error_reject_points as jax_error_reject
from gan_discovery_pso_tpu.models import GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.models.cae import CAEDef as JCAEDef
from gan_discovery_pso_tpu.models.cae import cae_decoder_apply, cae_encoder_apply
from gan_discovery_pso_tpu.ops import sqrtm_psd as jax_sqrtm_psd
from gan_discovery_pso_tpu.ops import trace_sqrt_product as jax_trace_sqrt_product
from gan_discovery_pso_tpu.ops.knn import knn_battery_posterior as jax_knn_battery
from gan_discovery_pso_tpu.ops.knn import knn_predict_proba as jax_knn_predict_proba
from gan_discovery_pso_tpu.ops.norm import BatchNormStats
from gan_discovery_pso_tpu.pipelines.stages import load_cae as jax_load_cae
from gan_discovery_pso_tpu.train import make_sampler as jax_make_sampler
from gan_discovery_pso_tpu.train.cae import cae_init, make_cae_steps as jax_make_cae_steps
from gan_discovery_pso_tpu.train.cae import save_encoded_samples_csv as jax_save_csv
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import (
    cae_decoder_state_dict,
    cae_decoder_tree,
    cae_encoder_state_dict,
    cae_encoder_tree,
    generator_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree
from gan_discovery_pso_tpu_torch.core.config import AdamConfig
from gan_discovery_pso_tpu_torch.evaluation import (
    compute_posterior,
    denoise_recon_loss,
    error_reject_points,
    evaluate_gan_epoch,
    fid_from_features,
    inception_score,
    load_battery,
    posterior_energy,
    posterior_variance,
    save_battery,
    train_classifier_battery,
)
from gan_discovery_pso_tpu_torch.models import CAEDecoder, CAEDef, CAEEncoder, Generator, GeneratorDef
from gan_discovery_pso_tpu_torch.ops import (
    knn_battery_posterior,
    knn_predict_proba,
    sqrtm_psd,
    trace_sqrt_product,
)
from gan_discovery_pso_tpu_torch.pipelines import load_cae
from gan_discovery_pso_tpu_torch.train.cae import make_cae_steps, save_encoded_samples_csv
from gan_discovery_pso_tpu_torch.train.common import make_optimizer
from gan_discovery_pso_tpu_torch.train.dcgan import make_sampler

CFG = "configs/dcgan_mnist.yaml"
LATENT = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _psd(n, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n).astype(np.float32)
    return (a @ a.T / n + 0.1 * np.eye(n)).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


# -- KNN ---------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5])
def test_knn_predict_proba_matches_sklearn_and_jax(k):
    """Equal to sklearn's predict_proba and to the JAX package's (atol 1e-6:
    shares of k votes)."""
    rng = np.random.RandomState(4)
    train_x = rng.randn(200, 10).astype(np.float32)
    train_y = (rng.rand(200) > 0.5).astype(np.uint8)
    queries = rng.randn(37, 10).astype(np.float32)
    want = KNeighborsClassifier(n_neighbors=k).fit(train_x, train_y).predict_proba(queries)[:, 1]
    got = knn_predict_proba(_t(queries), _t(train_x), _t(train_y), k=k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(jax_knn_predict_proba(
        jnp.asarray(queries), jnp.asarray(train_x), jnp.asarray(train_y), k=k)))


@pytest.mark.parametrize("k", [3, 5])
def test_battery_matches_sklearn_and_jax_chunked_or_not(k):
    """The 80/20 battery's posterior equal to one sklearn KNN per class on
    the head rows (atol 1e-6), to the JAX package's, and to itself in query
    chunks of 7 (bit for bit)."""
    rng = np.random.RandomState(3)
    emb = rng.randn(200, 6).astype(np.float32)
    labels = rng.choice([0, 2, 3, 7], size=200).astype(np.int32)
    queries = rng.randn(31, 6).astype(np.float32)
    battery = train_classifier_battery(emb, labels, k=k, device="cpu")
    got = compute_posterior(battery, queries).numpy()
    xt, yt = emb[:160], labels[:160]
    for ci, c in enumerate([0, 2, 3, 7]):
        want = KNeighborsClassifier(n_neighbors=k).fit(xt, (yt == c).astype(np.uint8))
        np.testing.assert_allclose(got[:, ci], want.predict_proba(queries)[:, 1], atol=1e-6)
    jbattery = jax_train_battery(emb, labels, k=k)
    np.testing.assert_array_equal(got, np.asarray(jax_compute_posterior(jbattery,
                                                                        jnp.asarray(queries))))
    chunked = compute_posterior(battery, queries, chunk_size=7).numpy()
    np.testing.assert_array_equal(chunked, got)
    assert compute_posterior(battery, queries, chunk_size=None).equal(torch.tensor(got))


@pytest.mark.parametrize("entry", ["train", "load"])
def test_battery_without_device_raises_on_a_host_without_cuda(entry, monkeypatch, tmp_path):
    """Like every loader of the port, the battery lands on the card unless
    the caller names a device; a host without CUDA raises rather than
    quietly keeping it on the CPU."""
    rng = np.random.RandomState(4)
    emb, labels = rng.randn(20, 3).astype(np.float32), rng.choice([0, 1], 20).astype(np.int32)
    save_battery(tmp_path / "b.msgpack", train_classifier_battery(emb, labels, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "train":
            train_classifier_battery(emb, labels)
        else:
            load_battery(tmp_path / "b.msgpack")


def test_posterior_refuses_queries_on_another_device():
    """A query tensor on another device than the battery raises instead of
    being copied across; a host array is taken to the battery's device."""
    rng = np.random.RandomState(5)
    emb, labels = rng.randn(20, 3).astype(np.float32), rng.choice([0, 1], 20).astype(np.int32)
    battery = train_classifier_battery(emb, labels, k=3, device="cpu")
    with pytest.raises(ValueError, match="battery on cpu"):
        compute_posterior(battery, torch.zeros(4, 3, device="meta"))
    assert compute_posterior(battery, emb[:4]).equal(compute_posterior(battery, _t(emb[:4])))


def test_knn_ties_go_to_the_lower_index_as_in_jax():
    """Training points duplicated under other labels: every query sits at
    the same distance from each copy, and the k nearest are the copies of
    lowest index, as `lax.top_k` picks them."""
    rng = np.random.RandomState(8)
    base = rng.randn(6, 4).astype(np.float32)
    train_x = np.concatenate([base, base, base])  # 3 copies of each point
    labels = np.repeat(np.asarray([0, 1, 2], np.int32), 6)
    classes = np.asarray([0, 1, 2], np.int32)
    queries = base[[0, 3, 5]] + 0.0
    for k in (1, 2, 3, 4, 5):
        got = knn_battery_posterior(_t(queries), _t(train_x), _t(labels), _t(classes), k=k)
        want = jax_knn_battery(jnp.asarray(queries), jnp.asarray(train_x), jnp.asarray(labels),
                               jnp.asarray(classes), k=k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # k = 2: the two nearest of each query are its copies 0 and 1 (labels 0, 1)
    got = knn_battery_posterior(_t(queries), _t(train_x), _t(labels), _t(classes), k=2)
    np.testing.assert_array_equal(got.numpy(), np.tile([0.5, 0.5, 0.0], (3, 1)))


def test_error_reject_points_match_jax():
    rng = np.random.RandomState(6)
    y = rng.randint(0, 2, 150)
    proba = rng.choice([0.0, 0.2, 0.4, 0.6, 0.8, 1.0], 150)
    for got, want in zip(error_reject_points(y, proba), jax_error_reject(y, proba)):
        np.testing.assert_array_equal(got, want)
    # nothing kept at a high threshold: 0 error, as the JAX sweep records
    p_rej, p_err, _ = error_reject_points(y, np.full(150, 0.6))
    assert p_rej[-1] == 100.0 and p_err[-1] == 0.0


# -- the FID and the posterior statistics ------------------------------------


def test_sqrtm_psd_matches_scipy_and_jax():
    """Elementwise within 2e-2 of scipy's float64 Schur root (fp32 eigh), and
    within 1e-5 of the JAX package's fp32 eigh root."""
    for seed in (0, 1):
        a = _psd(16, seed)
        got = sqrtm_psd(_t(a)).numpy()
        np.testing.assert_allclose(got, scipy.linalg.sqrtm(a).real, rtol=0, atol=2e-2)
        np.testing.assert_allclose(got @ got, a, rtol=0, atol=2e-2)
        np.testing.assert_allclose(got, np.asarray(jax_sqrtm_psd(jnp.asarray(a))), rtol=0,
                                   atol=1e-5)


def test_trace_sqrt_product_matches_scipy_and_jax():
    sx, sy = _psd(10, 2), _psd(10, 3)
    got = float(trace_sqrt_product(_t(sx), _t(sy)))
    np.testing.assert_allclose(got, np.trace(scipy.linalg.sqrtm(sx @ sy).real), rtol=1e-3)
    np.testing.assert_allclose(got, float(jax_trace_sqrt_product(jnp.asarray(sx),
                                                                 jnp.asarray(sy))), rtol=1e-5)


def test_fid_matches_scipy_and_jax():
    """Within rtol 1e-3 of the reference's scipy formula (float64), within
    rtol 1e-5 of the JAX package's; ~0 for identical sets."""
    rng = np.random.RandomState(0)
    real = rng.randn(300, 10).astype(np.float32)
    syn = (rng.randn(300, 10) * 1.3 + 0.5).astype(np.float32)
    cov_r, cov_s = np.cov(real, rowvar=False), np.cov(syn, rowvar=False)
    want = float(np.sum((real.mean(0) - syn.mean(0)) ** 2)
                 + np.trace(cov_r + cov_s - 2 * scipy.linalg.sqrtm(cov_r @ cov_s).real))
    got = float(fid_from_features(_t(real), _t(syn)))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got, float(jax_fid(jnp.asarray(real), jnp.asarray(syn))),
                               rtol=1e-5)
    assert abs(float(fid_from_features(_t(real), _t(real)))) < 1e-2


def test_inception_score_energy_and_variance_match_jax():
    """Within rtol 1e-5 of the JAX package's on a Dirichlet posterior with
    zeros in it; IS = 1 for a uniform posterior."""
    p = np.random.RandomState(2).dirichlet(np.ones(8), size=100).astype(np.float32)
    p[::7, 3] = 0.0
    np.testing.assert_allclose(float(inception_score(_t(p))),
                               float(jax_inception_score(jnp.asarray(p))), rtol=1e-5)
    np.testing.assert_allclose(posterior_energy(_t(p)).numpy(),
                               np.asarray(jax_energy(jnp.asarray(p))), rtol=1e-5)
    np.testing.assert_allclose(posterior_variance(_t(p)).numpy(),
                               np.asarray(jax_variance(jnp.asarray(p))), rtol=1e-5, atol=1e-9)
    u = np.full((50, 8), 1 / 8, np.float32)
    np.testing.assert_allclose(float(inception_score(_t(u))), 1.0, rtol=1e-5)


# -- the CAE -------------------------------------------------------------------


@pytest.fixture(scope="module")
def cae():
    """A JAX-initialised CAE (latent 6) and the port's modules on its
    weights."""
    state, _ = cae_init(jax.random.key(11), JCAEDef(LATENT), JAdamConfig())
    enc, dec = CAEEncoder(CAEDef(LATENT)), CAEDecoder(CAEDef(LATENT))
    tree = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)  # noqa: E731
    enc.load_state_dict(to_tensors(cae_encoder_state_dict(tree(state.enc_params),
                                                          tree(state.enc_state))), strict=True)
    dec.load_state_dict(to_tensors(cae_decoder_state_dict(tree(state.dec_params),
                                                          tree(state.dec_state))), strict=True)
    return state, enc.eval(), dec.eval()


def _np_trees(*trees):
    return [jax.tree.map(lambda a: np.array(a, copy=True), t) for t in trees]


def _assert_tree_close(got, want, rtol, atol):
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=rtol, atol=atol)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cae_forward_matches_jax(cae, train):
    """Latents and reconstructions within rtol 1e-5 (atol 1e-6) of the JAX
    package's, in eval mode and in train mode (batch statistics, the
    running ones updated alike); the weight maps round-trip the trees."""
    state, enc0, dec0 = cae
    import copy

    enc, dec = copy.deepcopy(enc0), copy.deepcopy(dec0)
    x = np.random.RandomState(1).rand(8, 1, 28, 28).astype(np.float32)
    z, es = cae_encoder_apply(state.enc_params, state.enc_state, jnp.asarray(x), train=train)
    rec, ds = cae_decoder_apply(state.dec_params, state.dec_state, z, train=train)
    enc.train(train)
    dec.train(train)
    with torch.no_grad():
        got_z = enc(torch.tensor(x))
        got_rec = dec(got_z)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(z), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_rec.numpy(), np.asarray(rec), rtol=1e-5, atol=1e-6)
    _assert_tree_close(cae_encoder_tree(enc.state_dict()), (state.enc_params, es), 1e-5, 1e-6)
    _assert_tree_close(cae_decoder_tree(dec.state_dict()), (state.dec_params, ds), 1e-5, 1e-6)


@pytest.mark.parametrize("task", ["denoising", "reconstruction"])
def test_two_cae_train_steps_match_jax(cae, task):
    """Two Adam steps (the shipped trainer_ae: lr 1e-3) on two batches, the
    denoising task fed the JAX package's noise draws; before the second the
    port takes the JAX package's updated weights. Per step: the loss
    within rtol 1e-5; after each, the BN statistics within rtol 1e-4 and
    the weights within rtol 1e-4 (atol 1e-7) where the first step's gradient
    is above 1 % of its tensor's largest and above 1e-4 of the largest of
    all (Adam's first step moves each entry by ±lr with its gradient's
    sign, which rounding can flip where the gradient is near 0: the bias of
    a conv that a BN follows has a gradient of 0 but for rounding)."""
    import copy

    state, enc0, dec0 = cae
    adam = JAdamConfig(lr=1e-3)
    jtrain, jeval = jax_make_cae_steps(JCAEDef(LATENT), adam, task, 0.3)
    enc, dec = copy.deepcopy(enc0), copy.deepcopy(dec0)
    opt = make_optimizer(AdamConfig(lr=1e-3), [*enc.parameters(), *dec.parameters()])
    train_step, eval_step = make_cae_steps(enc, dec, opt, task, 0.3)
    rs = np.random.RandomState(5)
    jstate = state
    for step in range(2):
        if step:  # from the JAX package's weights; each optimizer keeps its moments
            synced = {**to_tensors(cae_encoder_state_dict(*_np_trees(
                jstate.enc_params, jstate.enc_state))), **to_tensors(cae_decoder_state_dict(
                *_np_trees(jstate.dec_params, jstate.dec_state)))}
            with torch.no_grad():
                for module in (enc, dec):
                    for k, v in module.state_dict().items():
                        if not k.endswith("num_batches_tracked"):
                            v.copy_(synced[k])
        x = rs.rand(16, 1, 28, 28).astype(np.float32)
        key = jax.random.key(100 + step)
        noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        jstate, jloss = jtrain(jstate, jnp.asarray(x), key)
        loss = train_step(torch.tensor(x), noise=torch.tensor(noise))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        if step == 0:
            grads = [p.grad.clone() for p in [*enc.parameters(), *dec.parameters()]]
        got_e, got_d = cae_encoder_tree(enc.state_dict()), cae_decoder_tree(dec.state_dict())
        _assert_tree_close((got_e[1], got_d[1]), (jstate.enc_state, jstate.dec_state), 1e-4, 1e-7)
        named = dict([*(("e" + k, v) for k, v in enc.named_parameters()),
                      *(("d" + k, v) for k, v in dec.named_parameters())])
        jflat = {**{"e" + k: v for k, v in cae_encoder_state_dict(
                    jax.tree.map(np.asarray, jstate.enc_params),
                    jax.tree.map(np.asarray, jstate.enc_state)).items()},
                 **{"d" + k: v for k, v in cae_decoder_state_dict(
                    jax.tree.map(np.asarray, jstate.dec_params),
                    jax.tree.map(np.asarray, jstate.dec_state)).items()}}
        top = max(float(g.abs().max()) for g in grads)
        for g, (name, p) in zip(grads, named.items()):
            sure = ((g.abs() > 1e-2 * g.abs().max()) & (g.abs() > 1e-4 * top)).numpy()
            np.testing.assert_allclose(p.detach().numpy()[sure], jflat[name][sure], rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {step} {name}")
    x = rs.rand(16, 1, 28, 28).astype(np.float32)
    key = jax.random.key(7)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    np.testing.assert_allclose(float(eval_step(torch.tensor(x), noise=torch.tensor(noise))),
                               float(jeval(jstate, jnp.asarray(x), key)), rtol=1e-4)


def test_denoise_recon_loss_matches_jax(cae):
    state, enc, dec = cae
    x = np.random.RandomState(12).rand(20, 1, 28, 28).astype(np.float32)
    key = jax.random.key(12)
    want = jax_denoise_recon_loss(key, state.enc_params, state.enc_state, state.dec_params,
                                  state.dec_state, jnp.asarray(x), 0.3)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    got = denoise_recon_loss(enc, dec, torch.tensor(x), 0.3, noise=torch.tensor(noise))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.fixture(scope="module")
def gen():
    """G z=8 f=16 with torch's default init (its images move with z), and
    its JAX trees."""
    torch.manual_seed(0)
    g = Generator(GeneratorDef(8, 1, 16)).eval()
    gp, gs = generator_tree(g.state_dict())
    gs = {k: BatchNormStats(jnp.asarray(v["mean"]), jnp.asarray(v["var"])) for k, v in gs.items()}
    return g, jax.tree.map(jnp.asarray, gp), gs


def test_sampler_matches_jax(gen):
    """make_sampler's images (G, then each image rescaled to [0, 1] by the
    B2 wrapper's plain version on the CPU) within atol 1e-5 of the JAX
    sampler's on its z."""
    g, gp, gs = gen
    key = jax.random.key(3)
    want = jax_make_sampler(JGeneratorDef(8, 1, 16))(gp, gs, key, 10)
    z = np.asarray(jax.random.normal(key, (10, 8, 1, 1), jnp.float32))
    got = make_sampler(g)(10, z=torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    drawn = make_sampler(g)(4, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (4, 1, 28, 28) and float(drawn.min()) == 0 and float(drawn.max()) == 1


def test_evaluate_gan_epoch_matches_jax(cae, gen):
    """300 samples in chunks of 128, fed the z and noise the JAX evaluation
    draws from its key: the posterior equal, FID within rtol 1e-4, IS and
    the denoising loss within rtol 1e-5, energy and variance within rtol
    1e-5 of the JAX package's."""
    state, enc, dec = cae
    g, gp, gs = gen
    rs = np.random.RandomState(13)
    real = rs.rand(120, 1, 28, 28).astype(np.float32)
    emb = rs.randn(150, LATENT).astype(np.float32)
    labels = rs.choice([0, 2, 3], size=150).astype(np.int32)
    key = jax.random.key(14)
    n, chunk = 300, 128
    want = jax_evaluate_gan_epoch(
        key, jax_make_sampler(JGeneratorDef(8, 1, 16)), gp, gs, state.enc_params,
        state.enc_state, state.dec_params, state.dec_state, jax_train_battery(emb, labels),
        jnp.asarray(real), n_synthetic=n, chunk=chunk)
    ks, kn = jax.random.split(key)
    z = np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(ks, i),
                                                     (min(chunk, n - i), 8, 1, 1), jnp.float32))
                        for i in range(0, n, chunk)])
    noise = np.asarray(jax.random.normal(kn, (n, 1, 28, 28), jnp.float32))
    got = evaluate_gan_epoch(make_sampler(g), enc, dec,
                             train_classifier_battery(emb, labels, device="cpu"),
                             torch.tensor(real), n_synthetic=n, chunk=chunk,
                             z=torch.tensor(z), noise=torch.tensor(noise))
    np.testing.assert_array_equal(got.p_yx.numpy(), np.asarray(want.p_yx))
    np.testing.assert_allclose(float(got.fid), float(want.fid), rtol=1e-4)
    for name in ("inception_score", "rec_loss_syn", "energy", "variance"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)), rtol=1e-5, atol=1e-9,
                                   err_msg=name)


# -- files ---------------------------------------------------------------------


def test_classifiers_msgpack_is_byte_equal_to_jax(tmp_path):
    rng = np.random.RandomState(9)
    emb = rng.randn(60, 5).astype(np.float32)
    labels = rng.choice([0, 2, 7], size=60).astype(np.int32)
    save_battery(tmp_path / "port.msgpack",
                 train_classifier_battery(emb, labels, k=3, device="cpu"))
    jax_save_battery(tmp_path / "jax.msgpack", jax_train_battery(emb, labels, k=3))
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    mine = load_battery(tmp_path / "jax.msgpack", device="cpu")
    theirs = jax_load_battery(tmp_path / "port.msgpack")
    assert mine.k == theirs.k == 3 and type(load_pytree(tmp_path / "port.msgpack")["k"]) is int
    for a, b in zip(mine[:3], theirs[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_encoded_samples_csv_text_equals_jax(tmp_path):
    """The stdlib writer's text equals pandas' (the JAX writer), across
    magnitudes, NaN, infinities and signed zeros."""
    rng = np.random.RandomState(10)
    emb = (rng.randn(300, LATENT) * np.logspace(-9, 9, 300)[:, None]).astype(np.float32)
    emb[0, :5] = [np.nan, np.inf, -np.inf, 0.0, -0.0]
    labels = rng.randint(0, 10, 300).astype(np.int32)
    save_encoded_samples_csv(tmp_path / "port.csv", emb, labels)
    jax_save_csv(tmp_path / "jax.csv", emb, labels)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


# -- the stages through both CLIs ------------------------------------------------


def _write_idx(raw, n_train=100, n_test=40):
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


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """`cae` through each package's CLI (1 epoch, latent 6, batch 16), then
    `classifiers` through each CLI on the OTHER package's CAE."""
    root = tmp_path_factory.mktemp("eval_cli")
    _write_idx(root / "data" / "MNIST" / "raw")

    def sets(name):
        return ["--set", f"data.data_dir={root / 'data'}", "trainer_ae.batch_size=16",
                f"model_ae.latent_space={LATENT}",
                *(f"data.{k}_dir={root / name / k}" for k in ("reports", "model", "interim"))]

    def run_dir(name, kind, stage):
        return root / name / kind / "mnist" / f"00001--{stage}"

    for who, main, device in (("jax", jax_cli_main, []), ("port", cli_main, ["--device", "cpu"])):
        assert main(["cae", "--cfg", CFG, "--epochs", "1", *device, *sets(f"{who}_cae")]) == 0
    for who, main, device, other in (("jax", jax_cli_main, [], "port"),
                                     ("port", cli_main, ["--device", "cpu"], "jax")):
        assert main(["classifiers", "--cfg", CFG, *device, "--path-cae",
                     str(run_dir(f"{other}_cae", "model", "cae")),
                     *sets(f"{who}_cls")]) == 0
    return {f"{who}_{stage}": {kind: run_dir(f"{who}_{stage}", kind, name)
                               for kind in ("reports", "model", "interim")}
            for who in ("jax", "port") for stage, name in (("cae", "cae"),
                                                           ("cls", "classifiers"))}


def test_cli_cae_writes_the_jax_artifacts(cli_runs):
    """Both packages' cae runs write the same file names; each package loads
    the other's encoder.msgpack/decoder.msgpack, and its encoder gives the
    same latents (rtol 1e-5)."""
    for part in ("reports", "model", "interim"):
        names = [sorted(p.relative_to(cli_runs[f"{who}_cae"][part]).as_posix()
                        for p in cli_runs[f"{who}_cae"][part].rglob("*")
                        if p.is_file() and p.suffix != ".jsonl")
                 for who in ("jax", "port")]
        assert names[0] == names[1], part
    x = np.random.RandomState(2).rand(5, 1, 28, 28).astype(np.float32)
    for who in ("jax", "port"):
        enc, dec = load_cae(cli_runs[f"{who}_cae"]["model"], device="cpu")
        jstate = jax_load_cae(cli_runs[f"{who}_cae"]["model"])
        z, _ = cae_encoder_apply(jstate.enc_params, jstate.enc_state, jnp.asarray(x))
        rec, _ = cae_decoder_apply(jstate.dec_params, jstate.dec_state, z)
        with torch.no_grad():
            got_z = enc(torch.tensor(x))
            np.testing.assert_allclose(got_z.numpy(), np.asarray(z), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(dec(got_z).numpy(), np.asarray(rec), rtol=1e-5, atol=1e-6)


def test_cli_classifiers_on_each_others_cae_match(cli_runs):
    """The port's classifiers on the JAX package's CAE against the JAX
    package's on the port's CAE and on its own: the battery's classes and
    k equal, the CSVs of the same file's embeddings within rtol 1e-5, the
    artifact names equal."""
    port, jax_run = cli_runs["port_cls"], cli_runs["jax_cls"]
    mine = load_battery(port["model"] / "classifiers.msgpack", device="cpu")
    # the JAX package's classifiers on the JAX CAE: the port's read it here
    theirs = jax_load_battery(jax_run["model"] / "classifiers.msgpack")
    assert mine.k == theirs.k == 5
    np.testing.assert_array_equal(mine.classes.numpy(), np.asarray(theirs.classes))
    np.testing.assert_array_equal(mine.train_labels.numpy(), np.asarray(theirs.train_labels))
    assert mine.train_x.shape == theirs.train_x.shape == (64, LATENT)
    for part in ("reports", "model", "interim"):
        names = [sorted(p.relative_to(run[part]).as_posix() for p in run[part].rglob("*")
                        if p.is_file()) for run in (port, jax_run)]
        assert names[0] == names[1], part
    # the port's classifiers stage embeds with the JAX CAE as the JAX cae stage did
    for name in ("encoded_samples_train.csv", "encoded_samples_valid.csv"):
        a = np.loadtxt(port["interim"] / name, delimiter=",", skiprows=1)
        b = np.loadtxt(cli_runs["jax_cae"]["interim"] / name, delimiter=",", skiprows=1)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
