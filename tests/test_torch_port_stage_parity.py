"""The port's training stages held to the JAX package's over whole epochs
on the CPU: `run_cnn_multipatient` (its history, its early stop and the
best checkpoint it reloads and saves), `run_inverter` in both training
functions on one assessor, `run_cae` and `run_dcgan` (the losses and the
FID, IS and denoising loss of every epoch).

Both stages start from the same weights (the JAX package's init from the
same key, carried into the port's modules through `compat/weights.py`),
take the same batches (one fixed order an epoch, injected into both
contexts' `batches`) and the same draws (the JAX package's label
smoothing, noise and evaluation draws, handed to the port where its stage
asks its key chain or its sampler for them). The step-level tests hold
two steps; these hold the loops around them: modes, batch order, eval,
best-state selection, early stop and the checkpoints.

Tiny sizes: 120 random idx train images and 60 test images, batch 16, two
epochs (three asked of the assessor, which stops early), G z 8 f 16, D f 8,
and a ResNet of one bottleneck a stage (the ResNet-50 block at every
width, registered in both packages' layer tables for this file only).
Plots are not drawn. Tolerances, per column, as each test states: fp32
rounding grows over an epoch's steps (Adam's first steps move entries
whose gradient sits at rounding level by ±lr), so the assessor trains at
lr 1e-5 here, where that growth stays under 1e-3 of the losses.

A fault these stages showed on the card is held here too: under
`--fast-math` (`tf32_math()`) the FID's covariance and square root, the KNN
battery's distances, the swarm's mean pairwise distance and the VQ
codebook's distances must keep full fp32, as the JAX package pins them with
an explicit `precision=HIGHEST` that its `fast_math()` does not relax."""

import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.core.checkpoint import load_pytree as jax_load_pytree
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.core.prng import KeyChain as JKeyChain
from gan_discovery_pso_tpu.evaluation.fid import fid_from_features as jax_fid_from_features
from gan_discovery_pso_tpu.evaluation import classifiers as jax_classifiers
from gan_discovery_pso_tpu.models import DiscriminatorDef as JDiscriminatorDef
from gan_discovery_pso_tpu.models import GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.models import discriminator_init
from gan_discovery_pso_tpu.models import resnet as jax_resnet
from gan_discovery_pso_tpu.models.cae import CAEDef as JCAEDef
from gan_discovery_pso_tpu.models.encoder import EncoderDef as JEncoderDef
from gan_discovery_pso_tpu.models.encoder import encoder_init
from gan_discovery_pso_tpu.ops.norm import BatchNormStats
from gan_discovery_pso_tpu.pso.swarm import mean_pairwise_distance as jax_mean_pairwise_distance
from gan_discovery_pso_tpu.pipelines import StageContext as JStageContext
from gan_discovery_pso_tpu.pipelines import stages as jax_stages
from gan_discovery_pso_tpu.train.cae import CaeTrainState, cae_init
from gan_discovery_pso_tpu.train.cae import encode_dataset as jax_encode_dataset
from gan_discovery_pso_tpu.train.common import smooth_negative as jax_smooth_negative
from gan_discovery_pso_tpu.train.common import smooth_positive as jax_smooth_positive
from gan_discovery_pso_tpu.train.dcgan import gan_init as jax_gan_init
from gan_discovery_pso_tpu_torch.analysis import reporting
from gan_discovery_pso_tpu_torch.compat import (
    cae_decoder_state_dict,
    cae_decoder_tree,
    cae_encoder_state_dict,
    cae_encoder_tree,
    discriminator_state_dict,
    encoder_state_dict,
    generator_state_dict,
    generator_tree,
    resnet_state_dict,
    resnet_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.evaluation.classifiers import (
    compute_posterior,
    load_battery,
    train_classifier_battery,
)
from gan_discovery_pso_tpu_torch.evaluation.fid import fid_from_features
from gan_discovery_pso_tpu_torch.models import (
    CAEDecoder,
    CAEDef,
    CAEEncoder,
    Discriminator,
    Encoder,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    glorot_normal_init_,
)
from gan_discovery_pso_tpu_torch.models import resnet as port_resnet
from gan_discovery_pso_tpu_torch.models.layers import torch_default_init_
from gan_discovery_pso_tpu_torch.models.vqvae import vq_indices
from gan_discovery_pso_tpu_torch.ops.precision import tf32_math
from gan_discovery_pso_tpu_torch.pipelines import StageContext
from gan_discovery_pso_tpu_torch.pipelines import stages as port_stages
from gan_discovery_pso_tpu_torch.pso.swarm import mean_pairwise_distance
from gan_discovery_pso_tpu_torch.train import cae as port_cae
from gan_discovery_pso_tpu_torch.train.common import make_optimizer
from gan_discovery_pso_tpu_torch.train.dcgan import GanTrainState

CFG = "configs/dcgan_mnist.yaml"
SEED = 42  # the shipped config's
IID = (0, 2, 3, 4, 6, 7, 8, 9)
TINY = "ResNetTiny"
Z, F_G, F_D, BS, N_SYNTHETIC = 8, 16, 8, 16, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def _tiny_resnet():
    """A ResNet of one bottleneck a stage in both packages' layer tables."""
    for module in (jax_resnet, port_resnet):
        module._LAYERS[TINY] = (1, 1, 1, 1)
    yield
    for module in (jax_resnet, port_resnet):
        del module._LAYERS[TINY]


class _NoPlots:
    """A stand-in for the JAX stages' `reporting` module: no figure."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


@pytest.fixture(autouse=True)
def _no_plots(monkeypatch):
    monkeypatch.setattr(jax_stages, "reporting", _NoPlots())
    monkeypatch.setattr(reporting, "host_has", lambda package: False)


def _write_idx(raw, n_train=120, n_test=60, seed=0):
    """Random 28x28 idx files, labels 0-9 in equal numbers, shuffled."""
    raw.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("t10k", n_test)):
        images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = (np.arange(n) % 10).astype(np.uint8)
        rs.shuffle(labels)
        (raw / f"{split}-images-idx3-ubyte").write_bytes(
            struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
        (raw / f"{split}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 0x801, n) + labels.tobytes())


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage_parity")
    _write_idx(root / "data" / "MNIST" / "raw")
    return root


def _contexts(root, module, name, **overrides):
    """(JAX context, port context) of one stage on the same data, each with
    its own run dirs and the same fixed batch order."""
    sets = {"data.data_dir": str(root / "data"), **overrides}
    dirs = lambda who: {f"data.{k}_dir": str(root / name / who / k)  # noqa: E731
                        for k in ("reports", "model", "interim")}
    jctx = JStageContext.create(CFG, module, overrides={**sets, **dirs("jax")})
    pctx = StageContext.create(CFG, module, device="cpu", overrides={**sets, **dirs("port")})
    jctx.batches, pctx.batches = _jax_batches, _port_batches
    return jctx, pctx


def _order(n: int, batch_size: int, epoch: int, drop_last: bool) -> list:
    """Epoch `epoch`'s batches of indices into a dataset of n images."""
    perm = np.random.RandomState(1000 + epoch).permutation(n)
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    return [perm[b * batch_size:(b + 1) * batch_size] for b in range(n_batches)]


def _jax_batches(ds, batch_size, drop_last=True):
    return lambda epoch: iter([
        (ds.images[jnp.asarray(ix)], ds.labels[jnp.asarray(ix)])
        for ix in _order(len(ds.images), batch_size, epoch, drop_last)])


def _port_batches(ds, batch_size, drop_last=True):
    return lambda epoch: iter([
        (ds.images[torch.as_tensor(ix)], ds.labels[torch.as_tensor(ix)])
        for ix in _order(ds.images.shape[0], batch_size, epoch, drop_last)])


class _RecordingKeys:
    """The JAX context's key chain, recording what `streams` hand out."""

    def __init__(self, keys, streams):
        self.keys, self.log = keys, {s: [] for s in streams}

    def __call__(self, stream):
        key = self.keys(stream)
        if stream in self.log:
            self.log[stream].append(key)
        return key

    def __getattr__(self, name):
        return getattr(self.keys, name)


class _FeedingKeys:
    """The port context's key chain, handing out given draws for `feeds`'
    streams (call i of a stream gets feeds[stream](i)) and for `fold`."""

    def __init__(self, keys, feeds, fold=None):
        self.keys, self.feeds, self.calls, self._fold = keys, feeds, dict.fromkeys(feeds, 0), fold

    def __call__(self, stream, device=None):
        if stream not in self.feeds:
            return self.keys(stream, device)
        i = self.calls[stream]
        self.calls[stream] += 1
        return self.feeds[stream](i)

    def fold(self, stream, *indices, device=None):
        return self._fold(stream, *indices)

    def __getattr__(self, name):
        return getattr(self.keys, name)


def _host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _bn_stats(node):
    if isinstance(node, dict) and set(node) == {"mean", "var"}:
        return BatchNormStats(jnp.asarray(node["mean"]), jnp.asarray(node["var"]))
    if isinstance(node, dict):
        return {k: _bn_stats(v) for k, v in node.items()}
    return [_bn_stats(v) for v in node]


def _history(ctx) -> dict:
    with open(ctx.run.reports_dir / "general" / "overall_history.pkl", "rb") as f:
        return pickle.load(f)


def _assert_history(got: dict, want: dict, rtol: dict, atol: float = 1e-7):
    assert set(got) >= set(want)
    for key, w in want.items():
        g = np.asarray(got[key], np.float64)
        assert g.shape == np.shape(w), key
        tol = next((t for prefix, t in rtol.items() if key.startswith(prefix)), rtol[""])
        np.testing.assert_allclose(g, np.asarray(w, np.float64), rtol=tol, atol=atol,
                                   err_msg=key)


def _assert_checkpoints(jctx, pctx, name: str, atol: float):
    want = jax.tree.leaves(jax_load_pytree(jctx.run.models_dir / name))
    got = jax.tree.leaves(jax_load_pytree(pctx.run.models_dir / name))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=atol)


# -- the assessor --------------------------------------------------------------


def test_cnn_multipatient_stage_matches_jax(data_root, monkeypatch):
    """Three epochs asked, early stop after one without improvement: the
    stage stops at the same epoch (the val loss rises after epoch 0 on
    random images at lr 1e-5), every history column within rtol 1e-3
    (the counts equal), and `model.msgpack` holds the best epoch's
    weights and BN statistics within 1e-3 of the JAX stage's."""
    jctx, pctx = _contexts(data_root, "cnn_multipatient", "cnn",
                           **{"trainer_cnn.batch_size": BS, "model_cnn.model_name": TINY,
                              "trainer_cnn.early_stopping": 1,
                              "trainer_cnn.optimizer.lr": 1e-5})
    jctx.limit = pctx.limit = 80  # 64 train and 16 val images: one batch shape each
    _state, jdef = jax_stages.run_cnn_multipatient(jctx, epochs=3)
    params0, state0 = jax_resnet.resnet_init(JKeyChain(SEED)("cnn_multi"), jdef,
                                             init="glorot_normal")

    def init(model, name, generator):
        assert name == "glorot_normal"
        model.load_state_dict(to_tensors(resnet_state_dict(_host(params0), _host(state0))))
        return model

    monkeypatch.setattr(port_stages, "cnn_init_", init)
    port_stages.run_cnn_multipatient(pctx, epochs=3)
    want = _history(jctx)
    assert len(want["val_loss"]) < 3  # the early stop ran
    _assert_history(_history(pctx), want, {"": 1e-3})
    _assert_checkpoints(jctx, pctx, "model.msgpack", atol=1e-3)


# -- the inverter --------------------------------------------------------------


@pytest.fixture(scope="module")
def inverter_models():
    """G (z 8, f 16, torch-default init: a DCGAN-init G's images are flat in
    z) and the tiny assessor with the 8 IiD classes, as port modules and
    JAX trees."""
    torch.manual_seed(0)
    gen = Generator(GeneratorDef(Z, 1, F_G)).eval()
    cnn = glorot_normal_init_(ResNet(ResNetDef(TINY, 1, len(IID), IID)),
                              torch.Generator().manual_seed(1)).eval()
    return gen, cnn, _host(generator_tree(gen.state_dict())), _host(resnet_tree(cnn.state_dict()))


@pytest.mark.parametrize("training_function", ["pix_rec", "pix_fea_rec_adv"])
def test_inverter_stage_matches_jax(data_root, inverter_models, monkeypatch, training_function):
    """Two epochs of each training function from the JAX stage's encoder
    and discriminator init, fed its label draws: every history column
    within rtol 1e-3 of the JAX stage's and the saved encoder (the best
    epoch's by val IiD) within 1e-4."""
    gen, cnn, (gp, gs), (rp, rs) = inverter_models
    jctx, pctx = _contexts(data_root, "inverter", f"inverter_{training_function}",
                           **{"trainer_inverter.batch_size": BS, "trainer_gan.z_dim": Z,
                              "model_inverter.latent_space": Z,
                              "model_inverter.D_network.units_disc": F_D,
                              "trainer_inverter.training_function": training_function,
                              "model_cnn.model_name": TINY})
    adversarial = training_function == "pix_fea_rec_adv"
    jctx.keys = _RecordingKeys(jctx.keys, ("inv_step", "inv_eval"))
    jdef = jax_resnet.ResNetDef(TINY, 1, len(IID), IID)
    cnn_tree = (jax.tree.map(jnp.asarray, rp), _bn_stats(rs), jdef) if adversarial else None
    _enc, want = jax_stages.run_inverter(jctx, jax.tree.map(jnp.asarray, gp), _bn_stats(gs),
                                         cnn=cnn_tree, epochs=2, viz_every=0)

    keys = JKeyChain(SEED)
    enc0, _ = encoder_init(keys("enc"), JEncoderDef(Z, 1))
    disc0, _ = discriminator_init(keys("disc"), JDiscriminatorDef(1, F_D))

    def init(module, generator):
        if isinstance(module, Encoder):
            module.load_state_dict(to_tensors(encoder_state_dict(_host(enc0))))
        else:
            assert isinstance(module, Discriminator)
            module.load_state_dict(to_tensors(discriminator_state_dict(_host(disc0))))
        return module

    monkeypatch.setattr(port_stages, "dcgan_init_", init)
    steps, evals = jctx.keys.log["inv_step"], jctx.keys.log["inv_eval"]
    n_val = [pctx.dataset("test", classes=classes, drange=(-1, 1)).images.shape[0]
             for classes in (None, pctx.data_cfg.ood_classes)]
    eval_sizes = [len(ix) for epoch in range(2) for n in n_val
                  for ix in _order(n, BS, epoch, False)]
    assert len(evals) == (len(eval_sizes) if adversarial else 0)

    def step_draw(i):
        positives, negatives = jax.random.split(steps[i])
        return (torch.tensor(np.asarray(jax_smooth_positive(positives, (BS,)))),
                torch.tensor(np.asarray(jax_smooth_negative(negatives, (BS,)))))

    def eval_draw(i):
        return torch.tensor(np.asarray(jax_smooth_positive(evals[i], (eval_sizes[i],))))

    pctx.keys = _FeedingKeys(pctx.keys, {"inv_step": step_draw, "inv_eval": eval_draw})
    _encoder, got = port_stages.run_inverter(pctx, gen, cnn=cnn if adversarial else None,
                                             epochs=2)
    _assert_history(got, want, {"": 1e-3})
    _assert_checkpoints(jctx, pctx, "encoder.msgpack", atol=1e-4)


# -- the CAE and the DCGAN -----------------------------------------------------


def test_cae_stage_matches_jax(data_root, monkeypatch):
    """Two denoising epochs from the JAX stage's init, fed its noise: the
    train losses within rtol 1e-4, the val losses within 1e-3 and the
    validation embeddings the stage writes within 2e-3 (Adam moves the
    biases of the convs that a BN follows by ±lr either way where their
    gradient sits at rounding level: a train-mode BN takes that out, an
    eval-mode one only as its running mean catches up)."""
    jctx, pctx = _contexts(data_root, "cae", "cae",
                           **{"trainer_ae.batch_size": BS, "model_ae.latent_space": 10})
    _state, want = jax_stages.run_cae(jctx, epochs=2)
    key = JKeyChain(SEED)("cae")
    state0, _ = cae_init(key, JCAEDef(10), JAdamConfig.from_config(jctx.cfg.trainer_ae.optimizer))

    def init(module, generator):
        if isinstance(module, CAEEncoder):
            sd = cae_encoder_state_dict(_host(state0.enc_params), state0.enc_state)
        else:
            sd = cae_decoder_state_dict(_host(state0.dec_params), state0.dec_state)
        module.load_state_dict(to_tensors(sd))
        return module

    n = {split: pctx.dataset(split, drange=(0, 1)).images.shape[0] for split in ("train", "test")}
    noise_key = jax.random.fold_in(key, 1)
    draws = iter([
        (jax.random.fold_in(jax.random.fold_in(noise_key, 2 * epoch + phase), b), len(ix))
        for epoch in range(2)
        for phase, split in enumerate(("train", "test"))
        for b, ix in enumerate(_order(n[split], BS, epoch, phase == 0))])
    add_noise = port_cae.add_noise

    def jax_noise(x, noise_factor, noise=None, generator=None):
        k, rows = next(draws)
        drawn = jax.random.normal(k, (rows, *x.shape[1:]), jnp.float32)
        return add_noise(x, noise_factor, noise=torch.tensor(np.asarray(drawn)))

    monkeypatch.setattr(port_stages, "torch_default_init_", init)
    monkeypatch.setattr(port_cae, "add_noise", jax_noise)
    _enc, _dec, got = port_stages.run_cae(pctx, epochs=2)
    _assert_history(got, want, {"val": 1e-3, "": 1e-4})
    emb = [np.loadtxt(ctx.run.interim_dir / "encoded_samples_valid.csv", delimiter=",",
                      skiprows=1) for ctx in (jctx, pctx)]
    np.testing.assert_allclose(emb[1], emb[0], rtol=0, atol=2e-3)


def test_dcgan_stage_matches_jax(data_root, monkeypatch, tmp_path):
    """Two epochs from the JAX stage's G and D init on one CAE and battery,
    fed its step and evaluation draws: the per-step G and D losses within
    rtol 5e-3, each epoch's FID, IS and denoising loss within rtol 1e-2
    (G's conv biases before a BN move by ±lr where their gradient is at
    rounding level, and the adversarial steps carry that on), and the same
    epoch saved as best_g."""
    jctx, pctx = _contexts(data_root, "dcgan", "dcgan",
                           **{"trainer_gan.batch_size": BS, "trainer_gan.z_dim": Z,
                              "model_gan.network.units_gen": F_G,
                              "model_gan.network.units_disc": F_G,
                              "model_ae.latent_space": 10})
    generator = torch.Generator().manual_seed(3)
    encoder = torch_default_init_(CAEEncoder(CAEDef(10)), generator).eval()
    decoder = torch_default_init_(CAEDecoder(CAEDef(10)), generator).eval()
    ep, es = _host(cae_encoder_tree(encoder.state_dict()))
    dp, ds = _host(cae_decoder_tree(decoder.state_dict()))
    cae = CaeTrainState(jax.tree.map(jnp.asarray, ep), _bn_stats(es),
                        jax.tree.map(jnp.asarray, dp), _bn_stats(ds), None, None)
    train = jctx.dataset("train", drange=(0, 1))
    battery = jax_classifiers.train_classifier_battery(jax_encode_dataset(cae, train.images),
                                                       np.asarray(train.labels))
    jax_classifiers.save_battery(tmp_path / "classifiers.msgpack", battery)
    _state, want = jax_stages.run_dcgan(jctx, cae, battery, epochs=2, n_synthetic=N_SYNTHETIC)

    keys = JKeyChain(SEED)
    adam = JAdamConfig.from_config(jctx.cfg.trainer_gan.optimizer)
    state0, _ = jax_gan_init(keys("gan"), JGeneratorDef(Z, 1, F_G), JDiscriminatorDef(1, F_G),
                             adam)
    step_base, eval_base = keys.peek("gan_step"), keys.peek("gan_eval")

    def gan_init(_generator, gdef, ddef, adam, device=None):
        gen, disc = Generator(gdef), Discriminator(ddef)
        gen.load_state_dict(to_tensors(generator_state_dict(_host(state0.gen_params),
                                                            state0.gen_state)))
        disc.load_state_dict(to_tensors(discriminator_state_dict(_host(state0.disc_params))))
        return GanTrainState(gen, disc, make_optimizer(adam, list(gen.parameters())),
                             make_optimizer(adam, list(disc.parameters())))

    def fold(stream, *indices):
        if stream == "gan_eval":
            return indices  # the epoch, read by the evaluation below
        assert stream == "gan_step"
        kz, kp, kn = jax.random.split(
            jax.random.fold_in(jax.random.fold_in(step_base, indices[0]), indices[1]), 3)
        return tuple(torch.tensor(np.asarray(a)) for a in (
            jax.random.normal(kz, (BS, Z, 1, 1), jnp.float32),
            jax_smooth_positive(kp, (BS,)), jax_smooth_negative(kn, (BS,))))

    evaluate = port_stages.evaluate_gan_epoch

    def jax_draws_evaluation(*args, generator=None, n_synthetic=None, **kwargs):
        (epoch,) = generator
        ks, kn = jax.random.split(jax.random.fold_in(eval_base, epoch))
        z = jax.random.normal(jax.random.fold_in(ks, 0), (n_synthetic, Z, 1, 1), jnp.float32)
        noise = jax.random.normal(kn, (n_synthetic, 1, 28, 28), jnp.float32)
        return evaluate(*args, n_synthetic=n_synthetic, z=torch.tensor(np.asarray(z)),
                        noise=torch.tensor(np.asarray(noise)), **kwargs)

    monkeypatch.setattr(port_stages, "gan_init", gan_init)
    monkeypatch.setattr(port_stages, "evaluate_gan_epoch", jax_draws_evaluation)
    pctx.keys = _FeedingKeys(pctx.keys, {}, fold=fold)
    _state, got = port_stages.run_dcgan(pctx, (encoder, decoder),
                                        load_battery(tmp_path / "classifiers.msgpack",
                                                     device="cpu"),
                                        epochs=2, n_synthetic=N_SYNTHETIC)
    _assert_history(got, want, {"loss_": 5e-3, "": 1e-2})
    best = [jax_load_pytree(ctx.run.models_dir / "best_g.msgpack")["epoch"]
            for ctx in (jctx, pctx)]
    assert best[1] == best[0]


# -- full fp32 where the JAX package pins HIGHEST ------------------------------


class _ProductFlags(torch.overrides.TorchFunctionMode):
    """Records, for every matrix product, whether TF32 was allowed."""

    PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.Tensor.__matmul__,
                torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm}

    def __init__(self):
        super().__init__()
        self.tf32 = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            self.tf32.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


_RS = np.random.RandomState(5)
_EMB = torch.tensor(_RS.randn(64, 10).astype(np.float32) * 30)
_HIGHEST_SITES = {
    # JAX evaluation/fid.py:25, ops/sqrtm.py:27,34
    "fid": lambda: fid_from_features(_EMB[:32], _EMB[32:]),
    # JAX ops/knn.py:28
    "knn": lambda: compute_posterior(
        train_classifier_battery(_EMB.numpy(), np.arange(64) % 4, device="cpu"), _EMB[:8]),
    # JAX pso/swarm.py:115
    "mean_pairwise_distance": lambda: mean_pairwise_distance(_EMB.reshape(2, 32, 10)),
    # JAX models/vqvae.py:59
    "vq_indices": lambda: vq_indices(_EMB[:16].reshape(1, 4, 4, 10), _EMB[16:48]),
}


@pytest.mark.parametrize("site", sorted(_HIGHEST_SITES))
def test_highest_products_keep_fp32_under_fast_math(site):
    """Inside `tf32_math()` every product of the four computations the JAX
    package pins at `Precision.HIGHEST` runs with TF32 off, and TF32 is on
    again after it (the parent of this change ran them in TF32 on the card:
    `fp32_parity()` keeps TF32 inside `tf32_math()`, as it should for the
    models)."""
    with tf32_math():
        assert torch.backends.cuda.matmul.allow_tf32
        with _ProductFlags() as flags:
            _HIGHEST_SITES[site]()
        assert flags.tf32 and not any(flags.tf32), flags.tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_chip_smoke_highest_inputs_match_jax():
    """`chip_smoke.py`'s HIGHEST phase prints the card's FID and swarm
    distance on its seeded inputs beside JAX_HIGHEST: those are the JAX
    package's values on the same inputs (rtol 1e-6), and the port's CPU
    values agree with them (the FID within 1e-5 of its traces, the
    distance within rtol 1e-5: fp32 sums in another order)."""
    import chip_smoke

    x = chip_smoke.highest_inputs()
    want = {"fid": float(jax_fid_from_features(jnp.asarray(x["real"]),
                                               jnp.asarray(x["synthetic"]))),
            "mean_pairwise_distance": float(jax_mean_pairwise_distance(
                jnp.asarray(x["swarm"][0])))}
    for key, value in want.items():
        assert chip_smoke.JAX_HIGHEST[key] == pytest.approx(value, rel=1e-6), key
    traces = float(np.var(x["real"], 0, ddof=1).sum() + np.var(x["synthetic"], 0, ddof=1).sum())
    got_fid = float(fid_from_features(torch.as_tensor(x["real"]), torch.as_tensor(x["synthetic"])))
    assert abs(got_fid - want["fid"]) <= 1e-5 * traces
    got = float(mean_pairwise_distance(torch.as_tensor(x["swarm"]))[0])
    assert got == pytest.approx(want["mean_pairwise_distance"], rel=1e-5)
