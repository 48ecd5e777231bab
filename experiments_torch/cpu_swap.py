"""The 2x2 checkpoint swap between the JAX package and the port, at full
width on the CPU (both packages run there): which package's stage a gap
between their trained chains comes from.

    PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py gan OUT
    PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py assessor OUT {jax,port}
    PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py assessor-steps OUT N_TRAIN EPOCHS [SEED]
    PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py inverter OUT
    PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py jax-cae OUT
    PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py cae-seeds OUT [EPOCHS]

Run from the repository root. Every stage is the package's own
(`pipelines/stages.py`), on the synthetic digits, with the shipped config;
both packages start from the JAX package's init for the stage's key, take
one batch order an epoch (`order`) and the JAX package's draws, which the
port's stage is handed where it asks its key chain or its sampler.

- `gan`: `cae` (100 epochs) in both packages, a battery on each CAE, then
  `dcgan` (3 epochs, z 10) in each package on its own CAE and battery, and
  each G's FID, IS and denoising loss under both CAEs and batteries.
- `assessor`: `cnn-multipatient` of one package to its early stop (the
  shipped 100 epochs, early stop 20), saved as OUT/<package>/model.msgpack
  with its history, each epoch printed as it ends. Run it once for each
  package (they may run at once).
- `assessor-steps`: both packages' `cnn-multipatient` epochs side by side
  from one init (the JAX package's for SEED, default 42) and one batch
  order at the shipped lr, on the first N_TRAIN training images: per
  epoch each one's losses, BN running variances and pooled-feature scale
  on [-1, 1] and [0, 1], and how far the two have parted.
- `inverter`: a G trained by the JAX package's `dcgan` (3 epochs, z 10),
  then epoch 0 of each package's pix_fea_rec_adv `inverter` on each
  package's assessor from `assessor`: the 2x2 of its train_loss_enc and
  terms, and the assessors' pooled-feature scale over the IiD test images
  in [-1, 1].
- `jax-cae`: the JAX package's own `cae` stage (its init, order and noise
  from the shipped seed, 100 epochs), written under OUT/jax-cae/model/mnist/
  as the JAX package writes it, with its embeddings' total variance over
  the IiD test images: a CAE that the port's `classifiers` and `dcgan`
  read through `--path-cae`.
- `cae-seeds`: each package's own `cae` stage (its own init, order and
  noise) from seeds 42, 7 and 3, and the port's from the JAX package's
  seed-42 init, for EPOCHS (default 15): the embeddings' total variance of
  each, which sets the scale of every FID measured with that CAE.

Each prints one JSON line a result. A CPU run: its numbers are not the
card's.
"""

from __future__ import annotations

import functools
import json
import pickle
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.core.prng import KeyChain as JKeyChain
from gan_discovery_pso_tpu.evaluation import classifiers as jax_classifiers
from gan_discovery_pso_tpu.evaluation.gan_eval import evaluate_gan_epoch as jax_evaluate
from gan_discovery_pso_tpu.models import DiscriminatorDef as JDiscriminatorDef
from gan_discovery_pso_tpu.models import GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.models import discriminator_init
from gan_discovery_pso_tpu.models import resnet as jax_resnet
from gan_discovery_pso_tpu.models.cae import CAEDef as JCAEDef
from gan_discovery_pso_tpu.models.encoder import EncoderDef as JEncoderDef
from gan_discovery_pso_tpu.models.encoder import encoder_init
from gan_discovery_pso_tpu.ops.norm import BatchNormStats
from gan_discovery_pso_tpu.pipelines import StageContext as JStageContext
from gan_discovery_pso_tpu.pipelines import stages as jax_stages
from gan_discovery_pso_tpu.train.cae import CaeTrainState, cae_init
from gan_discovery_pso_tpu.train.cae import encode_dataset as jax_encode
from gan_discovery_pso_tpu.train.common import smooth_negative, smooth_positive
from gan_discovery_pso_tpu.train.dcgan import gan_init as jax_gan_init
from gan_discovery_pso_tpu.train.dcgan import make_sampler as jax_sampler
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
    to_tensors,
)
from gan_discovery_pso_tpu_torch.evaluation.classifiers import KnnBattery
from gan_discovery_pso_tpu_torch.models import (
    CAEEncoder,
    Discriminator,
    Encoder,
    Generator,
    GeneratorDef,
    ResNetDef,
)
from gan_discovery_pso_tpu_torch.pipelines import StageContext
from gan_discovery_pso_tpu_torch.pipelines import stages as port_stages
from gan_discovery_pso_tpu_torch.pipelines.stages import load_cnn
from gan_discovery_pso_tpu_torch.train import cae as port_cae
from gan_discovery_pso_tpu_torch.train.common import make_optimizer
from gan_discovery_pso_tpu_torch.train.dcgan import GanTrainState

CFG = "configs/dcgan_mnist.yaml"
SEED = 42
Z, LATENT, BS = 10, 10, 128
IID = (0, 2, 3, 4, 6, 7, 8, 9)


def emit(**record):
    print(json.dumps(record), flush=True)


def order(n: int, batch_size: int, epoch: int, drop_last: bool) -> list:
    perm = np.random.RandomState(1000 + epoch).permutation(n)
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    return [perm[b * batch_size:(b + 1) * batch_size] for b in range(n_batches)]


def jax_batches(ds, batch_size, drop_last=True):
    return lambda e: iter([(ds.images[jnp.asarray(ix)], ds.labels[jnp.asarray(ix)])
                           for ix in order(len(ds.images), batch_size, e, drop_last)])


def port_batches(ds, batch_size, drop_last=True):
    return lambda e: iter([(ds.images[torch.as_tensor(ix)], ds.labels[torch.as_tensor(ix)])
                           for ix in order(ds.images.shape[0], batch_size, e, drop_last)])


def host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def bn_stats(node):
    if isinstance(node, dict) and set(node) == {"mean", "var"}:
        return BatchNormStats(jnp.asarray(node["mean"]), jnp.asarray(node["var"]))
    if isinstance(node, dict):
        return {k: bn_stats(v) for k, v in node.items()}
    return [bn_stats(v) for v in node]


class FeedingKeys:
    """The port context's key chain, handing out the JAX package's draws."""

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


class RecordingKeys:
    def __init__(self, keys, streams):
        self.keys, self.log = keys, {s: [] for s in streams}

    def __call__(self, stream):
        key = self.keys(stream)
        if stream in self.log:
            self.log[stream].append(key)
        return key

    def __getattr__(self, name):
        return getattr(self.keys, name)


def contexts(out: Path, module: str, who: tuple = ("jax", "port"), **sets):
    dirs = lambda w: {f"data.{k}_dir": str(out / module / w / k)  # noqa: E731
                      for k in ("reports", "model", "interim")}
    made = []
    for w in who:
        if w == "jax":
            ctx = JStageContext.create(CFG, module, overrides={**sets, **dirs(w)})
            ctx.batches = jax_batches
        else:
            ctx = StageContext.create(CFG, module, device="cpu", overrides={**sets, **dirs(w)})
            ctx.batches = port_batches
        made.append(ctx)
    return made


# -- the CAE and the DCGAN ------------------------------------------------------


def train_caes(out: Path, epochs: int = 100) -> dict:
    jctx, pctx = contexts(out, "cae")
    jcae, jhist = jax_stages.run_cae(jctx, epochs=epochs)
    key = JKeyChain(SEED)("cae")
    s0, _ = cae_init(key, JCAEDef(LATENT), JAdamConfig.from_config(jctx.cfg.trainer_ae.optimizer))
    port_stages.torch_default_init_ = lambda m, g: (m.load_state_dict(to_tensors(
        cae_encoder_state_dict(host(s0.enc_params), s0.enc_state) if isinstance(m, CAEEncoder)
        else cae_decoder_state_dict(host(s0.dec_params), s0.dec_state))), m)[1]
    n = {s: len(jctx.dataset(s, drange=(0, 1)).images) for s in ("train", "test")}
    noise_key = jax.random.fold_in(key, 1)
    plan = iter([(jax.random.fold_in(jax.random.fold_in(noise_key, 2 * e + ph), b), len(ix))
                 for e in range(epochs) for ph, s in enumerate(("train", "test"))
                 for b, ix in enumerate(order(n[s], BS, e, ph == 0))])
    add_noise = port_cae.add_noise

    def jax_noise(x, nf, noise=None, generator=None):
        k, rows = next(plan)
        return add_noise(x, nf, noise=torch.tensor(np.asarray(
            jax.random.normal(k, (rows, *x.shape[1:]), jnp.float32))))

    port_cae.add_noise = jax_noise
    enc, dec, phist = port_stages.run_cae(pctx, epochs=epochs)
    port_cae.add_noise = add_noise
    pe, pes = host(cae_encoder_tree(enc.state_dict()))
    pd, pds = host(cae_decoder_tree(dec.state_dict()))
    caes = {"jax": jcae, "port": CaeTrainState(jax.tree.map(jnp.asarray, pe), bn_stats(pes),
                                               jax.tree.map(jnp.asarray, pd), bn_stats(pds),
                                               None, None)}
    val = jctx.dataset("test", drange=(0, 1)).images
    for who, hist in (("jax", jhist), ("port", phist)):
        emb = jax_encode(caes[who], val)
        emit(stage="cae", package=who, train_loss=hist["train_loss"][-1],
             val_loss=hist["val_loss"][-1], embedding_variance=float(np.var(emb, 0).sum()))
    return {"caes": caes, "port_modules": (enc, dec), "val": val,
            "train": jctx.dataset("train", drange=(0, 1))}


def train_gans(out: Path, cae: dict, who=("jax", "port"), epochs: int = 3) -> dict:
    train = cae["train"]
    bats = {k: jax_classifiers.train_classifier_battery(jax_encode(c, train.images),
                                                        np.asarray(train.labels))
            for k, c in cae["caes"].items()}
    ctxs = dict(zip(who, contexts(out, "dcgan", who, **{"trainer_gan.z_dim": Z})))
    gens = {}
    if "jax" in ctxs:
        state, hist = jax_stages.run_dcgan(ctxs["jax"], cae["caes"]["jax"], bats["jax"],
                                           epochs=epochs)
        gens["jax"] = (state.gen_params, state.gen_state)
        emit(stage="dcgan", package="jax", fid=hist["fid"], inception_score=hist["is"])
    if "port" in ctxs:
        keys = JKeyChain(SEED)
        s0, _ = jax_gan_init(keys("gan"), JGeneratorDef(Z, 1, 64), JDiscriminatorDef(1, 64),
                             JAdamConfig.from_config(ctxs["port"].cfg.trainer_gan.optimizer))
        step_base, eval_base = keys.peek("gan_step"), keys.peek("gan_eval")

        def init(_g, gdef, ddef, adam, device=None):
            gen, disc = Generator(gdef), Discriminator(ddef)
            gen.load_state_dict(to_tensors(generator_state_dict(host(s0.gen_params),
                                                                s0.gen_state)))
            disc.load_state_dict(to_tensors(discriminator_state_dict(host(s0.disc_params))))
            return GanTrainState(gen, disc, make_optimizer(adam, list(gen.parameters())),
                                 make_optimizer(adam, list(disc.parameters())))

        def fold(stream, *ix):
            if stream == "gan_eval":
                return ix
            kz, kp, kn = jax.random.split(
                jax.random.fold_in(jax.random.fold_in(step_base, ix[0]), ix[1]), 3)
            return tuple(torch.tensor(np.asarray(a)) for a in (
                jax.random.normal(kz, (BS, Z, 1, 1), jnp.float32),
                smooth_positive(kp, (BS,)), smooth_negative(kn, (BS,))))

        evaluate = port_stages.evaluate_gan_epoch

        def jax_draws(*a, generator=None, n_synthetic=None, **kw):
            ks, kn = jax.random.split(jax.random.fold_in(eval_base, generator[0]))
            z = jnp.concatenate([jax.random.normal(jax.random.fold_in(ks, i), (
                min(1280, n_synthetic - i), Z, 1, 1)) for i in range(0, n_synthetic, 1280)])
            noise = jax.random.normal(kn, (n_synthetic, 1, 28, 28))
            return evaluate(*a, n_synthetic=n_synthetic, z=torch.tensor(np.asarray(z)),
                            noise=torch.tensor(np.asarray(noise)), **kw)

        port_stages.gan_init, port_stages.evaluate_gan_epoch = init, jax_draws
        ctxs["port"].keys = FeedingKeys(ctxs["port"].keys, {}, fold=fold)
        pbat = KnnBattery(*(torch.tensor(np.asarray(v)) for v in bats["port"][:3]),
                          bats["port"].k)
        state, hist = port_stages.run_dcgan(ctxs["port"], cae["port_modules"], pbat,
                                            epochs=epochs)
        port_stages.evaluate_gan_epoch = evaluate
        gp, gs = host(generator_tree(state.gen.state_dict()))
        gens["port"] = (jax.tree.map(jnp.asarray, gp), bn_stats(gs))
        emit(stage="dcgan", package="port", fid=hist["fid"], inception_score=hist["is"])
    return {"gens": gens, "batteries": bats}


def cmd_gan(out: Path) -> None:
    cae = train_caes(out)
    gans = train_gans(out, cae)
    sampler = jax_sampler(JGeneratorDef(Z, 1, 64))
    for g_who, (gp, gs) in gans["gens"].items():
        for c_who, c in cae["caes"].items():
            r = jax_evaluate(jax.random.key(7), sampler, gp, gs, c.enc_params, c.enc_state,
                             c.dec_params, c.dec_state, gans["batteries"][c_who], cae["val"])
            emit(swap="gan", G=g_who, CAE=c_who, fid=float(r.fid),
                 inception_score=float(r.inception_score), rec=float(r.rec_loss_syn))


# -- the assessor and the adversarial inverter ---------------------------------


class EpochLog:
    """A `metrics_writer` for `train_cnn` that prints each epoch as it ends."""

    def __init__(self, package: str):
        self.package, self.t0 = package, time.perf_counter()

    def append(self, epoch, **metrics):
        emit(package=self.package, epoch=epoch, seconds=time.perf_counter() - self.t0,
             **{k: metrics[k] for k in ("train_loss", "val_loss", "val_acc")})


def cmd_assessor(out: Path, who: str) -> None:
    (ctx,) = contexts(out, "cnn_multipatient", (who,))
    t0 = time.perf_counter()
    stages = jax_stages if who == "jax" else port_stages
    stages.train_cnn = functools.partial(stages.train_cnn, metrics_writer=EpochLog(who))
    if who == "jax":
        state, _ = jax_stages.run_cnn_multipatient(ctx)
    else:
        jdef = jax_resnet.ResNetDef("ResNet50", 1, len(IID), IID)
        p0, s0 = jax_resnet.resnet_init(JKeyChain(SEED)("cnn_multi"), jdef,
                                        init="glorot_normal")
        port_stages.cnn_init_ = lambda m, name, g: (m.load_state_dict(to_tensors(
            resnet_state_dict(host(p0), host(s0)))), m)[1]
        port_stages.run_cnn_multipatient(ctx)
    with open(ctx.run.reports_dir / "general" / "overall_history.pkl", "rb") as f:
        hist = pickle.load(f)
    emit(stage="cnn_multipatient", package=who, seconds=time.perf_counter() - t0,
         epochs=len(hist["val_loss"]), val_loss=hist["val_loss"],
         models=str(ctx.run.models_dir))


def cmd_assessor_steps(out: Path, n_train: int, epochs: int, seed: int = SEED) -> None:
    """Both packages' `cnn-multipatient` epochs side by side: one init, one
    batch order, the shipped lr, the first `n_train` training images and the
    whole val split. Each epoch: each package's losses, its BN running
    variances, how far the two packages' weights and running statistics
    have parted, and each assessor's pooled-feature scale on test images in
    [-1, 1] and [0, 1] (the adversarial inverter feeds [-1, 1])."""
    from gan_discovery_pso_tpu.train import cnn as jax_cnn
    from gan_discovery_pso_tpu.train.common import make_optimizer as jax_make_optimizer
    from gan_discovery_pso_tpu_torch.core.config import AdamConfig
    from gan_discovery_pso_tpu_torch.pipelines.stages import build_assessor
    from gan_discovery_pso_tpu_torch.train import cnn as port_cnn

    jctx, pctx = contexts(out, "cnn_multipatient")
    jadam = JAdamConfig.from_config(jctx.cfg.trainer_cnn.optimizer)
    jdef = jax_resnet.ResNetDef("ResNet50", 1, len(IID), IID)
    rdef = ResNetDef("ResNet50", 1, len(IID), IID)
    p0, s0 = jax_resnet.resnet_init(JKeyChain(seed)("cnn_multi"), jdef, init="glorot_normal")
    jstate = jax_cnn.CnnTrainState(p0, s0, jax_make_optimizer(jadam).init(p0),
                                   jnp.asarray(1.0, jnp.float32), jnp.asarray(0, jnp.int32))
    j_train, j_eval = jax_cnn.make_cnn_steps(jdef, jadam)
    model = build_assessor(rdef)
    model.load_state_dict(to_tensors(resnet_state_dict(host(p0), host(s0))))
    opt = make_optimizer(AdamConfig.from_config(pctx.cfg.trainer_cnn.optimizer), model.parameters())
    p_train, p_eval = port_cnn.make_cnn_steps(model, opt)
    jview = build_assessor(rdef)  # the JAX package's weights, read by the port's forward

    ds = jctx.dataset("train", drange=(0, 1))
    cut = ds.images.shape[0] - int(ds.images.shape[0] * 0.2)  # train_val_split(ds, 0.2)
    lut = np.zeros(max(IID) + 1, np.int32)
    for c, i in rdef.class_to_idx().items():
        lut[c] = i
    x_all, y_all = np.asarray(ds.images), lut[np.asarray(ds.labels)]
    sets = {"train": (x_all[:min(n_train, cut)], y_all[:min(n_train, cut)]),
            "val": (x_all[cut:], y_all[cut:])}
    test = np.asarray(jctx.dataset("test", drange=(0, 1)).images)[:1024]

    def run_epoch(split, epoch):
        x, y = sets[split]
        jc, pc = jax_cnn.EpochCounts.zero(len(IID)), port_cnn.EpochCounts.zero(len(IID))
        nonlocal jstate
        for ix in order(x.shape[0], BS, epoch, split == "train"):
            if split == "train":
                jstate, jc = j_train(jstate, jnp.asarray(x[ix]), jnp.asarray(y[ix]), jc)
                pc = p_train(torch.tensor(x[ix]), torch.tensor(y[ix]), pc)
            else:
                jc = j_eval(jstate, jnp.asarray(x[ix]), jnp.asarray(y[ix]), jc)
                pc = p_eval(torch.tensor(x[ix]), torch.tensor(y[ix]), pc)
        return (jax_cnn.counts_to_metrics(jc, "macro"), port_cnn.counts_to_metrics(pc, "macro"))

    @torch.no_grad()
    def feature_scale(m, lo):
        m.eval()
        f = m.features(torch.tensor(test * (1 - lo) + lo))
        return float((f * f).mean())

    t0 = time.perf_counter()
    for epoch in range(epochs):
        (jtr, ptr), (jva, pva) = run_epoch("train", epoch), run_epoch("val", epoch)
        jview.load_state_dict(to_tensors(resnet_state_dict(host(jstate.params),
                                                           host(jstate.model_state))))
        jsd, psd = jview.state_dict(), model.state_dict()
        parted = {kind: max(float((jsd[k] - psd[k]).abs().max() / jsd[k].abs().max().clamp_min(1e-30))
                            for k in jsd if k.endswith(suffix))
                  for kind, suffix in (("weights", "weight"), ("running_var", "running_var"),
                                       ("running_mean", "running_mean"))}
        for pkg, tr, va, sd, m in (("jax", jtr, jva, jsd, jview), ("port", ptr, pva, psd, model)):
            var = torch.cat([sd[k].reshape(-1) for k in sd if k.endswith("running_var")])
            emit(stage="assessor-steps", seed=seed, package=pkg, epoch=epoch, n_train=sets["train"][0].shape[0],
                 seconds=time.perf_counter() - t0, train_loss=tr["loss"], val_loss=va["loss"],
                 val_acc=va["acc"], bn_running_var_max=float(var.max()),
                 bn_running_var_median=float(var.median()),
                 features_pm1=feature_scale(m, -1.0), features_01=feature_scale(m, 0.0))
        emit(stage="assessor-steps", seed=seed, epoch=epoch, parted_rel_max=parted)


def _assessor_dir(out: Path, who: str) -> Path:
    (d,) = sorted((out / "cnn_multipatient" / who / "model" / "mnist").glob("*--cnn_multipatient"))
    return d


def cmd_inverter(out: Path) -> None:
    jdef = jax_resnet.ResNetDef("ResNet50", 1, len(IID), IID)
    rdef = ResNetDef("ResNet50", 1, len(IID), IID)
    assessors = {}
    for who in ("jax", "port"):
        model = load_cnn(_assessor_dir(out, who), rdef, device="cpu")
        params, state = jax_stages.load_cnn(_assessor_dir(out, who), jdef)
        assessors[who] = (model, (params, state, jdef))
    # one G for every run: the JAX package's dcgan on its own CAE
    (gctx,) = contexts(out, "dcgan", ("jax",), **{"trainer_gan.z_dim": Z})
    (cctx,) = contexts(out, "cae", ("jax",))
    cae_state, _ = jax_stages.run_cae(cctx, epochs=20)
    train = cctx.dataset("train", drange=(0, 1))
    battery = jax_classifiers.train_classifier_battery(jax_encode(cae_state, train.images),
                                                       np.asarray(train.labels))
    gstate, _ = jax_stages.run_dcgan(gctx, cae_state, battery, epochs=3)
    gp, gs = gstate.gen_params, gstate.gen_state
    gen = Generator(GeneratorDef(Z, 1, 64))
    gen.load_state_dict(to_tensors(generator_state_dict(host(gp), gstate.gen_state)))
    gen.eval()
    sets = {"trainer_gan.z_dim": Z, "model_inverter.latent_space": Z,
            "trainer_inverter.training_function": "pix_fea_rec_adv"}
    for who, (model, jtree) in assessors.items():
        x = cctx.dataset("test", drange=(-1, 1)).images
        with torch.no_grad():
            f = torch.cat([model.features(torch.tensor(np.asarray(x[i:i + 256])))
                           for i in range(0, x.shape[0], 256)])
        emit(assessor=who, feature_mean_sq=float((f * f).mean()), feature_max=float(f.abs().max()))
        jctx, pctx = contexts(out / f"inverter_on_{who}", "inverter", **sets)
        jctx.keys = RecordingKeys(jctx.keys, ("inv_step", "inv_eval"))
        _enc, jh = jax_stages.run_inverter(jctx, gp, gs, cnn=jtree, epochs=1, viz_every=0)
        keys = JKeyChain(SEED)
        e0, _ = encoder_init(keys("enc"), JEncoderDef(Z, 1))
        d0, _ = discriminator_init(keys("disc"), JDiscriminatorDef(1, 64))

        def init(m, g, e0=e0, d0=d0):
            sd = (encoder_state_dict(host(e0)) if isinstance(m, Encoder)
                  else discriminator_state_dict(host(d0)))
            m.load_state_dict(to_tensors(sd))
            return m

        port_stages.dcgan_init_ = init
        steps, evals = jctx.keys.log["inv_step"], jctx.keys.log["inv_eval"]
        n_val = [pctx.dataset("test", classes=c, drange=(-1, 1)).images.shape[0]
                 for c in (None, pctx.data_cfg.ood_classes)]
        sizes = [len(ix) for n in n_val for ix in order(n, BS, 0, False)]

        def step_draw(i, steps=steps):
            kp, kn = jax.random.split(steps[i])
            return (torch.tensor(np.asarray(smooth_positive(kp, (BS,)))),
                    torch.tensor(np.asarray(smooth_negative(kn, (BS,)))))

        pctx.keys = FeedingKeys(pctx.keys, {
            "inv_step": step_draw,
            "inv_eval": lambda i, evals=evals: torch.tensor(np.asarray(
                smooth_positive(evals[i], (sizes[i],))))})
        _enc, ph = port_stages.run_inverter(pctx, gen, cnn=model, epochs=1)
        for pkg, h in (("jax", jh), ("port", ph)):
            emit(swap="inverter", inverter=pkg, assessor=who,
                 **{k: h[k][0] for k in ("train_loss_enc", "train_loss_enc_rec_pix",
                                         "train_loss_enc_rec_fea", "train_loss_enc_adv",
                                         "val_iid_pixfea", "val_ood_pixfea")})


def cmd_jax_cae(out: Path) -> None:
    ctx = JStageContext.create(CFG, "cae", overrides={
        f"data.{k}_dir": str(out / "jax-cae" / k) for k in ("reports", "model", "interim")})
    state, hist = jax_stages.run_cae(ctx)
    emb = jax_encode(state, ctx.dataset("test", drange=(0, 1)).images)
    emit(stage="cae", package="jax", val_loss=hist["val_loss"][-1],
         embedding_variance=float(np.var(emb, 0).sum()), models=str(ctx.run.models_dir))


def cmd_cae_seeds(out: Path, epochs: int) -> None:
    for seed in (42, 7, 3):
        for who in ("jax", "port"):
            for init in (("own", "jax") if (who, seed) == ("port", 42) else ("own",)):
                run = out / "cae-seeds" / f"{who}{seed}{init}"
                sets = {"seed": seed, **{f"data.{k}_dir": str(run / k)
                                         for k in ("reports", "model", "interim")}}
                if who == "jax":
                    ctx = JStageContext.create(CFG, "cae", overrides=sets)
                    state, hist = jax_stages.run_cae(ctx, epochs=epochs)
                else:
                    ctx = StageContext.create(CFG, "cae", device="cpu", overrides=sets)
                    real_init = port_stages.torch_default_init_
                    if init == "jax":
                        s0, _ = cae_init(JKeyChain(seed)("cae"), JCAEDef(LATENT),
                                         JAdamConfig.from_config(ctx.cfg.trainer_ae.optimizer))
                        port_stages.torch_default_init_ = lambda m, g, s0=s0: (m.load_state_dict(
                            to_tensors(cae_encoder_state_dict(host(s0.enc_params), s0.enc_state)
                                       if isinstance(m, CAEEncoder) else
                                       cae_decoder_state_dict(host(s0.dec_params), s0.dec_state))),
                            m)[1]
                    enc, dec, hist = port_stages.run_cae(ctx, epochs=epochs)
                    port_stages.torch_default_init_ = real_init
                    e, es = host(cae_encoder_tree(enc.state_dict()))
                    state = CaeTrainState(jax.tree.map(jnp.asarray, e), bn_stats(es),
                                          None, None, None, None)
                emb = jax_encode(state, jnp.asarray(np.asarray(
                    ctx.dataset("test", drange=(0, 1)).images)))
                emit(stage="cae", package=who, seed=seed, init=init, epochs=epochs,
                     val_loss=hist["val_loss"][-1], embedding_variance=float(np.var(emb, 0).sum()))


def main(argv) -> int:
    torch.set_num_threads(4)
    cmd, out = argv[0], Path(argv[1])
    out.mkdir(parents=True, exist_ok=True)
    if cmd == "gan":
        cmd_gan(out)
    elif cmd == "assessor":
        cmd_assessor(out, argv[2])
    elif cmd == "assessor-steps":
        cmd_assessor_steps(out, *map(int, argv[2:5]))
    elif cmd == "inverter":
        cmd_inverter(out)
    elif cmd == "jax-cae":
        cmd_jax_cae(out)
    elif cmd == "cae-seeds":
        cmd_cae_seeds(out, int(argv[2]) if len(argv) > 2 else 15)
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
