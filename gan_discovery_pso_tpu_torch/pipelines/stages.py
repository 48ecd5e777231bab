"""Model loaders, the CAE, classifier, DCGAN and assessor stages, the
inverter's training, the inversion stages and the VQ-VAE family
(counterpart of `gan_discovery_pso_tpu/pipelines/stages.py`: `run_cae` :72,
`load_cae` :150, `run_classifiers` :167, `run_dcgan` :240, `load_gan`
:463, `assessor_factory` :481, `run_cnn` :507, `run_cnn_multipatient`
:580, `load_cnn` :610, `_inverter_epoch_viz` :646, `run_inverter` :670,
`load_encoder` :927, `run_extractor` :954, `run_pso_inverter` :1002,
`_regularize_snapshots_and_pickle` :1144, `run_regularize_inverter` :1180,
`run_regularize_inverter_statistics` :1220, `run_vqvae` :1255,
`run_pixelcnn_prior_from_vqvae` :1375, `run_pixelcnn_prior` :1433).

The loaders read the flax-msgpack checkpoints that either package's `cae`,
`dcgan`, `cnn`/`cnn-multipatient` and `inverter` stages write
(`core/checkpoint.py`) and return the port's `nn.Module`s, in eval mode,
on the requested device (the card unless the caller names another), built
through `compat/weights.py`.

The DCGAN stage (reference src/training/dcgan.py) trains G and D against
each other, evaluates each epoch with the frozen CAE and KNN battery
(`evaluate_gan_epoch`, whose sampler launches the B2 kernel), and writes
`checkpoint_g` / `best_g` in the JAX layout, so that either package
resumes the other's run and reads its G.

The CAE stage (reference src/training/cae.py) trains the denoising
autoencoder that every GAN metric embeds with, and writes `encoder.msgpack`
/ `decoder.msgpack` and the encoded-samples CSVs. The classifiers stage
(reference src/training/classifiers.py) builds the KNN battery on the CAE
embeddings (`classifiers.msgpack`), its battery tree and error-reject
curves. The assessor stages (reference src/training/cnn.py,
cnn_multipatient.py) train the one-vs-all battery `model_{label}.msgpack`
or the n-way `model.msgpack` that pso-discovery and pso-inverter read,
ResNet-50/101/152 or AlexNet, initialised by
`model_cnn.network.cnn_initializer`. Every forward and backward of these
stages runs in fp32 parity.

The inverter stage (reference src/training/inverter.py) trains an encoder
against the frozen generator: the plain encoder (DCGAN init) or the AttGAN
one (`model_inverter.encoder_variant: attgan`, torch-default init), by
`pix_rec` or by `pix_fea_rec_adv` (with a discriminator and the frozen
assessor's features), every forward and backward in fp32 parity. The
encoder of the epoch with the best val-IiD loss (pix+fea for the
adversarial branch; the train loss where the val set is empty) is kept as a
cloned state dict and saved as `encoder.msgpack` in the JAX layout:
`{"params"}`, or `{"params", "state", "variant": "attgan"}`.

The regularize stages invert OoD test images by gradient descent on z
(`invert`), or on a mix of the PSO classes' latent statistics
(`invert_bn`, the particles of a pso-discovery run), and write the inverted
latents, the last image's ori/enc/inv triptych and the latent DataFrame.

The pso-inverter (reference src/training/pso_inverter.py) has two phases:
1. re-head the assessor to (not patient, patient) and fine-tune it on the
   IiD classes plus the patient in drange (0, 1) (`train/cnn.py`, fp32
   parity), unless the run's models dir already holds `model_{p}.msgpack`;
2. encode the patient's slices in drange (−1, 1) and move one swarm from
   those positions with the hybrid fitness (`pso/runner.py`
   `make_inverter_runner`), then write the discovery stage's artifact set
   nested under the patient id.

The VQ-VAE stage (reference src/training/vq_vae.py) trains a vqvae_dcgan
whose codebook is a pso-discovery run's final particles and whose decoder
is the trained G, frozen; the PixelCNN prior stage encodes the train split
to code indices with that model and trains the Gated PixelCNN on them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from gan_discovery_pso_tpu_torch.analysis import reporting
from gan_discovery_pso_tpu_torch.compat.weights import (
    alexnet_state_dict,
    alexnet_tree,
    cae_decoder_state_dict,
    cae_decoder_tree,
    cae_encoder_state_dict,
    cae_encoder_tree,
    encoder_attgan_tree,
    encoder_state_dict,
    encoder_tree,
    generator_state_dict,
    pixelcnn_tree,
    resnet_state_dict,
    resnet_tree,
    to_tensors,
    vqvae_state_dict,
    vqvae_tree,
)
from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree, restore_tree, save_pytree
from gan_discovery_pso_tpu_torch.core.config import AdamConfig, PsoConfig, cfg_default
from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.data import train_val_split
from gan_discovery_pso_tpu_torch.evaluation import (
    KnnBattery,
    compute_posterior,
    encode,
    evaluate_gan_epoch,
    save_battery,
    train_classifier_battery,
)
from gan_discovery_pso_tpu_torch.models import (
    AlexNet,
    AlexNetDef,
    CAEDecoder,
    CAEDef,
    CAEEncoder,
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
    add_noise,
    change_classifier_head,
    cnn_init_,
    dcgan_init_,
    torch_default_init_,
)
from gan_discovery_pso_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNDef, pixelcnn_loss
from gan_discovery_pso_tpu_torch.models.vqvae import VQVAEGan, VQVAEGanDef
from gan_discovery_pso_tpu_torch.ops import postprocess_uint8
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity, tf32_math
from gan_discovery_pso_tpu_torch.pipelines.context import StageContext
from gan_discovery_pso_tpu_torch.pipelines.pso_discovery import (
    _writable,
    emit_swarm_reports,
    render_swarm_grids,
)
from gan_discovery_pso_tpu_torch.pso import (
    OPTIMIZE_IN,
    SwarmResult,
    draw_uniforms,
    load_final_particle_positions,
    make_discovery_fitness_dynamic,
    make_inverter_runner,
    save_particle_histories,
    swarm_init_from_positions,
)
from gan_discovery_pso_tpu_torch.train.cae import (
    encode_dataset,
    save_encoded_samples_csv,
    train_cae,
)
from gan_discovery_pso_tpu_torch.train.cnn import train_cnn
from gan_discovery_pso_tpu_torch.train.dcgan import (
    GanTrainState,
    gan_init,
    make_gan_train_step,
    make_sampler,
)
from gan_discovery_pso_tpu_torch.train.common import optimizer_step
from gan_discovery_pso_tpu_torch.train.inverter import (
    invert,
    invert_bn,
    make_pix_fea_rec_adv_step,
    make_pix_rec_step,
)
from gan_discovery_pso_tpu_torch.train.vqvae import VqvaeTrainState, train_vqvae, vqvae_init


def load_gan(model_dir: str | Path, best: bool = True, device=None) -> Generator:
    """The generator of a dcgan run (`best_g.msgpack`, or `checkpoint_g` with
    best=False: {'epoch', 'state': {'gen_params', 'gen_state', ...},
    'loss'}); its widths come from the checkpoint's shapes."""
    device = resolve_device(device)
    name = "best_g.msgpack" if best else "checkpoint_g.msgpack"
    state = restore_tree(load_pytree(Path(model_dir) / name)["state"])
    params = state["gen_params"]
    z_dim, f2 = params["convt1"]["w"].shape[:2]
    f, channels = params["convt3"]["w"].shape[:2]
    if f2 != 2 * f:
        raise ValueError(f"{model_dir}/{name}: convt1 has {f2} output channels, "
                         f"not twice convt3's {f} inputs — not a DCGAN generator")
    gen = Generator(GeneratorDef(int(z_dim), int(channels), int(f)), device=device)
    gen.load_state_dict(to_tensors(generator_state_dict(params, state["gen_state"]),
                                   device=device), strict=True)
    return gen.eval()


def assessor_factory(cfg, data_cfg, n_class: int):
    """The reference get_cnn (util_cnn.py:24-38): (ResNetDef, None, None)
    for ResNet50/101/152, (AlexNetDef, None, None) for AlexNet with
    `model_cnn.network`'s kernel, padding ('valid' → 0, else 1) and
    activation — the triple the JAX package returns, whose init and apply
    functions are the modules' own here."""
    name = str(cfg.model_cnn.model_name)
    iid = tuple(data_cfg.iid_classes)
    if name.startswith("ResNet"):
        return ResNetDef(name, data_cfg.channel, n_class, iid), None, None
    if name == "AlexNet":
        net = cfg.model_cnn.get("network", {})
        pad = 0 if str(net.get("padding", "valid")) == "valid" else 1
        return AlexNetDef(image_channels=data_cfg.channel, n_class=n_class,
                          img_size=data_cfg.image_size, kernel=int(net.get("kernel", 3)),
                          padding=pad, iid_classes=iid,
                          activation=str(net.get("cnn_activation", "LeakyReLU"))), None, None
    raise ValueError(name)


def build_assessor(mdef: ResNetDef | AlexNetDef, device=None) -> ResNet | AlexNet:
    """The assessor module of `mdef` (weights not initialised)."""
    return (AlexNet if isinstance(mdef, AlexNetDef) else ResNet)(mdef, device=device)


def assessor_tree(model: ResNet | AlexNet) -> dict:
    """An assessor as the JAX checkpoint's {'params', 'state'} (AlexNet has
    no state)."""
    sd = model.state_dict()
    if isinstance(model, AlexNet):
        return {"params": alexnet_tree(sd), "state": {}}
    params, state = resnet_tree(sd)
    return {"params": params, "state": state}


def load_cnn(model_dir: str | Path, rdef: ResNetDef | AlexNetDef, label=None,
             device=None) -> ResNet | AlexNet:
    """The assessor of a cnn-multipatient run (`model.msgpack`, or
    `model_{label}.msgpack` of a cnn run: {'params', 'state'}), built as
    `rdef` says: a ResNet or an AlexNet."""
    device = resolve_device(device)
    name = f"model_{label}.msgpack" if label is not None else "model.msgpack"
    d = load_pytree(Path(model_dir) / name)
    params, state = restore_tree(d["params"]), restore_tree(d["state"])
    # the checkpoint's keys reveal the family it was trained as; a mismatch
    # would otherwise surface as a missing key deep in the weight mapping
    looks_resnet = "bn1" in params and "layer1" in params
    looks_alexnet = "fc1" in params and "conv4" in params
    want_resnet = type(rdef).__name__ == "ResNetDef"
    if want_resnet and looks_alexnet:
        raise ValueError(
            f"{model_dir}/{name} is an AlexNet checkpoint but the config "
            "resolves a ResNet assessor — set model_cnn.model_name=AlexNet "
            "(and its network block) for THIS stage too, not only for "
            "cnn/cnn-multipatient"
        )
    if not want_resnet and looks_resnet:
        raise ValueError(
            f"{model_dir}/{name} is a ResNet checkpoint but the config "
            "resolves an AlexNet assessor — drop model_cnn.model_name="
            "AlexNet for this stage or point --path-cnn at an AlexNet run"
        )
    net = build_assessor(rdef, device=device)
    sd = resnet_state_dict(params, state) if want_resnet else alexnet_state_dict(params)
    net.load_state_dict(to_tensors(sd, device=device), strict=True)
    return net.eval()


def load_encoder(model_dir: str | Path, device=None) -> Encoder:
    """The plain encoder of an inverter run (`encoder.msgpack`:
    {'params'}), its widths from the checkpoint's shapes. An AttGAN-variant
    checkpoint is refused here: the consumers (extractors, pso-inverter)
    apply the plain encoder, as the reference's extractors hard-instantiate
    `util_inverter.Encoder` (iid_extractor.py:170)."""
    device = resolve_device(device)
    d = load_pytree(Path(model_dir) / "encoder.msgpack")
    if d.get("variant") in (b"attgan", "attgan"):
        raise ValueError(
            f"{model_dir}: this inverter run trained the AttGAN encoder "
            "variant; the downstream stages (extractors, pso-inverter, "
            "gradient inversion) consume the plain dcgan-mirror encoder — "
            "train the inverter without model_inverter.encoder_variant="
            "attgan for those paths (the reference has the same constraint: "
            "its extractors hard-instantiate the plain Encoder)")
    params = restore_tree(d["params"])
    f, channels = params["conv1"]["w"].shape[:2]
    enc_dim = params["conv3"]["w"].shape[0]
    enc = Encoder(EncoderDef(int(enc_dim), int(channels), int(f)), device=device)
    enc.load_state_dict(to_tensors(encoder_state_dict(params), device=device), strict=True)
    return enc.eval()


def _can_write(tag: str, families) -> dict:
    """{package: importable here} for (package, what it writes) pairs; one
    printed line per missing package, naming what is not written."""
    out = {}
    for package, what in families:
        out[package] = reporting.host_has(package)
        if not out[package]:
            print(f"[{tag}] not writing {what}: {package} is not installed")
    return out


# -- CAE stage (reference src/training/cae.py) --------------------------------


def load_cae(model_dir: str | Path, device=None) -> tuple[CAEEncoder, CAEDecoder]:
    """The CAE of a cae run (`encoder.msgpack` and `decoder.msgpack`:
    {'params', 'state'}), its latent width from the checkpoint's shapes;
    both modules in eval mode."""
    device = resolve_device(device)
    enc = restore_tree(load_pytree(Path(model_dir) / "encoder.msgpack"))
    dec = restore_tree(load_pytree(Path(model_dir) / "decoder.msgpack"))
    d = CAEDef(int(enc["params"]["fc2"]["w"].shape[0]))
    encoder, decoder = CAEEncoder(d, device=device), CAEDecoder(d, device=device)
    encoder.load_state_dict(to_tensors(cae_encoder_state_dict(enc["params"], enc["state"]),
                                       device=device), strict=True)
    decoder.load_state_dict(to_tensors(cae_decoder_state_dict(dec["params"], dec["state"]),
                                       device=device), strict=True)
    return encoder.eval(), decoder.eval()


def _cae_tree(module: nn.Module, to_tree) -> dict:
    params, state = to_tree(module.state_dict())
    return {"params": params, "state": state}


def _write_embeddings(ctx: StageContext, emb, labels, emb_val, val_labels, can: dict) -> None:
    """`encoded_samples_{train,valid}.csv`, and the 2-D latent scatters where
    the latent is 2-D (reference cae.py:214-221, classifiers.py:150-163)."""
    save_encoded_samples_csv(ctx.run.interim_dir / "encoded_samples_train.csv", emb, labels)
    save_encoded_samples_csv(ctx.run.interim_dir / "encoded_samples_valid.csv", emb_val,
                             val_labels)
    if emb.shape[1] == 2 and can["matplotlib"]:
        reporting.plot_latent_space(emb, labels, ctx.run.general_dir, dataset="Training")
        reporting.plot_latent_space(emb_val, val_labels, ctx.run.general_dir,
                                    dataset="Validation")


def run_cae(ctx: StageContext, epochs: int | None = None
            ) -> tuple[CAEEncoder, CAEDecoder, dict]:
    """Train the CAE (`model_ae`, `trainer_ae`) for `epochs` (default
    `trainer_ae.epochs`) on the IiD train split in drange (0, 1), validated
    on the test split. Streams: `cae` (the init, then the denoising noise
    on the stage's device), `cae_img_loss` (the noise of `img_loss.png`),
    `epoch_{e}`. Writes `encoder.msgpack`/`decoder.msgpack` in the JAX
    layout, both encoded-samples CSVs, the 2-D latent plots where the latent
    is 2-D, the loss curves, `img_loss.png`, `timing` and
    `overall_history`. Returns (encoder, decoder, history), the modules in
    eval mode."""
    cfg, tag = ctx.cfg, "cae"
    d = CAEDef(latent_dim=int(cfg.model_ae.latent_space))
    adam = AdamConfig.from_config(cfg.trainer_ae.optimizer)
    bs = int(cfg.trainer_ae.batch_size)
    epochs = epochs if epochs is not None else int(cfg.trainer_ae.epochs)
    task = str(cfg.model_ae.task)
    noise_factor = float(cfg_default(cfg.model_ae, "noise_factor", 0.3))  # 0.0 is valid
    can = _can_write(tag, (("matplotlib", "plots (cae_training.png, train_val_loss.png, "
                                          "img_loss.png, the latent plots)"),))

    t0 = time.perf_counter()
    ds = ctx.dataset("train", drange=(0, 1))
    val = ctx.dataset("test", drange=(0, 1))
    t_data = time.perf_counter() - t0
    # drawn on the CPU, so the card and the CPU start alike
    g = ctx.keys("cae")
    encoder = torch_default_init_(CAEEncoder(d), g).to(ctx.device)
    decoder = torch_default_init_(CAEDecoder(d), g).to(ctx.device)
    t0 = time.perf_counter()
    history = train_cae(encoder, decoder, adam, ctx.batches(ds, bs),
                        ctx.batches(val, bs, drop_last=False), num_epochs=epochs, task=task,
                        noise_factor=noise_factor, generator=ctx.keys("cae", ctx.device),
                        metrics_writer=ctx.metrics("history_cae"))
    t_train = time.perf_counter() - t0

    t0 = time.perf_counter()
    ctx.ckpt.save_state_dict("encoder", _cae_tree(encoder, cae_encoder_tree))
    ctx.ckpt.save_state_dict("decoder", _cae_tree(decoder, cae_decoder_tree))
    emb, emb_val = encode_dataset(encoder, ds.images), encode_dataset(encoder, val.images)
    _write_embeddings(ctx, emb, ds.labels.cpu().numpy(), emb_val, val.labels.cpu().numpy(),
                      can)
    if can["matplotlib"]:
        if d.latent_dim == 2:
            def decode(z):
                with fp32_parity(), torch.no_grad():
                    return decoder(torch.as_tensor(z, device=ctx.device)).cpu().numpy()

            reporting.plot_img_latent_space(decode, ctx.run.general_dir,
                                            w=int(cfg.data.image_size))
        reporting.plot_training_curves(history, ctx.run.reports_dir / "cae_training.png")
        reporting.plot_cnn_training(history, ctx.run.plot_dir)
        # img_loss.png (reference util_cae.py:221/278): the final model's
        # original/noisy/denoised panel, or original/reconstructed; the
        # noise drawn on the CPU
        vis = val.images[:10]
        with fp32_parity(), torch.no_grad():
            if task == "denoising":
                noisy = add_noise(vis.cpu(), noise_factor,
                                  generator=ctx.keys("cae_img_loss")).to(ctx.device)
                reporting.denoise_panel(vis.cpu().numpy(), noisy.cpu().numpy(),
                                        decoder(encoder(noisy)).cpu().numpy(),
                                        ctx.run.general_dir / "img_loss.png")
            else:
                reporting.recon_panel(vis.cpu().numpy(), decoder(encoder(vis)).cpu().numpy(),
                                      ctx.run.general_dir / "img_loss.png")
    ctx.run.write_timing({})  # (reference cae.py:226-231)
    ctx.run.write_overall_history(history)
    last = history["train_loss"][-1] if epochs else float("nan")
    print(f"[{tag}] data {t_data:.6f}s ({ds.images.shape[0]} train, {val.images.shape[0]} "
          f"val images), {epochs} epochs {t_train:.6f}s, train loss {last:.6f}, artifacts "
          f"{time.perf_counter() - t0:.6f}s")
    return encoder, decoder, history


# -- classifier battery stage (reference src/training/classifiers.py) --------


def run_classifiers(ctx: StageContext, encoder: CAEEncoder | None = None,
                    cae_model_dir: str | Path | None = None) -> KnnBattery:
    """The KNN battery (reference classifiers.py:165-239): k =
    `model_classifiers.n_neighbors` (5) on the head of the CAE embeddings of
    the IiD train split, the last `val_fraction` (0.2) held out. Writes
    `classifiers.msgpack`, both encoded-samples CSVs, the battery tree
    (each class's TEST embeddings through every classifier, positives
    counted as p > 0.5) and the per-class error-reject curves on the
    held-out tail. `encoder` is the CAE's, or is loaded from
    `cae_model_dir`."""
    tag = "classifiers"
    if encoder is None:
        encoder, _ = load_cae(cae_model_dir, device=ctx.device)
    can = _can_write(tag, (("matplotlib", "plots (classifier_battery_tree.png, "
                                          "error_reject_curve_*.png, the latent plots)"),))
    t0 = time.perf_counter()
    ds = ctx.dataset("train", drange=(0, 1))
    val = ctx.dataset("test", drange=(0, 1))
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb, emb_te = encode_dataset(encoder, ds.images), encode_dataset(encoder, val.images)
    labels, te_labels = ds.labels.cpu().numpy(), val.labels.cpu().numpy()
    block = ctx.cfg.get("model_classifiers") or {}
    k = int(block.get("n_neighbors", 5) or 5)  # reference classifiers.py:184
    val_fraction = float(cfg_default(block, "val_fraction", 0.2))  # 0.0: no holdout
    battery = train_classifier_battery(emb, labels, k=k, val_fraction=val_fraction,
                                       device=ctx.device)
    save_battery(ctx.run.models_dir / "classifiers.msgpack", battery)
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    _write_embeddings(ctx, emb, labels, emb_te, te_labels, can)
    classes = battery.classes.cpu().numpy()
    p_te = compute_posterior(battery, emb_te).cpu().numpy()
    activation = {int(label): (p_te[te_labels == label] > 0.5).sum(axis=0).tolist()
                  for label in classes if (te_labels == label).any()}
    val_size = int(len(emb) * val_fraction)
    if can["matplotlib"]:
        reporting.plot_battery_tree(activation, list(classes),
                                    ctx.run.general_dir / "classifier_battery_tree.png")
        if val_size > 0:
            # the held-out tail of the train embeddings (reference :167,178-213)
            p_yx = compute_posterior(battery, emb[-val_size:]).cpu().numpy()
            for ci, label in enumerate(classes):
                reporting.error_reject_curve(
                    (labels[-val_size:] == label).astype(int), p_yx[:, ci],
                    ctx.run.general_dir / f"error_reject_curve_{label}.png", label=int(label))
    print(f"[{tag}] data {t_data:.6f}s ({len(emb)} train, {len(emb_te)} test images), "
          f"embeddings and battery {t_build:.6f}s (k={k}, {battery.train_x.shape[0]} "
          f"rows), posteriors and artifacts {time.perf_counter() - t0:.6f}s; battery tree "
          f"{activation}")
    return battery


# -- DCGAN stage (reference src/training/dcgan.py + util_dcgan.train) ----------

_GAN_HISTORY = ("loss_gen", "loss_disc", "fid", "is", "rec_loss_syn")


def _resume_gan(ctx: StageContext, state: GanTrainState, history: dict) -> int:
    """The resume branch (JAX :282-316): `checkpoint_g` into `state`, the
    full history reloaded and cut to the checkpoint's epoch (the history
    artifact is written before the checkpoint each epoch, so a kill between
    the two leaves it one epoch ahead). Returns the first epoch to run."""
    prev = ctx.ckpt.try_load("checkpoint_g.msgpack")
    if prev is None:
        return 0
    state.load_tree(restore_tree(prev["state"]))
    offset = int(prev["epoch"]) + 1
    hist_file = ctx.run.general_dir / "history_gan.msgpack"
    if not hist_file.exists():  # runs that kept it at the reports root
        hist_file = ctx.run.reports_dir / "history_gan.msgpack"
    if hist_file.exists():
        saved = load_pytree(hist_file)
        history.update({k: [float(v) for v in saved.get(k, [])] for k in history})
        n_ep = len(history["fid"])
        if n_ep > offset:
            steps = len(history["loss_gen"]) // n_ep if n_ep else 0
            for k in ("fid", "is", "rec_loss_syn"):
                history[k] = history[k][:offset]
            for k in ("loss_gen", "loss_disc"):
                history[k] = history[k][: offset * steps]
    return offset


def gan_compute_dtype(cfg) -> torch.dtype | None:
    """`trainer_gan.compute_dtype` as a torch dtype (None, and float32, for
    the fp32 step): the mixed-precision GAN step's (JAX stages.py:323-330)."""
    name = (cfg.get("trainer_gan") or {}).get("compute_dtype")
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"trainer_gan.compute_dtype={name}: not a floating torch dtype")
    return None if dtype == torch.float32 else dtype


def run_dcgan(ctx: StageContext, cae: tuple, battery: KnnBattery, epochs: int | None = None,
              n_synthetic: int | None = None, resume: bool = False
              ) -> tuple[GanTrainState, dict]:
    """Train the DCGAN (`model_gan`, `trainer_gan`) for `epochs` (default
    `trainer_gan.epochs`; with `resume`, epochs after the run's
    `checkpoint_g`) on the IiD train split in drange (−1, 1), evaluating
    each epoch on `n_synthetic` samples (default batch × 100) with the
    frozen CAE `cae` = (encoder, decoder) and the KNN `battery` against the
    test split in drange (0, 1), which the CAE encodes once. Every forward
    and backward runs in fp32 parity.

    Streams: `gan` (G and D init), `fixed_noise`, and `gan_step`/`gan_eval`
    addressed by the absolute (epoch, step) and epoch (`KeyChain.fold`), so
    that a resumed run replays the single-shot run's draws; the batch order
    `epoch_{e}`. Each step's losses stay on the device until the epoch ends.

    Each epoch writes `general/history_gan.msgpack`, THEN `checkpoint_g`
    (the train state in the JAX layout), the plots, the raw fixed-noise
    superimage and `best_g` when the IS improves; a run in which no epoch
    improved saves the state it started from as `best_g`. Returns (the
    state holding best_g's weights, G in eval mode; the history).

    `trainer_gan.compute_dtype=bfloat16` trains with the mixed-precision
    step (`train/dcgan.py`): master parameters, Adam and the checkpoints
    stay fp32."""
    cfg, tag = ctx.cfg, "dcgan"
    compute_dtype = gan_compute_dtype(cfg)
    gdef = GeneratorDef(int(cfg.trainer_gan.z_dim), ctx.data_cfg.channel,
                        int(cfg.model_gan.network.units_gen))
    ddef = DiscriminatorDef(ctx.data_cfg.channel, int(cfg.model_gan.network.units_disc))
    adam = AdamConfig.from_config(cfg.trainer_gan.optimizer)
    bs = int(cfg.trainer_gan.batch_size)
    epochs = epochs if epochs is not None else int(cfg.trainer_gan.epochs)
    if n_synthetic is None:
        n_synthetic = bs * 100  # reference util_dcgan.py:243
    label_smoothing = bool(cfg.trainer_gan.get("label_smoothing", True))
    # the CAE's training noise; a config without model_ae takes 0.3
    noise_factor = float(cfg_default(cfg.get("model_ae"), "noise_factor", 0.3))
    can = _can_write(tag, (
        ("matplotlib", "plots (training_plot/*.png, class_polarization_*.png, hist_*.png, "
                       "kde_*.png)"),
        ("PIL", "the fixed-noise superimages (synthetic_images_*.png)")))
    encoder, decoder = cae

    t0 = time.perf_counter()
    ds = ctx.dataset("train", drange=(-1, 1))
    val = ctx.dataset("test", drange=(0, 1))
    # the CAE is frozen over the run: the real embeddings are encoded once
    enc_real = encode(encoder, val.images)
    print(f"[{tag}] data {time.perf_counter() - t0:.6f}s ({ds.images.shape[0]} train, "
          f"{val.images.shape[0]} val images)")
    state = gan_init(ctx.keys("gan"), gdef, ddef, adam, device=ctx.device)
    history = {k: [] for k in _GAN_HISTORY}
    offset = _resume_gan(ctx, state, history) if resume else 0
    if len(ds.images) < bs:
        raise ValueError(f"train dataset has {len(ds.images)} images < batch_size {bs} — the "
                         "drop-last epoch loop would run zero batches; lower "
                         "trainer_gan.batch_size or raise the data cap")
    step = make_gan_train_step(state, label_smoothing, compute_dtype=compute_dtype)
    sampler = make_sampler(state.gen)
    mw = ctx.metrics("history_gan")
    if resume:
        # the re-run epochs' stale rows go (all of them when no checkpoint)
        mw.drop_rows_from(offset)
    # the best IS survives a resume, from the history and the disk best_g
    best_is = max(history["is"][:offset], default=0.0) if offset else 0.0
    best_epoch, best_tree = offset, state.tree()
    if resume and offset:
        prev_best = ctx.ckpt.try_load("best_g.msgpack")
        if prev_best is not None:
            best_tree = restore_tree(prev_best["state"])
            best_epoch = int(prev_best.get("epoch", offset))
    # the 32 z of the per-epoch superimage, drawn on the CPU
    fixed_z = torch.randn((32, gdef.z_dim, 1, 1), generator=ctx.keys("fixed_noise"))
    fixed_z = fixed_z.to(ctx.device)
    classes = list(battery.classes.cpu().numpy())

    with fp32_parity():
        for epoch in range(epochs):
            ep = epoch + offset
            t_ep = time.perf_counter()
            metrics = []
            for i, (x, _y) in enumerate(ctx.batches(ds, bs)(ep)):
                metrics.append(step(x, ctx.keys.fold("gan_step", ep, i, device=ctx.device)))
            # one transfer an epoch: the host never waits on a step's loss
            for k in ("loss_gen", "loss_disc"):
                history[k] += torch.stack([m[k] for m in metrics]).cpu().tolist()
            t_train = time.perf_counter() - t_ep
            res = evaluate_gan_epoch(sampler, encoder, decoder, battery, val.images,
                                     n_synthetic=n_synthetic, noise_factor=noise_factor,
                                     enc_real=enc_real,
                                     generator=ctx.keys.fold("gan_eval", ep, device=ctx.device))
            fid, is_score, rec = (float(res.fid), float(res.inception_score),
                                  float(res.rec_loss_syn))
            t_eval = time.perf_counter() - t_ep - t_train
            t_art = time.perf_counter()
            history["fid"].append(fid)
            history["is"].append(is_score)
            history["rec_loss_syn"].append(rec)
            mw.append(ep, loss_gen=history["loss_gen"][-1], loss_disc=history["loss_disc"][-1],
                      fid=fid, inception_score=is_score, rec_loss_syn=rec)
            # history first, the checkpoint last: a kill between the two
            # leaves a state the resume reconciles (JAX :391-400)
            save_pytree(ctx.run.general_dir / "history_gan.msgpack",
                        {k: np.asarray(v, np.float64) for k, v in history.items()})
            tree = state.tree()
            ctx.ckpt.save_every_epoch("g", ep, tree, loss=history["loss_gen"][-1])
            with torch.no_grad():
                raw = state.gen.eval()(fixed_z)  # raw tanh output (util_report_gan.py:51)
            if can["matplotlib"]:
                reporting.plot_gan_training(history, ctx.run.plot_dir)
                reporting.plot_posterior_polarization(
                    res.p_yx.cpu().numpy(), classes,
                    ctx.run.general_dir / f"class_polarization_{ep}.png")
                reporting.plot_posterior_histograms(
                    {"energy": res.energy.cpu().numpy(), "variance": res.variance.cpu().numpy()},
                    ctx.run.general_dir, ep)
            if can["PIL"]:
                reporting.superimage(raw.cpu().numpy(),
                                     ctx.run.general_dir / f"synthetic_images_{ep}.png",
                                     drange=(-1, 1), cap=16)
            # the best model by IS, saved on improvement (reference :279-283)
            if is_score > best_is:
                best_is, best_epoch, best_tree = is_score, ep, tree
                ctx.ckpt.save_best("g", best_epoch, best_tree)
            print(f"[{tag}] epoch {ep}: {len(metrics)} train steps {t_train:.6f}s, evaluation "
                  f"{t_eval:.6f}s, artifacts {time.perf_counter() - t_art:.6f}s; fid={fid:.6f} "
                  f"is={is_score:.6f} rec={rec:.6f}")

    if not (ctx.ckpt.model_dir / "best_g.msgpack").exists():
        # no epoch improved the IS (NaN throughout, say); the downstream
        # stages need a best_g: the state the run started from (JAX :441-455)
        print(f"[{tag}] WARNING: no epoch improved the inception score; saving the state of "
              f"epoch {best_epoch} as best_g")
        ctx.ckpt.save_best("g", best_epoch, best_tree)
    mw.close()
    ctx.run.write_timing({})  # (reference dcgan.py:209-214)
    ctx.run.write_overall_history(history)
    state.load_tree(best_tree)
    state.gen.eval()
    return state, history


# -- assessor stages (reference src/training/cnn.py, cnn_multipatient.py) ----


def _cnn_settings(ctx: StageContext, epochs: int | None) -> dict:
    cfg = ctx.cfg
    return {"adam": AdamConfig.from_config(cfg.trainer_cnn.optimizer),
            "bs": int(cfg.trainer_cnn.batch_size),
            "epochs": epochs if epochs is not None else int(cfg.trainer_cnn.epochs),
            "early_stopping": int(cfg.trainer_cnn.early_stopping),
            "scheduler_patience": int(cfg.trainer_cnn.scheduler.patience),
            # reference cnn.py:170 / cnn_multipatient.py:160
            "init": str(cfg.model_cnn.get("network", {}).get("cnn_initializer",
                                                             "glorot_normal"))}


def _train_assessor(ctx: StageContext, mdef, generator: torch.Generator, tr, va,
                    settings: dict, label=None):
    """An assessor of `mdef` initialised by `settings['init']` from
    `generator` (on the CPU, so the card and the CPU start alike), trained
    by `train_cnn` in fp32 parity: (model in eval mode, history, seconds)."""
    t0 = time.perf_counter()
    model = cnn_init_(build_assessor(mdef), settings["init"], generator).to(ctx.device)
    bs = settings["bs"]
    with fp32_parity():
        model, history, _best = train_cnn(
            model, mdef, settings["adam"], ctx.batches(tr, bs),
            ctx.batches(va, bs, drop_last=False), num_epochs=settings["epochs"],
            early_stopping=settings["early_stopping"],
            scheduler_patience=settings["scheduler_patience"], label=label)
    return model, history, time.perf_counter() - t0


@torch.no_grad()
def battery_positives(models: list, images: torch.Tensor, chunk: int = 256) -> list:
    """How many of `images` each model flags positive (argmax == 1), the
    images `chunk` at a time in eval mode and fp32 parity (reference
    cnn.py:211-246)."""
    counts = [0] * len(models)
    with fp32_parity():
        for i in range(0, images.shape[0], chunk):
            x = images[i:i + chunk]
            for j, model in enumerate(models):
                counts[j] += int(torch.argmax(model.eval()(x), dim=1).sum())
    return counts


def _last(history: dict, key: str) -> float:
    return history[key][-1] if history[key] else float("nan")


def run_cnn(ctx: StageContext, epochs: int | None = None, classes=None) -> dict:
    """The one-vs-all battery (reference cnn.py:154-246): per class, a
    binary assessor (`model_cnn`, from the stream `cnn_{label}`/`init`)
    trained on y == label over the train split (80/20), saved as
    `model_{label}.msgpack`, with its curves (`cnn_{label}.png`,
    `training_plot/*_{label}.png`); then every member runs over each
    class's positive validation images and the battery tree counts what
    each flags. Returns {label: model}."""
    tag = "cnn"
    settings = _cnn_settings(ctx, epochs)
    classes = tuple(classes if classes is not None else ctx.data_cfg.iid_classes)
    can = _can_write(tag, (("matplotlib", "plots (cnn_*.png, train_val_*.png, "
                                          "classifier_battery_tree.png)"),))
    t0 = time.perf_counter()
    ds = ctx.dataset("train", drange=(0, 1))
    tr, va = train_val_split(ds, 0.2)
    print(f"[{tag}] data {time.perf_counter() - t0:.6f}s ({tr.images.shape[0]} train, "
          f"{va.images.shape[0]} val images)")
    models, histories = {}, {}
    for label in classes:
        mdef = assessor_factory(ctx.cfg, ctx.data_cfg, 2)[0]
        model, history, seconds = _train_assessor(
            ctx, mdef, ctx.keys.child(f"cnn_{label}")("init"), tr, va, settings, label=label)
        ctx.ckpt.save_state_dict(f"model_{label}", assessor_tree(model))
        if can["matplotlib"]:
            reporting.plot_training_curves(history, ctx.run.reports_dir / f"cnn_{label}.png")
            reporting.plot_cnn_training(history, ctx.run.plot_dir, label=label)
        models[label], histories[label] = model, history
        print(f"[{tag}] class {label}: {len(history['train_loss'])} epochs {seconds:.6f}s, "
              f"val loss {_last(history, 'val_loss'):.6f}")
    ctx.run.write_timing({})  # (reference cnn.py:198-205)
    ctx.run.write_overall_history(histories)

    t0 = time.perf_counter()
    members = [models[label] for label in classes]
    activation = {int(label): battery_positives(members, va.images[va.labels == label])
                  for label in classes}
    if can["matplotlib"]:
        reporting.plot_battery_tree(activation, list(classes),
                                    ctx.run.general_dir / "classifier_battery_tree.png")
    print(f"[{tag}] battery evaluation {time.perf_counter() - t0:.6f}s; battery tree "
          f"{activation}")
    return models


def run_cnn_multipatient(ctx: StageContext, epochs: int | None = None):
    """The n-way assessor over the IiD classes (reference
    cnn_multipatient.py:151-193), from the stream `cnn_multi`, trained on
    the train split (80/20) and saved as `model.msgpack`, the file
    pso-discovery, pso-inverter and the adversarial inverter read; its
    curves, `timing` and `overall_history`. Returns (model, its def)."""
    tag = "cnn_multipatient"
    settings = _cnn_settings(ctx, epochs)
    mdef = assessor_factory(ctx.cfg, ctx.data_cfg, len(ctx.data_cfg.iid_classes))[0]
    can = _can_write(tag, (("matplotlib", "plots (cnn_multipatient.png, train_val_*.png)"),))
    t0 = time.perf_counter()
    ds = ctx.dataset("train", drange=(0, 1))
    tr, va = train_val_split(ds, 0.2)
    t_data = time.perf_counter() - t0
    model, history, seconds = _train_assessor(ctx, mdef, ctx.keys("cnn_multi"), tr, va,
                                              settings)
    ctx.ckpt.save_state_dict("model", assessor_tree(model))
    if can["matplotlib"]:
        reporting.plot_training_curves(history, ctx.run.reports_dir / "cnn_multipatient.png")
        reporting.plot_cnn_training(history, ctx.run.plot_dir)
    ctx.run.write_timing({})  # (reference cnn_multipatient.py:186-193)
    ctx.run.write_overall_history(history)
    print(f"[{tag}] data {t_data:.6f}s ({tr.images.shape[0]} train, {va.images.shape[0]} val "
          f"images), {len(history['train_loss'])} epochs {seconds:.6f}s, val loss "
          f"{_last(history, 'val_loss'):.6f}")
    return model, mdef


# -- inverter training (reference src/training/inverter.py) -------------------

_EVAL_KEYS = ("loss_enc", "loss_enc_adv", "loss_enc_rec_pix", "loss_enc_rec_fea")
_TRAIN_KEYS = ("loss_enc_adv", "loss_enc_rec_pix", "loss_enc_rec_fea", "loss_disc",
               "loss_disc_adv", "loss_disc_r1penalty")


def _epoch_mean(values: list) -> float:
    """The mean of an epoch's 0-d loss tensors, read in one transfer (NaN
    for none), in float64 as a mean of Python floats is."""
    if not values:
        return float("nan")
    return float(np.mean(torch.stack(values).cpu().numpy().astype(np.float64)))


def _inverter_epoch_viz(ctx: StageContext, gen: nn.Module, encoder: nn.Module,
                        phase_sets: dict, epoch: int, fixed_noise: torch.Tensor,
                        can: dict) -> None:
    """The reference's per-epoch visuals (util_inverter.py:259,280 /
    :455,477): `img_loss_{phase}_{epoch}.png`, each phase's first 10
    images over their G(E(x)) (matplotlib), and `synthetic_images_{epoch}
    .png`, G of one fixed noise batch (PIL). E in eval mode."""
    encoder.eval()
    with fp32_parity(), torch.no_grad():
        if can["matplotlib"]:
            for phase, ds in phase_sets.items():
                if len(ds.images) == 0:
                    continue
                x = ds.images[:10]
                reporting.recon_panel(x.cpu().numpy(), gen(encoder(x)).cpu().numpy(),
                                      ctx.run.general_dir / f"img_loss_{phase}_{epoch}.png")
        if can["PIL"]:
            reporting.superimage(gen(fixed_noise).cpu().numpy(),
                                 ctx.run.general_dir / f"synthetic_images_{epoch}.png",
                                 drange=(-1, 1))


def _snapshot(module: nn.Module) -> dict:
    """A copy of the state dict: the optimizer updates the weights in place."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def run_inverter(ctx: StageContext, gen: nn.Module, cnn: ResNet | None = None,
                 epochs: int | None = None) -> tuple[nn.Module, dict]:
    """Train the encoder of `model_inverter.encoder_variant` by
    `trainer_inverter.training_function` against the frozen generator `gen`
    (and, for pix_fea_rec_adv, the frozen assessor `cnn`'s features) for
    `epochs` (default `trainer_inverter.epochs`). Streams: the encoder's
    init `enc`, the discriminator's `disc`, the fixed noise
    `inv_fixed_noise`, each adversarial train step's label draws
    `inv_step` and each eval batch's `inv_eval`; each epoch's batch order
    `epoch_{e}`. The visuals are written every epoch.

    Returns (the encoder with the best epoch's weights, in eval mode; the
    history, with the JAX stage's keys)."""
    cfg = ctx.cfg
    tag = "inverter"
    latent = int(cfg.model_inverter.latent_space)
    adam = AdamConfig.from_config(cfg.trainer_inverter.encoder_optimizer)
    bs = int(cfg.trainer_inverter.batch_size)
    epochs = epochs if epochs is not None else int(cfg.trainer_inverter.epochs)
    training_fun = str(cfg.trainer_inverter.training_function)
    variant = str(cfg.model_inverter.get("encoder_variant", "dcgan") or "dcgan")
    if training_fun not in ("pix_rec", "pix_fea_rec_adv"):
        raise ValueError(f"trainer_inverter.training_function {training_fun!r}: the "
                         "inverter trains by pix_rec or pix_fea_rec_adv")
    adversarial = training_fun == "pix_fea_rec_adv"
    if adversarial and cnn is None:
        raise ValueError("pix_fea_rec_adv needs the multipatient cnn")
    can = _can_write(tag, (
        ("matplotlib", "plots (img_loss_*.png, inverter_training.png, *_G_losses.png, "
                       "*_D_losses.png)"),
        ("PIL", "the fixed-noise samples (synthetic_images_*.png)")))

    t0 = time.perf_counter()
    iid = ctx.dataset("train", drange=(-1, 1))
    val_iid = ctx.dataset("test", drange=(-1, 1))
    val_ood = ctx.dataset("test", classes=ctx.data_cfg.ood_classes, drange=(-1, 1))
    phase_sets = {"train": iid, "val_iid": val_iid, "val_ood": val_ood}
    print(f"[{tag}] data {time.perf_counter() - t0:.6f}s ({iid.images.shape[0]} train, "
          f"{val_iid.images.shape[0]} val IiD, {val_ood.images.shape[0]} val OoD images)")
    # drawn on the CPU, so the card and the CPU start alike
    fixed_noise = torch.randn((32, latent, 1, 1), generator=ctx.keys("inv_fixed_noise"))
    fixed_noise = fixed_noise.to(ctx.device)
    channel = ctx.data_cfg.channel
    if variant == "attgan":
        encoder = torch_default_init_(EncoderAttGAN(EncoderAttGANDef(latent, channel)),
                                      ctx.keys("enc"))
    else:
        encoder = dcgan_init_(Encoder(EncoderDef(latent, channel)), ctx.keys("enc"))
    encoder = encoder.to(ctx.device)

    mw = ctx.metrics("history_inverter")
    history: dict = {}
    best, best_state = np.inf, _snapshot(encoder)
    with fp32_parity():
        if adversarial:
            disc = dcgan_init_(Discriminator(DiscriminatorDef(
                channel, int(cfg.model_inverter.D_network.units_disc))), ctx.keys("disc"))
            disc = disc.to(ctx.device)
            adam_d = AdamConfig.from_config(cfg.trainer_inverter.discriminator_optimizer)
            train_step, eval_step = make_pix_fea_rec_adv_step(gen, encoder, disc, cnn.eval(),
                                                              adam, adam_d)
        else:
            train_step, eval_step = make_pix_rec_step(gen, encoder, adam)
            history = {"train_loss": [], "val_iid_loss": [], "val_ood_loss": []}
        for epoch in range(epochs):
            t_ep = time.perf_counter()
            if adversarial:
                tr = [train_step(x, ctx.keys("inv_step", ctx.device))
                      for x, _y in ctx.batches(iid, bs)(epoch)]
                t_train = time.perf_counter() - t_ep
                sums = {}
                for ds, phase in ((val_iid, "val_iid"), (val_ood, "val_ood")):
                    ms = [eval_step(x, ctx.keys("inv_eval", ctx.device))
                          for x, _ in ctx.batches(ds, bs, drop_last=False)(epoch)]
                    # per-phase component series for {phase}_G_losses.png
                    # (reference util_report_inverter.py:41-74)
                    for k in _EVAL_KEYS:
                        history.setdefault(f"{phase}_{k}", []).append(
                            _epoch_mean([m[k] for m in ms]))
                    sums[phase] = _epoch_mean([m["loss_enc_rec_pix"] + m["loss_enc_rec_fea"]
                                               for m in ms])
                tr_loss = _epoch_mean([m["loss_enc"] for m in tr])
                for k in _TRAIN_KEYS:
                    history.setdefault(f"train_{k}", []).append(_epoch_mean([m[k] for m in tr]))
                for k, v in (("train_loss_enc", tr_loss), ("val_iid_pixfea", sums["val_iid"]),
                             ("val_ood_pixfea", sums["val_ood"])):
                    history.setdefault(k, []).append(v)
                mw.append(epoch, train_loss_enc=tr_loss, val_iid_pixfea=sums["val_iid"],
                          val_ood_pixfea=sums["val_ood"])
                tr_l, sel = tr_loss, sums["val_iid"]
                n_steps = len(tr)
            else:
                tl = [train_step(x) for x, _y in ctx.batches(iid, bs)(epoch)]
                t_train = time.perf_counter() - t_ep
                vi = [eval_step(x) for x, _ in ctx.batches(val_iid, bs, drop_last=False)(epoch)]
                vo = [eval_step(x) for x, _ in ctx.batches(val_ood, bs, drop_last=False)(epoch)]
                tr_l, sel, vo_l = _epoch_mean(tl), _epoch_mean(vi), _epoch_mean(vo)
                for k, v in (("train_loss", tr_l), ("val_iid_loss", sel), ("val_ood_loss", vo_l)):
                    history[k].append(v)
                mw.append(epoch, train_loss=tr_l, val_iid_loss=sel, val_ood_loss=vo_l)
                n_steps = len(tl)
            t_eval = time.perf_counter() - t_ep - t_train
            # an empty val set gives NaN, and `nan < best` is always False,
            # which would keep the random init as "best": fall back to the
            # train loss (JAX :737-742, :893-897)
            sel = sel if np.isfinite(sel) else tr_l
            if sel < best:  # best by val IiD (reference :273-277, :470-475)
                best, best_state = sel, _snapshot(encoder)
            t_viz = time.perf_counter()
            _inverter_epoch_viz(ctx, gen, encoder, phase_sets, epoch, fixed_noise, can)
            print(f"[{tag}] epoch {epoch}: {n_steps} train steps {t_train:.6f}s, eval "
                  f"{t_eval:.6f}s, visuals {time.perf_counter() - t_viz:.6f}s; train loss "
                  f"{tr_l:.6f}, selection loss {sel:.6f}")

    encoder.load_state_dict(best_state)
    sd = encoder.state_dict()
    if variant == "attgan":
        params, state = encoder_attgan_tree(sd)
        ctx.ckpt.save_state_dict("encoder", {"params": params, "state": state,
                                             "variant": "attgan"})
    else:
        ctx.ckpt.save_state_dict("encoder", {"params": encoder_tree(sd)})
    if can["matplotlib"]:
        summary = ("train_loss", "val_iid_loss", "val_ood_loss", "train_loss_enc",
                   "val_iid_pixfea", "val_ood_pixfea")
        reporting.plot_training_curves({k: v for k, v in history.items() if k in summary},
                                       ctx.run.reports_dir / "inverter_training.png")
        # the adversarial branch's component figures ({phase}_G/D_losses.png)
        for phase in ("train", "val_iid", "val_ood"):
            reporting.plot_phase_losses(history, ctx.run.plot_dir, phase)
    mw.close()
    ctx.run.write_timing({})  # (reference inverter.py:242-249)
    ctx.run.write_overall_history(history)
    return encoder.eval(), history


def _encode(encoder: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """images [N, C, H, W] → latents [N, enc_dim], fp32 parity."""
    with fp32_parity(), torch.inference_mode():
        return encoder(images).reshape(images.shape[0], -1)


# -- latent extractors (reference iid_extractor.py / ood_extractor.py) --------


def run_extractor(ctx: StageContext, encoder: nn.Module, kind: str = "iid",
                  max_per_class: int = 256, gen: nn.Module | None = None) -> dict:
    """Encode up to `max_per_class` train images of each IiD (kind='iid') or
    OoD (kind='ood') class into pseudo-particle artifacts: a one-row
    trajectory [1, N, d] with zero velocities per class, the PSO stages'
    pickles and npz (reference iid_extractor.py:177-216). With `gen`, also
    each class's `general/{label}/synthetic_images_0.png` superimage of
    G(E(x)) (:181-199; the class decodes as one batch). Returns {label:
    latents [N, d]}."""
    classes = ctx.data_cfg.iid_classes if kind == "iid" else ctx.data_cfg.ood_classes
    ds = ctx.dataset("train", classes=classes, drange=(-1, 1))
    pickles = reporting.host_has("pandas")
    if not pickles:
        print(f"[{kind}_extractor] not writing particle pickles: pandas is not installed")
    draw = gen is not None and reporting.host_has("PIL")
    if gen is not None and not draw:
        print(f"[{kind}_extractor] not writing synthetic_images_0.png: PIL is not installed")
    out = {}
    for label in classes:
        z = _encode(encoder, ds.images[ds.labels == label][:max_per_class])
        if draw and len(z):
            d = ctx.run.general_dir / str(label)
            d.mkdir(parents=True, exist_ok=True)
            with fp32_parity(), torch.inference_mode():
                imgs = gen(z[..., None, None]).cpu().numpy()
            reporting.superimage(imgs, d / "synthetic_images_0.png", drange=(-1, 1))
        z = z.cpu().numpy()
        save_particle_histories(ctx.run.interim_dir, label, z[None], np.zeros_like(z)[None],
                                kind=kind, pickles=pickles)
        out[label] = z
    return out


# -- hybrid PSO inverter (reference src/training/pso_inverter.py) -------------


def _fine_tune(ctx: StageContext, assessor: ResNet, bdef: ResNetDef, ood_patient: int,
               epochs: int) -> tuple[ResNet, dict]:
    """Phase 1's training branch: re-head, fine-tune in fp32 parity, save
    `model_{p}.msgpack` in the JAX layout, plot the curves."""
    cfg = ctx.cfg.trainer_pso_inverter
    t0 = time.perf_counter()
    all_ds = ctx.dataset("train", classes=bdef.iid_classes, drange=(0, 1))
    tr, va = train_val_split(all_ds, 0.2)
    t_data = time.perf_counter() - t0
    bs = int(cfg.batch_size)
    fine = change_classifier_head(assessor, 2, ctx.keys("rehead"))
    with fp32_parity():
        fine, history, _best = train_cnn(
            fine, bdef, AdamConfig.from_config(cfg.optimizer), ctx.batches(tr, bs),
            ctx.batches(va, bs, drop_last=False), num_epochs=epochs,
            early_stopping=int(cfg.early_stopping), label=ood_patient)
    print(f"[pso_inverter] fine-tune: data {t_data:.6f}s ({tr.images.shape[0]} train, "
          f"{va.images.shape[0]} val images), {len(history['train_loss'])} epochs "
          f"{time.perf_counter() - t0 - t_data:.6f}s")
    ctx.ckpt.save_state_dict(f"model_{ood_patient}", assessor_tree(fine))
    # fine-tune figures (reference pso_inverter.py:263)
    if reporting.host_has("matplotlib"):
        reporting.plot_cnn_training(history, ctx.run.plot_dir, label=ood_patient)
    else:
        print("[pso_inverter] not writing the fine-tune curves (train_val_*.png): "
              "matplotlib is not installed")
    return fine, history


def run_pso_inverter(
    ctx: StageContext,
    gen_model: nn.Module,
    encoder: nn.Module,
    assessor: ResNet,
    cnn_def: ResNetDef,
    ood_patient: int | None = None,
    fine_tune_epochs: int | None = None,
    fast_math_dtype: torch.dtype | None = None,
    draws: tuple | None = None,
) -> tuple[SwarmResult, ResNet]:
    """Phase 1: the binary assessor for the patient, loaded from the run's
    `model_{p}.msgpack` where it exists (reference :224-231 try-load), else
    re-headed and fine-tuned (:222-263). Phase 2: the encoder-seeded swarm,
    n = min(#slices, n_particles, 256) particles (:279-284), d from the
    encoder. Returns (the swarm as a B = 1 SwarmResult on the host, the
    binary assessor).

    fast_math_dtype=torch.bfloat16 runs the swarm's forwards in bf16 and the
    fine-tune inside `tf32_math()` (the JAX stage's whole-stage DEFAULT
    precision covers it); the encoder stays fp32. draws=(velocities [n, d], r1
    [iters, n], r2 [iters, n]) replaces the swarm's draws from the stream
    `pso` (parity tests feed the JAX package's)."""
    cfg = ctx.cfg
    if ood_patient is None:
        ood_patient = int(cfg.pso_inverter.ood_patient)
    hp = PsoConfig.from_config(cfg.trainer_pso_inverter)
    control = str(cfg.trainer_pso_inverter.get("control_pso_fitness", OPTIMIZE_IN))
    tag = "pso_inverter"
    if not isinstance(cnn_def, ResNetDef):
        # the re-head replaces a ResNet's fc, as the JAX stage's does
        raise ValueError(f"pso-inverter fine-tunes a ResNet assessor, not {cnn_def!r}")

    # --- phase 1: the binary assessor for this patient
    t_phase1 = time.perf_counter()
    bdef = ResNetDef(cnn_def.model_name, cnn_def.image_channels, 2,
                     tuple(ctx.data_cfg.iid_classes) + (ood_patient,))
    cnn_history = None
    if (ctx.run.models_dir / f"model_{ood_patient}.msgpack").exists():
        fine = load_cnn(ctx.run.models_dir, bdef, label=ood_patient, device=ctx.device)
    else:
        epochs = (fine_tune_epochs if fine_tune_epochs is not None
                  else int(cfg.trainer_pso_inverter.epochs))
        with tf32_math() if fast_math_dtype is not None else contextlib.nullcontext():
            fine, cnn_history = _fine_tune(ctx, assessor, bdef, ood_patient, epochs)
    phase1_s = time.perf_counter() - t_phase1

    # --- phase 2: the encoder-seeded swarm over the patient's slices
    ood = ctx.dataset("train", classes=(ood_patient,), drange=(-1, 1))
    n = min(ood.images.shape[0], hp.n_particles, 256)
    slices = ood.images[:n]
    init_positions = _encode(encoder, slices)
    hp_n = dataclasses.replace(hp, n_particles=n)
    if draws is not None:
        vel, r1, r2 = (x.to(ctx.device, torch.float32) if torch.is_tensor(x)
                       else torch.tensor(x, dtype=torch.float32, device=ctx.device)
                       for x in draws)
        init = swarm_init_from_positions(None, init_positions[None], hp.w_inertia, vel[None])
        r1, r2 = r1[:, None], r2[:, None]
    else:
        g = ctx.keys("pso", ctx.device)
        init = swarm_init_from_positions(g, init_positions[None], hp.w_inertia)
        r1, r2 = draw_uniforms(g, hp.n_iterations, 1, n, ctx.device)
    run = make_inverter_runner(hp_n, control=control, dtype=fast_math_dtype, device=ctx.device)
    t0 = time.time()
    final, hist, first = run(gen_model, fine, 1, slices, None, init_state=init, r1=r1, r2=r2)
    final.g_best_val.cpu()  # a result transfer: the completion barrier
    res_wall = time.time() - t0

    t_art = time.perf_counter()
    res = SwarmResult(final, hist, first, hp_n).swarm(0)
    can = _writable(tag, True, True)
    save_particle_histories(ctx.run.interim_dir, ood_patient, res.particle_trajectories(),
                            res.velocity_trajectories(), kind="ood", pickles=can["pickles"])
    # the discovery stage's reports nested under the patient id; the 2-D
    # landscape scores the pure ASSESSOR fitness, as the reference's plot2d
    # does (pso_inverter.py:330), and is drawn when the config's dim_space
    # is 2, whatever the encoder's width
    fitness = None
    if hp_n.dim_space == 2:
        fitness_dyn = make_discovery_fitness_dynamic(gen_model, fine, control=control)
        fitness = lambda pos, **kw: fitness_dyn(pos, 1, **kw)  # noqa: E731
    emit_swarm_reports(ctx, res, ood_patient, fitness=fitness,
                       title=f"ood patient {ood_patient}")
    if can["grids"]:
        render_swarm_grids(ctx, gen_model, res, ood_patient, tag=f"patient_{ood_patient}")
    ctx.run.write_timing({f"pso_inverter_time_ood_patient_{ood_patient}": res_wall})
    # the fine-tune's history only when phase 1 trained (:261,346)
    overall_history = {f"pso_inverter_history_ood_patient_{ood_patient}": res.history_dict()}
    if cnn_history is not None:
        overall_history[f"cnn_history_ood_patient_{ood_patient}"] = cnn_history
    ctx.run.write_overall_history(overall_history)
    artifact_s = time.perf_counter() - t_art
    print(f"[{tag}] patient {ood_patient}: phase 1 "
          f"({'fine-tune' if cnn_history is not None else 'try-load'}) {phase1_s:.6f}s, "
          f"{n} particles x {hp_n.n_iterations} iterations in {res_wall:.6f}s, "
          f"g_best={float(res.g_best_val):.6f}, artifacts written in {artifact_s:.6f}s")
    return res, fine


# -- gradient inversion (reference regularize_inverter*.py) -------------------

_REGULARIZE_FAMILIES = (
    ("matplotlib", "plots (the loss curves)"),
    ("PIL", "images (synthetic_images_*.png, ori.png, enc.png, inv.png)"),
    ("pandas", "the inverted-latent pickle (particles_position_ood.pkl)"))


def _regularize_snapshots_and_pickle(ctx: StageContext, gen: nn.Module, encoder: nn.Module,
                                     images: torch.Tensor, z_final: torch.Tensor, labels,
                                     can: dict) -> None:
    """The reference's per-image artifacts (regularize_inverter[_statistics]
    .py:171-190): `ori.png` / `enc.png` / `inv.png`, rewritten per image
    there, so the LAST image's triptych is what survives; and the
    inverted-latent DataFrame `particles_position_ood.pkl` (rows = images,
    columns = z features and a last uint8 label column)."""
    if can["PIL"]:
        last = images[-1:]
        with fp32_parity(), torch.no_grad():
            triptych = (("ori", last), ("enc", gen(encoder(last))), ("inv", gen(z_final[-1:])))
            for name, img in triptych:
                reporting.save_grayscale(ctx.run.general_dir / f"{name}.png",
                                         postprocess_uint8(img).cpu().numpy()[0, 0])
    if can["pandas"]:
        import pandas as pd

        zmat = z_final.cpu().numpy().reshape(len(images), -1)
        df = pd.DataFrame(np.concatenate([zmat, np.zeros((len(zmat), 1), zmat.dtype)], axis=1))
        lab = np.zeros(len(zmat)) if labels is None else np.asarray(labels)[:len(zmat)]
        # a column assignment, so that the label column really becomes
        # uint8 (reference regularize_inverter.py:188)
        df[df.columns[-1]] = lab.astype(np.uint8)
        with open(ctx.run.interim_dir / "particles_position_ood.pkl", "wb") as f:
            pickle.dump(df, f)


def _log_inversion(tag: str, images, iterations: int, seconds: float, hist: dict) -> None:
    steps = iterations + 1
    print(f"[{tag}] {len(images)} images x {steps} steps in {seconds:.6f}s "
          f"({steps / seconds:.1f} it/s); loss {float(hist['loss'][0]):.6f} -> "
          f"{float(hist['loss'][-1]):.6f}")


def run_regularize_inverter(ctx: StageContext, gen: nn.Module, encoder: nn.Module,
                            images: torch.Tensor, iterations: int = 500,
                            labels=None) -> tuple[torch.Tensor, dict]:
    """Gradient descent on each image's z from E's encoding (reference
    regularize_inverter.py via util_inverter.invert:544-638), batched, fp32
    parity. Writes `inverted_z.npz`, the loss curves, the
    `synthetic_images_{step}.png` superimages of every tenth of the run
    (the JAX stage's num_vis=10), decoded from the recorded z trajectory
    (reference :622-624), the triptych and the DataFrame. Returns (z [B, z,
    1, 1], history)."""
    tag = "regularize_inverter"
    can = _can_write(tag, _REGULARIZE_FAMILIES)
    t0 = time.perf_counter()
    with fp32_parity():
        z, hist = invert(images, gen, encoder, iterations=iterations, record_z=True)
    _log_inversion(tag, images, iterations, time.perf_counter() - t0, hist)
    z_hist = hist.pop("z")
    if can["matplotlib"]:
        reporting.plot_training_curves({k: list(v) for k, v in hist.items()},
                                       ctx.run.reports_dir / "invert_loss.png")
        # the reference's combined component figure (util_report_inverter.py:76-84)
        reporting.plot_regularize_inverter_losses(
            hist, ctx.run.reports_dir / "regularize_inverter_losses.png")
    if can["PIL"]:
        every = max(iterations // 10, 1)
        for step in range(0, iterations + 1, every):
            zs = torch.as_tensor(z_hist[min(step, len(z_hist) - 1)], device=z.device)
            with fp32_parity(), torch.no_grad():
                x_rec = gen(zs).cpu().numpy()
            reporting.superimage(x_rec, ctx.run.general_dir / f"synthetic_images_{step}.png",
                                 drange=(-1, 1))
    np.savez_compressed(ctx.run.interim_dir / "inverted_z.npz", z=z.cpu().numpy())
    _regularize_snapshots_and_pickle(ctx, gen, encoder, images, z, labels, can)
    ctx.run.write_timing({})  # (reference regularize_inverter.py:195-200)
    ctx.run.write_overall_history({k: list(v) for k, v in hist.items()})
    return z, hist


def run_regularize_inverter_statistics(
    ctx: StageContext, gen: nn.Module, encoder: nn.Module, images: torch.Tensor,
    pso_interim_dir, iterations: int = 500, labels=None, w0=None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The z-statistics variant (reference regularize_inverter_statistics.py
    with invert_bn): each image's z mixes the per-class normalisations
    against the final particles of the IiD classes of the pso-discovery run
    in `pso_interim_dir`; the initial weights come
    from the stream `invert_bn`, or are `w0` [B, C] (parity tests feed the
    JAX package's draw). Writes `inverted_bn_z.npz` (z, weights),
    the loss curves, the triptych and the DataFrame. Returns (z, w,
    history)."""
    tag = "regularize_inverter_statistics"
    parts = np.stack([load_final_particle_positions(pso_interim_dir, c, "iid")
                      for c in ctx.data_cfg.iid_classes])
    can = _can_write(tag, _REGULARIZE_FAMILIES)
    t0 = time.perf_counter()
    with fp32_parity():
        z, w, hist = invert_bn(images, gen, encoder, parts, iterations=iterations,
                               generator=ctx.keys("invert_bn"), w0=w0)
    _log_inversion(tag, images, iterations, time.perf_counter() - t0, hist)
    if can["matplotlib"]:
        reporting.plot_training_curves({k: list(v) for k, v in hist.items()},
                                       ctx.run.reports_dir / "invert_bn_loss.png")
        reporting.plot_regularize_inverter_losses(
            hist, ctx.run.reports_dir / "regularize_inverter_losses.png")
    np.savez_compressed(ctx.run.interim_dir / "inverted_bn_z.npz", z=z.cpu().numpy(),
                        weights=w.cpu().numpy())
    _regularize_snapshots_and_pickle(ctx, gen, encoder, images, z, labels, can)
    ctx.run.write_timing({})
    ctx.run.write_overall_history({k: list(v) for k, v in hist.items()})
    return z, w, hist


# -- VQ-VAE stage (reference src/training/vq_vae.py) --------------------------


def _vqvae_checkpoint(model: VQVAEGan) -> dict:
    """{params, state} in the JAX layout, host copies (a CPU tensor's numpy
    view would alias what the optimizer updates in place)."""
    params, state = vqvae_tree({k: np.array(v.detach().cpu().numpy(), copy=True)
                                for k, v in model.state_dict().items()})
    return {"params": params, "state": state}


def run_vqvae(ctx: StageContext, gen: nn.Module, pso_interim_dir=None,
              epochs: int | None = None) -> tuple[VqvaeTrainState, dict, VQVAEGanDef]:
    """Train the vqvae_dcgan (`model.latent_space`, `trainer`) for `epochs`
    (default `trainer.epochs`) on the IiD train split in drange (−1, 1),
    validated on the IiD and OoD test splits, with the trained generator
    `gen` as its frozen decoder and, where `pso_interim_dir` names a
    pso-discovery run, the final particles of its IiD classes as the
    codebook (reference vq_vae.py:30-57: 32 particles x 8 classes = 256
    rows). A codebook or decoder width other than
    `model.latent_space.embedding_dim` is refused before training. Streams:
    `vqvae` (the init), `vqvae_fixed_noise`, `epoch_{e}`. Each epoch writes
    `img_loss_{phase}_{e+1}.png`, `synthetic_images_{e}.png` and
    `model_{e+1}.msgpack`; then `best_vqvae.msgpack`, the loss figures,
    `timing` and `overall_history`. Returns (the state with the best
    weights, the history, the model's def)."""
    cfg, tag = ctx.cfg, "vqvae"
    d = VQVAEGanDef(channels_img=ctx.data_cfg.channel,
                    embedded_dim=int(cfg.model.latent_space.embedding_dim),
                    num_embedding=int(cfg.model.latent_space.num_embedding),
                    features_g=int(cfg.model_gan.network.units_gen),
                    features_d=int(cfg.model_gan.network.units_disc))
    adam = AdamConfig.from_config(cfg.trainer.optimizer)
    beta, bs = float(cfg.trainer.beta), int(cfg.trainer.batch_size)
    epochs = epochs if epochs is not None else int(cfg.trainer.epochs)
    data_pso = None
    if pso_interim_dir is not None:
        rows = [load_final_particle_positions(pso_interim_dir, c, "iid")
                for c in ctx.data_cfg.iid_classes]
        data_pso = np.concatenate(rows, axis=0)[: d.num_embedding]
        if data_pso.shape[1] != d.embedded_dim:
            # the reference works only while trainer_pso.dim_space equals
            # model.latent_space.embedding_dim (vq_vae.py:44-47)
            raise ValueError(
                f"PSO particles in {pso_interim_dir} have dim {data_pso.shape[1]} but "
                f"model.latent_space.embedding_dim={d.embedded_dim} — set embedding_dim to "
                "the discovery run's trainer_pso.dim_space (the codebook IS those particle "
                "positions)")
    gen_z_dim = gen.gen[0][0].in_channels
    if gen_z_dim != d.embedded_dim:
        raise ValueError(
            f"frozen decoder expects z_dim={gen_z_dim} inputs but "
            f"model.latent_space.embedding_dim={d.embedded_dim} — the vqvae_dcgan decoder IS "
            "the pretrained G, so embedding_dim must equal the GAN run's trainer_gan.z_dim")
    can = _can_write(tag, (
        ("matplotlib", "plots (img_loss_*.png, vqvae_training.png, reconstruction_loss.png, "
                       "vq_loss.png)"),
        ("PIL", "the decoder's fixed-noise samples (synthetic_images_*.png)")))

    t0 = time.perf_counter()
    iid = ctx.dataset("train", drange=(-1, 1))
    val_iid = ctx.dataset("test", drange=(-1, 1))
    val_ood = ctx.dataset("test", classes=ctx.data_cfg.ood_classes, drange=(-1, 1))
    t_data = time.perf_counter() - t0
    state = vqvae_init(ctx.keys("vqvae"), d, adam, data_pso=data_pso, frozen_gen=gen,
                       device=ctx.device)
    # drawn on the CPU, so the card and the CPU start alike
    noise = torch.randn((32, d.embedded_dim, 1, 1), generator=ctx.keys("vqvae_fixed_noise"))
    noise = noise.to(ctx.device)

    def report(epoch: int, st: VqvaeTrainState) -> None:
        """The reference's per-epoch panels and samples (vq_vae.py:221-234)
        and `model_{e+1}` (:244-245), the model in eval mode."""
        model = st.model.eval()
        with torch.no_grad():
            if can["matplotlib"]:
                for phase, split in (("train", iid), ("val_ood", val_ood), ("val_iid", val_iid)):
                    if len(split.images) == 0:
                        continue
                    x = split.images[:10]
                    reporting.recon_panel(x.cpu().numpy(), model(x)[0].cpu().numpy(),
                                          ctx.run.general_dir / f"img_loss_{phase}_{epoch + 1}.png")
            if can["PIL"]:
                reporting.superimage(model.decoder(noise).cpu().numpy(),
                                     ctx.run.general_dir / f"synthetic_images_{epoch}.png",
                                     drange=(-1, 1))
        ctx.ckpt.save_state_dict(f"model_{epoch + 1}", _vqvae_checkpoint(model))

    t0 = time.perf_counter()
    with fp32_parity():
        state, history, best_epoch = train_vqvae(
            state, ctx.batches(iid, bs), ctx.batches(val_iid, bs, drop_last=False),
            ctx.batches(val_ood, bs, drop_last=False), num_epochs=epochs, beta=beta,
            metrics_writer=ctx.metrics("history_vqvae"), report_cb=report)
    t_train = time.perf_counter() - t0
    ctx.ckpt.save_best("vqvae", best_epoch, _vqvae_checkpoint(state.model))
    if can["matplotlib"]:
        reporting.plot_training_curves(history, ctx.run.reports_dir / "vqvae_training.png")
        reporting.plot_vqvae_losses(history, ctx.run.plot_dir)
    ctx.run.write_timing({})  # (reference vq_vae.py:247-257)
    ctx.run.write_overall_history(history)
    last = history["train_loss"][-1] if epochs else float("nan")
    print(f"[{tag}] data {t_data:.6f}s ({iid.images.shape[0]} train, "
          f"{val_iid.images.shape[0]} val IiD, {val_ood.images.shape[0]} val OoD images), "
          f"codebook {'from PSO' if data_pso is not None else 'drawn'} "
          f"{tuple(state.model.codebook.shape)}, {epochs} epochs {t_train:.6f}s, train loss "
          f"{last:.6f}, best epoch {best_epoch}")
    return state, history, d


def load_vqvae(model_dir: str | Path, cfg, channels: int = 1, device=None) -> VQVAEGan:
    """The vqvae_dcgan of a vqvae run's `best_vqvae.msgpack`, in eval mode:
    the codebook's shape from the checkpoint, the conv widths from `cfg`'s
    `model_gan.network`, checked against the checkpoint's encoder."""
    device = resolve_device(device)
    st = restore_tree(load_pytree(Path(model_dir) / "best_vqvae.msgpack")["state"])
    params, model_state = st["params"], st["state"]
    num_embedding, embedded_dim = (int(x) for x in params["codebook"].shape)
    d = VQVAEGanDef(channels_img=channels, embedded_dim=embedded_dim,
                    num_embedding=num_embedding,
                    features_g=int(cfg.model_gan.network.units_gen),
                    features_d=int(cfg.model_gan.network.units_disc))
    ck_f = params["encoder"]["conv1"]["w"].shape[0]
    if ck_f != d.features_d:
        raise ValueError(
            f"{model_dir}/best_vqvae.msgpack was trained with features_d={ck_f} but the "
            f"config says units_disc={d.features_d} — pass the same config (and --tiny flag) "
            "the vqvae run used")
    model = VQVAEGan(d).to(device)
    model.load_state_dict(to_tensors(vqvae_state_dict(params, model_state), device=device),
                          strict=True)
    return model.eval()


def run_pixelcnn_prior_from_vqvae(ctx: StageContext, vqvae_model_dir: str | Path,
                                  epochs: int | None = None, batch_size: int = 256):
    """Encode the IiD train split to code indices with a vqvae run's model
    (its codebook's shape from the checkpoint, not the config), `batch_size`
    images at a time, and train the class-conditioned prior on them
    (`run_pixelcnn_prior`, default 10 epochs). The reference ships its Gated
    PixelCNN (utils_vq_vae/util_model.py:391-448) without a training entry;
    the JAX package's stage is the contract."""
    model = load_vqvae(vqvae_model_dir, ctx.cfg, ctx.data_cfg.channel, device=ctx.device)
    ds = ctx.dataset("train", drange=(-1, 1))
    with fp32_parity(), torch.no_grad():
        indices = torch.cat([model.encode(ds.images[b:b + batch_size])
                             for b in range(0, ds.images.shape[0], batch_size)])
    labels = ds.labels.long()
    return run_pixelcnn_prior(ctx, indices, labels, num_embedding=model.d.num_embedding,
                              n_classes=int(labels.max()) + 1,
                              epochs=epochs if epochs is not None else 10,
                              batch_size=min(batch_size, len(labels)))


def run_pixelcnn_prior(ctx: StageContext, indices, labels, num_embedding: int, n_classes: int,
                       epochs: int = 10, batch_size: int = 128, dim: int = 64,
                       n_layers: int = 8, lr: float = 3e-4) -> tuple[PixelCNN, PixelCNNDef, dict]:
    """Train the Gated PixelCNN prior on `indices` [N, H, W] (code indices)
    and `labels` [N] with Adam (lr 3e-4), in full batches of `batch_size`
    (epoch e's order from the stream `pix_ep_{e}`, peeked), fp32 parity;
    the init from the stream `pixelcnn`. Writes `pixelcnn.msgpack`
    ({'params', 'def'}, the JAX layout), `history_pixelcnn` and the loss
    curve. Returns (model, def, history)."""
    d = PixelCNNDef(input_dim=num_embedding, dim=dim, n_layers=n_layers, n_classes=n_classes)
    model = PixelCNN(d, ctx.keys("pixelcnn")).to(ctx.device)
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=lr)
    indices = torch.as_tensor(indices, device=ctx.device).long()
    labels = torch.as_tensor(labels, device=ctx.device).long()
    n = indices.shape[0]
    history = {"train_loss": []}
    mw = ctx.metrics("history_pixelcnn")
    t0 = time.perf_counter()
    with fp32_parity():
        for epoch in range(epochs):
            perm = torch.randperm(n, generator=ctx.keys.peek(f"pix_ep_{epoch}")).to(ctx.device)
            losses = []
            for b in range(0, n - batch_size + 1, batch_size):
                sel = perm[b:b + batch_size]
                loss = pixelcnn_loss(model, indices[sel], labels[sel])
                optimizer_step(opt, params, loss)
                losses.append(loss.detach())
            tr = _epoch_mean(losses)
            history["train_loss"].append(tr)
            mw.append(epoch, train_loss=tr)
    ctx.ckpt.save_state_dict("pixelcnn", {"params": pixelcnn_tree(model.state_dict()),
                                          "def": d._asdict()})
    if reporting.host_has("matplotlib"):
        reporting.plot_training_curves(history, ctx.run.reports_dir / "pixelcnn_training.png")
    else:
        print("[pixelcnn_prior] not writing pixelcnn_training.png: matplotlib is not installed")
    mw.close()
    print(f"[pixelcnn_prior] {n} index grids {tuple(indices.shape[1:])}, K={num_embedding}, "
          f"{n_classes} classes, {epochs} epochs {time.perf_counter() - t0:.6f}s, train loss "
          f"{history['train_loss'][-1] if epochs else float('nan'):.6f}")
    return model.eval(), d, history
