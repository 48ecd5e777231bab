"""Model loaders and the inversion stages (counterpart of
`gan_discovery_pso_tpu/pipelines/stages.py`: `load_gan` :463,
`assessor_factory` :481, `load_cnn` :610, `load_encoder` :927,
`run_extractor` :954, `run_pso_inverter` :1002).

The loaders read the flax-msgpack checkpoints the JAX package's `dcgan`,
`cnn-multipatient` and `inverter` stages write (`core/checkpoint.py`) and
return the port's `nn.Module`s, in eval mode, on the requested device (the
card unless the caller names another), built through `compat/weights.py`.
The training stages of those checkpoints are later slices (ROADMAP A9, A10,
A12).

The pso-inverter (reference src/training/pso_inverter.py) has two phases:
1. re-head the assessor to (not patient, patient) and fine-tune it on the
   IiD classes plus the patient in drange (0, 1) (`train/cnn.py`, fp32
   parity), unless the run's models dir already holds `model_{p}.msgpack`;
2. encode the patient's slices in drange (−1, 1) and move one swarm from
   those positions with the hybrid fitness (`pso/runner.py`
   `make_inverter_runner`), then write the discovery stage's artifact set
   nested under the patient id.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from gan_discovery_pso_tpu_torch.analysis import reporting
from gan_discovery_pso_tpu_torch.compat.weights import (
    encoder_state_dict,
    generator_state_dict,
    resnet_state_dict,
    resnet_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree, restore_tree
from gan_discovery_pso_tpu_torch.core.config import AdamConfig, PsoConfig
from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.data import train_val_split
from gan_discovery_pso_tpu_torch.models import (
    Encoder,
    EncoderDef,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    change_classifier_head,
)
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity
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
    make_discovery_fitness_dynamic,
    make_inverter_runner,
    save_particle_histories,
    swarm_init_from_positions,
)
from gan_discovery_pso_tpu_torch.train.cnn import train_cnn


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
    """The reference get_cnn (util_cnn.py:24-38): (ResNetDef, None, None) for
    ResNet50/101/152, the triple the JAX package returns."""
    name = str(cfg.model_cnn.model_name)
    iid = tuple(data_cfg.iid_classes)
    if name.startswith("ResNet"):
        return ResNetDef(name, data_cfg.channel, n_class, iid), None, None
    if name == "AlexNet":
        raise NotImplementedError(
            "AlexNet assessors are not ported yet (ROADMAP A3: models)")
    raise ValueError(name)


def load_cnn(model_dir: str | Path, rdef: ResNetDef, label=None, device=None) -> ResNet:
    """The assessor of a cnn-multipatient run (`model.msgpack`, or
    `model_{label}.msgpack` of a cnn run: {'params', 'state'})."""
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
    net = ResNet(rdef, device=device)
    net.load_state_dict(to_tensors(resnet_state_dict(params, state), device=device),
                        strict=True)
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
    params, state = resnet_tree(fine.state_dict())
    ctx.ckpt.save_state_dict(f"model_{ood_patient}", {"params": params, "state": state})
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

    fast_math_dtype=torch.bfloat16 runs the swarm's forwards in bf16; the
    encoder and the fine-tune stay fp32. draws=(velocities [n, d], r1
    [iters, n], r2 [iters, n]) replaces the swarm's draws from the stream
    `pso` (parity tests feed the JAX package's)."""
    cfg = ctx.cfg
    if ood_patient is None:
        ood_patient = int(cfg.pso_inverter.ood_patient)
    hp = PsoConfig.from_config(cfg.trainer_pso_inverter)
    control = str(cfg.trainer_pso_inverter.get("control_pso_fitness", OPTIMIZE_IN))
    tag = "pso_inverter"

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
