"""Command-line entry point of the port (counterpart of
`gan_discovery_pso_tpu/cli/main.py`: every subcommand and flag of the JAX
CLI):

    python -m gan_discovery_pso_tpu_torch.cli cae [--epochs E] ...
    python -m gan_discovery_pso_tpu_torch.cli classifiers --path-cae DIR ...
    python -m gan_discovery_pso_tpu_torch.cli dcgan --path-cae DIR \\
        --path-classifiers DIR [--epochs E] [--resume-id N] ...
    python -m gan_discovery_pso_tpu_torch.cli cnn|cnn-multipatient [--epochs E] ...
    python -m gan_discovery_pso_tpu_torch.cli pso-discovery \\
        --cfg configs/dcgan_mnist.yaml --path-gan DIR --path-cnn DIR \\
        [--batch-classes | --shard-swarm N] [--fast-math] [--tiny] [--limit N] \\
        [--set key=value ...] [--device cuda|cpu|cuda:N]
    python -m gan_discovery_pso_tpu_torch.cli pso-inverter \\
        --path-gan DIR --path-cnn DIR --path-inverter DIR \\
        [--ood-patient P] [--epochs E] [--fast-math] ...
    python -m gan_discovery_pso_tpu_torch.cli iid-extract|ood-extract \\
        --path-inverter DIR [--path-gan DIR] ...
    python -m gan_discovery_pso_tpu_torch.cli inverter --path-gan DIR \\
        [--path-cnn DIR] [--epochs E] ...
    python -m gan_discovery_pso_tpu_torch.cli regularize-inverter \\
        --path-gan DIR --path-inverter DIR ...
    python -m gan_discovery_pso_tpu_torch.cli regularize-inverter-statistics \\
        --path-gan DIR --path-inverter DIR --path-pso DIR ...
    python -m gan_discovery_pso_tpu_torch.cli vqvae --cfg configs/vqvae.yaml \\
        --path-gan DIR --path-pso DIR [--epochs E] ...
    python -m gan_discovery_pso_tpu_torch.cli pixelcnn-prior --cfg configs/vqvae.yaml \\
        --path-vqvae DIR [--epochs E] ...
    python -m gan_discovery_pso_tpu_torch.cli pso-analysis|pso-analysis-distance \\
        --path-pso DIR ...
    python -m gan_discovery_pso_tpu_torch.cli pso-analysis-clustering --path-pso DIR \\
        [--path-ood-pso DIR ...] ...
    python -m gan_discovery_pso_tpu_torch.cli pso-inverter-analysis --path-pso DIR \\
        --path-ood-pso DIR [--ood-patient P] ...
    python -m gan_discovery_pso_tpu_torch.cli claro-preprocess \\
        --cfg configs/claro_preprocess.yaml [--limit N] ...
    python -m gan_discovery_pso_tpu_torch.cli sweep [--latent-dims D ...] \\
        [--stages S ...] | --patients P ... [--controls C ...]  [stage flags]
    python -m gan_discovery_pso_tpu_torch.cli export-model generator|fitness OUT \\
        --path-gan DIR [--path-cnn DIR] [--batch B] [--class-label L] \\
        [--platforms cuda cpu] [--fast-math] ...
    python -m gan_discovery_pso_tpu_torch.cli convert-torch SRC MODEL DST
    python -m gan_discovery_pso_tpu_torch.cli export-torch SRC MODEL DST \\
        [--epoch E] [--loss L]

`pso-discovery --shard-swarm N` splits each class's swarm over N ranks
(`parallel/`): in a process group of N ranks already up (a caller's, or
one the GDPT_COORDINATOR / GDPT_NUM_PROCESSES / GDPT_PROCESS_ID variables
configure; GDPT_COORDINATOR="" under torchrun) every rank runs the command;
otherwise the command starts N ranks itself (`parallel/launch.py`), rank r
on `cuda:{r % cards}` (`--device cpu`: the CPU), NCCL when each rank has a
card of its own, else gloo. Rank 0 makes the run dir and writes every
artifact and log line. It cannot be combined with --batch-classes.

`--path-cae`, `--path-classifiers`, `--path-gan`, `--path-cnn`,
`--path-inverter` and `--path-vqvae` are the models dirs of either
package's `cae`, `classifiers`, `dcgan`, `cnn-multipatient`, `inverter` and
`vqvae` runs: the port reads their flax-msgpack checkpoints. `dcgan
--resume-id N` re-enters run N and trains --epochs MORE epochs from its
`checkpoint_g`; `--tiny` evaluates it on 256 samples an epoch;
`trainer_gan.compute_dtype=bfloat16` trains it with the mixed-precision
step (`train/dcgan.py`). The stages run on the card; `--device cpu` is the
port's counterpart of `JAX_PLATFORMS=cpu`.

`--fast-math`: pso-discovery and pso-inverter run the swarm's forwards in
bf16 copies of the models; the training stages (cae, classifiers, cnn,
cnn-multipatient, dcgan, inverter, both regularize stages, vqvae,
pixelcnn-prior) and pso-inverter's fine-tune run inside
`ops.precision.tf32_math()`, the card's counterpart of the JAX package's
whole-stage DEFAULT precision; `export-model` exports the bf16 copies.

`--path-cnn` is read by `inverter` only for
`trainer_inverter.training_function=pix_fea_rec_adv`; `--path-pso` is the
interim dir of a pso-discovery run (the vqvae's codebook, the analyses'
particles); `--path-ood-pso` (repeatable) the interim dir of a pso-inverter
run per inverted patient, whose OoD latents the clustering overlays
(labelled by `data.ood_classes`) and pso-inverter-analysis assigns
(`--ood-patient`, else `pso_inverter.ood_patient`). `claro-preprocess`
reads its manifests from the config (`--tiny` caps it at 512 slices, like
--limit). These five run no model, so `--fast-math` changes nothing there.
The regularize stages invert the first 8 OoD test images, 500 iterations
(50 with `--tiny`). `--limit N` caps every dataset load at N images;
`--tiny` caps at 512 unless --limit says otherwise, and gives 1 training
epoch unless --epochs says otherwise.

`sweep` runs the JAX CLI's legs (`cli/main.py:307-334`), each a stage with
its own run dir and every leg sharing the upstream paths given: the
latent-dim sweep (reference start.sh:11-36) runs each of `--stages` at each
of `--latent-dims` with `trainer_gan.z_dim`, `trainer_pso.dim_space` and
`model_inverter.latent_space` set to the dim; with `--patients`, the
per-patient sweep (start_pso_optimize.sh:3-16) runs `pso-inverter` for each
patient x `--controls` entry. `export-model` writes a `torch.export`
artifact (`compat/export.py`); `--platforms` takes cuda and cpu (one
artifact serves both) and exits 2 on any other. `convert-torch` and
`export-torch` convert between the reference's torch checkpoints and the
msgpack saves (`compat/torch_import.py`, `compat/torch_export.py`) on the
CPU.

Every stage on a CUDA device, the sweep and export-model included, holds
the GPU lease (`core/gpulock.py`) while it runs; the ranks of
`--shard-swarm` and a sweep's legs run under their parent's.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from gan_discovery_pso_tpu_torch.core.gpulock import gpu_lock

ANALYSIS_STAGES = ("pso-analysis", "pso-analysis-clustering", "pso-analysis-distance",
                   "pso-inverter-analysis")
INVERSION_STAGES = ("regularize-inverter", "regularize-inverter-statistics")
# stages that build a model from the data alone (no upstream checkpoint but
# the classifiers' --path-cae)
MODEL_STAGES = ("cae", "classifiers", "cnn", "cnn-multipatient")
# stages that train, optimise by gradients or build the evaluation battery:
# --fast-math runs them inside ops.precision.tf32_math()
TF32_STAGES = (*MODEL_STAGES, "dcgan", "inverter", *INVERSION_STAGES, "vqvae",
               "pixelcnn-prior")


def _parse_set(values):
    """--set a.b.c=value (int/float/bool/list coerced via yaml)."""
    import yaml

    out = {}
    for item in values or []:
        k, _, v = item.partition("=")
        out[k] = yaml.safe_load(v)
    return out


def _add_common(p):
    p.add_argument("--cfg", default="configs/dcgan_mnist.yaml")
    # action="extend": repeated `--set a=1 --set b=2` accumulate
    p.add_argument("--set", nargs="*", action="extend", default=[],
                   help="dotted config overrides (repeatable)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny-config smoke run (small models and swarms)")
    p.add_argument("--limit", type=int, default=None, help="cap images per dataset")
    p.add_argument("--fast-math", action="store_true",
                   help="the swarm's model forwards in bf16 (the swarm math stays "
                        "fp32), training in TF32, instead of the fp32-parity default")
    p.add_argument("--device", default="cuda",
                   help="torch device of the stage (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch path)")


_TINY = {
    "model_gan.network.units_gen": 8,
    "model_gan.network.units_disc": 8,
    "trainer_gan.z_dim": 8,
    "trainer_pso.n_iterations": 4,
    "trainer_pso.n_particles": 8,
    "trainer_pso.dim_space": 8,
    "model_inverter.latent_space": 8,
    "model_ae.latent_space": 6,
    "model.latent_space.embedding_dim": 8,
    "model.latent_space.num_embedding": 64,
}


def _ctx(args, module):
    from gan_discovery_pso_tpu_torch.pipelines import StageContext

    overrides = _parse_set(args.set)
    if args.tiny:
        overrides = {**_TINY, **overrides}
    ctx = StageContext.create(args.cfg, module, overrides=overrides, device=args.device,
                              run_id=getattr(args, "resume_id", None))
    if args.limit or args.tiny:
        ctx.limit = args.limit or 512
    return ctx


def _epochs(args):
    return 1 if args.tiny and args.epochs is None else args.epochs


def _require(value, flag: str, hint: str):
    """Exit with a diagnosis when a prerequisite-artifact flag is missing."""
    if not value:
        sys.exit(f"{flag} required ({hint})")
    return value


def _load_gan(args, ctx):
    from gan_discovery_pso_tpu_torch.pipelines import load_gan

    if not args.path_gan:
        sys.exit("--path-gan required (models dir of a dcgan run)")
    return load_gan(args.path_gan, device=ctx.device)


def _load_cnn(args, ctx):
    from gan_discovery_pso_tpu_torch.pipelines import assessor_factory, load_cnn

    if not args.path_cnn:
        sys.exit("--path-cnn required (models dir of a cnn-multipatient run)")
    iid = tuple(ctx.data_cfg.iid_classes)
    rdef, _init, _apply = assessor_factory(ctx.cfg, ctx.data_cfg, len(iid))
    return load_cnn(args.path_cnn, rdef, device=ctx.device), rdef


def _parser() -> argparse.ArgumentParser:
    from gan_discovery_pso_tpu_torch.compat.torch_import import MODELS

    parser = argparse.ArgumentParser(prog="gan-discovery-pso-tpu-torch")
    sub = parser.add_subparsers(dest="stage", required=True)
    for name in MODEL_STAGES:
        p = sub.add_parser(name)
        _add_common(p)
        if name == "classifiers":
            p.add_argument("--path-cae", default=None, help="cae stage model dir")
        else:
            p.add_argument("--epochs", type=int, default=None,
                           help="training epochs (default: the stage's trainer_*.epochs)")
    for name in ("pso-discovery", "pso-inverter", "iid-extract", "ood-extract", "inverter",
                 *INVERSION_STAGES):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--path-gan", default=None, help="dcgan stage model dir")
        if name not in ("pso-discovery", "inverter"):
            p.add_argument("--path-inverter", default=None, help="inverter stage model dir")
        if name in ("pso-discovery", "pso-inverter", "inverter"):
            p.add_argument("--path-cnn", default=None, help="cnn stage model dir")
        if name in ("pso-inverter", "inverter"):
            p.add_argument("--epochs", type=int, default=None,
                           help="training epochs (default: the stage's trainer_*.epochs)")
        if name == "regularize-inverter-statistics":
            p.add_argument("--path-pso", default=None, help="pso-discovery stage interim dir")
        if name == "pso-discovery":
            p.add_argument("--batch-classes", action="store_true",
                           help="advance all class swarms in one batch")
            p.add_argument("--shard-swarm", type=int, default=None, metavar="N",
                           help="split each class's swarm over N ranks (torch.distributed; "
                                "started here unless a group of N is up)")
        if name == "pso-inverter":
            p.add_argument("--ood-patient", type=int, default=None)
    p = sub.add_parser("dcgan")
    _add_common(p)
    p.add_argument("--path-cae", default=None, help="cae stage model dir")
    p.add_argument("--path-classifiers", default=None, help="classifiers stage model dir")
    p.add_argument("--epochs", type=int, default=None,
                   help="training epochs (default: trainer_gan.epochs)")
    p.add_argument("--resume-id", type=int, default=None, metavar="N",
                   help="re-enter run dir N and resume from its checkpoint; --epochs "
                        "counts ADDITIONAL epochs")
    p = sub.add_parser("vqvae")
    _add_common(p)
    p.add_argument("--path-gan", default=None, help="dcgan stage model dir")
    p.add_argument("--path-pso", default=None, help="pso-discovery stage interim dir")
    p.add_argument("--epochs", type=int, default=None,
                   help="training epochs (default: trainer.epochs)")
    p = sub.add_parser("pixelcnn-prior")
    _add_common(p)
    p.add_argument("--path-vqvae", default=None, help="vqvae stage model dir")
    p.add_argument("--epochs", type=int, default=None, help="training epochs (default: 10)")
    for name in ANALYSIS_STAGES:
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--path-pso", default=None, help="pso-discovery stage interim dir")
        if name in ("pso-analysis-clustering", "pso-inverter-analysis"):
            p.add_argument("--path-ood-pso", action="append", default=None,
                           help="pso-inverter stage interim dir; repeatable, one per "
                                "inverted patient")
        if name == "pso-inverter-analysis":
            p.add_argument("--ood-patient", type=int, default=None)
    _add_common(sub.add_parser("claro-preprocess"))
    p = sub.add_parser("sweep")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=None)
    for flag, what in (("cae", "cae"), ("classifiers", "classifiers"), ("gan", "dcgan"),
                       ("cnn", "cnn"), ("inverter", "inverter"), ("vqvae", "vqvae")):
        p.add_argument(f"--path-{flag}", default=None, help=f"{what} stage model dir")
    p.add_argument("--path-pso", default=None, help="pso-discovery stage interim dir")
    p.add_argument("--path-ood-pso", action="append", default=None,
                   help="pso-inverter stage interim dir; repeatable")
    p.add_argument("--latent-dims", type=int, nargs="*", default=[2, 3, 4, 6, 8, 10, 20, 30, 100])
    p.add_argument("--stages", nargs="*", default=["dcgan", "pso-discovery"])
    p.add_argument("--patients", type=int, nargs="*", default=None,
                   help="per-patient sweep: pso-inverter for each patient x control")
    p.add_argument("--controls", nargs="*",
                   default=["optimize_in_training", "optimize_out_training"])
    # what the legs' stages read and the sweep does not set
    p.set_defaults(resume_id=None, batch_classes=False, shard_swarm=None, ood_patient=None)
    p = sub.add_parser("export-model",
                       help="export a torch.export serving artifact (weights inside)")
    _add_common(p)
    p.add_argument("what", choices=["generator", "fitness"])
    p.add_argument("out", help="output artifact path (.pt2)")
    p.add_argument("--path-gan", required=True)
    p.add_argument("--path-cnn", default=None,
                   help="required for `fitness` (assessor models dir)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--class-label", type=int, default=None,
                   help="fitness: the IiD class label to score (default: first iid class)")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="devices the artifact must serve: cuda, cpu (it serves both)")
    p = sub.add_parser("convert-torch", help="import a reference PyTorch checkpoint")
    p.add_argument("src", help=".pt / .tar checkpoint from the reference")
    p.add_argument("model", choices=MODELS)
    p.add_argument("dst", help="output .msgpack path")
    p = sub.add_parser("export-torch",
                       help="export a msgpack checkpoint to a reference PyTorch state dict "
                            "(.pt) or .tar container")
    p.add_argument("src", help="msgpack checkpoint (state-dict save or GAN checkpoint)")
    p.add_argument("model", choices=MODELS)
    p.add_argument("dst", help="output path; .tar wraps the reference's "
                               "{'epoch','model_state_dict','loss'} dict, anything else "
                               "saves the bare state_dict")
    p.add_argument("--epoch", type=int, default=0,
                   help=".tar epoch field (GAN checkpoints supply their own)")
    p.add_argument("--loss", type=float, default=0.0,
                   help=".tar loss field (GAN checkpoints supply their own)")
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.stage == "convert-torch":
        from gan_discovery_pso_tpu_torch.compat.torch_import import convert_torch_checkpoint

        convert_torch_checkpoint(args.src, args.model, dst=args.dst)
        print(f"[convert-torch] {args.src} ({args.model}) -> {args.dst}")
        return 0
    if args.stage == "export-torch":
        from gan_discovery_pso_tpu_torch.compat.torch_export import export_torch_checkpoint

        export_torch_checkpoint(args.src, args.model, args.dst, epoch=args.epoch,
                                loss=args.loss)
        print(f"[export-torch] {args.src} ({args.model}) -> {args.dst}")
        return 0
    if args.limit is not None and args.limit < 0:
        print(f"--limit {args.limit}: a cap on images must not be negative", file=sys.stderr)
        return 2
    if args.stage == "export-model":
        return _export_model(args)
    return dispatch(args, argv)


def _export_model(args):
    """`export-model {generator,fitness} OUT`: a `torch.export` artifact
    (`compat/export.py`); no run dir is made."""
    from gan_discovery_pso_tpu_torch.compat.export import (
        check_platforms,
        export_discovery_fitness,
        export_generator,
    )
    from gan_discovery_pso_tpu_torch.core import load_config
    from gan_discovery_pso_tpu_torch.core.config import DataConfig
    from gan_discovery_pso_tpu_torch.pipelines import assessor_factory, load_cnn, load_gan

    try:
        check_platforms(args.platforms)
    except ValueError as e:
        print(f"export-model: {e}", file=sys.stderr)
        return 2
    overrides = _parse_set(args.set)
    if args.tiny:
        overrides = {**_TINY, **overrides}
    cfg = load_config(args.cfg, overrides=overrides)
    data_cfg = DataConfig.from_config(cfg.data)
    dtype = torch.bfloat16 if args.fast_math else None
    with gpu_lock("cli:export-model", device=args.device):
        gen = load_gan(args.path_gan, device=args.device)
        if args.what == "generator":
            out = export_generator(gen, z_dim=int(cfg.trainer_gan.z_dim), batch=args.batch,
                                   path=args.out, platforms=args.platforms, dtype=dtype)
        else:
            iid = tuple(data_cfg.iid_classes)
            rdef, _init, _apply = assessor_factory(cfg, data_cfg, len(iid))
            cnn = load_cnn(_require(args.path_cnn, "--path-cnn",
                                    "models dir of a cnn-multipatient run"), rdef,
                           device=args.device)
            label = args.class_label if args.class_label is not None else iid[0]
            c2i = rdef.class_to_idx()
            if label not in c2i:
                sys.exit(f"export-model: --class-label {label} is not an IiD class of this "
                         f"config (classes: {sorted(c2i)}) — the exported fitness would "
                         "score the wrong logit column")
            out = export_discovery_fitness(gen, cnn, class_idx=c2i[label],
                                           dim_space=int(cfg.trainer_pso.dim_space),
                                           batch=args.batch, path=args.out,
                                           platforms=args.platforms, dtype=dtype)
    print(f"[export-model] {args.what} -> {out}")
    return 0


def _sweep(args) -> int:
    """The sweep's legs, each through `dispatch` with its own run dir
    (JAX `cli/main.py:307-334`)."""
    if args.patients:
        # per-patient x control sweep (reference start_pso_optimize.sh:3-16)
        for patient in args.patients:
            for control in args.controls:
                leg = argparse.Namespace(**vars(args))
                leg.stage = "pso-inverter"
                leg.ood_patient = patient
                leg.set = list(args.set) + [
                    f"pso_inverter.ood_patient={patient}",
                    f"trainer_pso_inverter.control_pso_fitness={control}",
                ]
                print(f"[sweep] patient={patient} control={control}")
                dispatch(leg)
        return 0
    # latent-dim sweep (reference start.sh:11-36)
    for dim in args.latent_dims:
        for stage in args.stages:
            leg = argparse.Namespace(**vars(args))
            leg.stage = stage
            leg.set = list(args.set) + [
                f"trainer_gan.z_dim={dim}",
                f"trainer_pso.dim_space={dim}",
                f"model_inverter.latent_space={dim}",
            ]
            print(f"[sweep] latent_dim={dim} stage={stage}")
            dispatch(leg)
    return 0


def dispatch(args, argv=None) -> int:
    """Run the stage `args` name under the GPU lease (`argv`: the command
    line, which the ranks of --shard-swarm run again)."""
    with gpu_lock(f"cli:{args.stage}", device=args.device):
        if args.stage == "sweep":
            return _sweep(args)
        return _run_stage(args, argv)


def _run_stage(args, argv) -> int:
    shards = args.shard_swarm if args.stage == "pso-discovery" else None
    if shards is not None:
        from gan_discovery_pso_tpu_torch.parallel import distributed_initialize_if_needed

        distributed_initialize_if_needed(device=args.device)  # GDPT_*, else nothing
        refused = _refuse_shards(args)
        if refused:
            print(refused, file=sys.stderr)
            return 2
        if not torch.distributed.is_initialized():
            from gan_discovery_pso_tpu_torch.parallel.launch import spawn

            spawn(_shard_rank, shards, argv, device=args.device)
            return 0

    from gan_discovery_pso_tpu_torch import pipelines as P
    from gan_discovery_pso_tpu_torch.ops.precision import tf32_math

    stage = args.stage
    fast_math = torch.bfloat16 if args.fast_math else None
    precision = (tf32_math() if args.fast_math and stage in TF32_STAGES
                 else contextlib.nullcontext())
    writer = shards is None or torch.distributed.get_rank() == 0
    ctx = _ctx(args, stage.replace("-", "_")) if shards is None else _rank_ctx(args, stage)
    with ctx.tee() if writer else contextlib.nullcontext(), precision:
        if shards is not None and writer:
            from gan_discovery_pso_tpu_torch.parallel.launch import spawn

            if spawn.seconds_to_group is not None:
                print(f"[{stage}] {shards} ranks started, process group up in "
                      f"{spawn.seconds_to_group:.6f}s")
        if stage == "cae":
            P.run_cae(ctx, epochs=_epochs(args))
        elif stage == "classifiers":
            P.run_classifiers(ctx, cae_model_dir=_require(args.path_cae, "--path-cae",
                                                          "models dir of a cae run"))
        elif stage == "dcgan":
            from pathlib import Path

            from gan_discovery_pso_tpu_torch.evaluation import load_battery

            cae = P.load_cae(_require(args.path_cae, "--path-cae", "models dir of a cae run"),
                             device=ctx.device)
            battery = load_battery(Path(_require(
                args.path_classifiers, "--path-classifiers",
                "models dir of a classifiers run")) / "classifiers.msgpack", device=ctx.device)
            P.run_dcgan(ctx, cae, battery, epochs=_epochs(args),
                        n_synthetic=256 if args.tiny else None,
                        resume=args.resume_id is not None)
        elif stage == "vqvae":
            P.run_vqvae(ctx, _load_gan(args, ctx), pso_interim_dir=args.path_pso,
                        epochs=_epochs(args))
        elif stage == "pixelcnn-prior":
            P.run_pixelcnn_prior_from_vqvae(
                ctx, _require(args.path_vqvae, "--path-vqvae", "models dir of a vqvae run"),
                epochs=_epochs(args))
        elif stage == "cnn":
            P.run_cnn(ctx, epochs=_epochs(args))
        elif stage == "cnn-multipatient":
            P.run_cnn_multipatient(ctx, epochs=_epochs(args))
        elif stage == "pso-discovery":
            gen = _load_gan(args, ctx)
            cnn, rdef = _load_cnn(args, ctx)
            P.run_pso_discovery(ctx, gen, cnn, rdef, batch_classes=args.batch_classes,
                                shard_devices=shards, fast_math_dtype=fast_math)
        elif stage == "inverter":
            gen = _load_gan(args, ctx)
            cnn = None
            if str(ctx.cfg.trainer_inverter.training_function) == "pix_fea_rec_adv":
                cnn, _rdef = _load_cnn(args, ctx)
            P.run_inverter(ctx, gen, cnn=cnn, epochs=_epochs(args))
        elif stage in INVERSION_STAGES:
            gen = _load_gan(args, ctx)
            enc = P.load_encoder(_require(args.path_inverter, "--path-inverter",
                                          "models dir of an inverter run"), device=ctx.device)
            ds = ctx.dataset("test", classes=ctx.data_cfg.ood_classes, drange=(-1, 1))
            images, labels = ds.images[:8], ds.labels[:8].cpu().numpy()
            iterations = 50 if args.tiny else 500
            if stage == "regularize-inverter":
                P.run_regularize_inverter(ctx, gen, enc, images, iterations=iterations,
                                          labels=labels)
            else:
                P.run_regularize_inverter_statistics(
                    ctx, gen, enc, images, _require(args.path_pso, "--path-pso",
                                                    "interim dir of a pso-discovery run"),
                    iterations=iterations, labels=labels)
        elif stage in ("iid-extract", "ood-extract"):
            enc = P.load_encoder(_require(args.path_inverter, "--path-inverter",
                                          "models dir of an inverter run"), device=ctx.device)
            # the reference extractor also writes per-class G(E(x))
            # superimages (iid_extractor.py:163-199); optional here
            gen = _load_gan(args, ctx) if args.path_gan else None
            P.run_extractor(ctx, enc, kind=stage.split("-")[0], gen=gen)
        elif stage in ANALYSIS_STAGES:
            pso = _require(args.path_pso, "--path-pso", "interim dir of a pso-discovery run")
            if stage == "pso-analysis":
                P.run_pso_analysis(ctx, pso)
            elif stage == "pso-analysis-distance":
                P.run_pso_analysis_distance(ctx, pso)
            elif stage == "pso-analysis-clustering":
                P.run_pso_analysis_clustering(
                    ctx, pso, ood_interim_dir=args.path_ood_pso,
                    ood_labels=tuple(ctx.data_cfg.ood_classes) if args.path_ood_pso else None)
            else:
                ood = _require(args.path_ood_pso, "--path-ood-pso",
                               "interim dir of a pso-inverter run")
                patient = args.ood_patient
                if patient is None:
                    patient = int(ctx.cfg.pso_inverter.ood_patient)
                P.run_pso_inverter_analysis(ctx, pso, list(ood), patient)
        elif stage == "claro-preprocess":
            P.run_claro_preprocess(ctx, limit=ctx.limit)
        else:
            gen = _load_gan(args, ctx)
            enc = P.load_encoder(_require(args.path_inverter, "--path-inverter",
                                          "models dir of an inverter run"), device=ctx.device)
            cnn, rdef = _load_cnn(args, ctx)
            P.run_pso_inverter(ctx, gen, enc, cnn, rdef, ood_patient=args.ood_patient,
                               fine_tune_epochs=_epochs(args), fast_math_dtype=fast_math)
    if writer:
        print(f"[{stage}] done → {ctx.run.reports_dir}")
    return 0


def _refuse_shards(args) -> str | None:
    """Why `--shard-swarm` cannot run as asked, or None."""
    if args.batch_classes:
        # the JAX stage's ValueError (pipelines/pso_discovery.py:70-71)
        return "--shard-swarm: batch_classes and shard_devices are mutually exclusive"
    if args.shard_swarm < 1:
        return f"--shard-swarm {args.shard_swarm}: needs at least one rank"
    dist = torch.distributed
    if dist.is_initialized() and dist.get_world_size() != args.shard_swarm:
        return (f"--shard-swarm {args.shard_swarm}: this process group has "
                f"{dist.get_world_size()} ranks")
    return None


def _shard_rank(argv) -> None:
    """One rank of a `--shard-swarm` run that the CLI started."""
    rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"rank {torch.distributed.get_rank()}: the CLI returned {rc}")


def _rank_ctx(args, stage: str):
    """The stage context of this rank of a sharded run: rank 0 makes the run
    dir, whose id it broadcasts; every rank runs on its own device
    (`parallel.mesh.rank_device`)."""
    from gan_discovery_pso_tpu_torch.parallel.mesh import rank_device

    dist = torch.distributed
    rank = dist.get_rank()
    args.device = str(rank_device(args.device, rank))
    ctx = _ctx(args, stage.replace("-", "_")) if rank == 0 else None
    run_id = torch.tensor([ctx.run.run_id if ctx else 0], device=args.device)
    dist.broadcast(run_id, src=0)
    if ctx is None:
        args.resume_id = int(run_id)
        ctx = _ctx(args, stage.replace("-", "_"))
    return ctx


if __name__ == "__main__":
    sys.exit(main())
