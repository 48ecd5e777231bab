"""Command-line entry point of the port (counterpart of
`gan_discovery_pso_tpu/cli/main.py`: `_parse_set`, `_add_common`, `_TINY`,
`_ctx`, `_epochs` :33-90, `_load_gan`/`_load_cnn` :271-290, and the
`cae`, `classifiers`, `dcgan`, `cnn`, `cnn-multipatient`, `pso-discovery`,
`inverter`, `iid-extract`/`ood-extract`, `pso-inverter`,
`regularize-inverter`, `regularize-inverter-statistics`, `vqvae`,
`pixelcnn-prior`, `pso-analysis`, `pso-analysis-clustering`,
`pso-analysis-distance`, `pso-inverter-analysis` and `claro-preprocess`
branches :351-448):

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
`checkpoint_g`; `--tiny` evaluates it on 256 samples an epoch. The stages
run on the card; `--device cpu` is the port's counterpart of
`JAX_PLATFORMS=cpu`. `--fast-math` runs the swarm's forwards in bf16 (the
pso-inverter's fine-tune stays in fp32 parity); the training stages (cae,
cnn, cnn-multipatient, dcgan, inverter, vqvae, pixelcnn-prior),
classifiers and the two regularize stages refuse it (exit 2, ROADMAP A18),
and so does `dcgan` under `trainer_gan.compute_dtype`. `--path-cnn` is read by
`inverter` only for `trainer_inverter.training_function=pix_fea_rec_adv`;
`--path-pso` is the interim dir of a pso-discovery run (the vqvae's
codebook, the analyses' particles); `--path-ood-pso` (repeatable) the
interim dir of a pso-inverter run per inverted patient, whose OoD latents
the clustering overlays (labelled by `data.ood_classes`) and
pso-inverter-analysis assigns (`--ood-patient`, else
`pso_inverter.ood_patient`). `claro-preprocess` reads its manifests from
the config (`--tiny` caps it at 512 slices, like --limit). These five run
no model, so `--fast-math` changes nothing there. The regularize
stages invert the first 8 OoD test images, 500 iterations (50 with
`--tiny`). `--limit N` caps every dataset load at N images; `--tiny` caps
at 512 unless --limit says otherwise, and gives 1 training epoch unless
--epochs says otherwise. Every other stage of the JAX CLI exits non-zero,
naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch

# stages of the JAX package's CLI that the port does not run yet, with the
# ROADMAP item of each
NOT_PORTED = {"sweep": "A17", "export-model": "A17", "convert-torch": "A17",
              "export-torch": "A17"}
ANALYSIS_STAGES = ("pso-analysis", "pso-analysis-clustering", "pso-analysis-distance",
                   "pso-inverter-analysis")
INVERSION_STAGES = ("regularize-inverter", "regularize-inverter-statistics")
# stages that build a model from the data alone (no upstream checkpoint but
# the classifiers' --path-cae)
MODEL_STAGES = ("cae", "classifiers", "cnn", "cnn-multipatient")
# stages that train, optimise by gradients or build the evaluation battery:
# the JAX package's --fast-math there is TPU DEFAULT precision, whose card
# counterpart is not decided yet
NO_FAST_MATH = (*MODEL_STAGES, "dcgan", "inverter", *INVERSION_STAGES, "vqvae",
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
                   help="run the swarm's model forwards in bf16 (the swarm math "
                        "stays fp32) instead of the fp32-parity default")
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
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"{argv[0]}: not yet ported to the PyTorch package "
              f"(ROADMAP {NOT_PORTED[argv[0]]}); run it with "
              "`python -m gan_discovery_pso_tpu.cli`", file=sys.stderr)
        return 2
    args = _parser().parse_args(argv)
    if args.fast_math and args.stage in NO_FAST_MATH:
        print(f"--fast-math: not yet ported for the {args.stage} stage (ROADMAP A18); it "
              "runs in fp32 parity", file=sys.stderr)
        return 2
    if args.stage == "dcgan":  # refused before a run dir is made
        from gan_discovery_pso_tpu_torch.core import load_config
        from gan_discovery_pso_tpu_torch.pipelines import NotPortedError, refuse_gan_compute_dtype

        try:
            refuse_gan_compute_dtype(load_config(args.cfg, overrides=_parse_set(args.set)))
        except NotPortedError as e:
            print(e, file=sys.stderr)
            return 2
    if args.limit is not None and args.limit < 0:
        print(f"--limit {args.limit}: a cap on images must not be negative", file=sys.stderr)
        return 2
    shards = getattr(args, "shard_swarm", None)
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

    stage = args.stage
    fast_math = torch.bfloat16 if args.fast_math else None
    writer = shards is None or torch.distributed.get_rank() == 0
    ctx = _ctx(args, stage.replace("-", "_")) if shards is None else _rank_ctx(args, stage)
    with ctx.tee() if writer else contextlib.nullcontext():
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
