"""The trained chain's early numbers in fp32 parity and under `--fast-math`
(TF32), on the card, from the same seed: what the reference chain's gaps
to the JAX package's run (`docs/RESULTS.md`) depend on.

    PYTHONPATH=. python3 experiments_torch/chain_probe.py [--out DIR]
        [--seeds 42 ...] [--gan-epochs 3]
    PYTHONPATH=. python3 experiments_torch/chain_probe.py --cae DIR
        [--dims 10 2] [--gan-epochs 100] [--assessors 42 7 ...] [--cnn DIR ...]

Run from the repository root, on a machine with a CUDA card.

For each seed and each mode (fp32 parity, then TF32) it runs, through the
port's CLI in this process, at the shipped widths and epochs but for the
DCGAN (--gan-epochs) and the inverter (INVERTER_EPOCHS): `cae` →
`classifiers` → `dcgan` (z 10) → `cnn-multipatient` → `inverter`
pix_fea_rec_adv (z 10) → `pso-inverter` (patient 5, one fine-tune epoch).
It prints one JSON line a run:
- the CAE's last losses and the total variance of its embeddings of the
  IiD test images (the FID's scale);
- the DCGAN's FID and IS per epoch, and its last G under both modes' CAEs
  and batteries (`evaluate_gan_epoch` in fp32 parity; one generator draw);
- the assessor's epochs, best val loss, and the mean square and largest
  |value| of its pooled features over the IiD test images in [−1, 1] (the
  inverter's input range) and [0, 1] (its training range);
- the adversarial inverter's per-epoch train_loss_enc and its terms;
- the seeded swarm's mean pairwise distance at iteration 0 and at the end,
  and its g_best.
With `--cae DIR` (a cae run's models dir, written by either package) it
runs instead `classifiers` on that CAE and, for each of --dims, `dcgan`
under `--fast-math` as the experiment driver does, and prints the CAE's
embedding variance and each run's FID and IS per epoch: how much of a FID
is the CAE's scale. With --assessors (seeds) or --cnn (cnn-multipatient
models dirs, either package's), it then holds the z-10 G fixed and runs,
on each of those assessors (the seeds' trained here by
`cnn-multipatient --fast-math`), the feature statistics above, the
adversarial `inverter` and `pso-inverter` (patient 5) at the shipped
epochs under `--fast-math`: how much of the inverter's numbers is the
assessor's.
Everything goes under --out (default `chiprun_out/chain_probe`): the
records in chain_probe.json; the run dirs are removed at the end.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import torch

from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.core.config import load_config
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity

CFG = "configs/dcgan_mnist.yaml"
DIM = 10
PATIENT = 5
INVERTER_EPOCHS = 2
IID = (0, 2, 3, 4, 6, 7, 8, 9)  # the shipped config's


def _test_images(drange) -> torch.Tensor:
    """The IiD test images the stages read (idx files or the synthetic
    digits), on the card."""
    from gan_discovery_pso_tpu_torch.data import load_mnist

    data_dir = load_config(CFG).data.data_dir
    return load_mnist(data_dir, split="test", classes=IID, drange=drange).images


def _stage(root: Path, stage: str, mode: str, seed: int, *args: str, dim: int = DIM) -> Path:
    """One CLI stage under root; returns its models dir."""
    sets = [f"data.{k}_dir={root / k}" for k in ("model", "reports", "interim")]
    argv = [stage, "--cfg", CFG, *args, *(["--fast-math"] if mode == "tf32" else []),
            "--set", f"seed={seed}", f"trainer_gan.z_dim={dim}", f"trainer_pso.dim_space={dim}",
            f"model_inverter.latent_space={dim}", *sets]
    t0 = time.perf_counter()
    rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"{stage} ({mode}, seed {seed}) returned {rc}")
    print(f"[chain_probe] {stage} {mode} seed {seed}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    (models,) = sorted((root / "model" / "mnist").glob(f"*--{stage.replace('-', '_')}"))[-1:]
    return models


def _inverter_and_swarm(root: Path, mode: str, seed: int, gan: Path, cnn: Path,
                        inverter_args=(), swarm_args=()) -> tuple[dict, dict]:
    """The adversarial inverter on G and the assessor, then the p5 swarm
    seeded by its encoder: the inverter's loss series, the swarm's spread at
    iteration 0 and at the end, and its g_best."""
    inv = _stage(root, "inverter", mode, seed, "--path-gan", str(gan), "--path-cnn", str(cnn),
                 *inverter_args, "--set", "trainer_inverter.training_function=pix_fea_rec_adv")
    h = _history(inv)
    pso = _stage(root, "pso-inverter", mode, seed, "--ood-patient", str(PATIENT), "--path-gan",
                 str(gan), "--path-inverter", str(inv), "--path-cnn", str(cnn), *swarm_args)
    s = _history(pso)[f"pso_inverter_history_ood_patient_{PATIENT}"]
    return ({k: h[k] for k in ("train_loss_enc", "train_loss_enc_rec_pix",
                               "train_loss_enc_rec_fea", "train_loss_enc_adv",
                               "val_iid_pixfea", "val_ood_pixfea")},
            {"mean_mse_first": s["mean_mse"][0], "mean_mse_last": s["mean_mse"][-1],
             "g_best": float(s["global_best_val"][-1])})


def _history(models: Path) -> dict:
    reports = Path(str(models).replace("/model/", "/reports/"))
    return json.loads((reports / "general" / "overall_history.json").read_text())


@torch.no_grad()
def _embedding_variance(cae_dir: Path) -> float:
    from gan_discovery_pso_tpu_torch.pipelines.stages import load_cae

    encoder, _ = load_cae(cae_dir)
    with fp32_parity():
        emb = encoder(_test_images((0, 1)))
    return float(emb.var(dim=0).sum())


@torch.no_grad()
def _feature_stats(cnn_dir: Path) -> dict:
    from gan_discovery_pso_tpu_torch.models import ResNetDef
    from gan_discovery_pso_tpu_torch.pipelines.stages import load_cnn

    cnn = load_cnn(cnn_dir, ResNetDef("ResNet50", 1, len(IID), IID))
    out = {}
    for name, drange in (("pm1", (-1, 1)), ("01", (0, 1))):
        x = _test_images(drange)
        with fp32_parity():
            f = torch.cat([cnn.features(x[i:i + 512]) for i in range(0, x.shape[0], 512)])
        out[name] = {"mean_sq": float((f * f).mean()), "max_abs": float(f.abs().max())}
    return out


@torch.no_grad()
def _cross_fid(gan_dirs: dict, cae_dirs: dict, cls_dirs: dict) -> dict:
    """Each mode's last G under each mode's CAE and battery, one z draw."""
    from gan_discovery_pso_tpu_torch.evaluation import evaluate_gan_epoch
    from gan_discovery_pso_tpu_torch.evaluation.classifiers import load_battery
    from gan_discovery_pso_tpu_torch.pipelines.stages import load_cae, load_gan
    from gan_discovery_pso_tpu_torch.train.dcgan import make_sampler

    val = _test_images((0, 1))
    out = {}
    for g_mode, g_dir in gan_dirs.items():
        sampler = make_sampler(load_gan(g_dir, best=False))
        for c_mode in cae_dirs:
            encoder, decoder = load_cae(cae_dirs[c_mode])
            battery = load_battery(cls_dirs[c_mode] / "classifiers.msgpack")
            gen = torch.Generator(device="cuda").manual_seed(7)
            res = evaluate_gan_epoch(sampler, encoder, decoder, battery, val,
                                     generator=gen)
            out[f"G_{g_mode}_CAE_{c_mode}"] = {"fid": float(res.fid),
                                               "is": float(res.inception_score)}
    return out


def probe(out: Path, seed: int, gan_epochs: int) -> dict:
    dirs: dict = {}
    rec: dict = {"seed": seed}
    for mode in ("fp32", "tf32"):
        root = out / f"seed{seed}_{mode}"
        r: dict = {}
        cae = _stage(root, "cae", mode, seed)
        h = _history(cae)
        r["cae"] = {"train_loss": h["train_loss"][-1], "val_loss": h["val_loss"][-1],
                    "embedding_variance": _embedding_variance(cae)}
        cls = _stage(root, "classifiers", mode, seed, "--path-cae", str(cae))
        gan = _stage(root, "dcgan", mode, seed, "--path-cae", str(cae), "--path-classifiers",
                     str(cls), "--epochs", str(gan_epochs))
        h = _history(gan)
        r["dcgan"] = {"fid": h["fid"], "is": h["is"]}
        cnn = _stage(root, "cnn-multipatient", mode, seed)
        h = _history(cnn)
        r["cnn_multipatient"] = {"epochs": len(h["val_loss"]), "best_val_loss": min(h["val_loss"]),
                                 "val_loss_max": max(h["val_loss"]),
                                 "features": _feature_stats(cnn)}
        r["inverter_adv"], r["pso_inverter"] = _inverter_and_swarm(
            root, mode, seed, gan, cnn, ("--epochs", str(INVERTER_EPOCHS)), ("--epochs", "1"))
        dirs[mode] = {"gan": gan, "cae": cae, "cls": cls}
        rec[mode] = r
        print(json.dumps({"seed": seed, "mode": mode, **r}), flush=True)
    with fp32_parity():
        rec["cross_fid"] = _cross_fid({m: d["gan"] for m, d in dirs.items()},
                                      {m: d["cae"] for m, d in dirs.items()},
                                      {m: d["cls"] for m, d in dirs.items()})
    print(json.dumps({"seed": seed, "cross_fid": rec["cross_fid"]}), flush=True)
    return rec


def probe_cae(out: Path, cae: Path, dims, gan_epochs: int) -> dict:
    """classifiers on `cae`, then dcgan (TF32) at each dim."""
    rec = {"cae": str(cae), "embedding_variance": _embedding_variance(cae)}
    cls = _stage(out, "classifiers", "tf32", 42, "--path-cae", str(cae))
    for dim in dims:
        gan = _stage(out, "dcgan", "tf32", 42, "--path-cae", str(cae), "--path-classifiers",
                     str(cls), "--epochs", str(gan_epochs), dim=dim)
        h = _history(gan)
        rec[f"dcgan_z{dim}"] = {"fid": h["fid"], "is": h["is"], "fid_least": min(h["fid"]),
                                "fid_final": h["fid"][-1], "is_best": max(h["is"])}
        rec[f"gan_z{dim}"] = gan
    print(json.dumps({k: v for k, v in rec.items() if not k.startswith("gan_")}), flush=True)
    return rec


def probe_assessors(out: Path, gan: Path, seeds, cnn_dirs) -> list:
    """The adversarial inverter and the seeded swarm (TF32, shipped epochs)
    on each assessor: trained here from each seed, or given."""
    recs = []
    assessors = [(f"seed {s}", s, None) for s in seeds] + [(str(d), 42, Path(d)) for d in cnn_dirs]
    for i, (name, seed, cnn) in enumerate(assessors):
        root = out / f"assessor{i}"
        if cnn is None:
            cnn = _stage(root, "cnn-multipatient", "tf32", seed)
        inverter, swarm = _inverter_and_swarm(root, "tf32", 42, gan, cnn)
        r = {"assessor": name, "features": _feature_stats(cnn),
             "inverter_adv": {k: [v[0], v[-1]] for k, v in inverter.items()},
             "pso_inverter": swarm}
        print(json.dumps(r), flush=True)
        recs.append(r)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/chain_probe")
    ap.add_argument("--seeds", type=int, nargs="*", default=[42])
    ap.add_argument("--gan-epochs", type=int, default=3)
    ap.add_argument("--cae", default=None, help="a cae run's models dir (see the docstring)")
    ap.add_argument("--dims", type=int, nargs="*", default=[DIM])
    ap.add_argument("--assessors", type=int, nargs="*", default=[])
    ap.add_argument("--cnn", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_probe: no CUDA device", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if (args.assessors or args.cnn) and not (args.cae and DIM in args.dims):
        ap.error(f"--assessors and --cnn need --cae and z {DIM} among --dims")
    if args.cae:
        rec = probe_cae(out / "runs", Path(args.cae), args.dims, args.gan_epochs)
        if args.assessors or args.cnn:
            rec["assessors"] = probe_assessors(out / "runs", rec[f"gan_z{DIM}"], args.assessors,
                                               args.cnn)
        recs = [{k: v for k, v in rec.items() if not k.startswith("gan_")}]
    else:
        recs = [probe(out / "runs", s, args.gan_epochs) for s in args.seeds]
    (out / "chain_probe.json").write_text(json.dumps(recs, indent=1))
    shutil.rmtree(out / "runs", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
