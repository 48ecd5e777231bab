"""The reference experiment chain on the card, one stage per subprocess
(the port's own copy of the repo's `tools/run_experiment.py`):

    python -m gan_discovery_pso_tpu_torch.tools.run_experiment [LEG ...] \\
        [--deadline-min M]

It runs the reference's chain (reference src/bash/start.sh:11-36,
readme_cnr.txt:46-87) through `python -m gan_discovery_pso_tpu_torch.cli`,
in the same legs, dependencies and order as the JAX driver:

    cae -> classifiers -> cnn_multipatient -> cnn battery
        -> dcgan and pso-discovery per latent dim (GDPT_DIMS, default 2,10,100)
        -> inverter (pix_rec + pix_fea_rec_adv) at dim 10
        -> iid/ood extract -> pso-inverter (patients 5 and 1, both controls)
        -> regularize-inverter (+statistics)
        -> vqvae (dim 100) -> pixelcnn prior
        -> the analysis legs at dim 10

The training and swarm legs run with `--fast-math` (TF32 on fp32 models,
as the JAX driver passes it). Everything goes under `experiments_torch/`,
never the JAX driver's `experiments/`: `timings.jsonl` (one record a leg:
rc, wall, argv, log, the run dirs it created), `logs/<leg>.log`, the legs'
run dirs under `runs/` (passed to every leg as `data.model_dir`,
`data.interim_dir`, `data.reports_dir`), failed legs' run dirs quarantined
under `failed_runs/<leg>-<stamp>/`, and `histories/<run>/`, the compact
machine-readable record of each run (`snapshot_histories`), which is what
is committed.

The records work as the JAX driver's:
- each leg records the run dirs it created (the artifact roots before and
  after), and later legs resolve `--path-gan`, `--path-pso`, ... from those
  records, never from a directory's position;
- a record counts only while its run dirs exist, at least one holds files,
  and the run dir's configuration.yaml has the z_dim the record pinned
  (`record_valid`), so a leg whose artifacts went is run again;
- the names under `histories/` are seeded as empty run dirs, so the run-id
  allocator never hands out a committed name again (`seed_run_roots`);
- a leg whose dependencies failed is skipped and recorded once (never a
  second skip record for a leg already recorded); a failure skips only its
  dependents, and the driver returns 1 naming the failed and skipped legs;
- a leg already done (an rc 0 record that is valid) is not run again, so a
  second invocation resumes; `--deadline-min` (or GDPT_DEADLINE_MIN) stops
  dispatching new legs after that many minutes, the leg in flight finishes;
  GDPT_STAGE_TIMEOUT_S bounds each leg (default 4 h).

Before the first leg that runs on the card, and again after a leg failed,
a subprocess checks that CUDA answers, bounded in time and tries
(`wait_for_card`); a leg with `--device cpu` needs no check. `main(only=,
leg_args=, root=)` takes extra command-line arguments per leg
({leg name or "*": [args]}) and another root, for a short chain on the
card or on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
EXP = REPO / "experiments_torch"
PY = sys.executable
CLI = "gan_discovery_pso_tpu_torch.cli"
STAGE_TIMEOUT_S = int(os.environ.get("GDPT_STAGE_TIMEOUT_S", 4 * 3600))
PROBE_TRIES, PROBE_TIMEOUT_S, PROBE_WAIT_S = 5, 120, 30
DATASET = "mnist"  # data.dataset of both configs the chain reads
# each artifact root under runs/, and the config key that points a stage at it
ROOTS = {"models": "model_dir", "interim": "interim_dir", "reports": "reports_dir"}
# the discovery chain's class split (configs/dcgan_mnist.yaml); vqvae.yaml
# ships another, and the vqvae legs must match the discovery run's
DISCOVERY_SPLIT = ["data.iid_classes=[0,2,3,4,6,7,8,9]", "data.ood_classes=[1,5]"]
HISTORY_MAX_BYTES = 2_000_000
HISTORY_FILES = ("configuration.yaml", "timing.json", "history_*.jsonl", "history_*.csv",
                 "general/history_*.jsonl", "general/overall_history.json",
                 "general/encoded_samples*.csv", "ood_patient_*_cluster_assignment.json",
                 "distance_summary.json", "ood_cluster_assignment.json")


def run_root(exp: Path, root: str) -> Path:
    """The directory a stage's `root` run dirs go to."""
    return exp / "runs" / root / DATASET


def dim_sets(dim: int) -> list[str]:
    """The override triple the CLI's `sweep` sets per latent dim."""
    return ["--set", f"trainer_gan.z_dim={dim}", f"trainer_pso.dim_space={dim}",
            f"model_inverter.latent_space={dim}"]


def _dir_has_files(p: Path) -> bool:
    return p.is_dir() and any(f.is_file() for f in p.rglob("*"))


def _record_dim(rec: dict) -> str | None:
    """The z_dim the record's argv pinned, if any."""
    for a in rec.get("argv", []):
        if a.startswith("trainer_gan.z_dim="):
            return a.split("=", 1)[1]
    return None


def _rundir_dim(rec: dict, exp: Path) -> str | None:
    """The z_dim in the recorded run dir's configuration.yaml, if found."""
    for root, names in (rec.get("run_dirs") or {}).items():
        for name in names:
            cfg = run_root(exp, root) / name / "configuration.yaml"
            if cfg.is_file():
                m = re.search(r"^\s*z_dim:\s*(\d+)\s*$", cfg.read_text(), re.M)
                if m:
                    return m.group(1)
    return None


def record_valid(rec: dict, exp: Path = EXP) -> bool:
    """Whether an rc 0 record still stands: every run dir it recorded
    exists, at least one holds files (a seeded placeholder is empty), and,
    where the record pinned a z_dim, the run dir's configuration.yaml
    agrees (a later run of another dim can be handed a stale record's
    name). A leg that made no run dir stands."""
    dirs = [run_root(exp, root) / name
            for root, names in (rec.get("run_dirs") or {}).items() for name in names]
    if not dirs:
        return True
    if not (all(d.is_dir() for d in dirs) and any(_dir_has_files(d) for d in dirs)):
        return False
    want, have = _record_dim(rec), _rundir_dim(rec, exp)
    return want is None or have is None or want == have


def _timings(exp: Path) -> list[dict]:
    path = exp / "timings.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def load_records(exp: Path = EXP) -> dict[str, dict]:
    """leg -> its latest rc 0 record, without the records whose artifacts
    are gone (those legs run again)."""
    recs: dict[str, dict] = {}
    for rec in _timings(exp):
        if rec.get("rc") != 0:
            continue
        if record_valid(rec, exp):
            recs[rec["leg"]] = rec
        else:
            recs.pop(rec["leg"], None)
            print(f"[experiment] {rec['leg']}: recorded artifacts missing on disk — will "
                  "re-run", flush=True)
    return recs


def seed_run_roots(exp: Path = EXP) -> None:
    """Each committed `histories/<run>` name as an EMPTY run dir in every
    root, so the run-id allocator (`core/rundir.py get_next_run_id`) moves
    past it; empty dirs never validate a record."""
    hist = exp / "histories"
    if not hist.is_dir():
        return
    for d in sorted(hist.iterdir()):
        if d.is_dir() and "--" in d.name:
            for root in ROOTS:
                (run_root(exp, root) / d.name).mkdir(parents=True, exist_ok=True)


def snapshot_roots(exp: Path) -> dict[str, set[str]]:
    return {root: {d.name for d in run_root(exp, root).iterdir() if d.is_dir()}
            if run_root(exp, root).is_dir() else set() for root in ROOTS}


def quarantine(exp: Path, leg: str, new_dirs: dict[str, list[str]]) -> None:
    """A failed leg's new run dirs out of the artifact roots, so that the
    allocator and later legs only see completed runs."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    for root, names in new_dirs.items():
        for name in names:
            src = run_root(exp, root) / name
            dst = exp / "failed_runs" / f"{leg}-{stamp}" / root / name
            dst.parent.mkdir(parents=True, exist_ok=True)
            if src.is_dir():
                shutil.move(str(src), str(dst))
                print(f"[experiment] quarantined {src} -> {dst}", flush=True)


def wait_for_card(tries: int = PROBE_TRIES, timeout_s: int = PROBE_TIMEOUT_S,
                  wait_s: int = PROBE_WAIT_S) -> None:
    """Return once a subprocess has put a tensor on the CUDA card and read it
    back, each try bounded by `timeout_s`; exit after `tries` failures."""
    code = "import torch; print(int(torch.ones(1, device='cuda').sum().item()))"
    for attempt in range(tries):
        try:
            p = subprocess.run([PY, "-c", code], timeout=timeout_s, capture_output=True,
                               text=True, cwd=REPO)
            if p.returncode == 0 and p.stdout.strip() == "1":
                if attempt:
                    print(f"[experiment] card up after {attempt + 1} probes", flush=True)
                return
        except subprocess.TimeoutExpired:
            pass
        print(f"[experiment] CUDA probe {attempt + 1}/{tries} failed; waiting {wait_s}s",
              flush=True)
        time.sleep(wait_s)
    sys.exit("[experiment] the CUDA card never answered")


def _on_card(argv: list[str]) -> bool:
    return not any(a == "--device" and b.startswith("cpu") for a, b in zip(argv, argv[1:]))


class Driver:
    """The legs of one invocation over the records under `exp`."""

    def __init__(self, exp: Path = EXP, only: set[str] | None = None,
                 leg_args: dict | None = None, deadline_ts: float | None = None):
        self.exp = exp
        self.only = only
        self.leg_args = leg_args or {}
        self.deadline_ts = deadline_ts
        self.records = load_records(exp)
        # every leg ever recorded (any rc): a skip is recorded only for a
        # leg with no record, so resumed invocations add no duplicate rows
        self.ever_recorded = {rec["leg"] for rec in _timings(exp)}
        # leg -> "ok" | "failed" | "skipped" | "deadline"
        self.status: dict[str, str] = {leg: "ok" for leg in self.records}
        self.card_checked = False

    def record(self, payload: dict) -> None:
        self.ever_recorded.add(payload["leg"])
        with open(self.exp / "timings.jsonl", "a") as f:
            f.write(json.dumps(payload) + "\n")

    def _record_skip(self, name: str, reason: str) -> None:
        if name not in self.ever_recorded:
            self.record({"leg": name, "rc": "skipped", "reason": reason})

    def produced_dir(self, leg: str, root: str) -> str:
        """The run dir `leg` created under `root`, from its record."""
        names = (self.records.get(leg) or {}).get("run_dirs", {}).get(root) or []
        if len(names) > 1:
            raise RuntimeError(f"{leg} recorded multiple {root} run dirs: {names}")
        if not names:
            raise FileNotFoundError(f"no recorded {root} run dir for leg {leg}")
        p = run_root(self.exp, root) / names[0]
        if not p.is_dir():
            raise FileNotFoundError(f"recorded run dir for {leg} missing: {p}")
        return str(p)

    def leg(self, name: str, argv_fn, deps: tuple[str, ...] = ()) -> None:
        if self.only and name not in self.only:
            return
        if self.status.get(name) == "ok":
            print(f"[experiment] {name}: already done, skipping", flush=True)
            return
        if self.deadline_ts is not None and time.time() > self.deadline_ts:
            print(f"[experiment] {name}: deadline passed — not dispatched", flush=True)
            self.status[name] = "deadline"
            return
        bad = [d for d in deps if self.status.get(d) != "ok"]
        if bad:
            reason = ", ".join(f"{d}={self.status.get(d, 'not run')}" for d in bad)
            print(f"[experiment] {name}: SKIPPED (deps: {reason})", flush=True)
            if not any(self.status.get(d) == "deadline" for d in bad):
                self._record_skip(name, reason)
            self.status[name] = "skipped"
            return
        try:
            tail = argv_fn()
        except (FileNotFoundError, RuntimeError) as e:
            print(f"[experiment] {name}: SKIPPED (resolution: {e})", flush=True)
            self._record_skip(name, str(e))
            self.status[name] = "skipped"
            return
        roots = [f"data.{key}={self.exp / 'runs' / root}" for root, key in ROOTS.items()]
        argv = [PY, "-m", CLI, *tail, "--set", *roots, *self.leg_args.get("*", ()),
                *self.leg_args.get(name, ())]
        if _on_card(argv) and not self.card_checked:
            wait_for_card()
            self.card_checked = True
        log_path = self.exp / "logs" / f"{name}.log"
        print(f"[experiment] {name}: {' '.join(argv[2:])}", flush=True)
        before = snapshot_roots(self.exp)
        t0 = time.time()
        with open(log_path, "w") as lf:
            lf.write(f"$ {' '.join(argv)}\n")
            lf.flush()
            try:
                rc = subprocess.run(argv, cwd=REPO, stdout=lf, stderr=subprocess.STDOUT,
                                    timeout=STAGE_TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = -9
                lf.write(f"\n[experiment] TIMEOUT after {STAGE_TIMEOUT_S}s\n")
        wall = time.time() - t0
        after = snapshot_roots(self.exp)
        new_dirs = {root: sorted(after[root] - before[root]) for root in ROOTS}
        rec = {"leg": name, "rc": rc, "wall_s": wall, "argv": argv[2:],
               "log": str(log_path), "run_dirs": {k: v for k, v in new_dirs.items() if v}}
        if rc == 0:
            self.records[name] = rec
            self.status[name] = "ok"
            print(f"[experiment] {name}: ok in {wall / 60:.1f} min", flush=True)
        else:
            self.status[name] = "failed"
            self.card_checked = False
            print(f"[experiment] {name}: FAILED rc={rc} in {wall / 60:.1f} min "
                  f"(see {log_path})", flush=True)
            quarantine(self.exp, name, new_dirs)
            rec["quarantined"] = rec.pop("run_dirs")
        self.record(rec)


def snapshot_histories(exp: Path = EXP) -> Path:
    """The compact record of every run under `exp/runs/reports` into
    `exp/histories/<run>/`: configuration.yaml, timing.json, the history
    jsonl/csv curves, `general/overall_history.json`, the analyses' json and
    the first and last 50 lines of log.txt; files over HISTORY_MAX_BYTES are
    left out. Returns the histories dir."""
    dest = exp / "histories"
    reports = run_root(exp, "reports")
    runs = sorted(d for d in reports.iterdir() if d.is_dir() and "--" in d.name) \
        if reports.is_dir() else []
    for run in runs:
        if not _dir_has_files(run):
            continue  # a seeded placeholder
        for pattern in HISTORY_FILES:
            for src in run.glob(pattern):
                if src.is_file() and src.stat().st_size <= HISTORY_MAX_BYTES:
                    out = dest / run.name / src.relative_to(run)
                    out.parent.mkdir(parents=True, exist_ok=True)
                    shutil.copy2(src, out)
        log = run / "log.txt"
        if log.is_file():
            lines = log.read_text(errors="replace").splitlines()
            if len(lines) > 100:
                lines = lines[:50] + [f"... [{len(lines) - 100} lines elided] ..."] + lines[-50:]
            (dest / run.name).mkdir(parents=True, exist_ok=True)
            (dest / run.name / "log_excerpt.txt").write_text("\n".join(lines) + "\n")
    return dest


def main(only: set[str] | None = None, leg_args: dict | None = None, root: Path | None = None,
         deadline_min: float | None = None) -> int:
    exp = Path(root) if root is not None else EXP
    (exp / "logs").mkdir(parents=True, exist_ok=True)
    seed_run_roots(exp)
    deadline_ts = time.time() + deadline_min * 60.0 if deadline_min else None
    dv = Driver(exp, only, leg_args, deadline_ts)
    fm = ["--fast-math"]
    cnn = lambda: dv.produced_dir("cnn_multipatient", "models")  # noqa: E731

    # ---- prerequisites (reference readme_cnr.txt:46-60)
    dv.leg("cae", lambda: ["cae"] + fm)
    dv.leg("classifiers", lambda: ["classifiers", "--path-cae", dv.produced_dir("cae", "models")],
           deps=("cae",))
    dv.leg("cnn_multipatient", lambda: ["cnn-multipatient"] + fm)
    dv.leg("cnn_battery", lambda: ["cnn"] + fm)

    # ---- per-dim GAN training and discovery (start.sh:11-24)
    dims = tuple(int(x) for x in os.environ.get("GDPT_DIMS", "2,10,100").split(","))
    for dim in dims:
        dv.leg(f"dcgan_z{dim}", lambda dim=dim: (
            ["dcgan", "--path-cae", dv.produced_dir("cae", "models"),
             "--path-classifiers", dv.produced_dir("classifiers", "models")]
            + dim_sets(dim) + fm), deps=("cae", "classifiers"))
        dv.leg(f"pso_z{dim}", lambda dim=dim: (
            ["pso-discovery", "--batch-classes",
             "--path-gan", dv.produced_dir(f"dcgan_z{dim}", "models"), "--path-cnn", cnn()]
            + dim_sets(dim) + fm), deps=(f"dcgan_z{dim}", "cnn_multipatient"))

    # ---- inversion at the reference's analysis dim (readme_cnr.txt:74-87);
    # extraction reads the adversarial inverter (start.sh:29-31)
    gan10 = lambda: dv.produced_dir("dcgan_z10", "models")  # noqa: E731
    inv10 = lambda: dv.produced_dir("inverter_adv_z10", "models")  # noqa: E731
    dv.leg("inverter_pixrec_z10", lambda: ["inverter", "--path-gan", gan10()] + dim_sets(10) + fm,
           deps=("dcgan_z10",))
    dv.leg("inverter_adv_z10", lambda: (
        ["inverter", "--path-gan", gan10(), "--path-cnn", cnn(),
         "--set", "trainer_inverter.training_function=pix_fea_rec_adv"] + dim_sets(10) + fm),
        deps=("dcgan_z10", "cnn_multipatient"))
    for kind in ("iid", "ood"):
        dv.leg(f"{kind}_extract_z10", lambda kind=kind: (
            [f"{kind}-extract", "--path-inverter", inv10(), "--path-gan", gan10()]
            + dim_sets(10) + fm), deps=("dcgan_z10", "inverter_adv_z10"))
    # every OoD patient of the split with the config's control
    # (optimize_in_training), then each with optimize_out_training
    # (start_pso_optimize.sh:3-16): one run dir per patient and control
    inverter_deps = ("dcgan_z10", "inverter_adv_z10", "cnn_multipatient")
    for pat, control in ((5, None), (1, None), (5, "out"), (1, "out")):
        extra = ([] if control is None else
                 ["--set", "trainer_pso_inverter.control_pso_fitness=optimize_out_training"])
        suffix = "" if control is None else "_out"
        dv.leg(f"pso_inverter_p{pat}{suffix}_z10", lambda pat=pat, extra=extra: (
            ["pso-inverter", "--ood-patient", str(pat), "--path-gan", gan10(),
             "--path-inverter", inv10(), "--path-cnn", cnn(), *extra] + dim_sets(10) + fm),
            deps=inverter_deps)
    dv.leg("regularize_inverter_z10", lambda: (
        ["regularize-inverter", "--path-gan", gan10(), "--path-inverter", inv10()]
        + dim_sets(10) + fm), deps=("dcgan_z10", "inverter_adv_z10"))
    dv.leg("regularize_inverter_stats_z10", lambda: (
        ["regularize-inverter-statistics", "--path-gan", gan10(), "--path-inverter", inv10(),
         "--path-pso", dv.produced_dir("pso_z10", "interim")] + dim_sets(10) + fm),
        deps=("dcgan_z10", "inverter_adv_z10", "pso_z10"))

    # ---- VQ-VAE on the dim-100 G and swarm (vqvae.yaml:44), discovery split
    dv.leg("vqvae_z100", lambda: (
        ["vqvae", "--cfg", "configs/vqvae.yaml",
         "--path-gan", dv.produced_dir("dcgan_z100", "models"),
         "--path-pso", dv.produced_dir("pso_z100", "interim"), "--set"] + DISCOVERY_SPLIT + fm),
        deps=("dcgan_z100", "pso_z100"))
    dv.leg("pixelcnn_prior_z100", lambda: (
        ["pixelcnn-prior", "--cfg", "configs/vqvae.yaml",
         "--path-vqvae", dv.produced_dir("vqvae_z100", "models"), "--set"]
        + DISCOVERY_SPLIT + fm), deps=("vqvae_z100",))

    # ---- analysis legs at dim 10 (start.sh:29-36), on discovery outputs only
    pso10 = lambda: dv.produced_dir("pso_z10", "interim")  # noqa: E731
    dv.leg("pso_analysis_z10", lambda: ["pso-analysis", "--path-pso", pso10()] + dim_sets(10),
           deps=("pso_z10",))
    dv.leg("pso_analysis_clustering_z10", lambda: (
        ["pso-analysis-clustering", "--path-pso", pso10(),
         "--path-ood-pso", dv.produced_dir("pso_inverter_p1_z10", "interim"),
         "--path-ood-pso", dv.produced_dir("pso_inverter_p5_z10", "interim")] + dim_sets(10)),
        deps=("pso_z10", "pso_inverter_p1_z10", "pso_inverter_p5_z10"))
    dv.leg("pso_analysis_distance_z10", lambda: (
        ["pso-analysis-distance", "--path-pso", pso10()] + dim_sets(10)), deps=("pso_z10",))
    dv.leg("pso_inverter_analysis_z10", lambda: (
        ["pso-inverter-analysis", "--path-pso", pso10(),
         "--path-ood-pso", dv.produced_dir("pso_inverter_p5_z10", "interim"),
         "--ood-patient", "5"] + dim_sets(10)), deps=("pso_z10", "pso_inverter_p5_z10"))
    # ... and over the other patient and control dirs (start_pso_optimize.sh:12-13)
    for pat, ctrl, src in ((5, "out", "pso_inverter_p5_out_z10"),
                           (1, "in", "pso_inverter_p1_z10"),
                           (1, "out", "pso_inverter_p1_out_z10")):
        dv.leg(f"pso_inverter_analysis_p{pat}_{ctrl}_z10", lambda pat=pat, src=src: (
            ["pso-inverter-analysis", "--path-pso", pso10(),
             "--path-ood-pso", dv.produced_dir(src, "interim"), "--ood-patient", str(pat)]
            + dim_sets(10)), deps=("pso_z10", src))

    snapshot_histories(exp)
    failed = sorted(k for k, v in dv.status.items() if v == "failed")
    skipped = sorted(k for k, v in dv.status.items() if v == "skipped")
    if failed or skipped:
        print(f"[experiment] done with failures={failed} skipped={skipped}", flush=True)
        return 1
    print("[experiment] all legs complete", flush=True)
    return 0


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("legs", nargs="*", help="run only these legs (default: the full chain)")
    ap.add_argument("--deadline-min", type=float,
                    default=float(os.environ.get("GDPT_DEADLINE_MIN", 0)) or None,
                    help="stop DISPATCHING new legs after this many minutes (a leg in "
                         "flight still finishes)")
    a = ap.parse_args(argv)
    if a.deadline_min:
        print(f"[experiment] deadline: no new legs after {a.deadline_min:.0f} min", flush=True)
    return main(only=set(a.legs) or None, deadline_min=a.deadline_min)


if __name__ == "__main__":
    sys.exit(cli())
