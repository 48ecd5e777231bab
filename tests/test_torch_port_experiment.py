"""The port's experiment driver (`gan_discovery_pso_tpu_torch/tools/
run_experiment.py`): the record semantics of `tests/test_run_experiment.py`
carried over (a record counts only while its artifacts exist and belong to
it, stale records are dropped, committed snapshot names are seeded as empty
run dirs, a skip is recorded once), a failure skipping only its
dependents, and a tiny chain of three legs (cae -> classifiers -> dcgan at
z 10) run as subprocesses of the port's CLI with `--device cpu --tiny` on
tiny idx files, resumed by a second invocation that runs no leg."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gan_discovery_pso_tpu_torch.core.rundir import get_next_run_id
from gan_discovery_pso_tpu_torch.tools import run_experiment as rex

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_assessor import write_idx  # noqa: E402


@pytest.fixture
def exp(tmp_path):
    """An empty experiment root with its histories dir and run roots."""
    (tmp_path / "histories").mkdir()
    (tmp_path / "logs").mkdir()
    for root in rex.ROOTS:
        rex.run_root(tmp_path, root).mkdir(parents=True)
    return tmp_path


def _rec(leg, run_dirs, **extra):
    return {"leg": leg, "rc": 0, "run_dirs": run_dirs, **extra}


def test_record_valid_requires_existing_nonempty_dirs(exp):
    rec = _rec("dcgan_z9", {"models": ["00003--dcgan"]})
    assert not rex.record_valid(rec, exp)  # missing
    d = rex.run_root(exp, "models") / "00003--dcgan"
    d.mkdir()
    assert not rex.record_valid(rec, exp)  # an empty placeholder does not count
    (d / "best_g.msgpack").write_bytes(b"x")
    assert rex.record_valid(rec, exp)
    assert rex.record_valid(_rec("classifiers", {}), exp)  # no run dir: stands


def test_load_records_drops_stale_and_keeps_live(exp, capsys):
    live = rex.run_root(exp, "interim") / "00001--pso_discovery"
    live.mkdir()
    (live / "particles_iid_class_0.npz").write_bytes(b"x")
    (exp / "timings.jsonl").write_text(
        json.dumps(_rec("pso_z2", {"interim": ["00001--pso_discovery"]})) + "\n"
        + json.dumps(_rec("dcgan_z2", {"models": ["00001--dcgan"]})) + "\n"
        + json.dumps({"leg": "cae", "rc": 1}) + "\n")
    recs = rex.load_records(exp)
    assert set(recs) == {"pso_z2"}  # dcgan_z2's artifacts are gone, cae failed
    assert "dcgan_z2: recorded artifacts missing on disk — will re-run" in capsys.readouterr().out


def test_seed_run_roots_bumps_allocator_past_snapshots(exp):
    (exp / "histories" / "00007--dcgan").mkdir()
    (exp / "histories" / "00002--cae").mkdir()
    rex.seed_run_roots(exp)
    reports = rex.run_root(exp, "reports")
    assert get_next_run_id(reports, "dcgan") == 8
    assert get_next_run_id(reports, "cae") == 3
    assert get_next_run_id(reports, "pso_discovery") == 1
    assert not rex.record_valid(_rec("dcgan_z8", {"models": ["00007--dcgan"]}), exp)


def test_skip_records_not_duplicated(exp):
    (exp / "timings.jsonl").write_text(json.dumps({"leg": "legB", "rc": 1}) + "\n")
    dv = rex.Driver(exp)
    dv._record_skip("legA", "deps: x=failed")
    dv._record_skip("legA", "deps: x=failed")
    dv._record_skip("legB", "whatever")  # a leg with any record gets no skip row
    lines = (exp / "timings.jsonl").read_text().splitlines()
    assert [json.loads(line)["leg"] for line in lines] == ["legB", "legA"]
    # a second invocation over the same records adds none either
    rex.Driver(exp)._record_skip("legA", "deps: x=failed")
    assert len((exp / "timings.jsonl").read_text().splitlines()) == 2


def test_record_valid_rejects_dim_mismatched_squatter(exp):
    """A record that pinned a z_dim holds only while the run dir's
    configuration.yaml has that z_dim (the allocator can hand a stale
    record's name to a run of another dim)."""
    rec = _rec("dcgan_z20", {"models": ["00008--dcgan"], "reports": ["00008--dcgan"]},
               argv=["gan_discovery_pso_tpu_torch.cli", "dcgan", "--set",
                     "trainer_gan.z_dim=20", "trainer_pso.dim_space=20"])
    mdl = rex.run_root(exp, "models") / "00008--dcgan"
    rep = rex.run_root(exp, "reports") / "00008--dcgan"
    mdl.mkdir()
    rep.mkdir()
    (mdl / "best_g.msgpack").write_bytes(b"x")
    assert rex.record_valid(rec, exp)  # no configuration.yaml: existence decides
    (rep / "configuration.yaml").write_text("trainer_gan:\n  z_dim: 10\n")
    assert not rex.record_valid(rec, exp)
    (rep / "configuration.yaml").write_text("trainer_gan:\n  z_dim: 20\n")
    assert rex.record_valid(rec, exp)


def test_a_failure_skips_only_its_dependents(exp, monkeypatch):
    """Legs a (fails), b (needs a), c, d (needs c), e (needs b and c): a is
    recorded failed with its new run dir quarantined, b and e skipped once
    with the reason, c and d run; a resumed invocation reruns a alone (its
    dependents stay skipped, no second skip row). The CUDA probe runs once,
    before the first leg on the card, and again after a failure."""
    probes = []
    monkeypatch.setattr(rex, "wait_for_card", lambda: probes.append(1))

    def fake_run(argv, cwd, stdout, stderr, timeout):
        stage = argv[3]
        run = rex.run_root(exp, "models") / f"0000{len(list(exp.rglob('*--*'))) + 1}--{stage}"
        run.mkdir()
        (run / "w.msgpack").write_bytes(b"x")
        return subprocess.CompletedProcess(argv, 3 if stage == "a" else 0)

    monkeypatch.setattr(rex.subprocess, "run", fake_run)

    def chain():
        dv = rex.Driver(exp)
        dv.leg("a", lambda: ["a"])
        dv.leg("b", lambda: ["b"], deps=("a",))
        dv.leg("c", lambda: ["c"])
        dv.leg("d", lambda: ["d", "--path", dv.produced_dir("c", "models")], deps=("c",))
        dv.leg("e", lambda: ["e"], deps=("b", "c"))
        return dv

    dv = chain()
    assert dv.status == {"a": "failed", "b": "skipped", "c": "ok", "d": "ok", "e": "skipped"}
    assert probes == [1, 1]  # before a; after a failed, before c
    recs = [json.loads(line) for line in (exp / "timings.jsonl").read_text().splitlines()]
    assert [(r["leg"], r["rc"]) for r in recs] == [("a", 3), ("b", "skipped"), ("c", 0),
                                                   ("d", 0), ("e", "skipped")]
    assert recs[0]["quarantined"] and "run_dirs" not in recs[0]
    assert not (rex.run_root(exp, "models") / recs[0]["quarantined"]["models"][0]).exists()
    assert list((exp / "failed_runs").glob("a-*/models/*--a"))
    assert recs[1]["reason"] == "a=failed" and recs[4]["reason"] == "b=skipped"
    assert dv.records["d"]["argv"][2:4] == ["--path", str(rex.run_root(exp, "models")
                                                          / dv.records["c"]["run_dirs"]
                                                          ["models"][0])]
    again = chain()
    assert again.status == {"a": "failed", "b": "skipped", "c": "ok", "d": "ok",
                            "e": "skipped"}
    recs = [json.loads(line) for line in (exp / "timings.jsonl").read_text().splitlines()]
    assert [(r["leg"], r["rc"]) for r in recs][5:] == [("a", 3)]


def test_deadline_stops_dispatch_and_records_no_skip(exp, monkeypatch):
    """Past the deadline no leg is dispatched; a leg whose dependency met
    the deadline is skipped without a skip record (it was never tried), so
    a resumed invocation runs both."""
    monkeypatch.setattr(rex.subprocess, "run", lambda *a, **k: pytest.fail("dispatched"))
    dv = rex.Driver(exp, deadline_ts=0.0)
    dv.leg("a", lambda: ["a"])
    dv.leg("b", lambda: ["b"], deps=("a",))
    assert dv.status == {"a": "deadline", "b": "deadline"}
    dv.deadline_ts = None
    dv.leg("c", lambda: ["c"], deps=("a",))
    assert dv.status["c"] == "skipped"
    assert not (exp / "timings.jsonl").exists()


def test_tiny_chain_on_the_cpu_and_its_resume(tmp_path):
    """cae -> classifiers -> dcgan_z10 through the driver's `main` with
    `--device cpu --tiny` on tiny idx files: each leg a subprocess of the
    port's CLI with rc 0, the later legs' --path-* resolved from the earlier
    legs' records, the dcgan run at z 10, its history snapshotted under
    histories/, each stage's launches in its leg's log (none on the CPU); a
    second invocation runs no leg."""
    write_idx(tmp_path / "data" / "MNIST" / "raw")
    root = tmp_path / "exp"
    leg_args = {"*": ["--device", "cpu", "--tiny", "--set", f"data.data_dir={tmp_path / 'data'}",
                      "trainer_ae.batch_size=16", "trainer_gan.batch_size=16"]}
    only = {"cae", "classifiers", "dcgan_z10"}
    env = {"OMP_NUM_THREADS": "1"}
    code = ("import json, sys; from gan_discovery_pso_tpu_torch.tools import run_experiment "
            "as rex; sys.exit(rex.main(only=set(json.loads(sys.argv[1])), "
            "leg_args=json.loads(sys.argv[2]), root=sys.argv[3]))")
    args = [sys.executable, "-c", code, json.dumps(sorted(only)), json.dumps(leg_args),
            str(root)]
    import os

    first = subprocess.run(args, capture_output=True, text=True, timeout=600,
                           env={**os.environ, **env}, cwd=rex.REPO)
    assert first.returncode == 0, first.stdout + first.stderr
    recs = [json.loads(line) for line in (root / "timings.jsonl").read_text().splitlines()]
    assert [(r["leg"], r["rc"]) for r in recs] == [("cae", 0), ("classifiers", 0),
                                                   ("dcgan_z10", 0)]
    models = rex.run_root(root, "models")
    assert recs[1]["argv"][2:4] == ["--path-cae", str(models / "00001--cae")]
    assert recs[2]["argv"][2:6] == ["--path-cae", str(models / "00001--cae"),
                                    "--path-classifiers", str(models / "00001--classifiers")]
    assert "--fast-math" in recs[2]["argv"] and "trainer_gan.z_dim=10" in recs[2]["argv"]
    assert recs[2]["run_dirs"] == {root: ["00001--dcgan"] for root in rex.ROOTS}
    assert "z_dim: 10" in (rex.run_root(root, "reports") / "00001--dcgan"
                           / "configuration.yaml").read_text()
    hist = root / "histories" / "00001--dcgan"
    assert (hist / "history_gan.jsonl").is_file() and (hist / "log_excerpt.txt").is_file()
    logs = [Path(r["log"]).read_text() for r in recs]
    for stage, text in zip(("cae", "classifiers", "dcgan"), logs):
        launched = re.findall(rf"^\[{stage}\] kernel launches: (\{{.*\}})$", text, re.M)
        assert len(launched) == 1 and not any(json.loads(launched[0]).values())
    second = subprocess.run(args, capture_output=True, text=True, timeout=600,
                            env={**os.environ, **env}, cwd=rex.REPO)
    assert second.returncode == 0, second.stdout + second.stderr
    assert second.stdout.count("already done, skipping") == 3
    assert len((root / "timings.jsonl").read_text().splitlines()) == 3
    assert [Path(r["log"]).read_text() for r in recs] == logs
