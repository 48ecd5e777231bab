"""The port's run-dir, checkpoint, artifact and CLI layer against the JAX
package on the CPU: the flax-msgpack codec byte for byte, RunDir names and
timing/history files, the particle pickles and npz, the random streams, the
program/chunk rules, optimize_resumable, and the CLI's refusals. No JAX
ResNet-50 compile in this file (the model.msgpack tree comes from the
port's ResNet-50 through the inverse weight mapping)."""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pandas as pd
import pytest
import torch
from flax import serialization

from gan_discovery_pso_tpu.core import checkpoint as jax_ckpt
from gan_discovery_pso_tpu.core import rundir as jax_rundir
from gan_discovery_pso_tpu.core.config import DataConfig as JDataConfig
from gan_discovery_pso_tpu.core.config import PsoConfig as JPsoConfig
from gan_discovery_pso_tpu.core.config import AdamConfig, load_config as jax_load_config
from gan_discovery_pso_tpu.core.prng import _h as jax_h
from gan_discovery_pso_tpu.models import DiscriminatorDef, GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.pso import io as jax_io
from gan_discovery_pso_tpu.pso import last_iteration as jax_last_iteration
from gan_discovery_pso_tpu.pso import resolve_fitness_chunk as jax_resolve_fitness_chunk
from gan_discovery_pso_tpu.pso import select_program as jax_select_program
from gan_discovery_pso_tpu.pso.swarm import PsoHistory as JPsoHistory
from gan_discovery_pso_tpu.train import gan_init
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import resnet_tree
from gan_discovery_pso_tpu_torch.core import checkpoint as ckpt
from gan_discovery_pso_tpu_torch.core import rundir
from gan_discovery_pso_tpu_torch.core.config import DataConfig, PsoConfig, load_config
from gan_discovery_pso_tpu_torch.core.prng import KeyChain, _h
from gan_discovery_pso_tpu_torch.models import ResNet, ResNetDef, glorot_normal_init_
from gan_discovery_pso_tpu_torch.pso import (
    io,
    last_iteration,
    optimize,
    optimize_resumable,
    resolve_fitness_chunk,
    select_program,
    state_from_positions,
)

CFG = "configs/dcgan_mnist.yaml"


def _host(tree):
    """A JAX tree with numpy leaves where it had jax arrays (python
    scalars, None and NamedTuples stay as they are)."""
    return jax.tree.map(lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


@pytest.fixture(scope="module")
def trees():
    """name → (tree as the JAX package saves it, the same tree for the port)."""
    gan_state, _ = gan_init(jax.random.key(0), JGeneratorDef(8, 1, 16), DiscriminatorDef(1, 16),
                            AdamConfig(lr=1e-3, beta1=0.5, beta2=0.99))
    gan = {"epoch": 3, "state": gan_state, "loss": 0.6931471805599453}
    net = glorot_normal_init_(ResNet(ResNetDef("ResNet50", 1, 8)),
                              torch.Generator().manual_seed(0))
    rp, rs = resnet_tree(net.state_dict())
    bits = np.arange(12, dtype=np.int16).reshape(3, 4) * 97
    leaves = {"flag": True, "off": False, "n": np.arange(5, dtype=np.int32), "none": None,
              "bf16": bits.view(ml_dtypes.bfloat16), "scalar": np.float32(1.5),
              "i64": np.int64(-7), "b": np.bool_(True), "count": 70000, "neg": -40000,
              "names": ["x" * 40, 2.5, -3], "empty": np.zeros((0, 3), np.float32)}
    port_leaves = dict(leaves, bf16=torch.from_numpy(bits.copy()).view(torch.bfloat16))
    return {"gan": (gan, _host(gan)), "model": ({"params": rp, "state": rs},) * 2,
            "leaves": (leaves, port_leaves)}


def _assert_same(a, b, path="tree"):
    if isinstance(a, dict):
        # flax writes every dict with its keys sorted
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        bits = lambda t: (t.view(torch.int16).numpy() if isinstance(t, torch.Tensor)  # noqa: E731
                          else np.asarray(t).view(np.int16))
        assert tuple(a.shape) == tuple(b.shape) and np.array_equal(bits(a), bits(b)), path
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(b).dtype == np.asarray(a).dtype, path
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("name", ["gan", "model", "leaves"])
def test_writer_is_byte_equal_to_flax(trees, name, tmp_path):
    jax_tree, port_tree = trees[name]
    jax_ckpt.save_pytree(tmp_path / "jax.msgpack", jax_tree)
    ckpt.save_pytree(tmp_path / "port.msgpack", port_tree)
    want = (tmp_path / "jax.msgpack").read_bytes()
    assert (tmp_path / "port.msgpack").read_bytes() == want
    assert not list(tmp_path.glob("*.tmp"))  # the atomic write left no tmp file


@pytest.mark.parametrize("name", ["gan", "model", "leaves"])
def test_each_package_reads_the_others_files(trees, name, tmp_path):
    jax_tree, port_tree = trees[name]
    jax_ckpt.save_pytree(tmp_path / "jax.msgpack", jax_tree)
    ckpt.save_pytree(tmp_path / "port.msgpack", port_tree)
    plain = jax_ckpt._plainify(jax_tree)
    _assert_same(plain, ckpt.load_pytree(tmp_path / "jax.msgpack"))
    _assert_same(jax_ckpt.load_pytree(tmp_path / "port.msgpack"),
                 ckpt.load_pytree(tmp_path / "jax.msgpack"))


def test_chunked_arrays_match_flax(monkeypatch):
    monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(40, dtype=np.float32).reshape(5, 8), "small": np.ones(3),
            "nested": {"x": np.arange(30, dtype=np.int64)}}
    blob = serialization.msgpack_serialize(tree)
    assert ckpt.msgpack_serialize(tree) == blob
    _assert_same(tree, ckpt.msgpack_restore(blob))


def test_reader_refuses_foreign_ext_types():
    with pytest.raises(ValueError, match="ext type 2"):
        ckpt.msgpack_restore(serialization.msgpack_serialize({"c": 1 + 2j}))


def test_checkpointer_files(tmp_path):
    c = ckpt.Checkpointer(tmp_path / "models")
    assert c.try_load("checkpoint_g.msgpack") is None
    state = {"w": torch.arange(4.0), "step": np.int32(3)}
    path = c.save_every_epoch("g", 2, state, loss=torch.tensor(0.25))
    assert path.name == "checkpoint_g.msgpack"
    got = c.load("checkpoint_g.msgpack")
    assert got["epoch"] == 2 and got["loss"] == 0.25
    np.testing.assert_array_equal(got["state"]["w"], np.arange(4.0, dtype=np.float32))
    c.save_state_dict("model", {"params": {"a": np.ones(2)}})
    saved = jax_ckpt.load_pytree(tmp_path / "models" / "model.msgpack")
    assert saved["params"]["a"].tolist() == [1, 1]


def test_metrics_writer_and_tee(tmp_path):
    from gan_discovery_pso_tpu_torch.core.logging import MetricsWriter, Tee

    mw = MetricsWriter(tmp_path, "history", tensorboard=False)
    mw.append(1, loss=np.float32(0.5), nan=float("nan"))
    mw.add_image("Real", np.zeros((1, 4, 4)), step=1)  # no sink: nothing happens
    mw.close()
    assert json.loads((tmp_path / "history.jsonl").read_text()) == {"step": 1, "loss": 0.5,
                                                                     "nan": None}
    assert (tmp_path / "history.csv").read_text().splitlines()[0] == "loss,nan,step"
    with Tee(tmp_path / "log.txt"):
        print("to both")
    assert (tmp_path / "log.txt").read_text() == "to both\n"


def _fresh_rundirs(tmp_path):
    """The same pre-existing run dirs under two roots; a RunDir of each
    package on its own root."""
    made = []
    for pkg, mod in (("jax", jax_rundir), ("port", rundir)):
        root = tmp_path / pkg
        for d in ("00003--pso_discovery", "00007--dcgan", "junk", "12--pso_discovery"):
            (root / "reports" / "mnist" / d).mkdir(parents=True)
        made.append(mod.RunDir("pso_discovery", "mnist", reports_root=root / "reports",
                               models_root=root / "models", interim_root=root / "interim"))
    return made


def test_rundir_names_timing_and_history_match_jax(tmp_path):
    jrun, prun = _fresh_rundirs(tmp_path)
    assert (prun.run_id, prun.name) == (jrun.run_id, jrun.name) == (13, "00013--pso_discovery")
    for sub in ("reports", "models", "interim"):
        assert (getattr(prun, f"{sub}_dir").relative_to(tmp_path / "port")
                == getattr(jrun, f"{sub}_dir").relative_to(tmp_path / "jax"))
    assert rundir.run_name(4, "x") == jax_rundir.run_name(4, "x") == "00004--x"
    assert (rundir.get_next_run_id(tmp_path / "port" / "reports" / "mnist", "dcgan")
            == jax_rundir.get_next_run_id(tmp_path / "jax" / "reports" / "mnist", "dcgan") == 8)
    timings = {"training_time_class_0": 1.25, "training_time_class_2": 2.5}
    history = {"class_0": {"mean_mse": [np.float32(0.5), np.float32(np.nan)],
                           "global_best_val": [np.float32(0.2)]}}
    for run in (jrun, prun):
        run.write_timing(timings)
        run.write_overall_history(history)
    load = lambda run, name: json.loads((run.reports_dir / name).read_text())  # noqa: E731
    assert list(load(prun, "timing.json")) == list(load(jrun, "timing.json"))
    with open(prun.general_dir / "timing.pkl", "rb") as f:
        assert list(pickle.load(f)) == ["overall_time", *timings]
    for name in ("general/overall_history.json",):
        assert (prun.reports_dir / name).read_text() == (jrun.reports_dir / name).read_text()
    with open(prun.general_dir / "overall_history.pkl", "rb") as f:
        got = pickle.load(f)
    assert type(got["class_0"]["global_best_val"][0]) is np.float32


def test_particle_artifacts_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    traj = rng.normal(size=(5, 4, 3)).astype(np.float32)
    vel = rng.normal(size=(5, 4, 3)).astype(np.float32)
    jw = jax_io.save_particle_histories(tmp_path / "jax", 7, traj, vel)
    pw = io.save_particle_histories(tmp_path / "port", 7, traj, vel)
    assert [p.name for p in pw] == [p.name for p in jw]
    assert "particles_position_iic_class_7.pkl" in [p.name for p in pw]
    for j, p in zip(jw, pw):
        if p.suffix == ".pkl":
            with open(j, "rb") as f, open(p, "rb") as g:
                a, b = pickle.load(f), pickle.load(g)
            assert list(a) == list(b)
            for k in a:
                pd.testing.assert_frame_equal(a[k], b[k])
        else:
            with np.load(j) as a, np.load(p) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
    # each package's readers on the other's files, npz and pickle fallback
    for reader, d in ((jax_io, tmp_path / "port"), (io, tmp_path / "jax")):
        np.testing.assert_array_equal(reader.load_particle_trajectories(d, 7), traj)
        (d / "particles_iid_class_7.npz").unlink()
        np.testing.assert_array_equal(reader.load_final_particle_positions(d, 7, n_particles=4,
                                                                           dim_space=3), traj[-1])
    only_npz = io.save_particle_histories(tmp_path / "npz", 1, traj, vel, pickles=False)
    assert [p.name for p in only_npz] == ["particles_iid_class_1.npz"]


def test_class_streams_depend_only_on_seed_class_and_name():
    assert [_h(s) for s in ("pso", "class_3", "")] == [jax_h(s) for s in ("pso", "class_3", "")]
    a = KeyChain(42)
    first = a.child("class_3")("pso").initial_seed()
    a("swarm_init")  # another consumer first
    a.child("class_5")("pso")
    b = KeyChain(42)
    assert b.child("class_3")("pso").initial_seed() == first
    assert KeyChain(43).child("class_3")("pso").initial_seed() != first
    assert a.child("class_5")("pso").initial_seed() != first
    c = KeyChain(42).child("class_3")
    assert c("pso").initial_seed() == first
    assert c("pso").initial_seed() != first  # the counter moved on


def test_data_config_matches_jax():
    assert (DataConfig.from_config(load_config(CFG).data).__dict__
            == JDataConfig.from_config(jax_load_config(CFG).data).__dict__)


def test_program_and_chunk_rules_match_jax():
    """The fitness_chunk rule gives JAX's chunk; the program key is refused
    where JAX refuses it (the port runs every accepted value as one loop)."""
    def outcome(fn, *args):
        try:
            return fn(*args)
        except ValueError:
            return ValueError

    for value in (None, "auto", 0, False, 16, 48, 64, 256, "32", -8):
        for n in (32, 256, 512):
            want = outcome(jax_resolve_fitness_chunk, value, n)
            assert outcome(resolve_fitness_chunk, value, n) == want
    assert outcome(resolve_fitness_chunk, 48, 256) is ValueError
    for program in ("auto", "chunked", "monolithic", "fastest", "Chunked", ""):
        want = outcome(jax_select_program, program, JPsoConfig(), False)
        assert (outcome(select_program, program) is ValueError) == (want is ValueError)
    assert outcome(select_program, "fastest") is ValueError


def _sphere(positions):
    return (positions * positions).sum(dim=2)


def _draws(b=2, n=6, d=3, iters=6):
    g = torch.Generator().manual_seed(3)
    pos = torch.randn((b, n, d), generator=g)
    vel = torch.randn((b, n, d), generator=g) / 10
    return pos, vel, torch.rand((iters, b, n), generator=g), torch.rand((iters, b, n), generator=g)


def test_optimize_resumable_replays_the_single_shot_run(tmp_path):
    hp = PsoConfig(n_iterations=6, n_particles=6, dim_space=3)
    pos, vel, r1, r2 = _draws()
    init = state_from_positions(pos, vel, hp.w_inertia)
    want_state, want_hist, _ = optimize(_sphere, hp, init, r1, r2)
    c = ckpt.Checkpointer(tmp_path / "two_chunks")
    state, hist, start = optimize_resumable(_sphere, hp, init, r1, r2, checkpointer=c,
                                            checkpoint_every=3)
    for name, x, y in zip(want_hist._fields, want_hist, hist):
        assert torch.equal(x, y), name
    for name, x, y in zip(want_state._fields, want_state, state):
        assert torch.equal(x, y), name
    assert start is init and c.load("checkpoint_swarm.msgpack")["epoch"] == 6
    # resuming a finished run: no iteration runs, a 0-row history
    again, empty, _ = optimize_resumable(_sphere, hp, init, r1, r2, checkpointer=c,
                                         checkpoint_every=3)
    assert empty.positions.shape == (2, 0, 6, 3) and torch.equal(again.positions, state.positions)
    assert last_iteration(empty, again.done, again.iteration) == [7, 7]
    # preempted after the first chunk: the resumed run ends where the single shot does
    c2 = ckpt.Checkpointer(tmp_path / "preempted")
    optimize_resumable(_sphere, PsoConfig(n_iterations=3, n_particles=6, dim_space=3), init,
                       r1, r2, checkpointer=c2, checkpoint_every=3)
    resumed, tail, _ = optimize_resumable(_sphere, hp, init, r1, r2, checkpointer=c2,
                                          checkpoint_every=3)
    assert torch.equal(tail.positions, want_hist.positions[:, 3:])
    assert torch.equal(resumed.g_best_val, want_state.g_best_val)


def test_last_iteration_of_a_zero_row_history_matches_jax():
    def hist(b):
        return tuple(torch.empty((b, 0)) for _ in range(6)) + (torch.empty((b, 0), dtype=torch.bool),)

    from gan_discovery_pso_tpu_torch.pso import PsoHistory

    got = last_iteration(PsoHistory(*hist(3)), torch.tensor([True, False, True]),
                         torch.tensor([5, 7, 51], dtype=torch.int32))
    empty = JPsoHistory(*(jnp.zeros((0,)) for _ in range(6)), jnp.zeros((0,), bool))
    want = [jax_last_iteration(empty, done=d, state_iteration=i)
            for d, i in ((True, 5), (False, 7), (True, 51))]
    assert got == want == [4, 7, 50]
    assert last_iteration(PsoHistory(*hist(2))) == [jax_last_iteration(empty)] * 2


@pytest.mark.parametrize("stage,item", [("convert-torch", "A17"), ("export-torch", "A17"),
                                        ("export-model", "A17"), ("sweep", "A17")])
def test_cli_refuses_unported_stages(stage, item, capsys):
    assert cli_main([stage, "--cfg", CFG]) != 0
    err = capsys.readouterr().err
    assert "not yet ported" in err and f"ROADMAP {item}" in err


@pytest.mark.parametrize("stage", ["inverter", "regularize-inverter",
                                   "regularize-inverter-statistics"])
def test_cli_refuses_fast_math_on_gradient_stages(stage, capsys, tmp_path):
    """The JAX package's --fast-math there is TPU DEFAULT precision, whose
    card counterpart is not decided: refused before a run dir is made."""
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    assert cli_main([stage, "--fast-math", "--device", "cpu", "--set", *roots]) == 2
    assert "ROADMAP A18" in capsys.readouterr().err
    assert not (tmp_path / "reports").exists()


def test_cli_refuses_shard_swarm(capsys, tmp_path):
    """--shard-swarm runs (tests/test_torch_port_parallel.py); with
    --batch-classes it exits 2 with the JAX stage's message
    (pipelines/pso_discovery.py:70-71), and so does a count below one
    rank, both before a run dir or a rank is made."""
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    assert cli_main(["pso-discovery", "--device", "cpu", "--shard-swarm", "4",
                     "--batch-classes", "--set", *roots]) == 2
    assert ("batch_classes and shard_devices are mutually exclusive"
            in capsys.readouterr().err)
    assert cli_main(["pso-discovery", "--device", "cpu", "--shard-swarm", "0",
                     "--set", *roots]) == 2
    assert "needs at least one rank" in capsys.readouterr().err
    assert not (tmp_path / "reports").exists()


def test_cli_refuses_limit(capsys, tmp_path):
    """--limit caps dataset loads; a negative cap is refused before a run
    dir is made."""
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    assert cli_main(["pso-discovery", "--tiny", "--limit", "-3", "--set", *roots]) != 0
    assert "--limit -3" in capsys.readouterr().err
    assert not (tmp_path / "reports").exists()


@pytest.mark.parametrize("flags,cap", [(["--limit", "7"], 7), (["--tiny"], 512),
                                       (["--tiny", "--limit", "9"], 9), ([], None)])
def test_cli_limit_caps_the_dataset(flags, cap, monkeypatch, tmp_path):
    """The stage context the CLI builds caps every dataset load at --limit,
    or at 512 under --tiny (JAX `cli/main.py:84-85`)."""
    import gan_discovery_pso_tpu_torch.cli.main as cli

    seen = {}
    real_ctx = cli._ctx

    def ctx_spy(args, module):
        seen["ctx"] = real_ctx(args, module)
        raise SystemExit(0)

    monkeypatch.setattr(cli, "_ctx", ctx_spy)
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    with pytest.raises(SystemExit):
        cli_main(["iid-extract", "--device", "cpu", *flags, "--set", *roots])
    ctx = seen["ctx"]
    assert ctx.limit == cap
    if cap is not None:
        ctx.data_cfg = dataclasses.replace(ctx.data_cfg, data_dir=str(tmp_path / "none"))
        assert ctx.dataset("test").images.shape[0] == cap  # of ~3200 IiD images


def test_cli_without_device_raises_on_a_host_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["pso-discovery", "--cfg", CFG, "--path-gan", str(tmp_path),
                  "--path-cnn", str(tmp_path), "--set", *roots])
    assert not (tmp_path / "reports").exists()  # raised before any run dir
