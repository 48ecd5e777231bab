"""The port's pso-discovery stage against the JAX package's on the CPU: the
same checkpoint files (written by the JAX package's `save_pytree`), the
same per-class draws (recomputed from the JAX package's KeyChain), and the
artifact set each writes. 2 classes x 8 particles x 4 iterations, z=8,
G f=16, ResNet-50 with 8 classes; one JAX compile of the batched stage and
one of the landscape's fitness."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.core.checkpoint import _plainify, save_pytree as jax_save_pytree
from gan_discovery_pso_tpu.core.config import PsoConfig as JPsoConfig
from gan_discovery_pso_tpu.core.prng import KeyChain as JKeyChain
from gan_discovery_pso_tpu.models import (
    GeneratorDef as JGeneratorDef,
    ResNetDef as JResNetDef,
    generator_init,
    resnet_init,
)
from gan_discovery_pso_tpu.pipelines import StageContext as JStageContext
from gan_discovery_pso_tpu.pipelines import run_pso_discovery_batched as jax_run_batched
from gan_discovery_pso_tpu.pipelines.pso_discovery import emit_swarm_reports as jax_emit
from gan_discovery_pso_tpu.pso import SwarmResult as JSwarmResult
from gan_discovery_pso_tpu.pso import io as jax_io
from gan_discovery_pso_tpu.pso import make_discovery_fitness_dynamic as jax_fitness_dynamic
from gan_discovery_pso_tpu.pso import optimize as jax_optimize
from gan_discovery_pso_tpu_torch.analysis import reporting
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import (
    generator_state_dict,
    generator_tree,
    resnet_state_dict,
    resnet_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core.checkpoint import msgpack_serialize
from gan_discovery_pso_tpu_torch.core.config import DataConfig, PsoConfig, load_config
from gan_discovery_pso_tpu_torch.pipelines import (
    StageContext,
    assessor_factory,
    emit_swarm_reports,
    load_cnn,
    load_gan,
    run_pso_discovery,
    run_pso_discovery_batched,
)
from gan_discovery_pso_tpu_torch.pso import (
    PsoHistory,
    SwarmResult,
    SwarmState,
    io,
    make_discovery_fitness_dynamic,
)

CFG = "configs/dcgan_mnist.yaml"
IID = (0, 2, 3, 4, 6, 7, 8, 9)
RUN = (0, 2)  # the classes each stage runs
TINY = {"trainer_gan.z_dim": 8, "trainer_pso.n_iterations": 4, "trainer_pso.n_particles": 8,
        "trainer_pso.dim_space": 8}
EPS = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _overrides(root, name):
    return {**TINY, **{f"data.{k}_dir": str(root / name / k)
                       for k in ("reports", "model", "interim")}}


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """JAX trees and the files the JAX package's save_pytree wrote: G z=8,
    G z=2, ResNet-50 with 8 classes, and the same ResNet cut to 2 classes."""
    root = tmp_path_factory.mktemp("upstream")
    rdef = JResNetDef("ResNet50", 1, 8, IID)
    gp, gs = jax.jit(lambda k: generator_init(k, JGeneratorDef(8, 1, 16)))(jax.random.key(0))
    gp2, gs2 = jax.jit(lambda k: generator_init(k, JGeneratorDef(2, 1, 16)))(jax.random.key(3))
    rp, rs = jax.jit(lambda k: resnet_init(k, rdef, init="glorot_normal"))(jax.random.key(1))
    models = root / "models" / "mnist"
    for run_id, (p, s) in ((1, (gp, gs)), (2, (gp2, gs2))):
        jax_save_pytree(models / f"{run_id:05d}--dcgan" / "best_g.msgpack",
                        {"epoch": 0, "state": {"gen_params": p, "gen_state": s}, "loss": 0.5})
    jax_save_pytree(models / "00001--cnn_multipatient" / "model.msgpack",
                    {"params": rp, "state": rs})
    rp2 = dict(rp, fc={"b": rp["fc"]["b"][:2], "w": rp["fc"]["w"][:2]})
    jax_save_pytree(models / "00002--cnn_multipatient" / "model.msgpack",
                    {"params": rp2, "state": rs})
    return {"root": root, "rdef": rdef, "gen": (gp, gs), "gen2": (gp2, gs2), "cnn": (rp, rs),
            "dirs": {k: models / f"0000{i}--{m}" for k, (i, m) in {
                "gan": (1, "dcgan"), "gan2": (2, "dcgan"), "cnn": (1, "cnn_multipatient"),
                "cnn2": (2, "cnn_multipatient")}.items()}}


def _jax_draws(classes, n, d, iters, seed=42):
    """{label: (positions, velocities, r1, r2)} as the JAX stage draws them:
    optimize's split of KeyChain(seed).child(f"class_{label}")("pso")."""
    out = {}
    for label in classes:
        key = JKeyChain(seed).child(f"class_{label}")("pso")
        init_key, iter_key = jax.random.split(key)
        kp, kv = jax.random.split(init_key)
        pos = jax.random.normal(kp, (n, d), jnp.float32)
        vel = (jax.random.normal(kv, (n, d), jnp.float32) - 0.5) / 10.0
        ks = [jax.random.split(jax.random.fold_in(iter_key, it)) for it in range(1, iters + 1)]
        r1 = jnp.stack([jax.random.uniform(k[0], (n,), jnp.float32) for k in ks])
        r2 = jnp.stack([jax.random.uniform(k[1], (n,), jnp.float32) for k in ks])
        out[label] = tuple(np.asarray(x) for x in (pos, vel, r1, r2))
    return out


@pytest.fixture(scope="module")
def port_models(upstream):
    """The port's loaders on the JAX package's files: (G z=8, ResNet-50, its
    ResNetDef from the shipped config)."""
    cfg = load_config(CFG)
    rdef = assessor_factory(cfg, DataConfig.from_config(cfg.data), len(IID))[0]
    return (load_gan(upstream["dirs"]["gan"], device="cpu"),
            load_cnn(upstream["dirs"]["cnn"], rdef, device="cpu"), rdef)


@pytest.fixture(scope="module")
def stages(upstream, port_models):
    """The JAX batched stage and the port's, on the same files and draws."""
    root = upstream["root"]
    jctx = JStageContext.create(CFG, "pso_discovery", overrides=_overrides(root, "jax"))
    jres = jax_run_batched(jctx, *upstream["gen"], *upstream["cnn"], upstream["rdef"],
                           classes=RUN, make_plots=False, image_grids=False)
    draws = _jax_draws(RUN, 8, 8, 4)
    pctx = StageContext.create(CFG, "pso_discovery", overrides=_overrides(root, "port"),
                               device="cpu")
    gen, cnn, rdef = port_models
    pres = run_pso_discovery_batched(pctx, gen, cnn, rdef, classes=RUN, make_plots=False,
                                     image_grids=False, draws=draws)
    return {"jax": (jctx, jres), "port": (pctx, pres), "draws": draws}


def test_inverse_weight_mapping_round_trips_jax_trees(upstream):
    for (p, s), (to_sd, to_tree) in ((upstream["gen"], (generator_state_dict, generator_tree)),
                                     (upstream["cnn"], (resnet_state_dict, resnet_tree))):
        back = dict(zip(("params", "state"), to_tree(to_tensors(to_sd(p, s)))))
        want = _plainify({"params": p, "state": s})
        assert msgpack_serialize(back) == msgpack_serialize(jax.tree.map(np.asarray, want))
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_loaders_build_the_checkpointed_models(upstream, port_models):
    gen, cnn, rdef = port_models
    assert (rdef.n_class, rdef.class_to_idx()[2]) == (8, 1)
    assert not gen.training and not cnn.training
    assert gen.gen[0][0].weight.shape == (8, 32, 7, 7)  # z=8, 2f=32 from the file
    np.testing.assert_array_equal(gen.gen[2].bias.detach().numpy(),
                                  np.asarray(upstream["gen"][0]["convt3"]["b"]))
    assert cnn.fc.weight.shape == (8, 2048)


def test_batched_stage_matches_jax(stages):
    (jctx, jres), (pctx, pres) = stages["jax"], stages["port"]
    for label in RUN:
        j, p = jres[label], pres[label]
        np.testing.assert_allclose(p.history.fitness[0].numpy(), np.asarray(j.history.fitness),
                                   rtol=1e-5)
        np.testing.assert_allclose(p.g_best_val.numpy()[0], np.asarray(j.g_best_val), atol=1e-5)
        for name in ("positions", "velocities"):
            with np.load(jctx.run.interim_dir / f"particles_iid_class_{label}.npz") as a, \
                    np.load(pctx.run.interim_dir / f"particles_iid_class_{label}.npz") as b:
                np.testing.assert_allclose(b[name], a[name], rtol=1e-4, atol=1e-5)
        assert p.last_iteration == [j.last_iteration]
    names = lambda run, sub: sorted(p.name for p in getattr(run, sub).rglob("*")  # noqa: E731
                                    if p.is_file())
    for sub in ("interim_dir", "reports_dir"):
        assert names(pctx.run, sub) == names(jctx.run, sub)
    timing = [json.loads((ctx.run.reports_dir / "timing.json").read_text()) for ctx in (jctx, pctx)]
    assert list(timing[0]) == list(timing[1]) == ["overall_time", "training_time_all_classes"]
    hist = []
    for ctx in (jctx, pctx):
        with open(ctx.run.general_dir / "overall_history.pkl", "rb") as f:
            hist.append(pickle.load(f))
    assert list(hist[0]) == list(hist[1]) == ["class_0", "class_2"]
    for cls in hist[0]:
        for key, want in hist[0][cls].items():
            got = hist[1][cls][key]
            assert [type(x) for x in got] == [type(x) for x in want] == [np.float32] * 4
            tol = dict(rtol=1e-4, atol=1e-5) if key == "mean_mse" else dict(atol=1e-5)
            np.testing.assert_allclose(got, want, **tol)


def test_each_package_reads_the_others_particle_files(stages):
    (jctx, _), (pctx, _) = stages["jax"], stages["port"]
    for label in RUN:
        for reader, mine, theirs in ((jax_io, jctx, pctx), (io, pctx, jctx)):
            np.testing.assert_array_equal(
                reader.load_particle_trajectories(theirs.run.interim_dir, label),
                io.load_particle_trajectories(theirs.run.interim_dir, label))
        for name in (f"particles_position_iic_class_{label}.pkl",
                     f"particles_velocity_iid_class_{label}.pkl"):
            with open(jctx.run.interim_dir / name, "rb") as f, \
                    open(pctx.run.interim_dir / name, "rb") as g:
                a, b = pickle.load(f), pickle.load(g)
            assert list(a) == list(b) == [f"particle_{i}" for i in range(8)]
            for k in a:
                np.testing.assert_allclose(b[k].to_numpy(), a[k].to_numpy(), rtol=1e-4, atol=1e-5)


def test_sequential_stage_matches_batched(upstream, port_models, stages):
    gen, cnn, rdef = port_models
    ctx = StageContext.create(CFG, "pso_discovery", device="cpu",
                              overrides=_overrides(upstream["root"], "sequential"))
    seq = run_pso_discovery(ctx, gen, cnn, rdef, classes=RUN, make_plots=False,
                            image_grids=False, draws=stages["draws"])
    batched = stages["port"][1]
    for label in RUN:
        np.testing.assert_allclose(seq[label].g_best_val.numpy(),
                                   batched[label].g_best_val.numpy(), atol=1e-5)
        np.testing.assert_allclose(seq[label].particle_trajectories(),
                                   batched[label].particle_trajectories(), atol=1e-5)
    timing = json.loads((ctx.run.reports_dir / "timing.json").read_text())
    assert list(timing) == ["overall_time", "training_time_class_0", "training_time_class_2"]


def test_stage_draws_each_class_from_its_own_stream(upstream, port_models):
    """Without injected draws, class c's swarm depends only on (seed, c):
    the batched and the sequential stage start it from the same positions."""
    gen, cnn, rdef = port_models
    hp = {"trainer_pso.n_iterations": 1}
    starts = []
    for name, fn, classes in (("one", run_pso_discovery_batched, (2, 0)),
                              ("two", run_pso_discovery, (0,))):
        ctx = StageContext.create(CFG, "pso_discovery", device="cpu",
                                  overrides={**_overrides(upstream["root"], name), **hp})
        starts.append(fn(ctx, gen, cnn, rdef, classes=classes, make_plots=False,
                         image_grids=False)[0].init_state.positions)
    assert torch.equal(starts[0], starts[1])


def test_landscape_matches_jax(upstream, port_models, tmp_path):
    """emit_swarm_reports at dim_space 2 with an 8x8 mesh in both packages:
    the same swarm, the z=2 generator and the 8-class assessor."""
    hp = JPsoConfig(n_iterations=3, n_particles=8, dim_space=2)
    final, hist, init = jax.jit(lambda k: jax_optimize(
        k, lambda p: jnp.sum(p * p, axis=1), hp))(jax.random.key(5))
    jctx = JStageContext.create(CFG, "pso_discovery", overrides=_overrides(tmp_path, "jax"))
    fit_j = jax.jit(jax_fitness_dynamic(*upstream["gen2"], *upstream["cnn"], upstream["rdef"]))
    jax_emit(jctx, JSwarmResult(final, hist, init, hp), 0, *upstream["gen2"],
             fitness=lambda pos: fit_j(pos, 0), resolution=8)

    one = lambda t: [torch.tensor(np.asarray(x))[None] for x in t]  # noqa: E731
    res = SwarmResult(SwarmState(*one(final)), PsoHistory(*one(hist)), SwarmState(*one(init)),
                      PsoConfig(n_iterations=3, n_particles=8, dim_space=2))
    pctx = StageContext.create(CFG, "pso_discovery", device="cpu",
                               overrides=_overrides(tmp_path, "port"))
    gen2 = load_gan(upstream["dirs"]["gan2"], device="cpu")
    fit_p = make_discovery_fitness_dynamic(gen2, port_models[1])
    emit_swarm_reports(pctx, res, 0, fitness=lambda pos, **kw: fit_p(pos, 0, **kw), resolution=8)

    for name, tol in (("fitness_grid.pkl", dict(rtol=1e-5, atol=1e-6)),
                      ("img_grid.pkl", dict(atol=1e-3, rtol=0))):
        with open(jctx.run.general_dir / "0" / name, "rb") as f, \
                open(pctx.run.general_dir / "0" / name, "rb") as g:
            want, got = pickle.load(f), pickle.load(g)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), **tol)
    for sub in ("general/0", "training_plot/0"):
        assert (sorted(p.name for p in (pctx.run.reports_dir / sub).iterdir())
                == sorted(p.name for p in (jctx.run.reports_dir / sub).iterdir()))


def test_stage_without_pandas_matplotlib_or_pil(upstream, port_models, stages, monkeypatch,
                                                capsys):
    """One printed line per artifact family the host cannot write, naming
    the package; the npz, landscape-free reports and histories still land."""
    monkeypatch.setattr(reporting, "host_has", lambda package: package == "numpy")
    gen, cnn, rdef = port_models
    ctx = StageContext.create(CFG, "pso_discovery", device="cpu",
                              overrides=_overrides(upstream["root"], "bare_host"))
    run_pso_discovery_batched(ctx, gen, cnn, rdef, classes=RUN, draws=stages["draws"])
    out = capsys.readouterr().out
    for package in ("pandas", "matplotlib", "PIL"):
        assert out.count(f"{package} is not installed") == 1
    written = sorted(p.relative_to(ctx.run.reports_dir).as_posix()
                     for p in ctx.run.reports_dir.rglob("*") if p.is_file())
    assert written == ["configuration.yaml", "general/overall_history.json",
                       "general/overall_history.pkl", "general/timing.pkl", "timing.json"]
    assert sorted(p.name for p in ctx.run.interim_dir.iterdir()) == [
        "particles_iid_class_0.npz", "particles_iid_class_2.npz"]


@pytest.mark.parametrize("stage", ["cae", "classifiers", "cnn"])
def test_new_stage_without_pandas_matplotlib_or_pil(stage, monkeypatch, capsys, tmp_path):
    """The cae, classifiers and cnn stages on a host without pandas,
    matplotlib or PIL: one line of the stage's naming matplotlib (the only
    package they would use), every plot left out, the checkpoints, CSVs and
    histories written."""
    from test_torch_port_assessor import write_idx

    from gan_discovery_pso_tpu_torch.pipelines import run_cae, run_classifiers, run_cnn

    monkeypatch.setattr(reporting, "host_has", lambda package: package == "numpy")
    write_idx(tmp_path / "data" / "MNIST" / "raw")
    sets = {"data.data_dir": str(tmp_path / "data"), "trainer_ae.batch_size": 16,
            "trainer_cnn.batch_size": 16, "model_ae.latent_space": 6,
            "model_cnn.model_name": "AlexNet", "model_cnn.network.padding": "same",
            **{f"data.{k}_dir": str(tmp_path / k) for k in ("reports", "model", "interim")}}
    make = lambda name: StageContext.create(CFG, name, overrides=sets, device="cpu")  # noqa: E731
    encoder = run_cae(make("cae"), epochs=1)[0] if stage != "cnn" else None
    capsys.readouterr()
    ctx = make(stage)
    if stage == "cae":
        run_cae(ctx, epochs=1)
    elif stage == "classifiers":
        run_classifiers(ctx, encoder=encoder)
    else:
        run_cnn(ctx, epochs=1, classes=(0, 2))
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith(f"[{stage}] not writing")]
    assert len(lines) == 1 and lines[0].endswith("matplotlib is not installed")
    written = sorted(p.relative_to(ctx.run.reports_dir).as_posix()
                     for p in ctx.run.reports_dir.rglob("*") if p.is_file())
    want = {"cae": ["configuration.yaml", "general/overall_history.json",
                    "general/overall_history.pkl", "general/timing.pkl", "history_cae.jsonl",
                    "timing.json"],
            "classifiers": ["configuration.yaml"],
            "cnn": ["configuration.yaml", "general/overall_history.json",
                    "general/overall_history.pkl", "general/timing.pkl", "timing.json"]}
    assert [w for w in written if w != "log.txt"] == want[stage]
    files = {"cae": ["encoder.msgpack", "decoder.msgpack"],
             "classifiers": ["classifiers.msgpack"], "cnn": ["model_0.msgpack", "model_2.msgpack"]}
    assert all((ctx.run.models_dir / f).exists() for f in files[stage])
    if stage != "cnn":
        assert sorted(p.name for p in ctx.run.interim_dir.iterdir()) == [
            "encoded_samples_train.csv", "encoded_samples_valid.csv"]


@pytest.mark.parametrize("program", ["chunked", "fastest"])
def test_program_key_chooses_nothing_on_the_port(upstream, port_models, stages, program):
    """trainer_pso.program=chunked runs the batched stage's one loop (the
    default run's values, bit for bit); a value JAX refuses is refused."""
    gen, cnn, rdef = port_models
    ctx = StageContext.create(CFG, "pso_discovery", device="cpu", overrides={
        **_overrides(upstream["root"], f"program_{program}"), "trainer_pso.program": program})
    run = lambda: run_pso_discovery_batched(  # noqa: E731
        ctx, gen, cnn, rdef, classes=RUN, make_plots=False, image_grids=False,
        draws=stages["draws"])
    if program == "fastest":
        with pytest.raises(ValueError, match="trainer_pso.program"):
            run()
        return
    got, want = run(), stages["port"][1]
    for label in RUN:
        for name, x, y in zip(PsoHistory._fields, got[label].history, want[label].history):
            assert torch.equal(x.nan_to_num(-1.0), y.nan_to_num(-1.0)), name
        for name, x, y in zip(SwarmState._fields, got[label].state, want[label].state):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("mode", ["batched", "sequential", "bf16", "bf16_sequential"])
def test_cli_runs_the_stage_on_files_jax_wrote(upstream, mode, capsys):
    """pso-discovery on the JAX package's files, batched and sequential:
    through the port's CLI in fp32, and as a caller asks for the swarm's
    bf16 model copies (`fast_math_dtype=torch.bfloat16`, which the CLI
    never passes: its --fast-math is TF32 on the fp32 models). Each writes
    every class's particle files and plots, and g_best in range."""
    dirs = upstream["dirs"]
    root = upstream["root"] / f"cli_{mode}"
    batch = not mode.endswith("sequential")
    if mode.startswith("bf16"):
        ctx = StageContext.create(CFG, "pso_discovery", device="cpu", overrides={
            **TINY, "data.iid_classes": [0, 2],
            **{f"data.{k}_dir": str(root / k) for k in ("reports", "model", "interim")}})
        rdef = assessor_factory(ctx.cfg, ctx.data_cfg, 2)[0]
        run_pso_discovery(ctx, load_gan(dirs["gan"], device="cpu"),
                          load_cnn(dirs["cnn2"], rdef, device="cpu"), rdef,
                          batch_classes=batch, fast_math_dtype=torch.bfloat16)
    else:
        assert cli_main(["pso-discovery", "--cfg", CFG, "--tiny", "--device", "cpu",
                         *(["--batch-classes"] if batch else []),
                         "--path-gan", str(dirs["gan"]), "--path-cnn", str(dirs["cnn2"]),
                         "--set", "data.iid_classes=[0,2]",
                         *(f"data.{k}_dir={root / k}" for k in ("reports", "model", "interim"))
                         ]) == 0
    reports = root / "reports" / "mnist" / "00001--pso_discovery"
    if not mode.startswith("bf16"):  # the CLI's last line and its log's tee
        assert capsys.readouterr().out.strip().splitlines()[-1] == (
            f"[pso-discovery] done → {reports}")
        assert (reports / "log.txt").exists()
    interim = root / "interim" / "mnist" / "00001--pso_discovery"
    for label in (0, 2):
        traj = jax_io.load_particle_trajectories(interim, label)
        assert traj.shape == (5, 8, 8) and np.isfinite(traj).all()
        for name in (f"particles_position_iid_class_{label}.pkl",
                     f"particles_position_iic_class_{label}.pkl",
                     f"particles_velocity_iid_class_{label}.pkl"):
            assert (interim / name).exists()
        for name in ("pso_iter.png", "mean_mse.png"):
            assert (reports / "general" / str(label) / name).exists()
        plots = reports / "training_plot" / str(label)
        for name in ("pso_dim_7.png", "pso_dim_last_iteration.png", "pso_images_4.png",
                     "iid_img.gif"):
            assert (plots / name).exists()
    with open(reports / "general" / "overall_history.pkl", "rb") as f:
        g = np.asarray([h["global_best_val"][-1] for h in pickle.load(f).values()])
    assert np.isfinite(g).all() and (g >= EPS).all() and (g <= 1 + EPS).all()
    assert (reports / "timing.json").exists()
