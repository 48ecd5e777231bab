"""The port's pso-inverter stage and the extractors against the JAX
package's on the CPU, on checkpoint files the JAX package wrote: the plain
encoder, the encoder-seeded swarm, the hybrid fitness, the try-load stage
(fed the JAX package's draws), the fine-tune branch's checkpoint, and the
CLI. Tiny sizes: G z=8 f=16, encoder z=8 f=8, ResNet-50 with the shipped 8
IiD classes, 8 particles x 4 iterations, 120 idx images (12 of the
patient's class)."""

import json
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.compat.torch_export import export_encoder
from gan_discovery_pso_tpu.core.checkpoint import save_pytree as jax_save_pytree
from gan_discovery_pso_tpu.core.prng import KeyChain as JKeyChain
from gan_discovery_pso_tpu.models import ResNetDef as JResNetDef
from gan_discovery_pso_tpu.models.encoder import EncoderDef as JEncoderDef
from gan_discovery_pso_tpu.models.encoder import encoder_apply, encoder_init
from gan_discovery_pso_tpu.models.resnet import change_classifier_head as jax_rehead
from gan_discovery_pso_tpu.models.resnet import resnet_apply
from gan_discovery_pso_tpu.pipelines import StageContext as JStageContext
from gan_discovery_pso_tpu.pipelines.stages import load_cnn as jax_load_cnn
from gan_discovery_pso_tpu.pipelines.stages import load_encoder as jax_load_encoder
from gan_discovery_pso_tpu.pipelines.stages import load_gan as jax_load_gan
from gan_discovery_pso_tpu.pipelines.stages import run_extractor as jax_run_extractor
from gan_discovery_pso_tpu.pipelines.stages import run_pso_inverter as jax_run_pso_inverter
from gan_discovery_pso_tpu.pso import make_inverter_fitness as jax_inverter_fitness
from gan_discovery_pso_tpu.pso.swarm import swarm_init_from_positions as jax_seeded_init
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import (
    encoder_state_dict,
    encoder_tree,
    generator_tree,
    resnet_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core.checkpoint import msgpack_serialize
from gan_discovery_pso_tpu_torch.core.config import DataConfig, PsoConfig, load_config
from gan_discovery_pso_tpu_torch.models import (
    Encoder,
    EncoderDef,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    glorot_normal_init_,
)
from gan_discovery_pso_tpu_torch.ops import fp32_parity
from gan_discovery_pso_tpu_torch.pipelines import (
    StageContext,
    assessor_factory,
    load_cnn,
    load_encoder,
    load_gan,
    run_pso_inverter,
)
from gan_discovery_pso_tpu_torch.pso import (
    SwarmResult,
    make_discovery_fitness_dynamic,
    make_inverter_fitness,
    make_inverter_runner,
    swarm_init_from_positions,
)

CFG = "configs/dcgan_mnist.yaml"
IID = (0, 2, 3, 4, 6, 7, 8, 9)
PATIENT = 1
EPS = 0.1
N, ITERS, D = 8, 4, 8
TINY = {"trainer_gan.z_dim": D, "model_inverter.latent_space": D,
        "trainer_pso_inverter.n_particles": N, "trainer_pso_inverter.n_iterations": ITERS,
        "trainer_pso_inverter.batch_size": 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_idx(raw, n=120):
    raw.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = (np.arange(n) % 10).astype(np.uint8)
    rs.shuffle(labels)
    (raw / "train-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
    (raw / "train-labels-idx1-ubyte").write_bytes(struct.pack(">II", 0x801, n) + labels.tobytes())


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """Files the JAX package's save_pytree wrote: G z=8 f=16, the plain
    encoder z=8 f=8, a seeded 8-class ResNet-50, and that ResNet re-headed
    to 2 classes (a fine-tuned patient assessor's layout); idx data."""
    root = tmp_path_factory.mktemp("upstream")
    _write_idx(root / "data" / "MNIST" / "raw")
    models = root / "models" / "mnist"
    # torch's default init for G too: images that move with z (the DCGAN
    # init's vary by ~1e-5 around the bias)
    torch.manual_seed(0)
    gp, gs = generator_tree(Generator(GeneratorDef(D, 1, 16)).state_dict())
    jax_save_pytree(models / "00001--dcgan" / "best_g.msgpack",
                    {"epoch": 0, "state": {"gen_params": gp, "gen_state": gs}, "loss": 0.5})
    # torch's default init for E: latents of order 1, as a trained encoder gives
    # (the DCGAN init's N(0, 0.02) puts every slice within ~0.05 of 0, where
    # the fitness is flat to ~1e-7 and fp32 noise picks the personal bests)
    ep, _ = jax.jit(lambda k: encoder_init(k, JEncoderDef(D, 1, 8), dcgan_init=False))(
        jax.random.key(2))
    jax_save_pytree(models / "00001--inverter" / "encoder.msgpack", {"params": ep})
    net = glorot_normal_init_(ResNet(ResNetDef("ResNet50", 1, len(IID), IID)),
                              torch.Generator().manual_seed(1))
    rp, rs = resnet_tree(net.state_dict())
    jax_save_pytree(models / "00001--cnn_multipatient" / "model.msgpack",
                    {"params": rp, "state": rs})
    binary = {"params": jax_rehead(jax.random.key(99), jax.tree.map(jnp.asarray, rp), 2),
              "state": rs}
    return {"root": root, "binary": binary,
            "dirs": {"gan": models / "00001--dcgan", "inv": models / "00001--inverter",
                     "cnn": models / "00001--cnn_multipatient"}}


def _overrides(root, name, **extra):
    return {**TINY, "data.data_dir": str(root / "data"),
            **{f"data.{k}_dir": str(root / name / k) for k in ("reports", "model", "interim")},
            **extra}


@pytest.fixture(scope="module")
def port_models(upstream):
    """The port's loaders on the JAX package's files."""
    dirs = upstream["dirs"]
    cfg = load_config(CFG)
    rdef = assessor_factory(cfg, DataConfig.from_config(cfg.data), len(IID))[0]
    return {"gen": load_gan(dirs["gan"], device="cpu"),
            "enc": load_encoder(dirs["inv"], device="cpu"),
            "cnn": load_cnn(dirs["cnn"], rdef, device="cpu"), "rdef": rdef}


@pytest.mark.parametrize("features,enc_dim", [(8, 8), (16, 5)])
def test_encoder_matches_jax_and_loads_its_exported_weights(features, enc_dim):
    """Forward within rtol 1e-5; the JAX package's `export_encoder` state
    dict loads with strict=True; weights round-trip both ways."""
    params, _ = encoder_init(jax.random.key(features), JEncoderDef(enc_dim, 1, features))
    x = np.random.RandomState(3).randn(6, 1, 28, 28).astype(np.float32)
    want, _ = encoder_apply(params, {}, jnp.asarray(x))
    for sd in (encoder_state_dict(params), export_encoder(params, {})):
        enc = Encoder(EncoderDef(enc_dim, 1, features))
        enc.load_state_dict(to_tensors({k: np.asarray(v) for k, v in sd.items()}), strict=True)
        got = enc(torch.tensor(x)).detach().numpy()
        assert got.shape == (6, enc_dim, 1, 1)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    back = encoder_tree(enc.state_dict())
    assert msgpack_serialize({"params": back}) == msgpack_serialize(
        {"params": jax.tree.map(np.asarray, params)})


def test_loaded_encoder_matches_jax_loader(upstream, port_models):
    want = jax_load_encoder(upstream["dirs"]["inv"])
    sd = port_models["enc"].state_dict()
    for name, key in (("enc.0", "conv1"), ("enc.2.0", "conv2"), ("enc.3", "conv3")):
        np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(), np.asarray(want[key]["w"]))
        np.testing.assert_array_equal(sd[f"{name}.bias"].numpy(), np.asarray(want[key]["b"]))
    assert not port_models["enc"].training


def test_load_encoder_refuses_the_attgan_variant(upstream, tmp_path):
    params, _ = encoder_init(jax.random.key(0), JEncoderDef(D, 1, 8))
    jax_save_pytree(tmp_path / "encoder.msgpack", {"params": params, "variant": "attgan"})
    with pytest.raises(ValueError, match="AttGAN"):
        load_encoder(tmp_path, device="cpu")


def test_seeded_swarm_init_matches_jax():
    """Given positions and the JAX package's velocity draw, the same state;
    drawn velocities follow (N(0, 1) − 0.5)/10."""
    pos = np.random.RandomState(5).randn(N, D).astype(np.float32)
    want = jax_seeded_init(jax.random.key(4), jnp.asarray(pos), 0.73)
    got = swarm_init_from_positions(None, torch.tensor(pos)[None], 0.73,
                                    torch.tensor(np.asarray(want.velocities))[None])
    for name in ("positions", "velocities", "p_best_pos", "p_best_val", "g_best_val",
                 "w_inertia", "iteration", "g_improvements"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    drawn = swarm_init_from_positions(torch.Generator().manual_seed(0),
                                      torch.zeros(1, 4096, 4), 0.73).velocities
    assert abs(float(drawn.mean()) + 0.05) < 5e-3 and abs(float(drawn.std()) - 0.1) < 5e-3


@pytest.fixture(scope="module")
def binary_models(upstream, port_models):
    """The re-headed binary assessor in both packages."""
    rp, rs = upstream["binary"]["params"], upstream["binary"]["state"]
    from gan_discovery_pso_tpu_torch.compat import resnet_state_dict

    net = ResNet(ResNetDef("ResNet50", 1, 2, IID + (PATIENT,)))
    net.load_state_dict(to_tensors(resnet_state_dict(jax.tree.map(np.asarray, rp), rs)),
                        strict=True)
    return net.eval()


def test_inverter_fitness_matches_jax(upstream, port_models, binary_models):
    """The hybrid fitness within rtol 1e-5; without the reconstruction term
    it is the discovery fitness plus a second eps; values lie in
    [2·eps, 1 + 2·eps + 4·w_rec]."""
    gp, gs = jax_load_gan(upstream["dirs"]["gan"])
    rp, rs = jax_load_cnn(_binary_dir(upstream), JResNetDef("ResNet50", 1, 2, IID + (1,)),
                          label=PATIENT)
    rs_ = np.random.RandomState(6)
    pos = rs_.randn(N, D).astype(np.float32)
    src = rs_.uniform(-1, 1, (N, 1, 28, 28)).astype(np.float32)
    jdef = JResNetDef("ResNet50", 1, 2, IID + (PATIENT,))
    want = jax.jit(jax_inverter_fitness(gp, gs, rp, rs, jdef, jnp.asarray(src), 1))(
        jnp.asarray(pos))
    got = make_inverter_fitness(port_models["gen"], binary_models, src, 1)(pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert bool(((got >= 2 * EPS) & (got <= 1 + 2 * EPS + 4)).all())
    no_rec = make_inverter_fitness(port_models["gen"], binary_models, src, 1, w_rec=0.0)(pos)
    disc = make_discovery_fitness_dynamic(port_models["gen"], binary_models,
                                          control="optimize_in_training")(pos, 1)
    torch.testing.assert_close(no_rec, disc + EPS, rtol=0, atol=1e-7)


def _binary_dir(upstream):
    """A models dir holding the binary assessor as `model_1.msgpack`."""
    d = upstream["root"] / "binary"
    if not (d / f"model_{PATIENT}.msgpack").exists():
        jax_save_pytree(d / f"model_{PATIENT}.msgpack", upstream["binary"])
    return d


def _jax_draws(seed=42):
    """(velocities [n, d], r1 [iters, n], r2 [iters, n]) as the JAX stage
    draws them: optimize's split of KeyChain(seed)("pso") and the seeded
    init's velocity draw."""
    key = JKeyChain(seed)("pso")
    init_key, iter_key = jax.random.split(key)
    vel = (jax.random.normal(init_key, (N, D), jnp.float32) - 0.5) / 10.0
    ks = [jax.random.split(jax.random.fold_in(iter_key, it)) for it in range(1, ITERS + 1)]
    r1 = jnp.stack([jax.random.uniform(k[0], (N,), jnp.float32) for k in ks])
    r2 = jnp.stack([jax.random.uniform(k[1], (N,), jnp.float32) for k in ks])
    return tuple(np.asarray(x) for x in (vel, r1, r2))


@pytest.fixture(scope="module")
def try_load(upstream, port_models):
    """Both stages on a run dir that already holds `model_1.msgpack` (the
    JAX package's file), the port fed the JAX package's draws."""
    root, dirs = upstream["root"], upstream["dirs"]
    jctx = JStageContext.create(CFG, "pso_inverter", overrides=_overrides(root, "jax"))
    pctx = StageContext.create(CFG, "pso_inverter", device="cpu",
                               overrides=_overrides(root, "port"))
    for ctx in (jctx, pctx):
        jax_save_pytree(ctx.run.models_dir / f"model_{PATIENT}.msgpack", upstream["binary"])
    gp, gs = jax_load_gan(dirs["gan"])
    rp, rs = jax_load_cnn(dirs["cnn"], JResNetDef("ResNet50", 1, len(IID), IID))
    jres, _ = jax_run_pso_inverter(jctx, gp, gs, jax_load_encoder(dirs["inv"]), rp, rs,
                                   JResNetDef("ResNet50", 1, len(IID), IID),
                                   ood_patient=PATIENT)
    draws = _jax_draws()
    pres, pfine = run_pso_inverter(pctx, port_models["gen"], port_models["enc"],
                                   port_models["cnn"], port_models["rdef"],
                                   ood_patient=PATIENT, draws=draws)
    return {"jax": (jctx, jres), "port": (pctx, pres, pfine), "draws": draws}


def test_try_load_stage_matches_jax(try_load):
    """The tolerances of the discovery stage's parity test: fitness rtol
    1e-5, g_best atol 1e-5, trajectories rtol 1e-4 atol 1e-5."""
    (jctx, j), (pctx, p, _fine) = try_load["jax"], try_load["port"]
    np.testing.assert_allclose(p.history.fitness[0].numpy(), np.asarray(j.history.fitness),
                               rtol=1e-5)
    np.testing.assert_allclose(p.g_best_val.numpy()[0], np.asarray(j.g_best_val), atol=1e-5)
    name = f"particles_ood_class_{PATIENT}.npz"
    with np.load(jctx.run.interim_dir / name) as a, np.load(pctx.run.interim_dir / name) as b:
        for key in ("positions", "velocities"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-4, atol=1e-5)
        assert b["positions"].shape == (ITERS + 1, N, D)
    assert p.last_iteration == [j.last_iteration]
    g = float(p.g_best_val[0])
    assert 2 * EPS <= g <= 1 + 2 * EPS + 4


def test_try_load_stage_writes_the_jax_artifact_names(try_load):
    (jctx, _), (pctx, _, _) = try_load["jax"], try_load["port"]
    names = lambda run, sub: sorted(p.relative_to(getattr(run, sub)).as_posix()  # noqa: E731
                                    for p in getattr(run, sub).rglob("*") if p.is_file())
    for sub in ("interim_dir", "reports_dir", "models_dir"):
        assert names(pctx.run, sub) == names(jctx.run, sub), sub
    timing = [json.loads((c.run.reports_dir / "timing.json").read_text()) for c in (jctx, pctx)]
    assert list(timing[0]) == list(timing[1]) == [
        "overall_time", f"pso_inverter_time_ood_patient_{PATIENT}"]
    hist = []
    for ctx in (jctx, pctx):
        with open(ctx.run.general_dir / "overall_history.pkl", "rb") as f:
            hist.append(pickle.load(f))
    key = f"pso_inverter_history_ood_patient_{PATIENT}"
    assert list(hist[0]) == list(hist[1]) == [key]  # no fine-tune history on a try-load
    for series, want in hist[0][key].items():
        tol = dict(rtol=1e-4, atol=1e-5) if series == "mean_mse" else dict(atol=1e-5)
        np.testing.assert_allclose(hist[1][key][series], want, **tol)


def test_runner_called_directly_equals_the_stage(try_load, port_models):
    """`make_inverter_runner` on the stage's slices, encoder positions and
    draws gives the stage's swarm bit for bit."""
    (pctx, res, fine) = try_load["port"]
    vel, r1, r2 = (torch.tensor(x) for x in try_load["draws"])
    ood = pctx.dataset("train", classes=(PATIENT,), drange=(-1, 1))
    slices = ood.images[:N]
    with fp32_parity(), torch.no_grad():
        pos = port_models["enc"](slices).reshape(N, -1)
    hp = PsoConfig.from_config(pctx.cfg.trainer_pso_inverter)
    run = make_inverter_runner(hp, device="cpu")
    init = swarm_init_from_positions(None, pos[None], hp.w_inertia, vel[None])
    final, hist, first = run(port_models["gen"], fine, 1, slices, None, init_state=init,
                             r1=r1[:, None], r2=r2[:, None])
    direct = SwarmResult(final, hist, first, hp).swarm(0)
    assert np.array_equal(direct.particle_trajectories(), res.particle_trajectories())
    assert np.array_equal(direct.velocity_trajectories(), res.velocity_trajectories())
    assert torch.equal(direct.g_best_val, res.g_best_val)
    # the runner draws its own velocities and uniforms from rng
    _, drawn, _ = run(port_models["gen"], fine, 1, slices, pos,
                      rng=torch.Generator().manual_seed(0))
    assert drawn.fitness.shape == (1, ITERS, N) and bool(torch.isfinite(drawn.fitness).all())


@pytest.fixture(scope="module")
def cli_inverter(upstream):
    """`pso-inverter --tiny --device cpu` on a fresh run dir: phase 1
    re-heads and fine-tunes (1 epoch) the JAX package's 8-class ResNet-50."""
    root, dirs = upstream["root"], upstream["dirs"]
    out = root / "cli"
    sets = [f"{k}={v}" for k, v in _overrides(root, "cli").items()]
    rc = cli_main(["pso-inverter", "--cfg", CFG, "--tiny", "--device", "cpu",
                   "--path-gan", str(dirs["gan"]), "--path-cnn", str(dirs["cnn"]),
                   "--path-inverter", str(dirs["inv"]), "--ood-patient", str(PATIENT),
                   "--set", *sets])
    assert rc == 0
    return {k: out / k / "mnist" / "00001--pso_inverter" for k in ("reports", "model", "interim")}


def test_cli_pso_inverter_runs_both_phases(cli_inverter):
    reports, interim = cli_inverter["reports"], cli_inverter["interim"]
    assert (cli_inverter["model"] / f"model_{PATIENT}.msgpack").exists()
    for name in (f"particles_position_ood_class_{PATIENT}.pkl",
                 f"particles_velocity_ood_class_{PATIENT}.pkl",
                 f"particles_ood_class_{PATIENT}.npz"):
        assert (interim / name).exists(), name
    for rel in (f"general/{PATIENT}/pso_iter.png", f"general/{PATIENT}/mean_mse.png",
                f"training_plot/train_val_loss_{PATIENT}.png",
                f"training_plot/{PATIENT}/pso_images_{ITERS}.png",
                f"training_plot/{PATIENT}/iid_img.gif", "general/mnist.png", "timing.json"):
        assert (reports / rel).exists(), rel
    with open(reports / "general" / "overall_history.pkl", "rb") as f:
        hist = pickle.load(f)
    assert list(hist) == [f"pso_inverter_history_ood_patient_{PATIENT}",
                          f"cnn_history_ood_patient_{PATIENT}"]
    cnn = hist[f"cnn_history_ood_patient_{PATIENT}"]
    assert len(cnn["train_loss"]) == 1 and all(np.isfinite(v[0]) for v in cnn.values())
    g = hist[f"pso_inverter_history_ood_patient_{PATIENT}"]["global_best_val"][-1]
    assert 2 * EPS <= g <= 1 + 2 * EPS + 4


def test_fine_tuned_assessor_reads_in_jax(cli_inverter):
    """The port's `model_1.msgpack` in the JAX tree layout: the JAX loader
    reads it, bit-equal to the port's loader, and both forwards agree within
    rtol 1e-4."""
    models = cli_inverter["model"]
    jdef = JResNetDef("ResNet50", 1, 2, IID + (PATIENT,))
    rp, rs = jax_load_cnn(models, jdef, label=PATIENT)
    net = load_cnn(models, ResNetDef("ResNet50", 1, 2, IID + (PATIENT,)), label=PATIENT,
                   device="cpu")
    params, state = resnet_tree(net.state_dict())
    for a, b in zip(jax.tree.leaves((rp, rs)), jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(a), b)
    x = np.random.RandomState(7).rand(3, 1, 28, 28).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: resnet_apply(p, s, x, jdef))(rp, rs, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["iid", "ood"])
def test_cli_extractor_matches_jax(upstream, kind):
    """`iid-extract`/`ood-extract` through the CLI against `run_extractor`
    of the JAX package: latents within rtol 1e-5, the same file names
    (with G, the per-class superimages too)."""
    root, dirs = upstream["root"], upstream["dirs"]
    name = f"{kind}_extract"
    sets = [f"{k}={v}" for k, v in _overrides(root, f"cli_{kind}").items()]
    rc = cli_main([f"{kind}-extract", "--cfg", CFG, "--tiny", "--device", "cpu",
                   "--path-inverter", str(dirs["inv"]), "--path-gan", str(dirs["gan"]),
                   "--set", *sets])
    assert rc == 0
    jctx = JStageContext.create(CFG, name, overrides=_overrides(root, f"jax_{kind}"))
    want = jax_run_extractor(jctx, jax_load_encoder(dirs["inv"]), kind=kind,
                             gen=jax_load_gan(dirs["gan"]))
    interim = root / f"cli_{kind}" / "interim" / "mnist" / f"00001--{name}"
    reports = root / f"cli_{kind}" / "reports" / "mnist" / f"00001--{name}"
    for label, z in want.items():
        with np.load(interim / f"particles_{kind}_class_{label}.npz") as got:
            assert got["positions"].shape == (1, *z.shape)
            np.testing.assert_allclose(got["positions"][0], z, rtol=1e-5, atol=1e-6)
            assert not got["velocities"].any()
    for mine, theirs in ((interim, jctx.run.interim_dir), (reports, jctx.run.reports_dir)):
        assert (sorted(p.relative_to(mine).as_posix() for p in mine.rglob("*.p*"))
                == sorted(p.relative_to(theirs).as_posix() for p in theirs.rglob("*.p*")))


@pytest.mark.parametrize("stage", ["pso-inverter", "iid-extract", "ood-extract"])
def test_cli_stage_without_device_raises_on_a_host_without_cuda(stage, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main([stage, "--cfg", CFG, "--path-inverter", str(tmp_path), "--set", *roots])
    assert not (tmp_path / "reports").exists()  # raised before any run dir

