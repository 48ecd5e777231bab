"""The port's DCGAN training against the JAX package's on the CPU: G's
train-mode forward, two train steps fed the JAX package's draws, the D
gradient after a G step, the train state in the JAX checkpoint layout
(Adam, Adam with weight decay, RMSprop), `save_best` and `drop_rows_from`,
the checkpoints each package reads of the other's (`best_g`, a resume from
`checkpoint_g` either way), the stage's artifacts and its three resume
paths, the compute-dtype refusal, and `dcgan` through both CLIs. Tiny
sizes: G and D at f=8, z=8, 200 idx train and 80 test images, batches of
16, `--tiny`'s 256 samples an evaluation; the CAE (latent 6) and the KNN
battery come from the JAX package's own init and battery functions.

Tolerances: forwards and losses rtol 1e-5; updated weights within rtol 1e-4
(atol 1e-7) where the step's gradient is above 1 % of its tensor's largest
and above 1e-4 of the largest of all (Adam's first step moves an entry by
±lr with its gradient's sign, which rounding flips where the gradient is
near 0: the biases of G's transposed convs, each followed by a BN, get a
gradient of 0 but for rounding; optax and torch also apply the bias
correction in other orders); Adam's moments within 1e-4 of each tensor's
largest plus 1e-5 of the largest of all (those biases' moments are
rounding); BN statistics within rtol 1e-5 (atol 1e-7); the resumed runs of
one package bit-equal."""

import copy
import json
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.cli.main import main as jax_cli_main
from gan_discovery_pso_tpu.core.checkpoint import Checkpointer as JCheckpointer
from gan_discovery_pso_tpu.core.checkpoint import _plainify
from gan_discovery_pso_tpu.core.checkpoint import load_pytree as jax_load_pytree
from gan_discovery_pso_tpu.core.checkpoint import save_pytree as jax_save_pytree
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.evaluation import save_battery as jax_save_battery
from gan_discovery_pso_tpu.evaluation import train_classifier_battery as jax_train_battery
from gan_discovery_pso_tpu.models import generator_forward
from gan_discovery_pso_tpu.models.cae import CAEDef as JCAEDef
from gan_discovery_pso_tpu.models.dcgan import DiscriminatorDef as JDiscriminatorDef
from gan_discovery_pso_tpu.models.dcgan import GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.models.dcgan import generator_apply, generator_init
from gan_discovery_pso_tpu.pipelines.stages import load_gan as jax_load_gan
from gan_discovery_pso_tpu.train import common as jcommon
from gan_discovery_pso_tpu.train import dcgan as jdcgan
from gan_discovery_pso_tpu.train.cae import cae_init
from gan_discovery_pso_tpu_torch.cli.main import _parser
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import generator_state_dict, generator_tree, to_tensors
from gan_discovery_pso_tpu_torch.core import AdamConfig, load_config
from gan_discovery_pso_tpu_torch.core.checkpoint import Checkpointer, load_pytree, restore_tree
from gan_discovery_pso_tpu_torch.core.logging import MetricsWriter
from gan_discovery_pso_tpu_torch.evaluation import load_battery
from gan_discovery_pso_tpu_torch.models import (
    DiscriminatorDef,
    Generator,
    GeneratorDef,
)
from gan_discovery_pso_tpu_torch.pipelines import StageContext, load_cae, load_gan, run_dcgan
from gan_discovery_pso_tpu_torch.train.common import bce_from_logits
from gan_discovery_pso_tpu_torch.train.dcgan import gan_init, make_gan_train_step

CFG = "configs/dcgan_mnist.yaml"
Z, F_ = 8, 8
IID = (0, 2, 3, 4, 6, 7, 8, 9)
# trainer_gan.optimizer of the shipped config
ADAM = dict(lr=1e-3, beta1=0.5, beta2=0.99, epsilon=1e-8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(tree):
    """A writable host copy of a JAX tree."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_state(seed=0, adam=None):
    """The JAX package's GAN train state (DCGAN init) and its plain tree."""
    state, _ = jdcgan.gan_init(jax.random.key(seed), JGeneratorDef(Z, 1, F_),
                               JDiscriminatorDef(1, F_), JAdamConfig(**(adam or ADAM)))
    return state, _host(_plainify(state))


def _port_state(tree, adam=None):
    state = gan_init(torch.Generator().manual_seed(0), GeneratorDef(Z, 1, F_),
                     DiscriminatorDef(1, F_), AdamConfig(**(adam or ADAM)), device="cpu")
    return state.load_tree(tree)


def _jax_draws(key, bs):
    """The noise and label draws of the JAX train step under `key`."""
    kz, kp, kn = jax.random.split(key, 3)
    return tuple(torch.tensor(np.asarray(t)) for t in (
        jax.random.normal(kz, (bs, Z, 1, 1), jnp.float32),
        jcommon.smooth_positive(kp, (bs,)), jcommon.smooth_negative(kn, (bs,))))


def _real(n=6, seed=1):
    return np.random.RandomState(seed).rand(n, 1, 28, 28).astype(np.float32) * 2 - 1


# -- G's train mode, the step ----------------------------------------------------


def test_generator_train_forward_matches_jax():
    """Train-mode images within rtol 1e-5 (atol 1e-6) of `generator_apply(
    train=True)`, and the running statistics after exactly one update within
    rtol 1e-5 (atol 1e-7); eval mode leaves them alone."""
    gp, gs = generator_init(jax.random.key(4), JGeneratorDef(Z, 1, F_), dcgan_init=False)
    z = np.random.RandomState(2).randn(6, Z, 1, 1).astype(np.float32)
    want, new_state = jax.jit(lambda p, s, x: generator_apply(p, s, x, train=True))(
        gp, gs, jnp.asarray(z))
    gen = Generator(GeneratorDef(Z, 1, F_))
    gen.load_state_dict(to_tensors(generator_state_dict(_host(gp), _host(gs))), strict=True)
    with torch.no_grad():
        got = gen.train()(torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _params, stats = generator_tree(gen.state_dict())
    for k in ("bn1", "bn2"):
        np.testing.assert_allclose(stats[k]["mean"], np.asarray(new_state[k].mean), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(stats[k]["var"], np.asarray(new_state[k].var), rtol=1e-5,
                                   atol=1e-7)
    before = copy.deepcopy(gen.state_dict())
    with torch.no_grad():
        gen.eval()(torch.tensor(z))
    for k, v in gen.state_dict().items():
        assert torch.equal(v, before[k]), k


def _assert_step_close(port, jtree, grads, what):
    """Weights where the step's gradient is clear of rounding, moments and
    BN statistics, as the module docstring states."""
    got = port.tree()
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(grads))
    for part in ("gen_params", "disc_params"):
        for g, a, b in zip(jax.tree.leaves(grads[part]), jax.tree.leaves(got[part]),
                           jax.tree.leaves(jtree[part])):
            sure = (np.abs(g) > 1e-2 * np.abs(g).max()) & (np.abs(g) > 1e-4 * top)
            np.testing.assert_allclose(a[sure], b[sure], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{what} {part}")
    for part in ("opt_g", "opt_d"):
        for moment in ("mu", "nu"):
            want = jax.tree.leaves(jtree[part][0][moment])
            top = max(float(np.abs(b).max()) for b in want)
            for a, b in zip(jax.tree.leaves(got[part][0][moment]), want):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=1e-4 * np.abs(b).max() + 1e-5 * top,
                                           err_msg=f"{what} {part} {moment}")
        assert int(got[part][0]["count"]) == int(jtree[part][0]["count"])
    for a, b in zip(jax.tree.leaves(got["gen_state"]), jax.tree.leaves(jtree["gen_state"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=f"{what} gen_state")
    assert int(got["step"]) == int(jtree["step"])


def _grads(port):
    """The gradients the last step applied, as a tree like the state's."""
    from gan_discovery_pso_tpu_torch.compat import discriminator_tree, generator_params_tree

    return {"gen_params": generator_params_tree({k: p.grad.clone() for k, p in
                                                 port.gen.named_parameters()}),
            "disc_params": discriminator_tree({k: p.grad.clone() for k, p in
                                               port.disc.named_parameters()})}


def test_two_gan_steps_match_jax():
    """Two steps of `make_gan_train_step` (DCGAN init, the shipped Adam),
    fed the JAX package's noise and label draws: both losses within rtol
    1e-5; after each, the weights, Adam's moments, the count and G's BN
    statistics as the module docstring states. Before the second step the
    port takes the JAX package's whole state (`load_tree` of a JAX tree)."""
    jstate, jtree = _jax_state()
    port = _port_state(jtree)
    jstep = jax.jit(jdcgan.make_gan_train_step(JGeneratorDef(Z, 1, F_), JAdamConfig(**ADAM)))
    step = make_gan_train_step(port)
    real = _real()
    for i in range(2):
        if i:
            port.load_tree(_host(_plainify(jstate)))
        key = jax.random.key(100 + i)
        jstate, jm = jstep(jstate, jnp.asarray(real), key)
        m = step(torch.tensor(real), _jax_draws(key, real.shape[0]))
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        _assert_step_close(port, _host(_plainify(jstate)), _grads(port), f"step {i}")


def test_g_step_leaves_only_the_d_loss_in_d_grad():
    """After a step D's `.grad` is the D loss's gradient at the pre-step
    weights (rtol 1e-6): the G step's backward through D adds nothing, and
    D's weights keep requires_grad. G's running statistics moved once: they
    equal one train-mode forward of the pre-step G on the step's noise."""
    _jstate, jtree = _jax_state(seed=3)
    port = _port_state(jtree)
    gen0, disc0 = copy.deepcopy(port.gen), copy.deepcopy(port.disc)
    real = torch.tensor(_real())
    noise, y_real, y_fake = _jax_draws(jax.random.key(7), real.shape[0])
    make_gan_train_step(port)(real, (noise, y_real, y_fake))
    fake = gen0.train()(noise).detach()
    loss_d = (bce_from_logits(disc0.logits(real), y_real)
              + bce_from_logits(disc0.logits(fake), y_fake)) / 2.0
    want = torch.autograd.grad(loss_d, list(disc0.parameters()))
    for p, g in zip(port.disc.parameters(), want):
        assert p.requires_grad
        torch.testing.assert_close(p.grad, g, rtol=1e-6, atol=0)
    for (name, a), b in zip(gen0.named_buffers(), port.gen.buffers()):
        if "running" in name:
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert port.step == 1


@pytest.mark.parametrize("opt", [{}, {"weight_decay": 1e-4}, {"name": "RMSprop"}],
                         ids=["adam", "adam_weight_decay", "rmsprop"])
def test_train_state_tree_has_the_jax_layout(opt):
    """The port's state tree after one step has the layout of the JAX
    package's `GanTrainState` for each optimizer its config allows: the same
    nesting, shapes and dtypes (optax's chains as lists, an empty dict for
    each stateless link); `load_tree(tree())` gives it back bit for bit."""
    adam = {**ADAM, **opt}
    _jstate, want = _jax_state(adam=adam)
    port = _port_state(want, adam=adam)
    make_gan_train_step(port)(torch.tensor(_real()), _jax_draws(jax.random.key(1), 6))
    tree = port.tree()
    assert (jax.tree.structure(tree) == jax.tree.structure(want))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = _port_state(tree, adam=adam)
    for a, b in zip(jax.tree.leaves(again.tree()), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_save_best_is_byte_equal_to_jax(tmp_path):
    """`Checkpointer.save_best` writes the JAX package's bytes for the same
    GAN state tree and loss."""
    _jstate, jtree = _jax_state()
    Checkpointer(tmp_path / "port").save_best("g", 3, jtree, loss=0.25)
    JCheckpointer(tmp_path / "jax").save_best("g", 3, jtree, loss=0.25)
    assert ((tmp_path / "port" / "best_g.msgpack").read_bytes()
            == (tmp_path / "jax" / "best_g.msgpack").read_bytes())


@pytest.mark.parametrize("start", [1, 0])
def test_metrics_writer_drop_rows_from(tmp_path, start):
    """The JAX package's tests/test_misc_coverage.py:94,123: the jsonl is cut
    at `start`, the kept rows seed the csv, and the re-run rows follow."""
    import csv

    mw = MetricsWriter(tmp_path, "h")
    for s in range(3):
        mw.append(s, loss=float(s))
    mw.close()
    mw2 = MetricsWriter(tmp_path, "h")
    mw2.drop_rows_from(start)
    for s in range(start, 3):
        mw2.append(s, loss=10.0 * s + 1)
    want = [float(s) for s in range(start)] + [10.0 * s + 1 for s in range(start, 3)]
    mw2.close()
    rows = [json.loads(line) for line in open(tmp_path / "h.jsonl")]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert [r["loss"] for r in rows] == want
    with open(tmp_path / "h.csv") as f:
        assert [float(r["loss"]) for r in csv.DictReader(f)] == want


# -- the stage -------------------------------------------------------------------


def _write_idx(raw, n_train=200, n_test=80):
    raw.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(0)
    for split, n in (("train", n_train), ("t10k", n_test)):
        images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = (np.arange(n) % 10).astype(np.uint8)
        rs.shuffle(labels)
        (raw / f"{split}-images-idx3-ubyte").write_bytes(
            struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
        (raw / f"{split}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 0x801, n) + labels.tobytes())


def _names(d):
    return sorted(p.relative_to(d).as_posix() for p in d.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """idx data, a CAE (latent 6) and a KNN battery on 8 IiD classes, both
    written by the JAX package; then `dcgan --tiny` through each package's
    CLI for 1 epoch, each on its own run dirs."""
    root = tmp_path_factory.mktemp("dcgan")
    _write_idx(root / "data" / "MNIST" / "raw")
    state, _ = cae_init(jax.random.key(1), JCAEDef(6), JAdamConfig())
    cae = root / "up" / "cae"
    jax_save_pytree(cae / "encoder.msgpack", {"params": state.enc_params,
                                              "state": state.enc_state})
    jax_save_pytree(cae / "decoder.msgpack", {"params": state.dec_params,
                                              "state": state.dec_state})
    emb = np.random.RandomState(3).randn(80, 6).astype(np.float32)
    labels = np.array([IID[i % len(IID)] for i in range(80)])
    cls = root / "up" / "cls"
    jax_save_battery(cls / "classifiers.msgpack", jax_train_battery(emb, labels, k=5))
    out = {"root": root, "cae": cae, "cls": cls}
    for who, main, device in (("jax", jax_cli_main, []), ("port", cli_main, ["--device", "cpu"])):
        assert main(["dcgan", "--cfg", CFG, "--tiny", "--epochs", "1", *device,
                     "--path-cae", str(cae), "--path-classifiers", str(cls),
                     *_sets(root, who)]) == 0
        out[who] = _run_dirs(root, who)
    return out


def _sets(root, name, **extra):
    sets = {"data.data_dir": str(root / "data"), "trainer_gan.batch_size": 16,
            **{f"data.{k}_dir": str(root / name / k) for k in ("reports", "model", "interim")},
            **extra}
    return ["--set", *(f"{k}={v}" for k, v in sets.items())]


def _run_dirs(root, name, run_id=1):
    return {k: root / name / k / "mnist" / f"{run_id:05d}--dcgan"
            for k in ("reports", "model", "interim")}


def _ctx(upstream, name, run_id=None):
    root = upstream["root"]
    overrides = {"data.data_dir": str(root / "data"), "trainer_gan.batch_size": 16,
                 "trainer_gan.z_dim": Z, "model_gan.network.units_gen": F_,
                 "model_gan.network.units_disc": F_,
                 **{f"data.{k}_dir": str(root / name / k) for k in ("reports", "model",
                                                                     "interim")}}
    return StageContext.create(CFG, "dcgan", overrides=overrides, run_id=run_id, device="cpu")


def _cae_battery(upstream):
    return (load_cae(upstream["cae"], device="cpu"),
            load_battery(upstream["cls"] / "classifiers.msgpack", device="cpu"))


def test_cli_dcgan_tiny_writes_the_jax_artifacts(upstream):
    """`dcgan --tiny` through both CLIs: the same file names in every run
    dir, one epoch of history with a finite FID, and the stage's figures
    and superimage (JAX tests/test_pipeline_e2e.py:140)."""
    for part in ("reports", "model", "interim"):
        names = [_names(upstream[who][part]) for who in ("jax", "port")]
        assert names[0] == names[1], part
    run = upstream["port"]
    for name in ("training_plot/train_loss.png", "training_plot/fid.png",
                 "training_plot/is.png", "general/synthetic_images_0.png"):
        assert (run["reports"] / name).exists(), name
    hist = load_pytree(run["reports"] / "general" / "history_gan.msgpack")
    assert len(hist["fid"]) == 1 and np.isfinite(hist["fid"]).all()
    assert len(hist["loss_gen"]) == 10  # 160 IiD train images in batches of 16


def test_each_package_reads_the_others_best_g(upstream):
    """JAX's `load_gan` reads the port's best_g and the port's reads JAX's:
    G's images on the same z within rtol 1e-5 (atol 1e-6)."""
    z = np.random.RandomState(5).randn(3, Z, 1, 1).astype(np.float32)
    for who in ("jax", "port"):
        gp, gs = jax_load_gan(upstream[who]["model"])
        want = generator_forward(gp, gs, jnp.asarray(z))
        with torch.no_grad():
            got = load_gan(upstream[who]["model"], device="cpu")(torch.tensor(z))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _copy_run(upstream, who, name):
    """A copy of a CLI run's dirs under `name`, run id 1."""
    import shutil

    dst = _run_dirs(upstream["root"], name)
    for k, d in upstream[who].items():
        shutil.copytree(d, dst[k])
    return dst


def test_port_resumes_a_jax_checkpoint_and_jax_resumes_the_ports(upstream):
    """`--resume-id 1 --epochs 1` of each CLI on a copy of the OTHER
    package's run: the resumed run starts from that checkpoint (the state
    each package restores equals the file's), and ends with 2 epochs of
    history, checkpoint epoch 1, and the first epoch's per-step losses kept
    as the other package wrote them."""
    root = upstream["root"]
    for who, other, main, device in (("port", "jax", cli_main, ["--device", "cpu"]),
                                     ("jax", "port", jax_cli_main, [])):
        dirs = _copy_run(upstream, other, f"{who}_resumes_{other}")
        before = load_pytree(dirs["reports"] / "general" / "history_gan.msgpack")
        if who == "port":
            tree = restore_tree(load_pytree(dirs["model"] / "checkpoint_g.msgpack")["state"])
            restored = _port_state(tree).tree()
            for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
                np.testing.assert_array_equal(a, b)
        assert main(["dcgan", "--cfg", CFG, "--tiny", "--epochs", "1", *device, "--resume-id",
                     "1", "--path-cae", str(upstream["cae"]), "--path-classifiers",
                     str(upstream["cls"]), *_sets(root, f"{who}_resumes_{other}")]) == 0
        ck = jax_load_pytree(dirs["model"] / "checkpoint_g.msgpack")
        assert int(ck["epoch"]) == 1 and int(ck["state"]["step"]) == 20
        hist = load_pytree(dirs["reports"] / "general" / "history_gan.msgpack")
        assert len(hist["fid"]) == 2 and len(hist["loss_gen"]) == 20
        np.testing.assert_array_equal(hist["loss_gen"][:10], before["loss_gen"])


def test_dcgan_resume_restores_history_and_epoch(upstream):
    """The JAX package's tests/test_pipeline_e2e.py:540 on the port: a
    resume in the same run dir reloads the history and continues at the
    checkpoint's epoch + 1."""
    dirs = _copy_run(upstream, "port", "port_resume")
    ctx = _ctx(upstream, "port_resume", run_id=1)
    _state, hist = run_dcgan(ctx, *_cae_battery(upstream), epochs=1, n_synthetic=64,
                             resume=True)
    assert len(hist["fid"]) == 2
    assert ctx.ckpt.load("checkpoint_g.msgpack")["epoch"] == 1
    assert ctx.run.models_dir == dirs["model"]


def test_dcgan_resume_reconciles_history_ahead_of_checkpoint(upstream):
    """tests/test_pipeline_e2e.py:561 on the port: a history one epoch AHEAD
    of the checkpoint (a kill between the two writes) is cut back, the
    epoch re-runs once, and the jsonl keeps one row per epoch."""
    from gan_discovery_pso_tpu_torch.core.checkpoint import save_pytree

    dirs = _copy_run(upstream, "port", "port_desync")
    hist_file = dirs["reports"] / "general" / "history_gan.msgpack"
    h = {k: np.asarray(v) for k, v in load_pytree(hist_file).items()}
    steps = len(h["loss_gen"])
    save_pytree(hist_file, {k: np.concatenate([v, v]) for k, v in h.items()})
    ctx = _ctx(upstream, "port_desync", run_id=1)
    _state, hist = run_dcgan(ctx, *_cae_battery(upstream), epochs=1, n_synthetic=64,
                             resume=True)
    assert len(hist["fid"]) == 2 and len(hist["loss_gen"]) == 2 * steps
    rows = [json.loads(line) for line in open(dirs["reports"] / "history_gan.jsonl")]
    assert sorted(r["step"] for r in rows) == [0, 1]


def test_dcgan_kill_and_resume_bit_identical(upstream):
    """tests/test_pipeline_e2e.py:598 on the port: 1 epoch, then a resume
    for 1 more, gives checkpoint_g.msgpack and history_gan.msgpack byte-equal
    to a single 2-epoch run's (draws keyed by the absolute (epoch, step))."""
    cae, battery = _cae_battery(upstream)
    files = {}
    for name, legs in (("single", (2,)), ("killed", (1, 1))):
        for i, epochs in enumerate(legs):
            ctx = _ctx(upstream, name, run_id=1 if i else None)
            run_dcgan(ctx, (cae[0], cae[1]), battery, epochs=epochs, n_synthetic=64,
                      resume=bool(i))
        files[name] = [(ctx.run.models_dir / "checkpoint_g.msgpack").read_bytes(),
                       (ctx.run.general_dir / "history_gan.msgpack").read_bytes()]
    assert files["single"] == files["killed"]


def test_dcgan_and_the_vqvae_stages_are_ported(capsys):
    """Every subcommand of the JAX CLI is one of the port's: none is left
    unported, dcgan and the VQ-VAE stages among them."""
    with pytest.raises(SystemExit):
        jax_cli_main(["--help"])
    usage = re.search(r"\{([^}]*)\}", capsys.readouterr().out).group(1)
    jax_stages = set(usage.split(","))
    port_stages = set(_parser()._subparsers._group_actions[0].choices)
    assert {"dcgan", "vqvae", "pixelcnn-prior"} <= jax_stages == port_stages
