"""The port's `inverter`, `regularize-inverter` and
`regularize-inverter-statistics` stages against the JAX package's on the
CPU, on checkpoint files the JAX package wrote: through both CLIs where the
draws need not agree (the artifact sets, the history keys, the encoder
checkpoint read back by the JAX loaders), and through the stage functions
where they must (the inversions). Tiny sizes: G z=8 f=8 (torch's default
init), the plain encoder z=8 f=8, ResNet-50 with the shipped 8 IiD classes,
120 train and 120 test idx images, batches of 16, PSO particles of 16 per
class."""

import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.cli.main import main as jax_cli_main
from gan_discovery_pso_tpu.core.checkpoint import load_pytree as jax_load_pytree
from gan_discovery_pso_tpu.core.checkpoint import save_pytree as jax_save_pytree
from gan_discovery_pso_tpu.core.prng import KeyChain as JKeyChain
from gan_discovery_pso_tpu.models import encoder_attgan_apply
from gan_discovery_pso_tpu.models.encoder import EncoderDef as JEncoderDef
from gan_discovery_pso_tpu.models.encoder import encoder_apply, encoder_init
from gan_discovery_pso_tpu.pipelines import StageContext as JStageContext
from gan_discovery_pso_tpu.pipelines.stages import load_encoder as jax_load_encoder
from gan_discovery_pso_tpu.pipelines.stages import load_gan as jax_load_gan
from gan_discovery_pso_tpu.pipelines.stages import (
    run_regularize_inverter_statistics as jax_run_statistics,
)
from gan_discovery_pso_tpu.pso.io import save_particle_histories as jax_save_particles
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import (
    encoder_attgan_state_dict,
    generator_tree,
    resnet_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core import load_config
from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree, restore_tree
from gan_discovery_pso_tpu_torch.models import (
    EncoderAttGAN,
    EncoderAttGANDef,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    glorot_normal_init_,
)
from gan_discovery_pso_tpu_torch.pipelines import (
    StageContext,
    load_encoder,
    load_gan,
    run_regularize_inverter_statistics,
)

CFG = "configs/dcgan_mnist.yaml"
IID = (0, 2, 3, 4, 6, 7, 8, 9)
Z = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_idx(raw, n=120):
    """Seeded train and test idx files, labels 0-9 shuffled."""
    raw.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(0)
    for stem in ("train", "t10k"):
        images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = (np.arange(n) % 10).astype(np.uint8)
        rs.shuffle(labels)
        (raw / f"{stem}-images-idx3-ubyte").write_bytes(
            struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
        (raw / f"{stem}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 0x801, n) + labels.tobytes())


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """Files the JAX package wrote: G, the plain encoder, the 8-class
    ResNet-50, a pso-discovery interim dir (16 final particles per IiD
    class), idx data."""
    root = tmp_path_factory.mktemp("upstream")
    _write_idx(root / "data" / "MNIST" / "raw")
    models = root / "models" / "mnist"
    torch.manual_seed(0)
    gp, gs = generator_tree(Generator(GeneratorDef(Z, 1, 8)).state_dict())
    jax_save_pytree(models / "00001--dcgan" / "best_g.msgpack",
                    {"epoch": 0, "state": {"gen_params": gp, "gen_state": gs}, "loss": 0.5})
    ep, _ = jax.jit(lambda k: encoder_init(k, JEncoderDef(Z, 1, 8), dcgan_init=False))(
        jax.random.key(2))
    jax_save_pytree(models / "00001--inverter" / "encoder.msgpack", {"params": ep})
    net = glorot_normal_init_(ResNet(ResNetDef("ResNet50", 1, len(IID), IID)),
                              torch.Generator().manual_seed(1))
    rp, rs = resnet_tree(net.state_dict())
    jax_save_pytree(models / "00001--cnn_multipatient" / "model.msgpack",
                    {"params": rp, "state": rs})
    pso = root / "interim" / "mnist" / "00001--pso_discovery"
    prs = np.random.RandomState(3)
    for c in IID:
        traj = prs.randn(3, 16, Z).astype(np.float32)
        jax_save_particles(pso, c, traj, np.zeros_like(traj))
    return {"root": root, "pso": pso,
            "dirs": {"gan": models / "00001--dcgan", "inv": models / "00001--inverter",
                     "cnn": models / "00001--cnn_multipatient"}}


def _sets(root, name, **extra):
    sets = {"trainer_gan.z_dim": Z, "model_inverter.latent_space": Z,
            "trainer_inverter.batch_size": 16, "data.data_dir": str(root / "data"),
            **{f"data.{k}_dir": str(root / name / k) for k in ("reports", "model", "interim")},
            **extra}
    return [f"{k}={v}" for k, v in sets.items()]


def _run_dirs(root, name, module):
    return {k: root / name / k / "mnist" / f"00001--{module}"
            for k in ("reports", "model", "interim")}


def _names(d):
    return sorted(p.relative_to(d).as_posix() for p in d.rglob("*") if p.is_file())


def _both_clis(upstream, stage, label, *flags, **extra):
    """The stage through the JAX CLI and the port's (`--device cpu`), each
    on its own run dirs: ({'jax': dirs, 'port': dirs})."""
    root, dirs = upstream["root"], upstream["dirs"]
    paths = ["--path-gan", str(dirs["gan"])]
    if stage == "inverter":
        paths += ["--path-cnn", str(dirs["cnn"])]
    else:
        paths += ["--path-inverter", str(dirs["inv"])]
    if stage == "regularize-inverter-statistics":
        paths += ["--path-pso", str(upstream["pso"])]
    out = {}
    for who, main, device in (("jax", jax_cli_main, []), ("port", cli_main, ["--device", "cpu"])):
        name = f"{who}_{label}"
        rc = main([stage, "--cfg", CFG, "--tiny", *device, *flags, *paths,
                   "--set", *_sets(root, name, **extra)])
        assert rc == 0, who
        out[who] = _run_dirs(root, name, stage.replace("-", "_"))
    return out


def _same_artifacts(runs):
    for sub in ("reports", "model", "interim"):
        assert _names(runs["port"][sub]) == _names(runs["jax"][sub]), sub


def _history(dirs):
    with open(dirs["reports"] / "general" / "overall_history.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("variant", ["dcgan", "attgan"])
@pytest.mark.parametrize("training_function", ["pix_rec", "pix_fea_rec_adv"])
def test_cli_inverter_writes_the_jax_stage_layout(upstream, variant, training_function):
    """`inverter --tiny --limit 16` (1 epoch: one batch of 16 in each of
    the train, val IiD and val OoD phases) in each branch through both
    CLIs: the same artifact names, the same history keys in the same
    order, finite losses; the port's `encoder.msgpack` read by the JAX
    loaders (`load_encoder` for the plain encoder, `load_pytree` with the
    `variant` tag for AttGAN) gives the port encoder's forward within rtol
    1e-5."""
    branch = {"model_inverter.encoder_variant": variant,
              "trainer_inverter.training_function": training_function}
    runs = _both_clis(upstream, "inverter", f"inv_{variant}_{training_function}",
                      "--limit", "16", **branch)
    _same_artifacts(runs)
    hist, want = _history(runs["port"]), _history(runs["jax"])
    assert list(hist) == list(want)
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in hist.values()), hist
    models = runs["port"]["model"]
    x = np.random.RandomState(5).rand(6, 1, 28, 28).astype(np.float32) * 2 - 1
    if variant == "dcgan":
        ref, _ = encoder_apply(jax_load_encoder(models), {}, jnp.asarray(x))
        enc = load_encoder(models, device="cpu")
    else:
        d = jax_load_pytree(models / "encoder.msgpack")
        assert d["variant"] in ("attgan", b"attgan") and set(d) == {"params", "state", "variant"}
        state = {k: _stats(v) for k, v in d["state"].items()}
        ref, _ = encoder_attgan_apply(jax.tree.map(jnp.asarray, d["params"]), state,
                                      jnp.asarray(x), train=False)
        mine = restore_tree(load_pytree(models / "encoder.msgpack"))
        enc = EncoderAttGAN(EncoderAttGANDef(Z, 1))
        enc.load_state_dict(to_tensors(encoder_attgan_state_dict(mine["params"], mine["state"])),
                            strict=True)
        enc.eval()
        with pytest.raises(ValueError, match="AttGAN"):
            load_encoder(models, device="cpu")
    with torch.no_grad():
        got = enc(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


def _stats(node):
    from gan_discovery_pso_tpu.ops.norm import BatchNormStats

    return BatchNormStats(jnp.asarray(node["mean"]), jnp.asarray(node["var"]))


def test_cli_regularize_inverter_matches_jax(upstream):
    """`regularize-inverter --tiny` (the first 8 OoD test images, 50
    iterations) through both CLIs: the inverted z within rtol 1e-4 atol
    1e-5, the history within rtol 1e-4, the DataFrame of 8 rows (z and a
    uint8 label column) equal within the same tolerance, the same artifact
    names; the loss falls."""
    runs = _both_clis(upstream, "regularize-inverter", "reg")
    _same_artifacts(runs)
    with np.load(runs["port"]["interim"] / "inverted_z.npz") as got, \
            np.load(runs["jax"]["interim"] / "inverted_z.npz") as want:
        assert got["z"].shape == (8, Z, 1, 1)
        np.testing.assert_allclose(got["z"], want["z"], rtol=1e-4, atol=1e-5)
    hist, want = _history(runs["port"]), _history(runs["jax"])
    assert list(hist) == list(want) == ["loss", "loss_pix", "loss_reg"]
    for k in want:
        assert len(hist[k]) == 51
        np.testing.assert_allclose(hist[k], want[k], rtol=1e-4, err_msg=k)
    assert hist["loss"][-1] < hist["loss"][0]
    _same_frame(runs)


def _same_frame(runs):
    frames = []
    for who in ("port", "jax"):
        with open(runs[who]["interim"] / "particles_position_ood.pkl", "rb") as f:
            frames.append(pickle.load(f))
    got, want = frames
    assert got.shape == want.shape == (8, Z + 1)
    assert got.iloc[:, -1].dtype == want.iloc[:, -1].dtype == np.uint8
    assert list(got.iloc[:, -1]) == list(want.iloc[:, -1])
    assert set(got.iloc[:, -1]) <= {1, 5}  # the OoD classes
    np.testing.assert_allclose(got.iloc[:, :-1].to_numpy(), want.iloc[:, :-1].to_numpy(),
                               rtol=1e-4, atol=1e-5)


def test_regularize_inverter_statistics_matches_jax(upstream):
    """The stage function fed the JAX stage's w0 (its first `invert_bn`
    draw), 15 iterations on the first 8 OoD test images against the 8 IiD
    classes' particles: z and w within 1e-4 absolute (the mix divides by
    Σw and magnifies rounding, `test_torch_port_inverter_train.py`), the
    history within rtol 1e-5, the npz and the DataFrame alike."""
    root, dirs = upstream["root"], upstream["dirs"]
    sets = dict(s.split("=", 1) for s in _sets(root, "stats"))
    overrides = {k: (int(v) if v.isdigit() else v) for k, v in sets.items()}
    jctx = JStageContext.create(CFG, "regularize_inverter_statistics", overrides={
        **overrides, **{f"data.{k}_dir": str(root / "jstats" / k)
                        for k in ("reports", "model", "interim")}})
    pctx = StageContext.create(CFG, "regularize_inverter_statistics", device="cpu",
                               overrides=overrides)
    jds = jctx.dataset("test", classes=jctx.data_cfg.ood_classes, drange=(-1, 1))
    ds = pctx.dataset("test", classes=pctx.data_cfg.ood_classes, drange=(-1, 1))
    np.testing.assert_array_equal(ds.images[:8].numpy(), np.asarray(jds.images[:8]))
    labels = ds.labels[:8].numpy()
    gp, gs = jax_load_gan(dirs["gan"])
    jz, jw, jhist = jax_run_statistics(jctx, gp, gs, jax_load_encoder(dirs["inv"]),
                                       jds.images[:8], upstream["pso"], iterations=15,
                                       labels=labels)
    seed = int(load_config(CFG).seed)
    w0 = np.asarray(jax.random.normal(JKeyChain(seed)("invert_bn"), (8, len(IID)),
                                      jnp.float32))
    z, w, hist = run_regularize_inverter_statistics(
        pctx, load_gan(dirs["gan"], device="cpu"), load_encoder(dirs["inv"], device="cpu"),
        ds.images[:8], upstream["pso"], iterations=15, labels=labels, w0=w0)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-4)
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-5, err_msg=k)
    runs = {"port": {"interim": pctx.run.interim_dir, "reports": pctx.run.reports_dir},
            "jax": {"interim": jctx.run.interim_dir, "reports": jctx.run.reports_dir}}
    with np.load(runs["port"]["interim"] / "inverted_bn_z.npz") as a, \
            np.load(runs["jax"]["interim"] / "inverted_bn_z.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["weights", "z"]
        for key in ("z", "weights"):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-4)
    _same_frame(runs)
    for sub in ("reports", "interim"):
        assert _names(runs["port"][sub]) == _names(runs["jax"][sub]), sub


def test_cli_regularize_inverter_statistics_writes_the_jax_stage_layout(upstream):
    """`regularize-inverter-statistics --tiny` through both CLIs (each
    drawing its own w0): the same artifact names and history keys, finite
    losses that fall."""
    runs = _both_clis(upstream, "regularize-inverter-statistics", "stats_cli")
    _same_artifacts(runs)
    hist, want = _history(runs["port"]), _history(runs["jax"])
    assert list(hist) == list(want) == ["loss", "loss_pix"]
    assert len(hist["loss"]) == 51 and np.isfinite(hist["loss"]).all()
    assert hist["loss"][-1] < hist["loss"][0]


@pytest.mark.parametrize("stage", ["inverter", "regularize-inverter",
                                   "regularize-inverter-statistics"])
def test_cli_gradient_stage_without_device_raises_on_a_host_without_cuda(
        stage, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main([stage, "--cfg", CFG, "--path-gan", str(tmp_path), "--set", *roots])
    assert not (tmp_path / "reports").exists()  # raised before any run dir


def test_cli_statistics_needs_path_pso(upstream, tmp_path):
    dirs = upstream["dirs"]
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    with pytest.raises(SystemExit, match="--path-pso required"):
        cli_main(["regularize-inverter-statistics", "--cfg", CFG, "--tiny", "--device", "cpu",
                  "--path-gan", str(dirs["gan"]), "--path-inverter", str(dirs["inv"]),
                  "--set", *roots, f"data.data_dir={upstream['root'] / 'data'}",
                  f"trainer_gan.z_dim={Z}"])
