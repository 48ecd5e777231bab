"""The port's remaining tools against the JAX package's on the CPU:
`convert-torch` (byte-equal msgpack for all eight models), `export-torch`
(equal state dicts, `{params, state}` saves and the GAN `.tar`), both error
paths of each, `export-model generator|fitness` (a `torch.export` artifact
bit-equal to the port's own forward and within rtol 1e-5 of the JAX
artifact on the same weights; the fitness graph holds B2's registered
operator), the latent-dim and per-patient `sweep`, the GPU lock (the six
cases of `tests/test_tpulock.py` and its re-entrancy), and profiling (spans
and the Chrome trace).
Tiny sizes: G and D with z 8 and f 8, batch 4; the ResNets at their fixed
widths with one input channel."""

import argparse
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import gan_discovery_pso_tpu.cli.main as jax_cli
from gan_discovery_pso_tpu.compat.export import load_exported as jax_load_exported
from gan_discovery_pso_tpu.compat.torch_export import (
    export_torch_checkpoint as jax_export_torch,
)
from gan_discovery_pso_tpu.compat.torch_import import (
    convert_torch_checkpoint as jax_convert_torch,
)
from gan_discovery_pso_tpu.core.checkpoint import save_pytree as jax_save_pytree
import gan_discovery_pso_tpu_torch.cli.main as port_cli
from gan_discovery_pso_tpu_torch.compat import generator_tree, resnet_tree
from gan_discovery_pso_tpu_torch.compat.export import load_exported
from gan_discovery_pso_tpu_torch.compat.torch_export import export_torch_checkpoint
from gan_discovery_pso_tpu_torch.compat.torch_import import convert_torch_checkpoint
from gan_discovery_pso_tpu_torch.core import gpulock, profiling, trace
from gan_discovery_pso_tpu_torch.core.checkpoint import save_pytree
from gan_discovery_pso_tpu_torch.models import (
    CAEDecoder,
    CAEDef,
    CAEEncoder,
    Discriminator,
    DiscriminatorDef,
    Encoder,
    EncoderDef,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    torch_default_init_,
)
from gan_discovery_pso_tpu_torch.ops import fp32_parity
from gan_discovery_pso_tpu_torch.pso.fitness import make_discovery_fitness_dynamic

CFG = "configs/dcgan_mnist.yaml"
Z, F_, BATCH = 8, 8, 4
IID = (0, 2, 3, 4, 6, 7, 8, 9)
RTOL = 1e-5  # the fitness tolerance of tests/test_torch_port_slice.py:96
_RESNETS = {"resnet50": "ResNet50", "resnet101": "ResNet101", "resnet152": "ResNet152"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _module(model: str) -> torch.nn.Module:
    """The port's module of a reference model name (its state-dict names are
    the reference's), on the meta device: only its names and shapes are
    read."""
    kw = {"device": "meta"}
    if model in _RESNETS:
        return ResNet(ResNetDef(_RESNETS[model], 1, len(IID)), **kw)
    return {"generator": lambda: Generator(GeneratorDef(Z, 1, F_), **kw),
            "discriminator": lambda: Discriminator(DiscriminatorDef(1, F_), **kw),
            "encoder": lambda: Encoder(EncoderDef(Z, 1, F_), **kw),
            "cae_encoder": lambda: CAEEncoder(CAEDef(6), **kw),
            "cae_decoder": lambda: CAEDecoder(CAEDef(6), **kw)}[model]()


def _reference_state_dict(model: str, seed: int = 0) -> dict:
    """A reference checkpoint's state dict of `model`: numpy-seeded values
    (running variances positive), the BN counters int64."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in _module(model).state_dict().items():
        if v.dtype == torch.int64:
            sd[k] = torch.tensor(int(rng.integers(0, 100)))
        else:
            a = rng.standard_normal(tuple(v.shape), dtype=np.float32)
            sd[k] = torch.from_numpy(np.abs(a) + 0.5 if k.endswith("running_var") else a)
    return sd


def _save_reference(tmp_path, model: str) -> str:
    """The generator as the reference's `.tar` (best_g), the rest bare `.pt`."""
    sd = _reference_state_dict(model)
    if model == "generator":
        path = tmp_path / "best_g.tar"
        torch.save({"epoch": 7, "model_state_dict": sd, "loss": 0.25}, path)
    else:
        path = tmp_path / f"{model}.pt"
        torch.save(sd, path)
    return str(path)


# -- convert-torch and export-torch ----------------------------------------------


@pytest.mark.parametrize("model", ["generator", "discriminator", "encoder", "cae_encoder",
                                   "cae_decoder", "resnet50", "resnet101", "resnet152"])
def test_convert_torch_is_byte_equal_to_jax(model, tmp_path, capsys):
    """`convert-torch SRC MODEL DST` through the port's CLI writes the bytes
    JAX's `convert_torch_checkpoint` writes."""
    src = _save_reference(tmp_path, model)
    assert port_cli.main(["convert-torch", src, model, str(tmp_path / "port.msgpack")]) == 0
    assert capsys.readouterr().out.startswith("[convert-torch]")
    jax_convert_torch(src, model, dst=tmp_path / "jax.msgpack")
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def _assert_same_checkpoint(a_path, b_path):
    a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in (a_path, b_path))
    if "model_state_dict" in b:
        assert (a["epoch"], a["loss"]) == (b["epoch"], b["loss"])
        a, b = a["model_state_dict"], b["model_state_dict"]
    assert a.keys() == b.keys()  # load_state_dict(strict=True) reads names, not their order
    for k in b:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("model", ["cae_encoder", "encoder", "resnet50"])
def test_export_torch_of_a_state_dict_save_equals_jax(model, tmp_path, capsys):
    """`export-torch` of a `{params, state}` save gives JAX's state dict:
    the same names, dtypes and values."""
    save = tmp_path / "model.msgpack"
    convert_torch_checkpoint(_save_reference(tmp_path, model), model, dst=save)
    assert port_cli.main(["export-torch", str(save), model, str(tmp_path / "port.pt")]) == 0
    assert capsys.readouterr().out.startswith("[export-torch]")
    jax_export_torch(save, model, tmp_path / "jax.pt")
    _assert_same_checkpoint(tmp_path / "port.pt", tmp_path / "jax.pt")


def test_export_torch_of_a_gan_checkpoint_to_tar_equals_jax(tmp_path):
    """A GAN `{epoch, state, loss}` checkpoint to the reference's `.tar`,
    either half: the tensors, epoch and loss equal JAX's."""
    gp, gs = generator_tree(_reference_state_dict("generator"))
    dp = convert_torch_checkpoint(_save_reference(tmp_path, "discriminator"), "discriminator")[0]
    ckpt = tmp_path / "best_g.msgpack"
    jax_save_pytree(ckpt, {"epoch": 3, "loss": 0.75, "state": {
        "gen_params": gp, "gen_state": gs, "disc_params": dp}})
    for model in ("generator", "discriminator"):
        port = export_torch_checkpoint(ckpt, model, tmp_path / f"port_{model}.tar")
        jax_export_torch(ckpt, model, tmp_path / f"jax_{model}.tar")
        _assert_same_checkpoint(port, tmp_path / f"jax_{model}.tar")
    assert torch.load(port, weights_only=True)["epoch"] == 3


def test_convert_torch_errors_name_the_model_like_jax(tmp_path):
    """A state dict of another model: KeyError naming the model and the
    missing key; an unknown model: ValueError listing the choices."""
    src = _save_reference(tmp_path, "generator")
    for convert in (convert_torch_checkpoint, jax_convert_torch):
        with pytest.raises(KeyError, match="enc.0.weight.*'encoder'"):
            convert(src, "encoder")
        with pytest.raises(ValueError, match="unknown model 'vgg'.*resnet152"):
            convert(src, "vgg")
    # a ResNet-50 is not a ResNet-101: the blocks it lacks are missing keys
    with pytest.raises(KeyError, match="layer3.6.*'resnet101'"):
        convert_torch_checkpoint(_save_reference(tmp_path, "resnet50"), "resnet101")


def test_export_torch_errors_name_the_model_like_jax(tmp_path):
    save = tmp_path / "enc.msgpack"
    convert_torch_checkpoint(_save_reference(tmp_path, "encoder"), "encoder", dst=save)
    gan = tmp_path / "gan.msgpack"
    save_pytree(gan, {"epoch": 1, "loss": 0.5, "state": {"gen_params": {}, "gen_state": {}}})
    for export in (export_torch_checkpoint, jax_export_torch):
        with pytest.raises(KeyError, match="'generator'"):
            export(save, "generator", tmp_path / "g.pt")
        with pytest.raises(ValueError, match="unknown model 'vgg'.*resnet152"):
            export(save, "vgg", tmp_path / "v.pt")
        with pytest.raises(ValueError, match="GAN checkpoint.*'encoder'"):
            export(gan, "encoder", tmp_path / "e.pt")


# -- export-model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A torch-default-init G (z 8, f 8: a DCGAN-init G's images are flat in
    z) and a ResNet-50 over the 8 IiD classes as JAX-format checkpoints;
    each package's `export-model generator` and `fitness` of them (class 2,
    batch 4)."""
    root = tmp_path_factory.mktemp("export")
    rng = torch.Generator().manual_seed(0)
    gen = torch_default_init_(Generator(GeneratorDef(Z, 1, F_)), rng).eval()
    cnn = torch_default_init_(ResNet(ResNetDef("ResNet50", 1, len(IID), IID)), rng).eval()
    gp, gs = generator_tree(gen.state_dict())
    save_pytree(root / "gan" / "best_g.msgpack",
                {"epoch": 0, "state": {"gen_params": gp, "gen_state": gs}, "loss": 0.0})
    rp, rs = resnet_tree(cnn.state_dict())
    save_pytree(root / "cnn" / "model.msgpack", {"params": rp, "state": rs})
    sets = ["--set", f"trainer_gan.z_dim={Z}", f"trainer_pso.dim_space={Z}"]
    paths = {}
    for pkg, cli, args in (("port", port_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        for what in ("generator", "fitness"):
            out = root / f"{pkg}_{what}"
            assert cli.main(["export-model", what, str(out), "--cfg", CFG, "--path-gan",
                             str(root / "gan"), "--path-cnn", str(root / "cnn"), "--batch",
                             str(BATCH), "--class-label", "3", *args, *sets]) == 0
            paths[pkg, what] = out
    return {"root": root, "gen": gen, "cnn": cnn, "paths": paths, "sets": sets}


def test_exported_generator_matches_the_port_and_jax(exported):
    z = np.random.RandomState(1).randn(BATCH, Z, 1, 1).astype(np.float32)
    art = load_exported(exported["paths"]["port", "generator"], device="cpu")
    assert art.policy == "fp32_parity"
    got = art.call(torch.tensor(z))
    with fp32_parity(), torch.no_grad():
        want = exported["gen"](torch.tensor(z))
    assert torch.equal(got, want)  # bit for bit
    jax_art = jax_load_exported(exported["paths"]["jax", "generator"])
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_art.call(z)), rtol=RTOL, atol=1e-6)


def test_exported_fitness_matches_the_port_and_jax_through_the_op(exported):
    """The fitness artifact (class label 3 = logit column 2): bit-equal to
    the port's discovery fitness, within rtol 1e-5 of JAX's artifact; its
    graph calls `gdpt::rescale01_rows` once; it runs where it is loaded
    (the meta device here, the card in chip_smoke.py)."""
    pos = np.random.RandomState(2).randn(BATCH, Z).astype(np.float32)
    art = load_exported(exported["paths"]["port", "fitness"], device="cpu")
    ops = [n.target for n in art.program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.gdpt.rescale01_rows.default) == 1
    got = art.call(torch.tensor(pos))
    want = make_discovery_fitness_dynamic(exported["gen"], exported["cnn"], eps=0.1)(pos, 2)
    assert torch.equal(got, want)
    assert float(got.max() - got.min()) > 1e-4  # not a flat fitness
    jax_art = jax_load_exported(exported["paths"]["jax", "fitness"])
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_art.call(pos)), rtol=RTOL)
    # device-neutral: weights, constants and the trace's recorded devices
    # all follow the device it is loaded on
    meta = load_exported(exported["paths"]["port", "fitness"], device="meta")
    out = meta.call(torch.zeros((BATCH, Z), device="meta"))
    assert out.device.type == "meta" and out.shape == (BATCH,)


def test_export_model_refuses_tpu_and_a_foreign_class_like_jax(exported, capsys):
    """--platforms tpu exits 2 with one line; a --class-label outside the
    IiD classes exits with JAX's message; neither writes a file."""
    root, sets = exported["root"], exported["sets"]
    base = ["--cfg", CFG, "--path-gan", str(root / "gan"), "--path-cnn", str(root / "cnn"),
            *sets]
    capsys.readouterr()
    assert port_cli.main(["export-model", "generator", str(root / "tpu"), "--platforms", "tpu",
                          "cpu", "--device", "cpu", *base]) == 2
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and "['tpu']" in err
    codes = []
    for cli, args in ((port_cli, ["--device", "cpu"]), (jax_cli, [])):
        with pytest.raises(SystemExit) as e:
            cli.main(["export-model", "fitness", str(root / "bad"), "--class-label", "1", *args,
                      *base])
        codes.append(e.value.code)
    assert codes[0] == codes[1] and "--class-label 1 is not an IiD class" in codes[0]
    assert not (root / "tpu").exists() and not (root / "bad").exists()


# -- sweep -----------------------------------------------------------------------


def _write_idx(raw, n_train=96, n_test=40, seed=0):
    raw.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("t10k", n_test)):
        images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = (np.arange(n) % 10).astype(np.uint8)
        (raw / f"{split}-images-idx3-ubyte").write_bytes(
            struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
        (raw / f"{split}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 0x801, n) + labels.tobytes())


def test_cli_latent_dim_sweep(tmp_path):
    """tests/test_cli.py:82 on the port: `--stages cae` at dims 4 and 6 is
    two legs, each its own run dir with the leg's dims in its config."""
    import yaml

    _write_idx(tmp_path / "data" / "MNIST" / "raw")
    rc = port_cli.main([
        "sweep", "--latent-dims", "4", "6", "--stages", "cae", "--tiny", "--limit", "96",
        "--device", "cpu", "--set", "trainer_ae.batch_size=32",
        f"data.data_dir={tmp_path / 'data'}", f"data.interim_dir={tmp_path / 'interim'}",
        f"data.model_dir={tmp_path / 'models'}", f"data.reports_dir={tmp_path / 'reports'}"])
    assert rc == 0
    runs = sorted((tmp_path / "models" / "mnist").glob("*--cae"))
    assert [r.name for r in runs] == ["00001--cae", "00002--cae"]
    for run, dim in zip(runs, (4, 6)):
        assert (run / "encoder.msgpack").exists()
        cfg = yaml.safe_load((tmp_path / "reports" / "mnist" / run.name /
                              "configuration.yaml").read_text())
        assert (cfg["trainer_gan"]["z_dim"], cfg["trainer_pso"]["dim_space"],
                cfg["model_inverter"]["latent_space"]) == (dim, dim, dim)


def _sweep_legs(cli, argv, monkeypatch) -> list:
    """The legs `sweep` dispatches, recorded in place of running them."""
    legs = []
    real = cli.dispatch

    def recording(args, *rest):
        if args.stage == "sweep":
            return real(args, *rest)
        legs.append((args.stage, args.ood_patient if args.stage == "pso-inverter" else None,
                     list(args.set)))
        return 0

    monkeypatch.setattr(cli, "dispatch", recording)
    assert cli.main(argv) == 0
    return legs


@pytest.mark.parametrize("sweep,n_legs", [
    (["--patients", "1", "5"], 4),
    (["--patients", "3", "--controls", "optimize_in_training"], 1),
    (["--latent-dims", "2", "10"], 4)])
def test_sweep_legs_are_jax_legs(sweep, n_legs, monkeypatch):
    """The per-patient sweep's patient x control legs and the latent-dim
    sweep's dim x stage legs: the stages, patients and overrides of JAX's
    `cli/main.py:307-334`."""
    argv = ["sweep", *sweep, "--set", "trainer_pso_inverter.n_iterations=3"]
    port = _sweep_legs(port_cli, [*argv, "--device", "cpu"], monkeypatch)
    jax_legs = _sweep_legs(jax_cli, argv, monkeypatch)
    assert port == jax_legs and len(port) == n_legs


# -- the GPU lock (tests/test_tpulock.py) -------------------------------------------


@pytest.fixture
def lockfile(tmp_path, monkeypatch):
    p = tmp_path / "gpu.lock"
    monkeypatch.setenv("GDPT_GPU_LOCK", str(p))
    monkeypatch.delenv("GDPT_NO_GPU_LOCK", raising=False)
    monkeypatch.delenv(gpulock.HOLDER_ENV, raising=False)
    return p


def test_lock_acquires_and_releases(lockfile):
    with gpulock.gpu_lock("t1") as held:
        assert held == lockfile
        info = json.loads(lockfile.read_text())
        assert (info["pid"], info["holder"]) == (os.getpid(), "t1")
        assert gpulock.current_holder() == info
        assert os.environ[gpulock.HOLDER_ENV] == str(os.getpid())
    assert not lockfile.exists() and gpulock.current_holder() is None
    assert gpulock.HOLDER_ENV not in os.environ


def test_lock_reaps_a_stale_holder(lockfile):
    lockfile.write_text(json.dumps({"pid": 2 ** 22 + 12345, "holder": "dead", "started": 0}))
    assert gpulock.current_holder() is None
    with gpulock.gpu_lock("t2", wait_s=10.0, poll_s=0.01):
        assert json.loads(lockfile.read_text())["holder"] == "t2"


def test_lock_reaps_a_corrupt_file(lockfile):
    lockfile.write_text("not json")
    with gpulock.gpu_lock("t3", wait_s=10.0, poll_s=0.01):
        assert json.loads(lockfile.read_text())["holder"] == "t3"


def test_lock_live_holder_blocks_until_timeout(lockfile):
    """A live pid holds the lease (this process, without having taken it
    here): acquisition times out, the file untouched."""
    lockfile.write_text(json.dumps({"pid": os.getpid(), "holder": "live", "started": 0}))
    with pytest.raises(TimeoutError, match="live"):
        with gpulock.gpu_lock("t4", wait_s=0.05, poll_s=0.01):
            pass
    assert json.loads(lockfile.read_text())["holder"] == "live"


def _holder_script(lockfile, hold_s: float) -> str:
    return ("import json, os, time\n"
            f"p = {str(lockfile)!r}\n"
            "open(p, 'w').write(json.dumps({'pid': os.getpid(), 'holder': 'sub', "
            "'started': time.time()}))\n"
            "print('held', flush=True)\n"
            f"time.sleep({hold_s})\n"
            "os.unlink(p)\n")


def test_lock_waits_for_a_real_process_to_release(lockfile):
    proc = subprocess.Popen([sys.executable, "-c", _holder_script(lockfile, 0.4)],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "held"
        with gpulock.gpu_lock("t5", wait_s=30.0, poll_s=0.05):
            assert json.loads(lockfile.read_text())["holder"] == "t5"
    finally:
        proc.wait(timeout=10)


def test_lock_gating(monkeypatch, tmp_path):
    """Not engaged for a stage on the CPU, nor with GDPT_NO_GPU_LOCK=1; the
    card engages it."""
    p = tmp_path / "l"
    monkeypatch.setenv("GDPT_GPU_LOCK", str(p))
    monkeypatch.delenv("GDPT_NO_GPU_LOCK", raising=False)
    assert not gpulock.lock_required("cpu")
    with gpulock.gpu_lock("t6", device="cpu") as held:
        assert held is None
    assert not p.exists()
    assert gpulock.lock_required("cuda") and gpulock.lock_required("cuda:1")
    monkeypatch.setenv("GDPT_NO_GPU_LOCK", "1")
    assert not gpulock.lock_required("cuda")
    monkeypatch.delenv("GDPT_NO_GPU_LOCK")
    monkeypatch.delenv("GDPT_GPU_LOCK")
    assert gpulock.lock_path().name == "gdpt_gpu.lock"


_CHILD = ("import os\n"
          "from gan_discovery_pso_tpu_torch.core import gpulock\n"
          "for inherit in (True, False):\n"
          "    if not inherit:\n"
          "        os.environ.pop(gpulock.HOLDER_ENV)\n"
          "    try:\n"
          "        with gpulock.gpu_lock('child', wait_s=0.2, poll_s=0.01) as held:\n"
          "            print('inherited' if held is None else 'took', flush=True)\n"
          "    except TimeoutError:\n"
          "        print('timeout', flush=True)\n")


def test_lock_is_reentrant_for_the_holders_process_tree(lockfile):
    """Inside the holder: a nested `gpu_lock` (a sweep's leg, an in-process
    stage) runs under the lease and leaves it held; a process the holder
    starts (a --shard-swarm rank) inherits it through GDPT_GPU_LOCK_HOLDER
    and does not wait; without that variable the same process times out."""
    with gpulock.gpu_lock("parent") as held:
        with gpulock.gpu_lock("leg") as nested:
            assert nested is None
        assert json.loads(held.read_text())["holder"] == "parent"
        out = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                             timeout=60, cwd=os.getcwd())
        assert out.stdout.split() == ["inherited", "timeout"], out.stderr
        assert json.loads(held.read_text())["holder"] == "parent"
    assert not lockfile.exists()


def test_cli_stage_runs_under_the_lease(lockfile, monkeypatch, tmp_path):
    """The CLI holds the lease while a stage on the card runs (its body
    stubbed); the lease is gone after."""
    from gan_discovery_pso_tpu_torch import pipelines

    seen = []
    monkeypatch.setattr(gpulock, "lock_required", lambda device="cuda": True)
    monkeypatch.setattr(pipelines, "run_cae",
                        lambda ctx, epochs=None: seen.append(gpulock.current_holder()))
    roots = [f"data.{k}_dir={tmp_path / k}" for k in ("reports", "model", "interim")]
    assert port_cli.main(["cae", "--device", "cpu", "--set", *roots]) == 0
    assert seen[0]["pid"] == os.getpid() and seen[0]["holder"] == "cli:cae"
    assert not lockfile.exists()


# -- profiling -------------------------------------------------------------------


def test_spans_sum_sections_by_name_only_under_a_profiler():
    """Sections timed as spans: each name's host time sums over its
    repeats, a child's lies inside its parent's, and outside a profiler
    session the same code records nothing."""
    from torch.profiler import ProfilerActivity, profile

    def sections():
        for _ in range(2):
            with profiling.span("section"):
                with profiling.span("part"):
                    torch.relu(torch.randn(64, 64))

    profiling.clear_spans()
    sections()
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        sections()
    spans = profiling.spans()
    assert [s["name"] for s in spans] == ["section", "part"] * 2
    total = {}
    for s in spans:
        total[s["name"]] = total.get(s["name"], 0) + s["host_ns"]
    assert 0 < total["part"] <= total["section"]
    roots = [s for s in spans if s["name"] == "section"]
    assert all(s["parent"] is None and s["call"] == s["id"] for s in roots)
    for root, part in zip(roots, (s for s in spans if s["name"] == "part")):
        assert part["parent"] == root["id"] and part["call"] == root["id"]
        assert root["start_ns"] <= part["start_ns"] <= part["end_ns"] <= root["end_ns"]
    profiling.clear_spans()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(tmp_path / "tb") as prof:
        torch.relu(torch.randn(64, 64))
    assert prof is not None
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::relu" in names
    with trace(tmp_path / "off", enabled=False) as off:
        assert off is None
    assert not (tmp_path / "off").exists()


def test_sweep_namespace_carries_what_its_legs_read():
    """Every attribute a leg's stage reads exists on the sweep's arguments."""
    args = port_cli._parser().parse_args(["sweep"])
    assert isinstance(args, argparse.Namespace)
    for name in ("resume_id", "batch_classes", "shard_swarm", "ood_patient", "epochs",
                 "path_cae", "path_classifiers", "path_gan", "path_cnn", "path_inverter",
                 "path_pso", "path_ood_pso", "path_vqvae", "device", "fast_math"):
        assert hasattr(args, name), name
