"""`--fast-math` for the training stages and the mixed-precision GAN step
against the JAX package on the CPU.

- Each stage that the JAX package's `--fast-math` runs at TPU DEFAULT
  precision over its whole body (`cli/main.py:340-350`) runs its body
  inside `ops.precision.tf32_math()` under `--fast-math` and outside it
  without: the fourteen stages that run a model, each body a recording
  stub. The swarm stages (pso-discovery batched and sequential, a sweep's
  leg, a `--shard-swarm` rank, pso-inverter) and the extractors get no
  bf16 dtype from the CLI: their models stay fp32, as the JAX CLI runs
  fp32 parameters under `fast_math()`. pso-inverter's fine-tune runs under
  its caller's precision.
- `export-model --fast-math` saves fp32 weights under the policy "tf32",
  within rtol 1e-5 of JAX's `export-model --fast-math` artifact on the CPU;
  an artifact saved under "bf16" still loads.
- `tf32_math()` sets TF32 and keeps it through the stages' own
  `fp32_parity()` blocks.
- `make_gan_train_step(compute_dtype=torch.bfloat16)` follows the JAX
  package's `compute_dtype=jnp.bfloat16` step from the same weights and the
  same draws, and `run_dcgan` takes `trainer_gan.compute_dtype`.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gan_discovery_pso_tpu.cli.main as jax_cli
from gan_discovery_pso_tpu.compat.export import load_exported as jax_load_exported
from gan_discovery_pso_tpu.core.checkpoint import _plainify
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.core.config import load_config as jax_load_config
from gan_discovery_pso_tpu.models.dcgan import DiscriminatorDef as JDiscriminatorDef
from gan_discovery_pso_tpu.models.dcgan import GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.train import common as jcommon
from gan_discovery_pso_tpu.train import dcgan as jdcgan
from gan_discovery_pso_tpu_torch import evaluation, pipelines
from gan_discovery_pso_tpu_torch.cli.main import TF32_STAGES
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import generator_tree
from gan_discovery_pso_tpu_torch.compat.export import (
    _Call,
    _frozen_cpu_copy,
    _generator,
    export_callable,
    load_exported,
)
from gan_discovery_pso_tpu_torch.core import AdamConfig, load_config
from gan_discovery_pso_tpu_torch.core.checkpoint import save_pytree
from gan_discovery_pso_tpu_torch.models import (
    DiscriminatorDef,
    Generator,
    GeneratorDef,
    torch_default_init_,
)
from gan_discovery_pso_tpu_torch.ops import cast_model, fp32_parity, tf32_enabled, tf32_math
from gan_discovery_pso_tpu_torch.pipelines import StageContext, gan_compute_dtype
from gan_discovery_pso_tpu_torch.pipelines import stages as stage_module
from gan_discovery_pso_tpu_torch.train.dcgan import gan_init, make_gan_train_step

CFG = "configs/dcgan_mnist.yaml"
Z, F_ = 8, 8
ADAM = dict(lr=1e-3, beta1=0.5, beta2=0.99, epsilon=1e-8)  # trainer_gan.optimizer
# |loss_bf16 port - loss_bf16 JAX| at each step: both steps round the convs'
# operands to bf16, JAX its activations too, so the two agree to about a
# bf16 step of a loss near 0.7 (2^-8 = 3.9e-3) and each sits from its fp32
# step by the same scale (here JAX's own bf16 vs fp32: up to 6e-4 over 8
# steps)
BF16_STEP_TOL = 2e-3
BF16_STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the stages' bodies under --fast-math ------------------------------------------


class _Stop(Exception):
    """Ends pso-inverter after the recorded fine-tune."""


STAGE_BODIES = ("run_cae", "run_classifiers", "run_cnn", "run_cnn_multipatient", "run_dcgan",
                "run_pso_discovery", "run_pso_inverter", "run_extractor", "run_inverter",
                "run_regularize_inverter", "run_regularize_inverter_statistics", "run_vqvae",
                "run_pixelcnn_prior_from_vqvae")


def _stub_stages(monkeypatch, seen: list, calls: list | None = None):
    """Every model-running stage's body replaced by a stub recording whether
    it runs inside `tf32_math()`, and (in `calls`) the keywords it was
    given; the loaders and the regularize stages' test split stubbed too."""
    def record(*_a, **kw):
        seen.append(tf32_enabled())
        if calls is not None:
            calls.append(kw)

    for name in STAGE_BODIES:
        monkeypatch.setattr(pipelines, name, record)
    for name in ("load_cae", "load_gan", "load_encoder", "load_cnn"):
        monkeypatch.setattr(pipelines, name, lambda *_a, **_k: None)
    monkeypatch.setattr(evaluation, "load_battery", lambda *_a, **_k: None)
    monkeypatch.setattr(StageContext, "dataset", lambda *_a, **_k: types.SimpleNamespace(
        images=torch.zeros((8, 1, 28, 28)), labels=torch.zeros(8, dtype=torch.long)))


PATHS = ["--path-cae", "c", "--path-classifiers", "k", "--path-gan", "g", "--path-cnn", "n",
         "--path-inverter", "i", "--path-pso", "p", "--path-vqvae", "v"]


def _path_args(stage: str) -> list:
    accepted = {a.dest for a in _stage_parser(stage)._actions}
    return [a for flag, value in zip(PATHS[::2], PATHS[1::2])
            if flag[2:].replace("-", "_") in accepted for a in (flag, value)]


def _roots(tmp_path, run) -> list:
    return [f"data.{k}_dir={tmp_path / str(run) / k}" for k in ("reports", "model", "interim")]


@pytest.mark.parametrize("stage", TF32_STAGES)
def test_fast_math_runs_the_stage_body_inside_tf32(stage, monkeypatch, tmp_path):
    """The fourteen stages that run a model (the ten training stages, the
    two swarm stages and the two extractors): the body inside `tf32_math()`
    under --fast-math, outside it without; the CLI returns 0."""
    assert len(TF32_STAGES) == 14
    seen = []
    _stub_stages(monkeypatch, seen)
    for run, fast in enumerate((["--fast-math"], [])):
        argv = [stage, "--cfg", CFG, "--device", "cpu", *fast, *_path_args(stage), "--set",
                *_roots(tmp_path, run)]
        assert cli_main(argv) == 0
    assert seen == [True, False]
    assert not tf32_enabled()


SWARM_RUNS = {
    "pso-discovery batched": ["pso-discovery", "--batch-classes"],
    "pso-discovery sequential": ["pso-discovery"],
    "pso-inverter": ["pso-inverter"],
    "iid-extract": ["iid-extract"],
    "ood-extract": ["ood-extract"],
    "sweep leg": ["sweep", "--latent-dims", "4", "--stages", "pso-discovery"],
    "sweep patient leg": ["sweep", "--patients", "1", "--controls", "optimize_in_training"],
}


@pytest.mark.parametrize("run", SWARM_RUNS)
def test_fast_math_keeps_the_swarm_stages_models_fp32(run, monkeypatch, tmp_path):
    """Under --fast-math the swarm stages, the extractors and a sweep's legs
    run inside `tf32_math()` and are given no bf16 dtype (no
    `fast_math_dtype`, or None): their models stay fp32, as JAX's CLI runs
    fp32 parameters under `fast_math()`."""
    seen, calls = [], []
    _stub_stages(monkeypatch, seen, calls)
    stage, *flags = SWARM_RUNS[run]
    leg = "pso-inverter" if "patient" in run else "pso-discovery" if stage == "sweep" else stage
    argv = [stage, "--cfg", CFG, "--device", "cpu", "--fast-math", *flags, *_path_args(leg),
            "--set", *_roots(tmp_path, 0)]
    assert cli_main(argv) == 0
    assert seen == [True]
    assert calls[0].get("fast_math_dtype") is None
    if stage == "pso-discovery":
        assert calls[0]["batch_classes"] == ("--batch-classes" in flags)


def test_fast_math_covers_a_shard_swarm_rank(monkeypatch, tmp_path):
    """A `--shard-swarm` rank goes back through the CLI: inside a process
    group already up (gloo, one rank here) the rank's stage body runs inside
    `tf32_math()` with no bf16 dtype and its shard count."""
    seen, calls = [], []
    _stub_stages(monkeypatch, seen, calls)
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                         world_size=1, rank=0)
    try:
        argv = ["pso-discovery", "--cfg", CFG, "--device", "cpu", "--fast-math",
                "--shard-swarm", "1", *_path_args("pso-discovery"), "--set",
                *_roots(tmp_path, 0)]
        assert cli_main(argv) == 0
    finally:
        torch.distributed.destroy_process_group()
    assert seen == [True]
    assert calls[0]["shard_devices"] == 1 and calls[0].get("fast_math_dtype") is None


def test_pso_inverter_fine_tune_runs_under_the_callers_precision(monkeypatch, tmp_path):
    """The stage enters no precision of its own: given the bf16 swarm dtype
    its fine-tune runs in fp32 parity outside `tf32_math()` and in TF32
    inside it (the CLI's --fast-math)."""
    seen = []

    def fine_tune(*_a, **_k):
        seen.append(tf32_enabled())
        raise _Stop

    monkeypatch.setattr(stage_module, "_fine_tune", fine_tune)
    monkeypatch.setattr(StageContext, "dataset", lambda *_a, **_k: None)
    sets = {f"data.{k}_dir": str(tmp_path / k) for k in ("reports", "model", "interim")}
    ctx = StageContext.create(load_config(CFG, overrides=sets), "pso_inverter", device="cpu")
    rdef = pipelines.assessor_factory(ctx.cfg, ctx.data_cfg, 8)[0]
    for precision in (fp32_parity, tf32_math):
        with precision(), pytest.raises(_Stop):
            pipelines.run_pso_inverter(ctx, None, None, None, rdef, ood_patient=1,
                                       fast_math_dtype=torch.bfloat16)
    assert seen == [False, True]


# -- export-model --fast-math ------------------------------------------------------


def test_export_model_fast_math_saves_fp32_weights_under_tf32(tmp_path):
    """`export-model generator --fast-math` (z 8, f 8, a torch-default G):
    the artifact names the policy "tf32", holds fp32 weights, and on the
    CPU (where TF32 changes nothing) equals the fp32 G bit for bit and
    JAX's `export-model --fast-math` artifact within rtol 1e-5; a G exported
    as bf16 copies (policy "bf16", the former --fast-math artifact) still
    loads and runs."""
    gen = torch_default_init_(Generator(GeneratorDef(Z, 1, F_)),
                              torch.Generator().manual_seed(0)).eval()
    gp, gs = generator_tree(gen.state_dict())
    save_pytree(tmp_path / "gan" / "best_g.msgpack",
                {"epoch": 0, "state": {"gen_params": gp, "gen_state": gs}, "loss": 0.0})
    argv = ["export-model", "generator", None, "--cfg", CFG, "--path-gan", str(tmp_path / "gan"),
            "--batch", "4", "--fast-math", "--set", f"trainer_gan.z_dim={Z}"]
    for pkg, cli, extra in (("port", cli_main, ["--device", "cpu"]),
                            ("jax", jax_cli.main, [])):
        argv[2] = str(tmp_path / f"{pkg}.pt2")
        assert cli(argv + extra) == 0
    art = load_exported(tmp_path / "port.pt2", device="cpu")
    assert art.policy == "tf32"
    weights = {**art.program.state_dict, **art.program.constants}
    assert weights and {t.dtype for t in weights.values() if t.is_floating_point()} == {
        torch.float32}
    z = np.random.RandomState(3).randn(4, Z, 1, 1).astype(np.float32)
    got = art.call(torch.tensor(z))
    with fp32_parity(), torch.no_grad():
        assert torch.equal(got, gen(torch.tensor(z)))
    want = np.asarray(jax_load_exported(tmp_path / "jax.pt2").call(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the former --fast-math artifact: G's bf16 copy under the policy "bf16"
    export_callable(_Call(_generator, gen=cast_model(_frozen_cpu_copy(gen), torch.bfloat16)),
                    (torch.zeros((4, Z, 1, 1)),), tmp_path / "bf16.pt2", policy="bf16")
    old = load_exported(tmp_path / "bf16.pt2", device="cpu")
    assert old.policy == "bf16"
    assert torch.bfloat16 in {t.dtype for t in old.program.state_dict.values()}
    out = old.call(torch.tensor(z))
    assert out.shape == got.shape and bool(torch.isfinite(out).all())


def _stage_parser(stage: str):
    from gan_discovery_pso_tpu_torch.cli.main import _parser

    return _parser()._subparsers._group_actions[0].choices[stage]


def test_tf32_math_holds_through_fp32_parity_and_restores():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    with fp32_parity():
        assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic) == (False, False, True)
    with tf32_math():
        assert tf32_enabled()
        assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic) == (True, True, False)
        with fp32_parity():  # a stage's own parity block changes nothing inside
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
            assert tf32_enabled()
    assert not tf32_enabled()
    assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark) == before


# -- the mixed-precision GAN step --------------------------------------------------


def _host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_draws(key, bs):
    kz, kp, kn = jax.random.split(key, 3)
    return tuple(torch.tensor(np.asarray(t)) for t in (
        jax.random.normal(kz, (bs, Z, 1, 1), jnp.float32),
        jcommon.smooth_positive(kp, (bs,)), jcommon.smooth_negative(kn, (bs,))))


def test_bf16_gan_step_follows_jax():
    """BF16_STEPS steps of the bf16 step from the JAX state's weights, fed
    JAX's draws and a numpy-seeded batch of 16: each loss within
    BF16_STEP_TOL of JAX's `compute_dtype=jnp.bfloat16` step; the steps
    differ from the port's fp32 steps (the cast took effect) while the
    master parameters, G's BN statistics and Adam's moments stay fp32."""
    jstate, _ = jdcgan.gan_init(jax.random.key(0), JGeneratorDef(Z, 1, F_),
                                JDiscriminatorDef(1, F_), JAdamConfig(**ADAM))
    tree = _host(_plainify(jstate))
    real = np.random.RandomState(1).rand(16, 1, 28, 28).astype(np.float32) * 2 - 1
    losses = {}
    for label, jdtype, dtype in (("fp32", None, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
        port = gan_init(torch.Generator().manual_seed(0), GeneratorDef(Z, 1, F_),
                        DiscriminatorDef(1, F_), AdamConfig(**ADAM), device="cpu").load_tree(tree)
        step = make_gan_train_step(port, compute_dtype=dtype)
        jstep = jax.jit(jdcgan.make_gan_train_step(JGeneratorDef(Z, 1, F_), JAdamConfig(**ADAM),
                                                   compute_dtype=jdtype))
        js, got, want = jstate, [], []
        for i in range(BF16_STEPS):
            key = jax.random.key(100 + i)
            js, jm = jstep(js, jnp.asarray(real), key)
            with fp32_parity():
                m = step(torch.tensor(real), _jax_draws(key, real.shape[0]))
            got.append([float(m["loss_gen"]), float(m["loss_disc"])])
            want.append([float(jm["loss_gen"]), float(jm["loss_disc"])])
        losses[label] = np.asarray(got)
        tol = BF16_STEP_TOL if dtype is not None else 1e-5
        np.testing.assert_allclose(got, want, rtol=0 if dtype is not None else tol,
                                   atol=tol if dtype is not None else 0, err_msg=label)
    for mod in (port.gen, port.disc):
        assert {p.dtype for p in mod.parameters()} == {torch.float32}
    assert {b.dtype for b in port.gen.buffers() if b.is_floating_point()} == {torch.float32}
    for opt in (port.opt_g, port.opt_d):
        assert {s["exp_avg"].dtype for s in opt.state.values()} == {torch.float32}
    assert np.abs(losses["bf16"] - losses["fp32"]).max() > 0


def test_gan_compute_dtype_reads_the_jax_setting():
    """`trainer_gan.compute_dtype` as both packages read it: bfloat16 is the
    bf16 step, unset and float32 the fp32 one; a name that is no floating
    dtype is refused."""
    for value, want in (("bfloat16", torch.bfloat16), ("float32", None), (None, None)):
        sets = {} if value is None else {"trainer_gan.compute_dtype": value}
        assert gan_compute_dtype(load_config(CFG, overrides=sets)) == want
        jax_value = jax_load_config(CFG, overrides=sets).trainer_gan.get("compute_dtype")
        assert (jax_value is None) == (value is None)
    with pytest.raises(ValueError, match="compute_dtype=int32"):
        gan_compute_dtype(load_config(CFG, overrides={"trainer_gan.compute_dtype": "int32"}))


def test_run_dcgan_trains_with_the_configured_dtype(monkeypatch, tmp_path):
    """`run_dcgan` under `trainer_gan.compute_dtype=bfloat16` makes the bf16
    step (the step's maker stubbed, the data a zero batch)."""
    made = []

    def maker(state, label_smoothing=True, group=None, compute_dtype=None):
        made.append(compute_dtype)
        raise _Stop

    monkeypatch.setattr(stage_module, "make_gan_train_step", maker)
    monkeypatch.setattr(stage_module, "encode", lambda *_a, **_k: None)
    monkeypatch.setattr(StageContext, "dataset", lambda *_a, **_k: types.SimpleNamespace(
        images=torch.zeros((128, 1, 28, 28)), labels=torch.zeros(128, dtype=torch.long)))
    for value in ("bfloat16", None):
        sets = {f"data.{k}_dir": str(tmp_path / str(value) / k)
                for k in ("reports", "model", "interim")}
        sets.update({"trainer_gan.z_dim": Z, "model_gan.network.units_gen": F_,
                     "model_gan.network.units_disc": F_})
        if value:
            sets["trainer_gan.compute_dtype"] = value
        ctx = StageContext.create(load_config(CFG, overrides=sets), "dcgan", device="cpu")
        with pytest.raises(_Stop):
            pipelines.run_dcgan(ctx, (None, None), types.SimpleNamespace(
                classes=torch.arange(8)), epochs=1)
    assert made == [torch.bfloat16, None]
