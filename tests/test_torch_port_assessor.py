"""The port's assessor stages against the JAX package's on the CPU: AlexNet
(forward, activations, the initialisers, two `train_cnn` epochs), the
assessor loader on files the JAX package wrote, the discovery fitness with
an AlexNet assessor, `run_cnn`'s one-vs-all battery and its battery tree,
`run_cnn_multipatient`'s checkpoint, and both CLIs. Tiny sizes: 100 idx
train images and 40 test images, batch 16, 1 epoch."""

import contextlib
import copy
import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.core.checkpoint import save_pytree as jax_save_pytree
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.models import AlexNetDef as JAlexNetDef
from gan_discovery_pso_tpu.models import ResNetDef as JResNetDef
from gan_discovery_pso_tpu.models import alexnet_apply, alexnet_init, resnet_apply
from gan_discovery_pso_tpu.models import layers as jax_layers
from gan_discovery_pso_tpu.ops.norm import BatchNormStats
from gan_discovery_pso_tpu.pipelines.stages import load_cnn as jax_load_cnn
from gan_discovery_pso_tpu.pso import apply_discovery_fitness as jax_fitness
from gan_discovery_pso_tpu.train import train_cnn as jax_train_cnn
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import (
    alexnet_state_dict,
    alexnet_tree,
    generator_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core import AdamConfig, PsoConfig, load_config
from gan_discovery_pso_tpu_torch.core.config import DataConfig
from gan_discovery_pso_tpu_torch.models import (
    CNN_INITIALIZERS,
    AlexNet,
    AlexNetDef,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    cnn_init_,
)
from gan_discovery_pso_tpu_torch.pipelines import (
    StageContext,
    assessor_factory,
    battery_positives,
    load_cnn,
    run_cnn,
    run_cnn_multipatient,
)
from gan_discovery_pso_tpu_torch.pso import apply_discovery_fitness, make_batched_discovery_runner
from gan_discovery_pso_tpu_torch.train.cnn import train_cnn

CFG = "configs/dcgan_mnist.yaml"
IID = (0, 2, 3, 4, 6, 7, 8, 9)
ALEXNET = {"model_cnn.model_name": "AlexNet", "model_cnn.network.padding": "same"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_idx(raw, n_train=100, n_test=40, seed=0):
    """Random 28x28 idx files, labels 0-9 in equal numbers, shuffled."""
    raw.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("t10k", n_test)):
        images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = (np.arange(n) % 10).astype(np.uint8)
        rs.shuffle(labels)
        (raw / f"{split}-images-idx3-ubyte").write_bytes(
            struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
        (raw / f"{split}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 0x801, n) + labels.tobytes())


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("assessor")
    write_idx(root / "data" / "MNIST" / "raw")
    return root


def _overrides(root, name, **extra):
    return {"data.data_dir": str(root / "data"), "trainer_cnn.batch_size": 16,
            **{f"data.{k}_dir": str(root / name / k) for k in ("reports", "model", "interim")},
            **extra}


def _port_alexnet(params, d: JAlexNetDef) -> AlexNet:
    net = AlexNet(AlexNetDef(*d))
    net.load_state_dict(to_tensors(alexnet_state_dict(jax.tree.map(np.asarray, params))),
                        strict=True)
    return net.eval()


@pytest.mark.parametrize("activation,padding,size", [
    ("LeakyReLU", 0, 64), ("ReLU", 0, 64), ("LeakyReLU", 1, 28), ("ReLU", 1, 28)])
def test_alexnet_forward_matches_jax(activation, padding, size):
    """Logits within rtol 1e-5 of `alexnet_apply` on the same weights (fp32
    convs and matmuls summed in another order); the weight map round-trips
    the JAX tree exactly."""
    d = JAlexNetDef(image_channels=1, n_class=3, img_size=size, padding=padding,
                    activation=activation)
    params, state = alexnet_init(jax.random.key(size + padding), d)
    x = np.random.RandomState(size).rand(4, 1, size, size).astype(np.float32)
    want, _ = alexnet_apply(params, state, jnp.asarray(x), d)
    net = _port_alexnet(params, d)
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    back = alexnet_tree(net.state_dict())
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert AlexNetDef(*d).conv_sizes() == d.conv_sizes() and AlexNetDef(*d).to_linear == d.to_linear


def test_alexnet_unknown_activation_raises_as_jax_does():
    d = JAlexNetDef(image_channels=1, n_class=2, img_size=28, padding=1, activation="GELU")
    params, state = alexnet_init(jax.random.key(0), d._replace(activation="ReLU"))
    with pytest.raises(ValueError, match="GELU"):
        alexnet_apply(params, state, jnp.zeros((1, 1, 28, 28)), d)
    with pytest.raises(ValueError, match="GELU"):
        AlexNet(AlexNetDef(*d))


def test_alexnet_drops_out_only_in_train_mode_with_a_generator():
    """The JAX train step applies AlexNet without a dropout key, so it trains
    without dropout; the port's forward drops out only when a generator is
    passed in train mode."""
    net = AlexNet(AlexNetDef(1, 2, 28, padding=1))
    cnn_init_(net, "glorot_normal", torch.Generator().manual_seed(0))
    x = torch.rand(4, 1, 28, 28, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        eval_out = net.eval()(x)
        train_out = net.train()(x)
        dropped = net(x, generator=torch.Generator().manual_seed(2))
        again = net.eval()(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(eval_out, train_out) and torch.equal(eval_out, again)
    assert not torch.allclose(dropped, eval_out)


@pytest.mark.parametrize("name", CNN_INITIALIZERS)
def test_cnn_initialisers_draw_the_jax_schemes(name):
    """Per layer of AlexNet: the weights' standard deviation within 12 % of
    the JAX initialiser's (draws from other generators: ~3 % sampling error
    at conv1's 288 entries), both within the scheme's bound where it has
    one; biases within torch's U(±1/sqrt(fan_in)); the same generator seed
    gives the same weights."""
    d = AlexNetDef(1, 2, 28, padding=1)
    net = cnn_init_(AlexNet(d), name, torch.Generator().manual_seed(3))
    params, _ = alexnet_init(jax.random.key(3), JAlexNetDef(*d), init=name)
    for layer, p in params.items():
        w, want = getattr(net, layer).weight.detach().numpy(), np.asarray(p["w"])
        np.testing.assert_allclose(w.std(), want.std(), rtol=0.12, err_msg=f"{name} {layer}")
        fan_in = int(np.prod(w.shape[1:]))
        b = getattr(net, layer).bias.detach().numpy()
        assert np.abs(b).max() <= 1 / np.sqrt(fan_in) + 1e-7
        if name in ("torch_default", "glorot_uniform"):
            assert np.abs(w).max() <= np.abs(want).max() * 1.05
    twin = cnn_init_(AlexNet(d), name, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 twin.state_dict().values()))


def test_cnn_initialiser_unknown_name_raises():
    with pytest.raises(ValueError, match="xavier"):
        cnn_init_(AlexNet(AlexNetDef(1, 2, 28, padding=1)), "xavier", torch.Generator())
    with pytest.raises(KeyError):
        jax_layers.conv_params(jax.random.key(0), 1, 2, 3, init="xavier")


def test_two_alexnet_train_cnn_epochs_match_jax():
    """`train_cnn` on AlexNet (64x64, the binary label 3, Adam lr 1e-3), two
    epochs of one batch, from the weights the JAX loop draws from its key:
    the history within rtol 1e-4 (atol 1e-6) of the JAX package's, the best
    epoch equal, and the final weights within rtol 1e-3 (atol 1e-6) where
    the first gradient is above 1 % of its tensor's largest (Adam's first
    step moves every entry by ±lr with its gradient's sign, so entries whose
    gradient sits at rounding level may move the other way)."""
    d = JAlexNetDef(image_channels=1, n_class=2, img_size=64)
    x = np.random.RandomState(30).rand(16, 1, 64, 64).astype(np.float32)
    y = np.random.RandomState(31).randint(0, 10, 16).astype(np.int32)
    key = jax.random.key(21)
    params0, _ = alexnet_init(key, d, init="glorot_normal")  # what train_cnn draws
    jstate, jhist, jbest = jax_train_cnn(
        key, d, JAdamConfig(lr=1e-3), lambda e: iter([(jnp.asarray(x), jnp.asarray(y))]),
        lambda e: iter([(jnp.asarray(x), jnp.asarray(y))]), num_epochs=2, label=3,
        apply_fn=alexnet_apply, init_fn=lambda k, dd, init: alexnet_init(k, dd, init=init))
    net = _port_alexnet(params0, d)
    probe = _port_alexnet(params0, d).train()
    torch.nn.functional.cross_entropy(probe(torch.tensor(x)),
                                      torch.tensor((y == 3).astype(np.int64))).backward()
    batches = lambda e: iter([(torch.tensor(x), torch.tensor(y))])  # noqa: E731
    net, hist, best = train_cnn(net, AlexNetDef(*d), AdamConfig(lr=1e-3), batches, batches,
                                num_epochs=2, label=3)
    assert best == jbest
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-4, atol=1e-6, err_msg=k)
    got = alexnet_tree(net.state_dict())
    grads = alexnet_tree({f"{k}": p.grad for k, p in probe.named_parameters()})
    for g, a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jstate.params),
                       jax.tree.leaves(got)):
        sure = np.abs(g) > 1e-2 * np.abs(g).max()
        np.testing.assert_allclose(b[sure], np.asarray(a)[sure], rtol=1e-3, atol=1e-6)


def test_load_cnn_reads_a_jax_alexnet_and_refuses_both_mismatches(tmp_path):
    d = JAlexNetDef(image_channels=1, n_class=8, img_size=28, padding=1, iid_classes=IID)
    params, state = alexnet_init(jax.random.key(5), d)
    jax_save_pytree(tmp_path / "alex" / "model.msgpack", {"params": params, "state": state})
    x = np.random.RandomState(5).rand(3, 1, 28, 28).astype(np.float32)
    want, _ = alexnet_apply(params, state, jnp.asarray(x), d)
    net = load_cnn(tmp_path / "alex", AlexNetDef(*d), device="cpu")
    assert isinstance(net, AlexNet) and not net.training
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.tensor(x)).numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    rdef = ResNetDef("ResNet50", 1, 8, IID)
    for load in (lambda: load_cnn(tmp_path / "alex", rdef, device="cpu"),
                 lambda: jax_load_cnn(tmp_path / "alex", JResNetDef(*rdef))):
        with pytest.raises(ValueError, match="is an AlexNet checkpoint"):
            load()
    # a ResNet file's keys, as either package's loader inspects them first
    jax_save_pytree(tmp_path / "res" / "model.msgpack",
                    {"params": {"bn1": {"bias": np.zeros(1)}, "layer1": [{}]}, "state": {}})
    for load in (lambda: load_cnn(tmp_path / "res", AlexNetDef(*d), device="cpu"),
                 lambda: jax_load_cnn(tmp_path / "res", d)):
        with pytest.raises(ValueError, match="is a ResNet checkpoint"):
            load()


def test_assessor_factory_builds_the_jax_defs():
    from gan_discovery_pso_tpu.core.config import load_config as jax_load_config
    from gan_discovery_pso_tpu.core.config import DataConfig as JDataConfig
    from gan_discovery_pso_tpu.pipelines.stages import assessor_factory as jax_factory

    for sets in ({}, ALEXNET, {**ALEXNET, "model_cnn.network.cnn_activation": "ReLU",
                              "model_cnn.network.padding": "valid"}):
        cfg, jcfg = load_config(CFG, overrides=sets), jax_load_config(CFG, overrides=sets)
        got = assessor_factory(cfg, DataConfig.from_config(cfg.data), 8)
        want = jax_factory(jcfg, JDataConfig.from_config(jcfg.data), 8)
        assert tuple(got[0]) == tuple(want[0]) and type(got[0]).__name__ == type(want[0]).__name__
        assert got[1:] == (None, None)


def test_discovery_fitness_with_an_alexnet_assessor_matches_jax():
    """`apply_discovery_fitness` with an AlexNet (28x28, padding 1, the 8
    shipped classes) within rtol 1e-5 of the JAX package's on the same
    weights (G with torch's default init, whose images move with z), in
    (eps, 1 + eps]; the batched runner takes the AlexNet too."""
    torch.manual_seed(0)
    gen = Generator(GeneratorDef(6, 1, 8)).eval()
    gp, gs = generator_tree(gen.state_dict())
    gs = {k: BatchNormStats(jnp.asarray(v["mean"]), jnp.asarray(v["var"])) for k, v in gs.items()}
    d = JAlexNetDef(image_channels=1, n_class=8, img_size=28, padding=1, iid_classes=IID)
    ap, as_ = alexnet_init(jax.random.key(7), d)
    net = _port_alexnet(ap, d)
    pos = np.random.RandomState(7).randn(5, 6).astype(np.float32)
    want = np.asarray(jax_fitness(jnp.asarray(pos), gp, gs, ap, as_, d, class_idx=2))
    with torch.no_grad():
        got = apply_discovery_fitness(torch.tensor(pos), gen, net, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ((got > 0.1 - 1e-6) & (got <= 1.1 + 1e-6)).all()
    run = make_batched_discovery_runner(PsoConfig(n_iterations=3, n_particles=5, dim_space=6),
                                        device="cpu")
    final, hist, _ = run(gen, net, [2, 5], rng=torch.Generator().manual_seed(0))
    g = final.g_best_val
    assert hist.fitness.shape == (2, 3, 5) and bool(((g >= 0.1) & (g <= 1.1)).all())


@pytest.fixture(scope="module")
def cnn_run(data_root):
    """The port's run_cnn on classes (0, 2), ResNet-50, 1 epoch, and what it
    printed."""
    ctx = StageContext.create(CFG, "cnn", overrides=_overrides(data_root, "cnn"), device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        models = run_cnn(ctx, epochs=1, classes=(0, 2))
    return ctx, models, out.getvalue()


def test_run_cnn_writes_the_battery_and_its_artifacts(cnn_run):
    """model_{label}.msgpack per class in the JAX layout (the JAX loader and
    `resnet_apply` give the port's logits within rtol 1e-4), the curves, the
    battery tree, timing and the histories (mirrors
    tests/test_pipeline_e2e.py::test_cnn_per_class_battery)."""
    ctx, models, _printed = cnn_run
    assert set(models) == {0, 2}
    rdef = JResNetDef("ResNet50", 1, 2, IID)
    x = np.random.RandomState(9).rand(2, 1, 28, 28).astype(np.float32)
    for label in (0, 2):
        assert (ctx.run.reports_dir / f"cnn_{label}.png").exists()
        assert (ctx.run.plot_dir / f"train_val_loss_{label}.png").exists()
        params, state = jax_load_cnn(ctx.run.models_dir, rdef, label=label)
        logits, _ = resnet_apply(params, state, jnp.asarray(x), rdef)
        with torch.no_grad():
            got = models[label](torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(logits), rtol=1e-4, atol=1e-5)
    assert (ctx.run.general_dir / "classifier_battery_tree.png").exists()
    for name in ("timing.json", "general/overall_history.pkl", "general/timing.pkl"):
        assert (ctx.run.reports_dir / name).exists()


def test_run_cnn_battery_tree_counts_equal_jax_on_the_same_members(cnn_run):
    """The battery tree the stage prints equals the JAX stage's evaluation
    (the members' files vmapped over each class's positive val images,
    argmax == 1 counted, JAX pipelines/stages.py:546-572). One epoch on
    random images flags few or none, so the count is held again with each
    member's positive logit shifted to flag half the val images."""
    ctx, models, printed = cnn_run
    rdef = JResNetDef("ResNet50", 1, 2, IID)
    loaded = [jax_load_cnn(ctx.run.models_dir, rdef, label=label) for label in (0, 2)]
    fwd = jax.jit(jax.vmap(lambda p, s, x: jnp.argmax(resnet_apply(p, s, x, rdef)[0], axis=1),
                           in_axes=(0, 0, None)))
    ds = ctx.dataset("train", drange=(0, 1))
    cut = ds.images.shape[0] - int(ds.images.shape[0] * 0.2)
    images, labels = ds.images[cut:], ds.labels[cut:]

    def jax_tree(members):
        ps = jax.tree.map(lambda *a: jnp.stack(a), *[p for p, _ in members])
        ss = jax.tree.map(lambda *a: jnp.stack(a), *[s for _, s in members])
        out = {}
        for label in (0, 2):
            x = images[labels == label].numpy()
            counts = np.zeros(2, np.int64)
            for i in range(0, x.shape[0], 256):  # the JAX stage's loop
                counts += np.asarray(fwd(ps, ss, jnp.asarray(x[i:i + 256]))).sum(axis=1)
            out[label] = counts.tolist()
        return out

    want = jax_tree(loaded)
    line = [ln for ln in printed.splitlines() if ln.startswith("[cnn] battery evaluation")]
    assert line and line[-1].endswith(f"battery tree {want}")

    shifted, members = [], []
    for (p, s), label in zip(loaded, (0, 2)):
        net = copy.deepcopy(models[label])
        with torch.no_grad():
            logits = net(images)
            net.fc.bias[1] -= torch.median(logits[:, 1] - logits[:, 0])
        members.append(net)
        shifted.append(({**p, "fc": {"b": net.fc.bias.detach().numpy().copy(), "w": p["fc"]["w"]}}, s))
    want = jax_tree(shifted)
    got = {label: battery_positives(members, images[labels == label]) for label in (0, 2)}
    assert got == want and sum(map(sum, want.values())) > 0


def test_run_cnn_multipatient_writes_the_jax_model_file(data_root):
    """model.msgpack of an AlexNet (padding 'same') n-way assessor, which the
    JAX loader reads and `alexnet_apply` evaluates to the port's logits
    (rtol 1e-5), beside the curves, timing and the history."""
    ctx = StageContext.create(CFG, "cnn_multipatient", device="cpu",
                              overrides=_overrides(data_root, "multi", **ALEXNET))
    model, mdef = run_cnn_multipatient(ctx, epochs=1)
    assert isinstance(model, AlexNet) and mdef.n_class == len(IID) and mdef.padding == 1
    jdef = JAlexNetDef(*mdef)
    params, state = jax_load_cnn(ctx.run.models_dir, jdef)
    x = np.random.RandomState(4).rand(3, 1, 28, 28).astype(np.float32)
    want, _ = alexnet_apply(params, state, jnp.asarray(x), jdef)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.tensor(x)).numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    for name in ("cnn_multipatient.png", "timing.json", "general/overall_history.pkl",
                 "training_plot/train_val_loss.png", "training_plot/train_val_f1-score.png"):
        assert (ctx.run.reports_dir / name).exists(), name
    assert isinstance(load_cnn(ctx.run.models_dir, mdef, device="cpu"), AlexNet)


def test_pso_discovery_cli_takes_an_alexnet_assessor(data_root, capsys):
    """cnn-multipatient trains an AlexNet (padding 'same') through the CLI,
    and pso-discovery --batch-classes runs on its model.msgpack with
    model_cnn.model_name=AlexNet: every class's g_best in [eps, 1 + eps]."""
    import pickle

    torch.manual_seed(0)
    gp, gs = generator_tree(Generator(GeneratorDef(8, 1, 16)).state_dict())
    gan = data_root / "alex_cli" / "upstream" / "00001--dcgan"
    jax_save_pytree(gan / "best_g.msgpack",
                    {"epoch": 0, "state": {"gen_params": gp, "gen_state": gs}, "loss": 0.5})
    sets = {**_overrides(data_root, "alex_cli"), **ALEXNET, "data.iid_classes": "[0,2]"}
    argv = lambda *a: [*a, "--cfg", CFG, "--tiny", "--device", "cpu", "--set",  # noqa: E731
                       *(f"{k}={v}" for k, v in sets.items())]
    assert cli_main(argv("cnn-multipatient")) == 0
    models = data_root / "alex_cli" / "model" / "mnist" / "00001--cnn_multipatient"
    assert cli_main(argv("pso-discovery", "--batch-classes", "--path-gan", str(gan),
                         "--path-cnn", str(models))) == 0
    reports = data_root / "alex_cli" / "reports" / "mnist" / "00001--pso_discovery"
    with open(reports / "general" / "overall_history.pkl", "rb") as f:
        g = np.asarray([h["global_best_val"][-1] for h in pickle.load(f).values()])
    assert len(g) == 2 and ((g >= 0.1) & (g <= 1.1)).all()
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("[pso-discovery] done")


@pytest.mark.parametrize("stage", ["cnn", "cnn-multipatient"])
def test_cli_runs_the_assessor_stages_on_the_cpu(data_root, stage, capsys):
    """--tiny (1 epoch), ResNet-50; the run's model files read back."""
    root = data_root / f"cli_{stage}"
    sets = _overrides(data_root, f"cli_{stage}", **{"data.iid_classes": "[0,2]"})
    rc = cli_main([stage, "--cfg", CFG, "--tiny", "--device", "cpu", "--set",
                   *(f"{k}={v}" for k, v in sets.items())])
    assert rc == 0
    run = f"00001--{stage.replace('-', '_')}"
    reports = root / "reports" / "mnist" / run
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"[{stage}] done → {reports}"
    models = root / "model" / "mnist" / run
    rdef = ResNetDef("ResNet50", 1, 2, (0, 2))
    labels = (0, 2) if stage == "cnn" else (None,)
    for label in labels:
        assert isinstance(load_cnn(models, rdef, label=label, device="cpu"), ResNet)
