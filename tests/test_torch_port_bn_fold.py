"""The assessor's eval BatchNorm folded into its convs for a runner call
(`ops.fold_batch_norm`, `models.folded_batch_norm`, both runners), on the
CPU. Every ResNet here draws non-trivial BN statistics (γ in [0.5, 1.5],
β and μ N(0, 0.5), σ² in [0.5, 2]), since the benchmark's draws (γ 1, β 0,
μ 0, σ² 1) leave the fold nearly an identity.

Held: the fold is the float64 product rounded once; the folded ResNet-50
forward matches the unfolded one (rtol 1e-5, atol 1e-6) and runs no BN
pass; train-mode BN, bf16 weights and other models run as outside; entries
nest; a runner call (the sharded runner's too) folds the weights as they
are at the call, leaves the state dict as it was, fires a hook on the assessor once a fitness
evaluation, records one `models.fold` span in fp32 and none for its bf16
copies, whose path is bit-equal to a run without the fold. Tiny sizes: G
z 6 f 8, 28x28 images, 2 swarms x 4 particles x 2 iterations."""

import contextlib
import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gan_discovery_pso_tpu_torch.models.resnet as resnet_mod
import gan_discovery_pso_tpu_torch.pso.runner as runner_mod
from gan_discovery_pso_tpu_torch.core import profiling
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.models import (
    AlexNet,
    AlexNetDef,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    folded_batch_norm,
)
from gan_discovery_pso_tpu_torch.ops import fold_batch_norm
from gan_discovery_pso_tpu_torch.parallel import make_batched_sharded_discovery_runner, make_mesh
from gan_discovery_pso_tpu_torch.pso import make_batched_discovery_runner, make_inverter_runner

Z, N, T = 6, 4, 2
HP = PsoConfig(n_iterations=T, n_particles=N, dim_space=Z)


def _bn_draws_(model: ResNet, seed: int) -> ResNet:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, bn in resnet_mod._conv_bn_pairs(model):
            c = bn.num_features
            bn.weight.copy_(0.5 + torch.rand(c, generator=g))
            bn.bias.copy_(0.5 * torch.randn(c, generator=g))
            bn.running_mean.copy_(0.5 * torch.randn(c, generator=g))
            bn.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
    return model


def _resnet(n_class: int, seed: int = 0) -> ResNet:
    torch.manual_seed(seed)
    return _bn_draws_(ResNet(ResNetDef("ResNet50", 1, n_class)), seed + 100).eval()


@pytest.fixture(scope="module")
def gen():
    torch.manual_seed(7)
    return Generator(GeneratorDef(Z, 1, 8)).eval()


@pytest.fixture(scope="module")
def images():
    return torch.rand((6, 1, 28, 28), generator=torch.Generator().manual_seed(3)) * 2 - 1


def _states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def _count_bn_passes(monkeypatch) -> list:
    calls = []
    real = resnet_mod.batch_norm_eval

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(resnet_mod, "batch_norm_eval", counting)
    return calls


def test_fold_is_the_float64_product_rounded_once():
    """Each (w', b') is (w·s, β − μ·s) computed in float64 and rounded once
    to float32, s = γ·rsqrt(σ² + eps), per BN eps; pairs of one I·kH·kW
    and of another come back in their order and shapes."""
    g = torch.Generator().manual_seed(0)
    shapes = [(4, 3, 3, 3), (5, 2, 1, 1), (6, 3, 3, 3), (2, 2, 1, 1)]
    ws = [torch.randn(s, generator=g) for s in shapes]
    gam, bet, mu, var = ([f(s[0]) for s in shapes] for f in (
        lambda c: 0.5 + torch.rand(c, generator=g), lambda c: torch.randn(c, generator=g),
        lambda c: torch.randn(c, generator=g), lambda c: 0.5 + 1.5 * torch.rand(c, generator=g)))
    eps = [1e-5, 1e-3, 1e-5, 0.1]
    got = fold_batch_norm(ws, gam, bet, mu, var, eps)
    for i, (w, b) in enumerate(got):
        s = gam[i].double() * torch.rsqrt(var[i].double() + eps[i])
        assert w.shape == shapes[i] and w.dtype == b.dtype == torch.float32
        assert torch.equal(w, (ws[i].double() * s.view(-1, 1, 1, 1)).float())
        assert torch.equal(b, (bet[i].double() - mu[i].double() * s).float())


@pytest.mark.parametrize("n_class", [8, 2])
def test_folded_resnet50_matches_the_unfolded_forward_without_a_bn_pass(
        monkeypatch, images, n_class):
    model = _resnet(n_class)
    passes = _count_bn_passes(monkeypatch)
    with torch.no_grad():
        want = model(images)
        assert len(passes) == 53
        with folded_batch_norm(model):
            got = model(images)
            feats = model.features(images)
        assert len(passes) == 53  # none inside
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(feats, model.features(images), rtol=1e-5, atol=1e-6)
        assert torch.equal(model(images), want)  # bit-equal again once out


@pytest.mark.parametrize("when", ["before_entry", "inside"])
def test_train_mode_bn_inside_the_context_runs_as_outside(images, when):
    """The batch statistics normalise and the running ones move bit-equal
    to a copy trained outside, whether the model is in train mode when the
    context is entered (nothing folds) or put there inside it."""
    model, outside = _resnet(8), _resnet(8)
    outside.train()
    want = outside(images)
    if when == "before_entry":
        model.train()
    with folded_batch_norm(model):
        model.train()
        got = model(images)
    assert torch.equal(got, want)
    assert _states_equal(model.state_dict(), outside.state_dict())


def test_other_models_and_bf16_weights_are_not_folded(monkeypatch, images):
    folds, real = [], resnet_mod.fold_batch_norm
    monkeypatch.setattr(resnet_mod, "fold_batch_norm", lambda *a: folds.append(1) or real(*a))
    torch.manual_seed(0)
    alex = AlexNet(AlexNetDef(img_size=28, padding=1, n_class=3)).eval()
    bf16 = _resnet(8).to(torch.bfloat16)
    with torch.no_grad():
        want = (alex(images), bf16(images.bfloat16()))
        with folded_batch_norm(alex), folded_batch_norm(bf16):
            got = (alex(images), bf16(images.bfloat16()))
    assert folds == [] and all(torch.equal(a, b) for a, b in zip(got, want))


def test_nested_entries_keep_the_outer_fold(monkeypatch, images):
    model = _resnet(8)
    with torch.no_grad():
        with folded_batch_norm(model):
            folded = model(images)
            with folded_batch_norm(model):
                assert torch.equal(model(images), folded)
            passes = _count_bn_passes(monkeypatch)
            assert torch.equal(model(images), folded) and passes == []
        model(images)
        assert len(passes) == 53


def _discovery(dtype=None):
    run = make_batched_discovery_runner(HP, dtype=dtype, device="cpu")
    return lambda gen, cnn: run(gen, cnn, [1, 6], rng=torch.Generator().manual_seed(0))


def _inverter(dtype=None):
    run = make_inverter_runner(HP, dtype=dtype, device="cpu")
    src = torch.rand((N, 1, 28, 28), generator=torch.Generator().manual_seed(1)) * 2 - 1
    pos = torch.randn((N, Z), generator=torch.Generator().manual_seed(2))
    return lambda gen, cnn: run(gen, cnn, 1, src, pos, rng=torch.Generator().manual_seed(0))


RUNNERS = {"discovery": (_discovery, 8), "inverter": (_inverter, 2)}


def _same_result(a, b) -> bool:
    return all(torch.equal(x.nan_to_num(-1.0), y.nan_to_num(-1.0))
               for part_a, part_b in zip(a, b) for x, y in zip(part_a, part_b))


@pytest.mark.parametrize("change", ["running_var", "conv_weight"])
def test_a_change_between_calls_is_seen_by_the_next_call(gen, change):
    """A BN statistic or a conv weight changed in place after a call: the
    next call equals a call on a fresh copy of the changed model, and
    differs from the first."""
    call = _discovery()
    model = _resnet(8)
    first = call(gen, model)
    with torch.no_grad():
        if change == "running_var":
            model.layer2[0].bn2.running_var.mul_(3.0)
        else:
            model.layer3[1].conv2.weight.mul_(-2.0)
    second = call(gen, model)
    fresh = call(gen, copy.deepcopy(model))
    assert _same_result(second, fresh)
    assert not torch.equal(second[1].fitness, first[1].fitness)


@pytest.mark.parametrize("kind", sorted(RUNNERS))
def test_a_call_leaves_the_state_dict_as_it_was(gen, kind):
    make, n_class = RUNNERS[kind]
    model = _resnet(n_class)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    attrs = {name: set(vars(m)) for name, m in model.named_modules()}
    make()(gen, model)
    assert _states_equal(model.state_dict(), before)
    assert {name: set(vars(m)) for name, m in model.named_modules()} == attrs


@pytest.mark.parametrize("kind", sorted(RUNNERS))
def test_a_hook_on_the_assessor_fires_once_a_fitness_evaluation(gen, kind):
    """What the benchmark's capture records: one input and output an
    iteration, the output the folded forward's, within the tolerance of
    the unfolded forward of the same input."""
    make, n_class = RUNNERS[kind]
    model = _resnet(n_class)
    seen = []
    handle = model.register_forward_hook(lambda _m, args, out: seen.append((args[0], out)))
    try:
        make()(gen, model)
    finally:
        handle.remove()
    assert len(seen) == T
    with torch.no_grad():
        for x, out in seen:
            torch.testing.assert_close(out, model(x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(RUNNERS))
def test_bf16_path_is_bit_equal_without_the_fold_and_its_copy_is_not_folded(
        monkeypatch, gen, kind):
    make, n_class = RUNNERS[kind]
    model = _resnet(n_class)
    folds = []
    real = resnet_mod.fold_batch_norm
    monkeypatch.setattr(resnet_mod, "fold_batch_norm", lambda *a: folds.append(1) or real(*a))
    got = make(torch.bfloat16)(gen, model)
    assert folds == []
    monkeypatch.setattr(runner_mod, "folded_batch_norm", lambda _m: contextlib.nullcontext())
    assert _same_result(got, make(torch.bfloat16)(gen, model))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", sorted(RUNNERS))
def test_fold_span_once_a_fp32_call_and_never_for_bf16(gen, kind, dtype):
    make, n_class = RUNNERS[kind]
    model, call = _resnet(n_class), make(dtype)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        call(gen, model)
        call(gen, model)
    spans = profiling.spans()
    profiling.clear_spans()
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["runner.call"] * 2
    folded = dtype is None
    for root in roots:
        children = [s["name"] for s in spans if s["parent"] == root["id"]]
        assert children == (["runner.inputs"] + ["models.fold"] * folded
                            + ["pso.iteration"] * T + ["pso.stack"])
    fold = [s for s in spans if s["name"] == "models.fold"]
    assert len(fold) == 2 * folded and all(s["host_ns"] > 0 for s in fold)


def test_no_span_when_nothing_folds(images):
    """A model in train mode folds nothing and records no span."""
    model = _resnet(8).train()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with folded_batch_norm(model):
            pass
        with folded_batch_norm(model.eval()):
            pass
    assert [s["name"] for s in profiling.spans()] == ["models.fold"]
    profiling.clear_spans()


def test_the_sharded_runner_folds_as_the_batched_one(monkeypatch, gen):
    """A mesh of one rank (no process group): the batched sharded runner
    folds once a call and is bit-equal to the batched runner."""
    folds, real = [], resnet_mod.fold_batch_norm
    monkeypatch.setattr(resnet_mod, "fold_batch_norm", lambda *a: folds.append(1) or real(*a))
    model = _resnet(8)
    sharded = make_batched_sharded_discovery_runner(make_mesh(1, device="cpu"), HP,
                                                    class_axis=None)
    got = sharded(gen, model, [1, 6], rng=torch.Generator().manual_seed(0))
    assert folds == [1]
    assert _same_result(got, _discovery()(gen, model)) and folds == [1, 1]
