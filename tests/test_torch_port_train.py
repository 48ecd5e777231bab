"""The port's training pieces against the JAX package's on the CPU:
train-mode BatchNorm, ResNet-50 in train mode, the assessor's train steps
with the pso-inverter's Adam, the epoch metrics, the optimizers, and
`train_cnn`'s early stop and best-weights restore. ResNet-50 runs on a
batch of 16 28x28 images; `train_cnn` on a linear model, so that the whole
epoch loop runs in both packages.

Train-mode ResNet-50 is ill-conditioned at this size: layer4 is 1x1, so
each of its BNs normalises over 16 values per channel, and both packages'
fp32 logits sit ~1e-4 (of their largest) from a float64 run (~3e-3 with a
batch of 4). Its logits are held within 2e-4 of the largest logit."""


def assert_close_to_scale(got, want, share):
    """|got − want| within `share` of want's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=share * float(np.abs(want).max()))

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.models import ResNetDef as JResNetDef
from gan_discovery_pso_tpu.models.resnet import resnet_apply
from gan_discovery_pso_tpu.ops.norm import BatchNormStats
from gan_discovery_pso_tpu.ops.norm import batch_norm_train as jax_batch_norm_train
from gan_discovery_pso_tpu.train.cnn import CnnTrainState
from gan_discovery_pso_tpu.train.cnn import EpochCounts as JEpochCounts
from gan_discovery_pso_tpu.train.cnn import _update_counts as jax_update_counts
from gan_discovery_pso_tpu.train.cnn import counts_to_metrics as jax_counts_to_metrics
from gan_discovery_pso_tpu.train.cnn import make_cnn_steps as jax_make_cnn_steps
from gan_discovery_pso_tpu.train.cnn import train_cnn as jax_train_cnn
from gan_discovery_pso_tpu.train.common import cross_entropy_loss as jax_cross_entropy
from gan_discovery_pso_tpu.train.common import make_optimizer as jax_make_optimizer
from gan_discovery_pso_tpu_torch.compat import resnet_state_dict, resnet_tree, to_tensors
from gan_discovery_pso_tpu_torch.core import AdamConfig
from gan_discovery_pso_tpu_torch.models import (
    ResNet,
    ResNetDef,
    change_classifier_head,
    glorot_normal_init_,
)
from gan_discovery_pso_tpu_torch.ops import batch_norm_train
from gan_discovery_pso_tpu_torch.train.cnn import (
    EpochCounts,
    _update_counts,
    counts_to_metrics,
    make_cnn_steps,
    train_cnn,
)
from gan_discovery_pso_tpu_torch.train.common import cross_entropy_loss, make_optimizer

# trainer_pso_inverter.optimizer of the shipped config
ADAM = dict(lr=1e-4, beta1=0.0, beta2=0.99, epsilon=1e-8, weight_decay=1e-5)
RDEF = ("ResNet50", 1, 2, (0, 2, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def resnet():
    """A seeded 2-class ResNet-50, its JAX tree, and a batch of 16."""
    net = glorot_normal_init_(ResNet(ResNetDef(*RDEF)), torch.Generator().manual_seed(0))
    params, state = resnet_tree(net.state_dict())
    rs = np.random.RandomState(1)
    x = rs.rand(16, 1, 28, 28).astype(np.float32)
    y = np.asarray([0, 1, 1, 0] * 4, np.int32)
    return net, jax.tree.map(jnp.asarray, params), _bn_stats(state), x, y


def _bn_stats(node):
    """A state tree's {mean, var} leaves as the JAX package's BatchNormStats."""
    if isinstance(node, dict) and set(node) == {"mean", "var"}:
        return BatchNormStats(jnp.asarray(node["mean"]), jnp.asarray(node["var"]))
    if isinstance(node, dict):
        return {k: _bn_stats(v) for k, v in node.items()}
    return [_bn_stats(v) for v in node]


@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (2, 8, 1, 1), (6, 2, 7, 3)])
def test_batch_norm_train_matches_jax(shape):
    """The output, and the running statistics (unbiased variance, momentum
    0.1), within rtol 1e-5."""
    rs = np.random.RandomState(sum(shape))
    x = (rs.randn(*shape) * 2 + 1).astype(np.float32)
    c = shape[1]
    scale, bias = rs.rand(c).astype(np.float32), rs.randn(c).astype(np.float32)
    mean, var = rs.randn(c).astype(np.float32), (rs.rand(c) + 0.5).astype(np.float32)
    y, st = jax_batch_norm_train(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                 BatchNormStats(jnp.asarray(mean), jnp.asarray(var)))
    rm, rv = torch.tensor(mean), torch.tensor(var)
    got = batch_norm_train(torch.tensor(x), torch.tensor(scale), torch.tensor(bias), rm, rv)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rm.numpy(), np.asarray(st.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rv.numpy(), np.asarray(st.var), rtol=1e-5, atol=1e-6)


def test_resnet_train_mode_matches_jax(resnet):
    """Logits within 2e-4 of the largest (see the module's docstring), and
    every BN's running statistics after the forward within 1e-4 of each
    tensor's largest."""
    _net, params, state, x, _y = resnet
    net = copy.deepcopy(_net)
    logits, new_state = jax.jit(lambda p, s, x: resnet_apply(
        p, s, x, JResNetDef(*RDEF), train=True))(params, state, jnp.asarray(x))
    net.train()
    got = net(torch.tensor(x))
    assert_close_to_scale(got.detach().numpy(), logits, 2e-4)
    _p, want_state = resnet_tree(net.state_dict())
    for a, b in zip(jax.tree.leaves(new_state), jax.tree.leaves(want_state)):
        assert_close_to_scale(b, a, 1e-4)
    net.eval()
    assert not net.layer1[0].bn1.training  # eval mode reaches every block


def test_two_train_steps_match_jax(resnet):
    """Two Adam steps (the pso-inverter's config) on the same batch.

    Each step starts from the same weights in both packages: before the
    second, the port takes the JAX package's updated weights and BN
    statistics (each optimizer keeps its own moments). Per step: the logits
    (2e-4 of the largest, as above), the loss (rtol 5e-4, of the order of
    the logits' difference) and the BN
    statistics after it (1e-4 of each tensor's largest).

    The first update is compared entry by entry, by count. Adam's first
    step is ≈ lr·g/(|g| + eps), so each entry moves by ±lr with g's sign:
    noise where |g| is near eps, and where g is within the gradient's own
    error — ResNet-50 at 28x28 is ill-conditioned (see the module's
    docstring; both packages' fp32 gradients sit 7-16 % of a tensor's
    largest from a float64 run on some tensors). So entries count where |g|
    is above 1 % of its tensor's largest gradient, and up to 1 in 10^4 of
    them may take the other sign (measured: 205 of 15.7M). The second
    update's size depends on each package's first gradient (Adam's second
    moment) and is not compared; `test_optimizers_match_optax` holds the
    optimizer itself."""
    net0, params, state, x, y = resnet
    adam = JAdamConfig(**ADAM)
    jtrain, _ = jax_make_cnn_steps(JResNetDef(*RDEF), adam)
    jstate = CnnTrainState(params, state, jax_make_optimizer(adam).init(params),
                           jnp.asarray(1.0, jnp.float32), jnp.asarray(0, jnp.int32))
    jfwd = jax.jit(lambda p, s, x: resnet_apply(p, s, x, JResNetDef(*RDEF), train=True)[0])

    net = copy.deepcopy(net0)
    opt = make_optimizer(AdamConfig(**ADAM), net.parameters())
    train_step, _ = make_cnn_steps(net, opt)
    xt, yt = torch.tensor(x), torch.tensor(y)
    for step in range(2):
        if step:
            synced = to_tensors(resnet_state_dict(jax.tree.map(np.asarray, jstate.params),
                                                  jax.tree.map(np.asarray, jstate.model_state)))
            with torch.no_grad():
                for k, v in net.state_dict().items():
                    if not k.endswith("num_batches_tracked"):
                        v.copy_(synced[k])
        with torch.no_grad():  # a copy, so that its BN statistics update goes nowhere
            logits = copy.deepcopy(net).train()(xt)
        assert_close_to_scale(logits.numpy(), jfwd(jstate.params, jstate.model_state,
                                                   jnp.asarray(x)), 2e-4)
        jstate, jcounts = jtrain(jstate, jnp.asarray(x), jnp.asarray(y), JEpochCounts.zero(2))
        counts = train_step(xt, yt, EpochCounts.zero(2))
        np.testing.assert_allclose(float(counts.loss_sum), float(jcounts.loss_sum), rtol=5e-4)
        np.testing.assert_array_equal(counts.tp.numpy(), np.asarray(jcounts.tp))
        got_params, got_state = resnet_tree(net.state_dict())
        for a, b in zip(jax.tree.leaves(jstate.model_state), jax.tree.leaves(got_state)):
            assert_close_to_scale(b, a, 1e-4)
        if step:
            continue
        grads, _ = resnet_tree({**{k: p.grad for k, p in net.named_parameters()},
                                **{k: v for k, v in net.state_dict().items() if "running" in k}})
        checked = differ = 0
        for g, a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jstate.params),
                           jax.tree.leaves(got_params)):
            sure = np.abs(g) > 1e-2 * np.abs(g).max()
            a = np.asarray(a)[sure]
            checked += a.size
            differ += int((~np.isclose(b[sure], a, rtol=1e-5, atol=1e-7)).sum())
        assert checked > 10 ** 7 and differ <= checked // 10 ** 4, (differ, checked)


@pytest.mark.parametrize("average,n_class", [("binary", 2), ("macro", 2), ("macro", 5)])
def test_counts_to_metrics_matches_jax(average, n_class):
    rs = np.random.RandomState(n_class)
    jc, pc = JEpochCounts.zero(n_class), EpochCounts.zero(n_class)
    for _ in range(3):
        logits = rs.randn(9, n_class).astype(np.float32)
        labels = rs.randint(0, n_class, 9).astype(np.int32)
        loss = float(rs.rand())
        jc = jax_update_counts(jc, jnp.float32(loss), jnp.asarray(logits), jnp.asarray(labels))
        pc = _update_counts(pc, torch.tensor(loss), torch.tensor(logits), torch.tensor(labels))
    got, want = counts_to_metrics(pc, average), jax_counts_to_metrics(jc, average)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(2)
    logits, labels = rs.randn(7, 3).astype(np.float32), rs.randint(0, 3, 7).astype(np.int32)
    np.testing.assert_allclose(
        float(cross_entropy_loss(torch.tensor(logits), torch.tensor(labels))),
        float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("name", ["Adam", "RMSprop"])
def test_optimizers_match_optax(name):
    """Three steps on the same gradients, weight decay on: torch's optimizers
    against the JAX package's optax chains, within rtol 1e-6."""
    cfg = dict(lr=1e-2, beta1=0.5, beta2=0.99, epsilon=1e-8, weight_decay=1e-2, name=name)
    rs = np.random.RandomState(3)
    w0 = rs.randn(6).astype(np.float32)
    grads = [rs.randn(6).astype(np.float32) for _ in range(3)]
    tx = jax_make_optimizer(JAdamConfig(**cfg))
    jw = jnp.asarray(w0)
    jst = tx.init(jw)
    w = torch.nn.Parameter(torch.tensor(w0))
    opt = make_optimizer(AdamConfig(**cfg), [w])
    for g in grads:
        upd, jst = tx.update(jnp.asarray(g), jst, jw)
        jw = optax.apply_updates(jw, upd)
        w.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


def test_change_classifier_head_keeps_the_trunk(resnet):
    net = resnet[0]
    out = change_classifier_head(net, 3, torch.Generator().manual_seed(9))
    again = change_classifier_head(net, 3, torch.Generator().manual_seed(9))
    assert out.fc.weight.shape == (3, 2048) and out.fc.bias.shape == (3,)
    bound = 1 / np.sqrt(2048)
    assert float(out.fc.weight.detach().abs().max()) <= bound
    assert float(out.fc.bias.detach().abs().max()) <= bound
    assert torch.equal(out.fc.weight, again.fc.weight)
    assert net.fc.weight.shape == (2, 2048)  # the original keeps its head
    for k, v in net.state_dict().items():
        if not k.startswith("fc."):
            assert torch.equal(out.state_dict()[k], v), k
    out.layer1[0].conv1.weight.data.zero_()
    assert float(net.layer1[0].conv1.weight.detach().abs().sum()) > 0  # a copy, not a view


class _Snapshots:
    """A metrics writer that keeps each epoch's weights."""

    def __init__(self, model):
        self.model, self.epochs = model, []

    def append(self, epoch, **metrics):
        self.epochs.append({k: v.clone() for k, v in self.model.state_dict().items()})


@pytest.mark.parametrize("patience", [10000, 0], ids=["no_plateau", "plateau_each_epoch"])
def test_train_cnn_early_stop_and_best_weights_match_jax(patience):
    """A linear model on 2x2 images whose training labels flip after epoch
    0: the val loss is best at an early epoch and then rises, early stopping
    ends the run, and the weights that come back are the best epoch's, not
    the last's. With patience 0 the plateau scale cuts the lr x0.1 after
    every epoch without improvement. History and weights within rtol 1e-4 of the JAX package's
    loop on the same batches (Adam at lr 0.05 over several epochs carries
    fp32 rounding along), the best epoch equal."""
    rs = np.random.RandomState(4)
    x = rs.randn(48, 1, 2, 2).astype(np.float32)
    y = (x.reshape(48, -1).sum(1) > 0).astype(np.int32)
    xv = rs.randn(16, 1, 2, 2).astype(np.float32)
    yv = (xv.reshape(16, -1).sum(1) > 0).astype(np.int32)
    w0 = (rs.randn(2, 4) * 0.1).astype(np.float32)
    b0 = np.zeros(2, np.float32)
    cfg = dict(lr=0.05, beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.0)

    def train_batches(to):
        def make(epoch):
            lab = y if epoch == 0 else 1 - y
            return [(to(x[i:i + 16]), to(lab[i:i + 16])) for i in range(0, 48, 16)]
        return make

    def val_batches(to):
        return lambda epoch: [(to(xv), to(yv))]

    rdef = JResNetDef("ResNet50", 1, 2, (0, 1))
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    jadam = JAdamConfig(**cfg)
    init = CnnTrainState(params, {}, jax_make_optimizer(jadam).init(params),
                         jnp.asarray(1.0, jnp.float32), jnp.asarray(0, jnp.int32))
    apply = lambda p, s, xx, d, train=False: (xx.reshape(xx.shape[0], -1) @ p["w"].T + p["b"], s)  # noqa: E731
    jstate, jhist, jbest = jax_train_cnn(
        jax.random.key(0), rdef, jadam, train_batches(jnp.asarray), val_batches(jnp.asarray),
        num_epochs=8, early_stopping=2, scheduler_patience=patience, label=1,
        init_state=init, apply_fn=apply)

    model = nn.Sequential(nn.Flatten(), nn.Linear(4, 2))
    with torch.no_grad():
        model[1].weight.copy_(torch.tensor(w0))
        model[1].bias.copy_(torch.tensor(b0))
    snaps = _Snapshots(model)
    model, hist, best = train_cnn(model, ResNetDef("ResNet50", 1, 2, (0, 1)), AdamConfig(**cfg),
                                  train_batches(torch.tensor), val_batches(torch.tensor),
                                  num_epochs=8, early_stopping=2, scheduler_patience=patience,
                                  label=1, metrics_writer=snaps)
    assert best == jbest and 0 < len(hist["val_loss"]) == len(jhist["val_loss"]) < 8
    assert best < len(hist["val_loss"]) - 1  # the best epoch is not the last
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(model[1].weight.detach().numpy(), np.asarray(jstate.params["w"]),
                               rtol=1e-4, atol=1e-6)
    assert torch.equal(model[1].weight, snaps.epochs[best]["1.weight"])
    assert not torch.equal(model[1].weight, snaps.epochs[-1]["1.weight"])
    assert not model.training
