"""The port's `make_gan_train_scan_step` against the JAX package's on the
CPU, at z 8, f 16, batch 8 (`tests/test_train.py:456`'s sizes).

On the CPU the scan is the plain loop of K eager steps (the card captures
them as one CUDA graph, which `chip_smoke.py` holds bit-equal to K eager
steps there). Both packages are fed the draws that JAX's
`fold_in(key, i)` makes for step i, as numpy arrays.

Tolerances, those of `tests/test_train.py:456` (JAX's scan against its own
steps): K = 1, the losses within rtol 1e-5 / atol 1e-6 and the weights
within rtol 1e-2 / atol 2e-4; K = 3, the weights within rtol 5e-2 / atol
1e-3 and the losses within rtol 1e-2 / atol 5e-3, every weight of G and D
included. The scan against K eager port steps, the state put back after a capture's
warm-up, and the checkpoint tree are held bit for bit."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.core.checkpoint import _plainify
from gan_discovery_pso_tpu.core.checkpoint import load_pytree as jax_load_pytree
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.models.dcgan import DiscriminatorDef as JDiscriminatorDef
from gan_discovery_pso_tpu.models.dcgan import GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.train import common as jcommon
from gan_discovery_pso_tpu.train import dcgan as jdcgan
from gan_discovery_pso_tpu_torch.core import AdamConfig
from gan_discovery_pso_tpu_torch.core.checkpoint import save_pytree
from gan_discovery_pso_tpu_torch.models import DiscriminatorDef, GeneratorDef
from gan_discovery_pso_tpu_torch.train import (
    gan_init,
    make_gan_train_scan_step,
    make_gan_train_step,
)
from gan_discovery_pso_tpu_torch.train.common import make_capturable
from gan_discovery_pso_tpu_torch.train.dcgan import restore_state, snapshot_state

Z, F_, BATCH, K = 8, 16, 8, 3
ADAM = dict(lr=1e-3, beta1=0.5, beta2=0.99, epsilon=1e-8)  # test_train.py:39


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's state at `gan_init(key(3))`, the reals of test_train.py:474,
    the draws of fold_in(key(42), i), JAX's K sequential steps and its
    scan of 1 and of K."""
    gdef, adam = JGeneratorDef(Z, 1, F_), JAdamConfig(**ADAM)
    state0, _ = jdcgan.gan_init(jax.random.key(3), gdef, JDiscriminatorDef(1, F_), adam)
    tree0 = _host(_plainify(state0))
    step = jax.jit(jdcgan.make_gan_train_step(gdef, adam))
    scan = jax.jit(jdcgan.make_gan_train_scan_step(gdef, adam))
    reals = np.random.RandomState(1).rand(K, BATCH, 1, 28, 28).astype(np.float32) * 2 - 1
    key = jax.random.key(42)
    draws = []
    for i in range(K):
        kz, kp, kn = jax.random.split(jax.random.fold_in(key, i), 3)
        draws.append([np.asarray(jax.random.normal(kz, (BATCH, Z, 1, 1), jnp.float32)),
                      np.asarray(jcommon.smooth_positive(kp, (BATCH,))),
                      np.asarray(jcommon.smooth_negative(kn, (BATCH,)))])
    draws = [np.stack(col) for col in zip(*draws)]
    s, seq = state0, []
    for i in range(K):
        s, m = step(s, jnp.asarray(reals[i]), jax.random.fold_in(key, i))
        seq.append({k: float(v) for k, v in m.items()})
        if i == 0:
            one = _host(_plainify(s))
    s1, m1 = scan(state0, jnp.asarray(reals[:1]), key)
    sk, mk = scan(state0, jnp.asarray(reals), key)
    return {"tree0": tree0, "reals": reals, "draws": draws, "seq": seq, "one": one,
            "seq_state": _host(_plainify(s)), "scan1": (_host(_plainify(s1)), m1),
            "scank": (_host(_plainify(sk)), mk)}


def _port_state(tree):
    return gan_init(torch.Generator().manual_seed(0), GeneratorDef(Z, 1, F_),
                    DiscriminatorDef(1, F_), AdamConfig(**ADAM), device="cpu").load_tree(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _assert_weights(got: dict, want: dict, rtol, atol, what: str):
    for net in ("gen_params", "disc_params"):
        ref = _leaves(want[net])
        for path, a in _leaves(got[net]).items():
            np.testing.assert_allclose(a, ref[path], rtol=rtol, atol=atol,
                                       err_msg=f"{what} {net} {path}")


def _scan(tree, reals, draws):
    state = _port_state(tree)
    m = make_gan_train_scan_step(state)(torch.tensor(reals),
                                        tuple(torch.tensor(d) for d in draws))
    return state, {k: v.numpy() for k, v in m.items()}


def test_one_scanned_step_matches_jax(jax_side):
    """K = 1: the losses of the port's scan within rtol 1e-5 / atol 1e-6 of
    JAX's step and of JAX's scan, its weights within rtol 1e-2 / atol 2e-4
    of both."""
    state, m = _scan(jax_side["tree0"], jax_side["reals"][:1],
                     [d[:1] for d in jax_side["draws"]])
    assert {k: v.shape for k, v in m.items()} == {"loss_gen": (1,), "loss_disc": (1,)}
    assert state.step == 1
    jscan_tree, jm = jax_side["scan1"]
    for name in ("loss_gen", "loss_disc"):
        for want in (jax_side["seq"][0][name], float(np.asarray(jm[name])[0])):
            np.testing.assert_allclose(m[name][0], want, rtol=1e-5, atol=1e-6, err_msg=name)
    for want in (jax_side["one"], jscan_tree):
        _assert_weights(state.tree(), want, 1e-2, 2e-4, "K=1")


def test_scanned_trajectory_matches_jax(jax_side):
    """K = 3: the loss trajectory within rtol 1e-2 / atol 5e-3 of JAX's
    sequential steps and of its scan, the weights within rtol 5e-2 / atol
    1e-3 of both; the step count and Adam's count are 3."""
    state, m = _scan(jax_side["tree0"], jax_side["reals"], jax_side["draws"])
    jscan_tree, jm = jax_side["scank"]
    for name in ("loss_gen", "loss_disc"):
        for want in ([s[name] for s in jax_side["seq"]], np.asarray(jm[name])):
            np.testing.assert_allclose(m[name], want, rtol=1e-2, atol=5e-3, err_msg=name)
    for want in (jax_side["seq_state"], jscan_tree):
        _assert_weights(state.tree(), want, 5e-2, 1e-3, "K=3")
    tree = state.tree()
    assert int(tree["step"]) == K
    assert int(tree["opt_g"][0]["count"]) == int(tree["opt_d"][0]["count"]) == K


def _everything(state) -> list:
    out = [*state.gen.state_dict().values(), *state.disc.state_dict().values()]
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            out += [v for v in st.values() if torch.is_tensor(v)]
    return out


def _bits_equal(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


SCAN_CASES = {
    "triple": dict(),
    "generator": dict(generator=True),
    "generator without smoothing": dict(generator=True, label_smoothing=False),
    "bf16": dict(compute_dtype=torch.bfloat16),
}


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_equals_k_eager_port_steps(jax_side, case):
    """The scan of K steps against K calls of the port's step from the same
    state and the same draws, bit for bit: the losses, every weight and BN
    statistic, the optimizers' state and the step count. A generator gives
    the scan exactly the draws it gives K steps, in the same order."""
    kw = dict(SCAN_CASES[case])
    generator = kw.pop("generator", False)
    reals = torch.tensor(jax_side["reals"])
    draws = [torch.tensor(d) for d in jax_side["draws"]]
    eager, scanned = _port_state(jax_side["tree0"]), _port_state(jax_side["tree0"])
    step = make_gan_train_step(eager, **kw)
    rng = torch.Generator().manual_seed(7)
    rows = [step(reals[i], rng if generator else tuple(d[i] for d in draws))
            for i in range(K)]
    got = make_gan_train_scan_step(scanned, **kw)(
        reals, torch.Generator().manual_seed(7) if generator else tuple(draws))
    for name in ("loss_gen", "loss_disc"):
        assert torch.equal(got[name], torch.stack([r[name] for r in rows])), name
    _bits_equal(_everything(scanned), _everything(eager))
    assert scanned.step == eager.step == K


def test_snapshot_restore_undoes_warm_up_steps(jax_side):
    """What a capture does around its warm-up, on the CPU: steps run after
    `snapshot_state` are undone by `restore_state` in the same tensors, and
    a fresh optimizer's state made by them becomes a fresh optimizer's
    again (its next step equals a never-stepped copy's, bit for bit)."""
    reals = torch.tensor(jax_side["reals"])
    draws = [torch.tensor(d) for d in jax_side["draws"]]
    fresh = _port_state(jax_side["tree0"])
    state = copy.deepcopy(fresh)
    step = make_gan_train_step(state)
    snap = snapshot_state(state)
    before = [t.clone() for t in _everything(state)]
    ptrs = [t.data_ptr() for t in _everything(state)]
    for i in range(K):
        step(reals[i], tuple(d[i] for d in draws))
    restore_state(state, snap)
    assert state.step == 0
    assert [t.data_ptr() for t in _everything(state)[:len(ptrs)]] == ptrs
    _bits_equal(_everything(state)[:len(before)], before)
    m = step(reals[0], tuple(d[0] for d in draws))
    m_fresh = make_gan_train_step(fresh)(reals[0], tuple(d[0] for d in draws))
    assert all(torch.equal(m[k], m_fresh[k]) for k in m)
    _bits_equal(_everything(state), _everything(fresh))


def test_scanned_state_reads_back_in_the_jax_layout(jax_side, tmp_path):
    """A state saved after a scan of K steps (its optimizers switched to
    `capturable`, as the card's scan does) is read by the JAX package's
    loader into the tree of JAX's `GanTrainState` after K steps: the same
    structure, the same leaves bit for bit as the port's, step and counts
    K."""
    state, _m = _scan(jax_side["tree0"], jax_side["reals"], jax_side["draws"])
    make_capturable(state.opt_g)
    make_capturable(state.opt_d)
    assert all(g["capturable"] for opt in (state.opt_g, state.opt_d)
               for g in opt.param_groups)
    path = tmp_path / "checkpoint_g.msgpack"
    save_pytree(path, {"epoch": 0, "state": state.tree(), "loss": 0.0})
    got = jax_load_pytree(path)["state"]
    want = jax_side["seq_state"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    mine = state.tree()
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(mine)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert int(got["step"]) == K and int(got["opt_g"][0]["count"]) == K
    back = _port_state(jax_side["tree0"]).load_tree(_host(got))
    _bits_equal(_everything(back), _everything(state))


def test_scan_step_refuses_a_process_group(jax_side):
    with pytest.raises(ValueError, match="ROADMAP A21"):
        make_gan_train_scan_step(_port_state(jax_side["tree0"]), group=object())
