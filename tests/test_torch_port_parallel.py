"""The port's parallel paths (`gan_discovery_pso_tpu_torch/parallel/`) on
the CPU: ranks are processes in a gloo group (a FileStore under tmp_path,
so no port is shared between test workers), the JAX side runs here on the
8 virtual CPU devices of tests/conftest.py, and the draws are JAX's
(`test_torch_port_swarm.jax_draws`).

Two groups are spawned, of 2 and of 4 ranks, each joined through the
GDPT_* variables (`distributed_initialize_if_needed`); every rank runs the
scenarios of `_rank` and returns its results, which the tests hold:
- against the port's unsharded run, bit for bit, wherever the fitness is
  row-wise (the sharded swarm, the multi-swarm runner, the checkpoint);
- against JAX within the tolerances of `tests/test_parallel.py`;
- the class x swarm runner (4 ranks) within `test_parallel.py:202-240`'s;
- the data-parallel GAN step against the one-process step and JAX's DP
  step, and, with the BN sync off, apart from it (the negative control).
The CLI's `--shard-swarm 2` starts its own two ranks (`parallel/launch.py`).
"""

import contextlib
import functools
import os
import pickle
import re
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P
from test_torch_port_swarm import jax_draws

from gan_discovery_pso_tpu.core.checkpoint import _plainify
from gan_discovery_pso_tpu.core.config import AdamConfig as JAdamConfig
from gan_discovery_pso_tpu.core.config import PsoConfig as JPsoConfig
from gan_discovery_pso_tpu.models import GeneratorDef as JGeneratorDef
from gan_discovery_pso_tpu.models import ResNetDef as JResNetDef
from gan_discovery_pso_tpu.models import generator_init, resnet_init
from gan_discovery_pso_tpu.models.dcgan import DiscriminatorDef as JDiscriminatorDef
from gan_discovery_pso_tpu.parallel import make_batched_sharded_discovery_runner as jax_grid
from gan_discovery_pso_tpu.parallel import make_mesh as jax_make_mesh
from gan_discovery_pso_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from gan_discovery_pso_tpu.parallel import make_multi_swarm_optimize as jax_multi
from gan_discovery_pso_tpu.parallel import make_sharded_optimize as jax_sharded
from gan_discovery_pso_tpu.parallel import make_shardmap_optimize as jax_shardmap
from gan_discovery_pso_tpu.pso import analytic as jax_analytic
from gan_discovery_pso_tpu.pso import last_iteration as jax_last_iteration
from gan_discovery_pso_tpu.pso import make_analytic_fitness
from gan_discovery_pso_tpu.pso import optimize as jax_optimize
from gan_discovery_pso_tpu.pso.swarm import swarm_init_from_positions as jax_seeded_init
from gan_discovery_pso_tpu.train import common as jcommon
from gan_discovery_pso_tpu.train import dcgan as jdcgan
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import (
    discriminator_tree,
    generator_params_tree,
    generator_state_dict,
    generator_tree,
    resnet_state_dict,
    resnet_tree,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core import AdamConfig
from gan_discovery_pso_tpu_torch.core.checkpoint import RowShard, save_pytree
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.models import (
    DiscriminatorDef,
    Generator,
    GeneratorDef,
    ResNet,
    ResNetDef,
    glorot_normal_init_,
)
from gan_discovery_pso_tpu_torch.ops.kernels import (
    swarm_move,
    swarm_move_plain,
    swarm_pbest_local,
    swarm_pbest_local_plain,
    swarm_update_plain,
)
from gan_discovery_pso_tpu_torch.parallel import (
    distributed_initialize_if_needed,
    history_sharding,
    make_batched_sharded_discovery_runner,
    make_mesh,
    make_mesh_2d,
    make_multi_swarm_optimize,
    make_shardmap_optimize,
    make_sharded_optimize,
    swarm_state_sharding,
)
from gan_discovery_pso_tpu_torch.parallel.swarm_sharding import order_key
from gan_discovery_pso_tpu_torch.pso import (
    PsoHistory,
    SwarmState,
    analytic,
    last_iteration,
    make_batched_discovery_runner,
    optimize,
    state_from_positions,
)
from gan_discovery_pso_tpu_torch.train import dcgan as train_dcgan
from gan_discovery_pso_tpu_torch.train.dcgan import gan_init, make_gan_train_step

CFG = "configs/dcgan_mnist.yaml"
IID = (0, 2, 3, 4, 6, 7, 8, 9)
ADAM = dict(lr=1e-3, beta1=0.5, beta2=0.99, epsilon=1e-8)
Z, F_, BATCH = 10, 16, 16  # the DP step's G, D and global batch (test_parallel.py:93)
# D's weights x10: at the DCGAN init its logits sit near 0, so the losses
# stay within 2e-6 of log 2 whether G's BN statistics are the global
# batch's or a rank's; scaled, the losses read G's images
D_SCALE = 10.0
# G's transposed-conv biases that feed a BN: the BN takes their per-channel
# shift out again, so their gradient is 0 but for rounding, and Adam's first
# step turns its sign into +-lr either way (ROADMAP §C)
BIASES_BEFORE_BN = ("convt1/b", "convt2/b")
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # the DP step's averaged gradients
HP_SPHERE = dict(n_iterations=25, n_particles=32, dim_space=4)  # test_parallel.py:25
HP_SEEDED = dict(n_iterations=10, n_particles=16, dim_space=3)  # :55
HP_STOP = dict(n_iterations=30, n_particles=32, dim_space=4, tolerance=1e-3,
               early_stopping=True)  # :173
HP_MULTI = dict(n_iterations=30, n_particles=16, dim_space=2)  # :66
HP_GRID = dict(n_iterations=4, n_particles=8, dim_space=8)  # :202
CENTERS = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.5]], np.float32)
GRID_IDXS = [0, 2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs, here and in every
    rank (the suite runs six workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _init(draws, hp: PsoConfig):
    """A B = 1 state and [iters, 1, N] r1, r2 from (pos, vel, r1, r2)."""
    pos, vel, r1, r2 = draws
    return state_from_positions(pos[None], vel[None], hp.w_inertia), r1[:, None], r2[:, None]


def _stack_draws(draws):
    """B swarms' (pos, vel, r1, r2) stacked: [B, N, d] and [iters, B, N]."""
    pos, vel, r1, r2 = zip(*draws)
    return torch.stack(pos), torch.stack(vel), torch.stack(r1, dim=1), torch.stack(r2, dim=1)


def _gan_tree(seed=3):
    """The JAX DP test's GAN state (D scaled) and its plain host tree."""
    state, _ = jdcgan.gan_init(jax.random.key(seed), JGeneratorDef(Z, 1, F_),
                               JDiscriminatorDef(1, F_), JAdamConfig(**ADAM))
    state = state._replace(disc_params=jax.tree.map(lambda a: a * D_SCALE, state.disc_params))
    return state, jax.tree.map(lambda a: np.array(a, copy=True), _plainify(state))


def _gan_draws(key):
    """The noise and label draws of the JAX train step under `key`."""
    kz, kp, kn = jax.random.split(key, 3)
    return tuple(torch.tensor(np.asarray(t)) for t in (
        jax.random.normal(kz, (BATCH, Z, 1, 1), jnp.float32),
        jcommon.smooth_positive(kp, (BATCH,)), jcommon.smooth_negative(kn, (BATCH,))))


def _port_gan_step(tree, real, draws, group=None) -> dict:
    state = gan_init(torch.Generator().manual_seed(0), GeneratorDef(Z, 1, F_),
                     DiscriminatorDef(1, F_), AdamConfig(**ADAM), device="cpu").load_tree(tree)
    m = make_gan_train_step(state, group=group)(real, draws)
    out = state.tree()
    grads = lambda net: {k: p.grad.clone() for k, p in net.named_parameters()}  # noqa: E731
    return {"losses": {k: float(v) for k, v in m.items()}, "gen_params": out["gen_params"],
            "disc_params": out["disc_params"], "gen_state": out["gen_state"],
            "gen_grads": generator_params_tree(grads(state.gen)),
            "disc_grads": discriminator_tree(grads(state.disc))}


def _grid_models(inputs):
    gen = Generator(GeneratorDef(8, 1, 8))
    gen.load_state_dict(to_tensors(generator_state_dict(*inputs["grid_gen"])), strict=True)
    net = ResNet(ResNetDef("ResNet50", 1, 8))
    net.load_state_dict(to_tensors(resnet_state_dict(*inputs["grid_cnn"])), strict=True)
    return gen.eval(), net.eval()


@pytest.fixture(scope="module")
def tiny_upstream(tmp_path_factory):
    """G z=8 f=16 and a 2-class ResNet-50, written by the port's writer."""
    root = tmp_path_factory.mktemp("upstream")
    g = torch.Generator().manual_seed(0)
    gen = Generator(GeneratorDef(8, 1, 16))
    torch.nn.init.normal_(gen.gen[0][0].weight, generator=g)
    cnn = glorot_normal_init_(ResNet(ResNetDef("ResNet50", 1, 2)), g)
    gp, gs = generator_tree(gen.state_dict())
    rp, rs = resnet_tree(cnn.state_dict())
    save_pytree(root / "gan" / "best_g.msgpack",
                {"epoch": 0, "state": {"gen_params": gp, "gen_state": gs}, "loss": 0.0})
    save_pytree(root / "cnn" / "model.msgpack", {"params": rp, "state": rs})
    return root


def _cli(root, upstream, name, *flags):
    return cli_main(["pso-discovery", "--cfg", CFG, "--tiny", "--device", "cpu", *flags,
                     "--path-gan", str(upstream / "gan"), "--path-cnn", str(upstream / "cnn"),
                     "--set", "data.iid_classes=[0,2]",
                     *(f"data.{k}_dir={root / name / k}" for k in ("reports", "model",
                                                                   "interim"))])


def _rank(inputs: dict) -> dict:
    """Every scenario on this rank; the results on the CPU."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(device="cpu")
    out = {"world": world, "rank": rank, "backend": dist.get_backend()}

    hp = PsoConfig(**HP_SPHERE)
    out["sphere"] = make_sharded_optimize(mesh, analytic.sphere, hp)(*_init(inputs["sphere"], hp))
    rows = swarm_state_sharding(mesh, hp.n_particles).positions[1]
    final = out["sphere"][0]
    save_pytree(inputs["ckpt"] / f"sharded_{world}.msgpack",
                {f: RowShard(getattr(final, f)[:, rows], rows.start, hp.n_particles, dim=1)
                 if f in ("positions", "velocities", "p_best_pos", "p_best_val")
                 else getattr(final, f) for f in SwarmState._fields}, mesh=mesh)

    hp = PsoConfig(**HP_SEEDED)
    out["seeded"] = make_sharded_optimize(mesh, analytic.sphere, hp)(*_init(inputs["seeded"], hp))

    hp = PsoConfig(**HP_STOP)
    out["stop"] = make_shardmap_optimize(mesh, analytic.sphere, hp)(*_init(inputs["stop"], hp))
    try:
        make_shardmap_optimize(mesh, analytic.sphere, PsoConfig(n_particles=2 * world + 1,
                                                                dim_space=4))
    except ValueError as e:
        out["uneven"] = str(e)

    real, draws = inputs["gan"]
    out["gan"] = _port_gan_step(inputs["gan_tree"], real, draws, group=dist.group.WORLD)
    # the negative control: G's train-mode BN on each rank's own rows
    unsynced = lambda group: contextlib.nullcontext()  # noqa: E731
    with unittest.mock.patch.object(train_dcgan, "sync_batch_norm", unsynced):
        out["gan_unsynced"] = _port_gan_step(inputs["gan_tree"], real, draws,
                                             group=dist.group.WORLD)

    if world == 2:
        # the CLI inside a process group that is already up: no new ranks
        out["cli_rc"] = _cli(*inputs["cli"], "in_group", "--shard-swarm", "2")
        hp = PsoConfig(**HP_MULTI)
        centers = torch.from_numpy(CENTERS)
        fit = lambda idx, pos: ((pos - centers[idx][:, None, :]) ** 2).sum(-1)  # noqa: E731
        pos, vel, r1, r2 = _stack_draws(inputs["multi"])
        out["multi"] = make_multi_swarm_optimize(fit, hp, 4, mesh=mesh)(
            state_from_positions(pos, vel, hp.w_inertia), r1, r2)
    else:
        hp = PsoConfig(**HP_GRID)
        grid = make_mesh_2d((2, 2), ("class", "swarm"), device="cpu")
        pos, vel, r1, r2 = _stack_draws(inputs["grid"])
        run = make_batched_sharded_discovery_runner(grid, hp, eps=0.1)
        out["grid"] = run(*_grid_models(inputs), GRID_IDXS,
                          init_state=state_from_positions(pos, vel, hp.w_inertia), r1=r1, r2=r2)
        out["grid_coords"] = grid.coords
    return out


def _gdpt_rank(rank: int, world: int, tmp: str, inputs: dict) -> None:
    os.environ.update(GDPT_COORDINATOR=f"file://{tmp}/store", GDPT_NUM_PROCESSES=str(world),
                      GDPT_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    joined = distributed_initialize_if_needed(device="cpu")
    try:
        out = {"joined": joined, **_rank(inputs)}
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory, tiny_upstream):
    """The draws, weights and GAN case every rank and the JAX side share."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    seeded_pos = np.random.RandomState(0).randn(16, 3).astype(np.float32)
    init_key, _ = jax.random.split(jax.random.key(1))
    seeded_vel = np.array(jax_seeded_init(init_key, jnp.asarray(seeded_pos), 0.73).velocities)
    _, _, r1, r2 = jax_draws(jax.random.key(1), 16, 3, HP_SEEDED["n_iterations"])
    gdef = JGeneratorDef(8, 1, 8)
    rdef = JResNetDef("ResNet50", 1, 8, IID)
    gp, gs = jax.jit(lambda k: generator_init(k, gdef))(jax.random.key(0))
    rp, rs = jax.jit(lambda k: resnet_init(k, rdef, init="glorot_normal"))(jax.random.key(1))
    host = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)  # noqa: E731
    state, tree = _gan_tree()
    real = np.random.RandomState(1).rand(BATCH, 1, 28, 28).astype(np.float32) * 2 - 1
    return {
        "ckpt": ckpt,
        "cli": (tmp_path_factory.mktemp("cli"), tiny_upstream),
        "sphere": jax_draws(jax.random.key(0), 32, 4, HP_SPHERE["n_iterations"]),
        "seeded": (torch.from_numpy(seeded_pos), torch.from_numpy(seeded_vel), r1, r2),
        "stop": jax_draws(jax.random.key(9), 32, 4, HP_STOP["n_iterations"]),
        "multi": [jax_draws(k, 16, 2, HP_MULTI["n_iterations"])
                  for k in jax.random.split(jax.random.key(2), 4)],
        "grid": [jax_draws(k, 8, 8, HP_GRID["n_iterations"])
                 for k in (jax.random.key(5), jax.random.key(6))],
        "grid_gen": (host(gp), host(gs)), "grid_cnn": (host(rp), host(rs)),
        "jax_grid_models": (rdef, gp, gs, rp, rs),
        "gan_tree": tree, "gan_state": state,
        "gan": (torch.from_numpy(real), _gan_draws(jax.random.key(4))),
    }


def _spawn(world: int, tmp, inputs: dict) -> list:
    shared = {k: v for k, v in inputs.items() if k not in ("jax_grid_models", "gan_state")}
    torch.multiprocessing.spawn(_gdpt_rank, args=(world, str(tmp), shared), nprocs=world,
                                join=True, start_method="spawn")
    out = []
    for rank in range(world):
        with open(tmp / f"rank_{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} for the groups of 2 and 4."""
    return {world: _spawn(world, tmp_path_factory.mktemp(f"world{world}"), inputs)
            for world in (2, 4)}


# -- analytic, the split halves, the order key ---------------------------------


@pytest.mark.parametrize("name", ["sphere", "cosine_mixture", "rastrigin"])
def test_analytic_objectives_match_jax(name):
    x = np.random.RandomState(3).randn(3, 7, 5).astype(np.float32) * 2
    want = jax.vmap(jax.vmap(getattr(jax_analytic, name)))(jnp.asarray(x))
    got = getattr(analytic, name)(torch.from_numpy(x))
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _split_update(s, fit, r1, r2, w, shards: int):
    """The split halves over `shards` row shards, the winner picked by
    `order_key` as the collective picks it; returns the whole swarm's
    (positions, velocities, p_best_pos, p_best_val, g_best_pos, g_best_val,
    g_prev_val, g_appended)."""
    n = s.positions.shape[1]
    cuts = np.linspace(0, n, shards + 1).astype(int)
    rows = [slice(int(a), int(b)) for a, b in zip(cuts, cuts[1:])]
    part = lambda t, r: t[:, r].contiguous()  # noqa: E731
    local = [swarm_pbest_local_plain(part(s.positions, r), part(s.p_best_pos, r),
                                     part(s.p_best_val, r), part(fit, r), r.start) for r in rows]
    keys = torch.stack([order_key(c.candidate[:, -1], c.cand_index) for c in local])
    winner = torch.stack([local[int(k)].candidate[i] for i, k in enumerate(keys.argmin(0))])
    moved = [swarm_move_plain(part(s.positions, r), part(s.velocities, r), c.p_best_pos,
                              part(r1, r), part(r2, r), winner, s.g_best_pos, s.g_best_val,
                              s.g_prev_val, w, 1.496, 1.496) for r, c in zip(rows, local)]
    cat = lambda xs: torch.cat(xs, dim=1)  # noqa: E731
    return (cat([m.positions for m in moved]), cat([m.velocities for m in moved]),
            cat([c.p_best_pos for c in local]), cat([c.p_best_val for c in local]),
            moved[0].g_best_pos, moved[0].g_best_val, moved[0].g_prev_val, moved[0].g_appended)


@pytest.mark.parametrize("shards", [2, 4])
def test_split_halves_compose_to_the_fused_update(shards):
    """The plain halves over 2 and 4 shards, chained over 6 iterations of
    [3, 13, 5] swarms (uneven shards), are bit-equal to
    `swarm_update_plain` on the whole swarms: an all-inf start, exact ties
    at the minimum (the first index wins, across shards too), a NaN (it
    comes first), -0.0 against +0.0 values."""
    g = torch.Generator().manual_seed(5)
    b, n, d = 3, 13, 5
    s = state_from_positions(torch.randn(b, n, d, generator=g),
                             torch.randn(b, n, d, generator=g) / 10, 0.73)
    for it in range(6):
        fit = (s.positions ** 2).sum(-1)
        if it == 0:
            fit = torch.full((b, n), torch.inf)
        if it >= 2:
            fit[:, 2::3] = fit.amin(dim=1, keepdim=True) - 1.0
        if it == 3:
            fit[0, 11] = torch.nan
        if it == 4:  # swarm 1's best: 0.0 at row 3 and -0.0 at row 12
            fit[1] = fit[1].abs() + 5.0
            fit[1, 3], fit[1, 12] = 0.0, -0.0
            s = s._replace(p_best_val=s.p_best_val.clone())
            s.p_best_val[1] = torch.inf
        r1, r2 = torch.rand(b, n, generator=g), torch.rand(b, n, generator=g)
        w = torch.full((b,), 0.73 * 0.99 ** it)
        whole = swarm_update_plain(s.positions, s.velocities, s.p_best_pos, s.p_best_val,
                                   fit, r1, r2, s.g_best_pos, s.g_best_val, s.g_prev_val, w,
                                   1.496, 1.496)
        got = _split_update(s, fit, r1, r2, w, shards)
        for name, x, y in zip(whole._fields, got, whole):
            assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                               y.view(torch.int32) if y.is_floating_point() else y), (it, name)
        s = s._replace(positions=whole.positions, velocities=whole.velocities,
                       p_best_pos=whole.p_best_pos, p_best_val=whole.p_best_val,
                       g_best_pos=whole.g_best_pos, g_best_val=whole.g_best_val,
                       g_prev_val=whole.g_prev_val)


def test_split_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions and launch
    nothing; a device they do not know raises."""
    g = torch.Generator().manual_seed(1)
    pos, pbp = torch.randn(2, 4, 3, generator=g), torch.randn(2, 4, 3, generator=g)
    pbv, fit = torch.rand(2, 4, generator=g), torch.rand(2, 4, generator=g)
    before = (swarm_pbest_local.launches, swarm_move.launches)
    got, want = swarm_pbest_local(pos, pbp, pbv, fit, 4), swarm_pbest_local_plain(
        pos, pbp, pbv, fit, 4)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert got.cand_index.dtype == torch.int32 and (got.cand_index >= 4).all()
    args = (pos, pos, pbp, fit, fit, want.candidate, pos[:, 0], pbv[:, 0], pbv[:, 1],
            torch.full((2,), 0.7), 1.5, 1.5)
    for x, y in zip(swarm_move(*args), swarm_move_plain(*args)):
        assert torch.equal(x, y)
    assert (swarm_pbest_local.launches, swarm_move.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        swarm_pbest_local(pos.to("meta"), pbp.to("meta"), pbv.to("meta"), fit.to("meta"), 0)


def test_order_key_orders_as_argmin():
    """The collective's key: NaN first, then the value (-0.0 ties +0.0),
    then the lower index; the winner of each row is torch.argmin's."""
    vals = torch.tensor([3.0, -0.0, 0.0, -2.5, torch.inf, -torch.inf, torch.nan, -1e-30, 1e-30])
    idx = torch.arange(vals.numel(), dtype=torch.int32)
    keys = order_key(vals, idx)
    assert int(keys.argmin()) == 6  # the NaN
    finite = torch.tensor([0, 1, 2, 3, 4, 5, 7, 8])
    order = finite[keys[finite].argsort()].tolist()
    assert order == [5, 3, 7, 1, 2, 8, 0, 4]  # -inf, -2.5, -1e-30, -0.0 = 0.0, 1e-30, 3, inf
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-3, 3, (50, 7), generator=g).float()
    x[::7, 3] = torch.nan
    k = order_key(x, torch.arange(7, dtype=torch.int32).expand(50, 7))
    assert torch.equal(k.argmin(1), torch.argmin(x, 1))


def test_mesh_of_one_process_and_its_layout():
    """Without a process group: no collective runs, a mesh of more ranks
    raises, and each rank's rows and classes come from the layout."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.size(), mesh.coords, mesh.backend) == (1, (0,), None)
    t = torch.arange(4.0)
    assert mesh.all_reduce(t, "min") is t and torch.equal(t, torch.arange(4.0))
    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh(2, device="cpu")
    sh = swarm_state_sharding(mesh, 32)
    assert sh.positions == (slice(0, 1), slice(0, 32)) and sh.g_best_val == (slice(0, 1),)
    assert history_sharding(mesh, 32).positions[2] == slice(0, 32)


def test_initialize_without_configuration_does_nothing(monkeypatch):
    for var in ("GDPT_COORDINATOR", "GDPT_NUM_PROCESSES", "GDPT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_initialize_if_needed(device="cpu") is False
    assert not dist.is_initialized()


# -- the spawned groups ----------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_join_through_the_gdpt_variables(ranks, world):
    for rank, res in enumerate(ranks[world]):
        assert (res["joined"], res["world"], res["rank"], res["backend"]) == (
            True, world, rank, "gloo")


def _assert_same(got, want, fields):
    for name, x, y in zip(fields, got, want):
        assert torch.equal(x.nan_to_num(-9.0) if x.is_floating_point() else x,
                           y.nan_to_num(-9.0) if y.is_floating_point() else y), name


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_optimize_is_bit_equal_to_optimize_and_near_jax(ranks, inputs, world):
    """World 2 and 4 on the sphere: final state and history bit-equal to the
    port's one-process optimize on every rank; against JAX's sharded
    optimize on 8 devices within `test_parallel.py:25-52`'s tolerances."""
    hp = PsoConfig(**HP_SPHERE)
    want_f, want_h, _ = optimize(analytic.sphere, hp, *_init(inputs["sphere"], hp))
    for res in ranks[world]:
        final, hist, _ = res["sphere"]
        _assert_same(final, want_f, SwarmState._fields)
        _assert_same(hist, want_h, PsoHistory._fields)
    jf, jh, _ = _jax_run("sphere")
    final, hist, _ = ranks[world][0]["sphere"]
    np.testing.assert_allclose(hist.g_best_val[0, :5].numpy(), np.asarray(jh.g_best_val)[:5],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(final.positions[0].numpy(), np.asarray(jf.positions),
                               rtol=5e-2, atol=5e-3)
    np.testing.assert_allclose(float(final.g_best_val[0]), float(jf.g_best_val), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_optimize_from_seeded_positions(ranks, inputs, world):
    """`test_parallel.py:55`: the run keeps the given positions as its init
    and improves on their best; bit-equal to one-process optimize."""
    hp = PsoConfig(**HP_SEEDED)
    init, r1, r2 = _init(inputs["seeded"], hp)
    want_f, _, _ = optimize(analytic.sphere, hp, init, r1, r2)
    final, _, got_init = ranks[world][0]["seeded"]
    assert torch.equal(got_init.positions[0], inputs["seeded"][0])
    _assert_same(final, want_f, SwarmState._fields)
    assert float(final.g_best_val[0]) < float(analytic.sphere(inputs["seeded"][0]).min())
    jf, _, _ = jax_sharded(jax_make_mesh(8, "swarm"), make_analytic_fitness(jax_analytic.sphere),
                           JPsoConfig(**HP_SEEDED))(jax.random.key(1),
                                                    jnp.asarray(inputs["seeded"][0].numpy()))
    np.testing.assert_allclose(float(final.g_best_val[0]), float(jf.g_best_val), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_shardmap_optimize_latches_early_stop_as_jax(ranks, inputs, world):
    """`test_parallel.py:173`: the trace freezes on the same iteration as
    JAX's shard_map swarm and the one-process run; an uneven particle count
    raises."""
    out = ranks[world][0]["stop"]
    jout, (_, jh, _) = _jax_run("stop")
    li = jax_last_iteration(jh)
    assert li < HP_STOP["n_iterations"] + 1
    trace, jtrace = out["g_best_trace"][0].numpy(), np.asarray(jout["g_best_trace"])
    np.testing.assert_array_equal(trace[li:], np.full_like(trace[li:], trace[li - 1]))
    np.testing.assert_array_equal(jtrace[li:], np.full_like(jtrace[li:], jtrace[li - 1]))
    np.testing.assert_allclose(trace[:li], jtrace[:li], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(out["g_best_val"][0]), float(jout["g_best_val"]),
                               rtol=1e-4, atol=1e-6)
    hp = PsoConfig(**HP_STOP)
    _, hist, _ = optimize(analytic.sphere, hp, *_init(inputs["stop"], hp))
    assert last_iteration(hist) == [li]
    assert torch.equal(out["g_best_trace"], hist.g_best_val)
    assert re.fullmatch(rf"n_particles {2 * world + 1} % mesh {world} != 0",
                        ranks[world][0]["uneven"])


def test_multi_swarm_matches_each_single_swarm_and_jax(ranks, inputs):
    """`test_parallel.py:66-90`: 4 swarms over 2 ranks, each bit-equal to
    its own one-swarm port run, within rtol 1e-3 (atol 1e-4) of JAX's,
    converged near its own center."""
    hp = PsoConfig(**HP_MULTI)
    finals, hists, _ = ranks[2][0]["multi"]
    assert finals.positions.shape == (4, 16, 2)
    keys = jax.random.split(jax.random.key(2), 4)
    centers = jnp.asarray(CENTERS)
    jf, _, _ = jax_multi(lambda idx, pos: jnp.sum((pos - centers[idx][None, :]) ** 2, axis=1),
                         JPsoConfig(**HP_MULTI), 4, mesh=jax_make_mesh(4, "swarm"))(keys)
    for i in range(4):
        c = torch.from_numpy(CENTERS[i])
        f1, h1, _ = optimize(lambda pos, c=c: ((pos - c) ** 2).sum(-1), hp,
                             *_init(inputs["multi"][i], hp))
        _assert_same([x[i:i + 1] for x in finals], f1, SwarmState._fields)
        _assert_same([x[i:i + 1] for x in hists], h1, PsoHistory._fields)
        np.testing.assert_allclose(float(finals.g_best_val[i]), float(jf.g_best_val[i]),
                                   rtol=1e-3, atol=1e-4)
        assert float(finals.g_best_val[i]) < 0.2


def test_class_by_swarm_runner_matches_batched_and_jax(ranks, inputs):
    """`test_parallel.py:202-240` on a 2 x 2 world: classes on one axis,
    particles on the other; every class row within that test's tolerances
    of the port's batched runner and of JAX's 2-D runner; the init as
    given; every rank holds the same whole result."""
    hp = PsoConfig(**HP_GRID)
    pos, vel, r1, r2 = _stack_draws(inputs["grid"])
    gen, net = _grid_models(inputs)
    bf, bh, _ = make_batched_discovery_runner(hp, eps=0.1, device="cpu")(
        gen, net, GRID_IDXS, init_state=state_from_positions(pos, vel, hp.w_inertia), r1=r1, r2=r2)
    rdef, gp, gs, rp, rs = inputs["jax_grid_models"]
    keys = jnp.stack([jax.random.key(5), jax.random.key(6)])
    jf, jh, _ = jax_grid(jax_make_mesh_2d((2, 4), ("class", "swarm")), rdef,
                         JPsoConfig(**HP_GRID))(keys, gp, gs, rp, rs,
                                                jnp.asarray(GRID_IDXS, jnp.int32))
    assert sorted(r["grid_coords"] for r in ranks[4]) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    sf, sh, si = ranks[4][0]["grid"]
    assert torch.equal(si.positions, pos)
    for other in ranks[4][1:]:
        _assert_same(other["grid"][0], sf, SwarmState._fields)
    for want_f, want_g in ((bf.g_best_val.numpy(), bh.g_best_val.numpy()),
                           (np.asarray(jf.g_best_val), np.asarray(jh.g_best_val))):
        np.testing.assert_allclose(sf.g_best_val.numpy(), want_f, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(sh.g_best_val.numpy(), want_g, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sf.positions.numpy(), bf.positions.numpy(), rtol=5e-2, atol=5e-3)
    np.testing.assert_allclose(sf.positions.numpy(), np.asarray(jf.positions), rtol=5e-2,
                               atol=5e-3)


@functools.lru_cache(maxsize=None)
def _jax_run(name: str):
    """JAX's sharded runs on the 8 virtual devices, once each."""
    sphere = make_analytic_fitness(jax_analytic.sphere)
    mesh = jax_make_mesh(8, "swarm")
    if name == "sphere":
        return jax_sharded(mesh, sphere, JPsoConfig(**HP_SPHERE))(jax.random.key(0))
    if name == "stop":
        run = jax.jit(lambda k: jax_optimize(k, sphere, JPsoConfig(**HP_STOP)))
        return (jax_shardmap(mesh, sphere, JPsoConfig(**HP_STOP))(jax.random.key(9)),
                run(jax.random.key(9)))
    raise KeyError(name)


def _leaves(tree) -> dict:
    """{'conv1/w': array, ...} of a parameter tree."""
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_dp_step(inputs):
    """The JAX step on the 8-device data mesh (`test_parallel.py:93`)."""
    real, _ = inputs["gan"]
    step = jdcgan.make_gan_train_step(JGeneratorDef(Z, 1, F_), JAdamConfig(**ADAM))
    mesh = jax_make_mesh(8, "data")
    repl = NamedSharding(mesh, P())
    state = jax.device_put(inputs["gan_state"], jax.tree.map(lambda _: repl,
                                                             inputs["gan_state"]))
    s8, m8 = jax.jit(step)(state, jax.device_put(jnp.asarray(real.numpy()),
                                                 NamedSharding(mesh, P("data"))),
                           jax.random.key(4))
    return {k: float(v) for k, v in m8.items()}, _plainify(s8)


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_gan_step_matches_one_process_and_jax(ranks, inputs, world):
    """Losses within rtol 1e-5 of the one-process step on the global batch
    and of JAX's DP step; the averaged gradients of G and D within
    GRAD_RTOL (atol GRAD_ATOL of the net's largest) of the one-process
    step's; every weight of G and D within rtol 5e-2 / atol 2e-4 of both
    (`test_parallel.py:93-121`), but for BIASES_BEFORE_BN, whose gradient
    must be rounding-level and whose weights move by lr either way; G's BN
    running statistics within 1e-6; every rank reports the same losses."""
    real, draws = inputs["gan"]
    one = _port_gan_step(inputs["gan_tree"], real, draws)
    jm, jstate = _jax_dp_step(inputs)
    res = ranks[world][0]["gan"]
    for other in ranks[world][1:]:
        assert other["gan"]["losses"] == res["losses"]
    for k in ("loss_gen", "loss_disc"):
        np.testing.assert_allclose(res["losses"][k], one["losses"][k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(res["losses"][k], jm[k], rtol=1e-5, err_msg=k)
    for net in ("gen", "disc"):
        want = _leaves(one[f"{net}_grads"])
        top = max(float(np.abs(g).max()) for g in want.values())
        for path, g in _leaves(res[f"{net}_grads"]).items():
            np.testing.assert_allclose(g, want[path], rtol=GRAD_RTOL, atol=GRAD_ATOL * top,
                                       err_msg=f"{net} gradient {path}")
            if net == "gen" and path in BIASES_BEFORE_BN:
                print(f"G {path}: one-process |grad| max {np.abs(want[path]).max():.3e} "
                      f"(G's largest {top:.3e})")
                assert np.abs(want[path]).max() <= GRAD_ATOL * top, path
    for want in (one, jstate):
        for net in ("gen", "disc"):
            ref = _leaves(want[f"{net}_params"])
            for path, a in _leaves(res[f"{net}_params"]).items():
                if net == "gen" and path in BIASES_BEFORE_BN:
                    assert np.abs(a - ref[path]).max() <= 2 * ADAM["lr"] * (1 + 1e-3), path
                else:
                    np.testing.assert_allclose(a, ref[path], rtol=5e-2, atol=2e-4,
                                               err_msg=f"{net} {path}")
    for want in (one["gen_state"], jstate["gen_state"]):
        for a, b in zip(jax.tree.leaves(res["gen_state"]), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_gan_step_without_bn_sync_differs(ranks, inputs, world):
    """The negative control: with each rank's own BN statistics, a loss
    moves more than 1e-5 (relative) from the one-process step's, and the
    running statistics move by far more than 1e-6."""
    real, draws = inputs["gan"]
    one = _port_gan_step(inputs["gan_tree"], real, draws)
    res = ranks[world][0]["gan_unsynced"]
    rel = max(abs(res["losses"][k] - one["losses"][k]) / abs(one["losses"][k])
              for k in ("loss_gen", "loss_disc"))
    assert rel > 1e-5
    stats = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree.leaves(res["gen_state"]), jax.tree.leaves(one["gen_state"])))
    assert stats > 1e-4


def test_sharded_checkpoint_is_byte_equal_to_the_unsharded_save(ranks, inputs, tmp_path):
    """World 2's rank 0 gathered the RowShards and wrote alone; the file is
    byte-equal to the one-process save of the same final state."""
    hp = PsoConfig(**HP_SPHERE)
    final, _, _ = optimize(analytic.sphere, hp, *_init(inputs["sphere"], hp))
    save_pytree(tmp_path / "whole.msgpack", final)
    for world in (2, 4):
        got = (inputs["ckpt"] / f"sharded_{world}.msgpack").read_bytes()
        assert got == (tmp_path / "whole.msgpack").read_bytes()


# -- the CLI ---------------------------------------------------------------------


def _artifacts(root):
    """(the files under root, g_best per class of its one run)."""
    files = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    with open(root / "reports" / "mnist" / "00001--pso_discovery" / "general"
              / "overall_history.pkl", "rb") as f:
        return files, np.asarray([v["global_best_val"][-1] for v in pickle.load(f).values()])


def test_cli_shard_swarm_writes_the_unsharded_artifacts(ranks, inputs, tiny_upstream, tmp_path,
                                                        monkeypatch):
    """`pso-discovery --shard-swarm 2` starts two gloo ranks on the CPU,
    and inside a group of 2 already up (world 2's ranks) it runs on it:
    both write the same files as the sequential run, g_best per class
    within rtol 1e-4 of it (the ResNet sees 4 images a rank, not 8), rank
    0's log naming both ranks' backend and device and their launches."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert _cli(tmp_path, tiny_upstream, "seq") == 0
    assert _cli(tmp_path, tiny_upstream, "shard", "--shard-swarm", "2") == 0
    assert not dist.is_initialized()
    assert [r["cli_rc"] for r in ranks[2]] == [0, 0]
    files, g_best = _artifacts(tmp_path / "seq")
    assert len(files) > 20
    for root in (tmp_path / "shard", inputs["cli"][0] / "in_group"):
        got_files, got_g = _artifacts(root)
        assert got_files == files
        np.testing.assert_allclose(got_g, g_best, rtol=1e-4)
        log = (root / "reports" / "mnist" / "00001--pso_discovery" / "log.txt").read_text()
        assert "2 ranks, backend gloo: rank 0 on cpu, rank 1 on cpu" in log
        assert re.search(r"launches per rank: \[\{.*\}, \{.*\}\]", log)
    assert re.search(r"2 ranks started, process group up in [0-9.]+s",
                     (tmp_path / "shard" / "reports" / "mnist" / "00001--pso_discovery"
                      / "log.txt").read_text())
