"""The plain reference against the measured program at a small size on the
CPU: the models, the fitness, B2's and B1's semantics, one swarm step."""

import torch

from port_bench import weights
from port_bench.reference import models, pso

from gan_discovery_pso_tpu_torch.models import (
    Encoder, EncoderDef, Generator, GeneratorDef, ResNet, ResNetDef)
from gan_discovery_pso_tpu_torch.ops.kernels import rescale01_rows_plain, swarm_update_plain
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.pso import (
    apply_discovery_fitness, inverter_fitness, pso_iteration, state_from_positions)

CFG = {"image": {"size": 28, "channels": 1}, "gan": {"z_dim": 6, "features_g": 8},
       "assessor": {"model_name": "ResNet50", "n_class": 5}, "encoder": {"features_e": 8}}
SCHEMES = {"gen": "dcgan", "assessor": "glorot_normal", "encoder": "dcgan"}


def pair(seed: int = 3):
    """(reference models, the program's models), one state dict each role."""
    g = torch.Generator().manual_seed(seed)
    ref = models.build(CFG)
    sds = {r: weights.make_state_dict(m, SCHEMES[r], g, "cpu") for r, m in ref.items()}
    prog = {"gen": Generator(GeneratorDef(6, 1, 8)),
            "assessor": ResNet(ResNetDef("ResNet50", 1, 5)),
            "encoder": Encoder(EncoderDef(6, 1, 8))}
    for role in ref:
        ref[role].load_state_dict(sds[role], strict=True)
        prog[role].load_state_dict(sds[role], strict=True)
        prog[role].eval()
    return ref, prog


def close(a, b, tol=1e-5):
    scale = b.abs().max().clamp_min(1e-30)
    assert float((a - b).abs().max() / scale) < tol


def test_models_match_the_program():
    ref, prog = pair()
    z = torch.randn(5, 6, generator=torch.Generator().manual_seed(1))
    x = torch.rand(5, 1, 28, 28, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        close(ref["gen"](z), prog["gen"](z[:, :, None, None]))
        close(ref["assessor"](x), prog["assessor"](x))
        close(ref["encoder"](x * 2 - 1), prog["encoder"](x * 2 - 1).reshape(5, -1))


def test_weights_are_seeded_and_reference_named():
    ref = models.build(CFG, "meta")
    a = weights.make_state_dict(ref["assessor"], "glorot_normal",
                                torch.Generator().manual_seed(7), "cpu")
    b = weights.make_state_dict(ref["assessor"], "glorot_normal",
                                torch.Generator().manual_seed(7), "cpu")
    assert a.keys() == ResNet(ResNetDef("ResNet50", 1, 5)).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    g = weights.make_state_dict(models.build(CFG, "meta")["gen"], "dcgan",
                                torch.Generator().manual_seed(7), "cpu")
    assert abs(float(g["gen.0.1.weight"].mean()) - 1.0) < 0.01  # BN weights N(1, 0.02)


def test_rescale_is_b2s_plain_semantics():
    x = torch.randn(9, 1, 28, 28, generator=torch.Generator().manual_seed(4))
    x[3] = 0.5  # a constant image: 0/0 gives NaN on both sides
    got = rescale01_rows_plain(x.reshape(9, -1)).reshape(x.shape)
    want = pso.rescale01(x)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_discovery_and_hybrid_fitness_match():
    ref, prog = pair()
    g = torch.Generator().manual_seed(5)
    pos = torch.randn(6, 6, generator=g)
    classes = torch.tensor([0, 1, 2, 3, 4, 0])
    src = torch.rand(6, 1, 28, 28, generator=g) * 2 - 1
    f = {"control": "optimize_out_training", "threshold": 0.0, "eps": 0.1,
         "w_ass": 1.0, "w_rec": 1.0}
    with torch.no_grad():
        got = apply_discovery_fitness(pos, prog["gen"], prog["assessor"], classes, eps=0.1)
        img = ref["gen"](pos)
        p = pso.posterior(ref["assessor"](pso.rescale01(img)), classes)
        close(pso.fitness(p, f["control"], 0.0, 0.1), got)
        got_h = inverter_fitness(pos, prog["gen"], prog["assessor"], src, classes,
                                 control="optimize_out_training", eps=0.1)
        close(pso.hybrid_fitness(p, src, img, f), got_h)
        # a binary head scores column 1 whatever the class
        two = torch.randn(4, 2, generator=g)
        assert torch.equal(pso.posterior(two, torch.zeros(4, dtype=torch.long)),
                           torch.softmax(two, 1)[:, 1])


def draws(b, n, d, seed=6):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, n, d, generator=g), torch.randn(b, n, d, generator=g),
            torch.rand(b, n, generator=g), torch.rand(b, n, generator=g),
            torch.rand(b, n, generator=g))


def test_update_is_b1s_plain_semantics_bit_for_bit():
    b, n, d = 3, 7, 5
    x, v, f, r1, r2 = draws(b, n, d)
    p_pos, p_val = x + 0.1, torch.full((b, n), 0.5)
    p_val[0, 2] = 0.2  # a personal best that holds
    g_pos = torch.zeros(b, d)
    g_val = torch.tensor([float("inf"), 0.3, 0.9])
    g_prev = torch.tensor([float("inf"), 0.4, 1.0])
    w = torch.full((b,), 0.73)
    got = swarm_update_plain(x, v, p_pos, p_val, f, r1, r2, g_pos, g_val, g_prev, w,
                             1.496, 1.496)
    want = pso.update(x, v, p_pos, p_val, f, r1, r2, g_pos, g_val, g_prev, w, 1.496, 1.496)
    fields = ("positions", "velocities", "p_best_pos", "p_best_val", "g_best_pos",
              "g_best_val", "g_prev_val")
    for name, a in zip(fields, want):
        assert torch.equal(getattr(got, name), a), name


def test_one_swarm_step_matches():
    b, n, d = 2, 6, 4
    x, v, f, r1, r2 = draws(b, n, d, seed=8)
    hp = PsoConfig(n_iterations=1, n_particles=n, dim_space=d)
    state = state_from_positions(x, v, hp.w_inertia)
    new = pso_iteration(state, f, r1, r2, hp)
    inf = torch.full((b,), float("inf"))
    want = pso.update(x, v, x, torch.full((b, n), float("inf")), f, r1, r2,
                      torch.zeros(b, d), inf, inf, torch.full((b,), hp.w_inertia),
                      hp.w_cognitive, hp.w_social)
    for a, w in zip((new.positions, new.velocities, new.p_best_pos, new.p_best_val,
                     new.g_best_pos, new.g_best_val, new.g_prev_val), want):
        assert torch.equal(a, w)
