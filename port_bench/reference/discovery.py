"""The discovery configurations' check: each recorded call's layers and
swarm against the plain reference (`check.py`), and every call's answer in
the fitness's range."""

from __future__ import annotations

import torch

from port_bench.reference import check, pso


def answer_ok(cfg: dict, out: dict) -> bool:
    """Every swarm's final global best finite and in [eps, 1 + eps]."""
    eps = cfg["fitness"]["eps"]
    g = out["final"]["g_best_val"]
    return bool(torch.isfinite(g).all() and (g >= eps).all() and (g <= 1.0 + eps).all())


def compare(cfg: dict, state_dicts: dict, records: list, device) -> dict:
    f = cfg["fitness"]
    numbers = []
    with check.full_fp32():
        ref = check.reference_models(cfg, state_dicts, device)
        for rec in records:
            inp, out = rec["inputs"], rec["out"]
            x0 = inp["positions"]
            b, n, _ = x0.shape
            t_iter = inp["r1"].shape[0]
            x = check.pre_move(x0, out, device)  # [T, B, N, d]
            nums, _img_ref, logits_ref = check.layers(ref, rec, x.reshape(t_iter, b * n, -1),
                                                      t_iter)
            if logits_ref is None:
                nums["fitness_abs"] = float("inf")
            else:
                classes = torch.tensor(inp["classes"], device=device).repeat_interleave(n)
                fit = pso.fitness(pso.posterior(logits_ref, classes.repeat(t_iter)),
                                  f["control"], f["threshold"], f["eps"])
                got = out["history"]["fitness"].to(device).transpose(0, 1)  # [T, B, N]
                nums["fitness_abs"] = float((fit.reshape(t_iter, b, n) - got).abs().max())
            nums["swarm_bits"] = check.swarm_bits(cfg["pso"], x0, inp["velocities"], inp["r1"],
                                                  inp["r2"], out, device)
            numbers.append(nums)
    return check.worst(numbers)
