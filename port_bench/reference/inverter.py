"""The pso-inverter configurations' check: the encoder, each recorded
call's layers, the hybrid fitness and the swarm against the plain reference
(`check.py`), and every call's answer in the hybrid fitness's range."""

from __future__ import annotations

import torch

from port_bench.reference import check, pso


def answer_ok(cfg: dict, out: dict) -> bool:
    """The final global best finite and in [2 eps, w_ass + 2 eps + 4 w_rec]
    (pixels in [-1, 1])."""
    f = cfg["fitness"]
    g = out["final"]["g_best_val"]
    hi = f["w_ass"] * (1.0 + f["eps"]) + 4.0 * f["w_rec"] + f["eps"]
    return bool(torch.isfinite(g).all() and (g >= 2 * f["eps"]).all() and (g <= hi).all())


def compare(cfg: dict, state_dicts: dict, records: list, device) -> dict:
    f = cfg["fitness"]
    numbers = []
    with check.full_fp32():
        ref = check.reference_models(cfg, state_dicts, device)
        for rec in records:
            inp, out = rec["inputs"], rec["out"]
            src = inp["source"]
            latents = rec.get("encoder_out")
            nums = {"enc_rel": check.rel(check.in_blocks(ref["encoder"], src), latents)
                    if latents is not None else float("inf")}
            x0 = (latents if latents is not None else torch.zeros(
                src.shape[0], cfg["gan"]["z_dim"], device=device))[None].float()
            n = x0.shape[1]
            t_iter = inp["r1"].shape[0]
            x = check.pre_move(x0, out, device)  # [T, 1, N, d]
            layer_nums, img_ref, logits_ref = check.layers(ref, rec, x.reshape(t_iter, n, -1),
                                                           t_iter)
            nums.update(layer_nums)
            if logits_ref is None:
                nums["fitness_abs"] = float("inf")
            else:
                classes = torch.full((t_iter * n,), int(inp["class_idx"]), device=device)
                fit = pso.hybrid_fitness(pso.posterior(logits_ref, classes),
                                         src.repeat(t_iter, 1, 1, 1), img_ref, f)
                got = out["history"]["fitness"].to(device)[0]  # [T, N]
                nums["fitness_abs"] = float((fit.reshape(t_iter, n) - got).abs().max())
            nums["swarm_bits"] = check.swarm_bits(cfg["pso"], x0, inp["velocities"], inp["r1"],
                                                  inp["r2"], out, device)
            numbers.append(nums)
    return check.worst(numbers)
