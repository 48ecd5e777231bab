"""The comparison of a recorded call with the plain reference, layer by
layer, each layer fed the measured program's own input (the swarm is
chaotic over 50 iterations, so two free-running swarms part on rounding):

- `img_gap`: the reference generator at the swarm's pre-move positions z
  against the program's images: the widest |diff| of a row over 1 + |z|
  of that row. Before its tanh the generator is piecewise affine in z, so
  its rounding grows with |z|; the swarm's particles reach |z| of 10^4 on
  some seeds, where an unscaled gap read 100 times what it reads near the
  origin;
- `rescale_bits`: the reference rescale of the program's images against the
  program's rescaled images: entries that differ (exact);
- `logit_rel`: the reference assessor on the program's rescaled images
  against the program's logits, max |diff| over max |reference|;
- `fitness_abs`: the reference fitness from the reference's logits (and,
  for the hybrid fitness, the reference's images) against the fitness the
  program's history holds, max |diff|;
- `swarm_bits`: the reference update, fed each iteration the program's
  positions, velocities and fitness and its own personal and global bests,
  against the program's moved positions, velocities, global-best series and
  final state: entries that differ (exact);
- `enc_rel` (a patient's swarm): the reference encoder on the patient's
  slices against the program's initial positions.

The reference runs in float32 with TF32 off, in blocks of rows, after the
measured window; the program's models are gone by then.
"""

from __future__ import annotations

import contextlib

import torch

from port_bench.reference import models, pso

BLOCK_ROWS = 2048


@contextlib.contextmanager
def full_fp32():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def reference_models(cfg: dict, state_dicts: dict, device) -> dict:
    ref = models.build(cfg, device)
    for role, model in ref.items():
        model.load_state_dict(state_dicts[role], strict=True)
    return ref


def in_blocks(model, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([model(x[i:i + BLOCK_ROWS]) for i in range(0, x.shape[0], BLOCK_ROWS)])


def rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    """max |ref - got| / max |ref|; inf where shapes differ or a value is
    not finite in one and finite in the other."""
    if ref.shape != got.shape:
        return float("inf")
    diff = (ref.float() - got.float()).abs()
    if not bool(torch.isfinite(diff).all()):
        return float("inf")
    return float(diff.max() / ref.abs().max().clamp_min(torch.finfo(torch.float32).tiny))


def row_gap_per_input(ref: torch.Tensor, got: torch.Tensor, inputs: torch.Tensor) -> float:
    """max over rows of max |ref - got| / (1 + |input row|); inf where
    shapes differ or a gap is not finite."""
    if ref.shape != got.shape:
        return float("inf")
    gap = (ref.float() - got.float()).abs().reshape(ref.shape[0], -1).amax(dim=1)
    if not bool(torch.isfinite(gap).all()):
        return float("inf")
    return float((gap / (1.0 + inputs.reshape(inputs.shape[0], -1).norm(dim=1))).max())


def unequal(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of a and b that differ (NaN matches NaN); every entry where
    the shapes differ."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
    return int((~same).sum())


def stacked(record: dict, key: str) -> torch.Tensor:
    """The call's captured tensors under `key`, one fitness call after
    another along dim 0."""
    parts = record.get(key)
    return torch.cat([t.float() for t in parts]) if parts else torch.empty(0)


def layers(ref: dict, record: dict, x: torch.Tensor, n_iter: int) -> tuple:
    """The per-layer numbers of one recorded call over its n_iter fitness
    calls at pre-move positions x [T, M, d] (M rows an iteration):
    (numbers, reference images [T*M, ...], reference logits [T*M, K])."""
    rows = x.reshape(-1, x.shape[-1])
    img, img01 = stacked(record, "gen_out"), stacked(record, "assessor_in")
    logits = stacked(record, "assessor_out")
    if len(record.get("gen_out", [])) != n_iter or any(
            t.shape[0] != rows.shape[0] for t in (img, img01, logits)):
        inf = float("inf")
        return {"img_gap": inf, "rescale_bits": inf, "logit_rel": inf}, None, None
    img_ref = in_blocks(ref["gen"], rows)
    logits_ref = in_blocks(ref["assessor"], img01)
    nums = {"img_gap": row_gap_per_input(img_ref, img, rows),
            "rescale_bits": unequal(pso.rescale01(img), img01),
            "logit_rel": rel(logits_ref, logits)}
    return nums, img_ref, logits_ref


def swarm_bits(hp: dict, x0, v0, r1, r2, out: dict, device) -> int:
    """The teacher-forced swarm: entries of the program's moves, global-best
    series and final state that differ from the reference update's."""
    if hp["schedule_inertia"] or hp["early_stopping"]:
        raise ValueError("the reference follows neither the inertia schedule nor early stop")
    h = {k: t.to(device) for k, t in out["history"].items()}
    fin = {k: t.to(device) for k, t in out["final"].items()}
    b, n, d = x0.shape
    t_iter = r1.shape[0]
    inf = torch.full((b,), float("inf"), device=device)
    p_pos, p_val = x0, torch.full((b, n), float("inf"), device=device)
    g_pos, g_val, g_prev = torch.zeros((b, d), device=device), inf, inf
    w = torch.full((b,), hp["w_inertia"], device=device)
    bits = 0
    x, v = x0, v0
    for t in range(t_iter):
        f = h["fitness"][:, t]
        x_ref, v_ref, p_pos, p_val, g_pos, g_val, g_prev = pso.update(
            x, v, p_pos, p_val, f, r1[t], r2[t], g_pos, g_val, g_prev, w,
            hp["w_cognitive"], hp["w_social"])
        # the next iteration starts from the program's own move
        x, v = h["positions"][:, t], h["velocities"][:, t]
        bits += unequal(x_ref, x) + unequal(v_ref, v)
        bits += unequal(g_val, h["g_best_val"][:, t]) + unequal(p_val.amin(1), h["g_best_dummy"][:, t])
    bits += unequal(p_pos, fin["p_best_pos"]) + unequal(p_val, fin["p_best_val"])
    bits += unequal(g_pos, fin["g_best_pos"]) + unequal(g_val, fin["g_best_val"])
    bits += unequal(g_prev, fin["g_prev_val"]) + unequal(x_ref, fin["positions"])
    bits += unequal(v_ref, fin["velocities"])
    bits += unequal(fin["iteration"], torch.full_like(fin["iteration"], t_iter + 1))
    bits += int(fin["done"].sum()) + int((~h["active"]).sum())
    return bits


def pre_move(x0: torch.Tensor, out: dict, device) -> torch.Tensor:
    """[T, B, N, d]: the positions each iteration's fitness scored."""
    pos = out["history"]["positions"].to(device)  # [B, T, N, d]
    return torch.cat([x0[None], pos[:, :-1].transpose(0, 1)])


def worst(all_numbers: list) -> dict:
    """The largest reading of each number over the recorded calls."""
    keys = all_numbers[0].keys()
    return {k: max(nums[k] for nums in all_numbers) for k in keys}
