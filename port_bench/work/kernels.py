"""Operations and bytes of the port's two hand-written kernels, from their
shapes, and the least time the card could take for them.

Frozen copies of `chip_smoke.py`'s `swarm_update_work`, `rescale_work` and
`bound_ms`, so that a later change to the program cannot change the
yardstick. Bytes count each input read once and each output written once.
"""

from __future__ import annotations

from port_bench.work.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS


def swarm_update_work(b: int, n: int, d: int, n_improved: int) -> tuple[int, int]:
    """B1, one fused PSO update of [b, n, d]: (bytes, fp32 operations).
    The p_best_pos rows of particles that improved are not needed (the new
    personal best is the position)."""
    nbytes = 4 * (3 * b * n * d - n_improved * d + 4 * b * n + b * d + 3 * b)  # inputs
    nbytes += 4 * (3 * b * n * d + b * n + b * d + 2 * b) + b  # outputs
    return nbytes, 10 * b * n * d + 2 * b * n


def rescale_work(n: int, f: int, out_bytes: int) -> tuple[int, int]:
    """B2, the per-row min-max rescale of [n, f] fp32: (bytes, operations)."""
    return 4 * n * f + out_bytes * n * f, 6 * n * f


def bound_us(nbytes: int, ops: int) -> float:
    """The least time for the work on one card, in µs: bytes over the HBM
    peak or fp32 operations over the fp32 peak, the larger."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS["fp32_parity"]) * 1e6
