"""B2's share of its roofline: the least time of one launch over the
fitness's rows (one image a row, fp32 in, the cell's dtype out) by
`work/kernels.py`, over B2's mean device µs a launch in the traced
stretch."""

from port_bench import tracing
from port_bench.work.kernels import bound_us, rescale_work

KERNELS = ("rescale_short_kernel", "rescale_long_kernel")


def read(run):
    if run.trace is None:
        return None
    us, events = tracing.kernel_us(run.trace, KERNELS)
    if not events:
        return None
    s = run.shape
    out_bytes = 2 if run.precision == "bf16" else 4
    return 100.0 * bound_us(*rescale_work(s["b"] * s["n"], s["pixels"], out_bytes)) / (us / events)
