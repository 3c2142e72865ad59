"""The three DCN kernels' share of their roofline in the traced training
window.  A step launches each kernel once for each deformable conv: for
each of the N frames, at L3, L2, L1 and the cascading one at L1, on
(B, nf, h, w) features at their level's size.  Their least times (bytes
over the memory rate, or operations over the fp32 rate) summed over the
traced steps, over the three kernels' summed device time; nothing when the
launches traced are not whole steps' worth."""
from h100_bench.bench.roofline import dcn_bounds
from h100_bench.bench.trace import kernel_time


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    layer, kw = run["layer"], run["config"]["net"]["kwargs"]
    B, (h, w), nf, N, dg = layer["batch"], layer["lr_hw"], kw["nf"], kw["nframes"], kw["groups"]
    per_step = {}
    for div in (4, 2, 1, 1):  # L3, L2, L1, cascading
        for kernel, bound in dcn_bounds(B, nf, h // div, w // div, dg, 9, run["peaks"]).items():
            per_step[kernel] = per_step.get(kernel, 0.0) + N * bound
    calls = 4 * N
    least = seconds = 0.0
    for kernel, bound in per_step.items():
        sec, n = kernel_time(tr, kernel)
        if n == 0 or n % calls:
            return None
        least += (n // calls) * bound
        seconds += sec
    return 100.0 * least / seconds
