"""The gate kernels' share of their roofline in the traced window: each
launch's least time (the bytes of its (B, 4F, h, w) gates, c, bias, h' and
c', and in training the backward's, over the memory rate, or its operations
over the fp32 rate) summed over the launches traced, over their summed
device time.  Serving launches the forward alone; training both."""
from h100_bench.bench.roofline import gate_bounds
from h100_bench.bench.trace import kernel_time


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    bounds = gate_bounds(*run["layer"]["gate_shape"], run["peaks"])
    least = seconds = 0.0
    for kernel, bound in bounds.items():
        sec, n = kernel_time(tr, kernel)
        least += n * bound
        seconds += sec
    return 100.0 * least / seconds if seconds > 0 else None
