"""``gemm_roofline.<kind>``: the matrix-product kernels' share of their
roofline.

The least time the model's matrix products need for the rows the
traced window completed — per layer the larger of FLOP ÷ bf16 dense
peak and computed bytes ÷ HBM bandwidth (:func:`benchmark.flops.
least_time_s`) — over the device time of the kernels the trace
reduction classifies as matrix products. Nothing to read without such
kernels in the trace.
"""

from benchmark import flops


def read(run):
    if run.trace is None or run.trace.matmul_s <= 0 or not run.work.get(
            "rows"):
        return None
    least, _ = flops.least_time_s(run.config, run.work["entry"],
                                  run.work["rows"], run.peak)
    return 100.0 * least / run.trace.n_devices / run.trace.matmul_s
