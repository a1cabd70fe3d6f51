"""``mfu.<kind>``: the whole step's share of the chip's bf16 dense peak.

rows per second (host clock, over the whole window) × the model's FLOP
per row (:mod:`benchmark.flops`, from the configuration's widths) ÷ the
bf16 dense peak of the device (``peaks.json``). The bf16 peak is the
one divisor that reads the same work on the same yardstick whatever dot
algorithm a later change finds that still passes the check. Nothing to
read where the cell reports no row rate (a served cell).
"""

from benchmark import flops


def read(run):
    rate = run.work.get("rows_per_s")
    if not rate:
        return None
    flop = flops.model_flop_per_row(run.config, run.work["entry"])
    return 100.0 * rate * flop / (run.peak["bf16_dense_flop_per_s"]
                                  * run.chips)
