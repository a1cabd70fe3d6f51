"""``idle_share.<kind>``: the share of the traced window in which no
operation ran on the device (1 − busy ÷ window, busy the union of the
device's op intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.trace.idle_share
