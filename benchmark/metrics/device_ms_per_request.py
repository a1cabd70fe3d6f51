"""``device_ms_per_request.<kind>``: device busy time in the traced
window over the requests completed in it, in ms."""


def read(run):
    done = run.work.get("requests")
    if run.trace is None or not done:
        return None
    return 1e3 * run.trace.busy_s / done
