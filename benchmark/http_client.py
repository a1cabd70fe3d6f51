"""One closed-loop client of a served emulator, run as a child process.

Never imports JAX. Usage (the serving driver starts it)::

    python benchmark/http_client.py '<json args>'

``args``: ``port``, ``seed``, ``client`` (index), ``mix`` (the traffic
file's parameters). The client draws its request sizes (the mix's fixed
cycle, in an order drawn from the seed) and its rows (prior draws) from
``(seed, client)``, sends one warm-up request of the smallest and of
the largest size, prints ``ready``, reads the window's deadline (on
``time.monotonic``'s clock) from standard input, then sends one request
at a time until the deadline. Each request is timed from before it is
sent to the last byte of the response. It prints one JSON object: the
latencies in ms, the counts, and a seeded sample of (rows, answer)
pairs — every request of the largest size among them — for the
comparison with the reference.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import traffic  # noqa: E402


def post(port: int, path: str, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main(args: dict) -> dict:
    mix, port = args["mix"], args["port"]
    rng = traffic.rng_for(args["seed"], 1 + args["client"])
    keep_rng = traffic.rng_for(args["seed"], 1001 + args["client"])
    sizes = traffic.shuffled_sizes(mix, rng)
    largest = max(sizes)
    path = mix["endpoint"]
    for n in (1, largest):
        body = json.dumps({"params": traffic.prior_rows(n, rng).tolist()})
        status, _ = post(port, path, body.encode())
        if status != 200:
            raise RuntimeError(f"warm-up request answered {status}")
    print("ready", flush=True)
    deadline = float(sys.stdin.readline())

    latencies, samples, errors = [], [], []
    attempted = failed = 0
    gap_s = 0.0
    t_prev = time.perf_counter()
    while time.monotonic() < deadline:
        n = sizes[attempted % len(sizes)]
        rows = traffic.prior_rows(n, rng).astype("float32")
        body = json.dumps({"params": rows.tolist()}).encode()
        keep = n == largest or keep_rng.random() < mix["sample_share"]
        t0 = time.perf_counter()
        gap_s += t0 - t_prev
        try:
            status, data = post(port, path, body)
        except (OSError, http.client.HTTPException) as e:
            status, data = repr(e), b""
        t1 = time.perf_counter()
        t_prev = t1
        attempted += 1
        if status != 200:
            failed += 1
            latencies.append(float("inf"))
            errors.append(f"{n} rows after {(t1 - t0) * 1e3:.1f} ms: "
                          f"{status} {data[:200]!r}")
            continue
        latencies.append((t1 - t0) * 1e3)
        if keep:
            samples.append([rows.tolist(), json.loads(data)["signals"]])
    return {"client": args["client"], "attempted": attempted,
            "failed": failed, "latencies_ms": latencies,
            "client_gap_ms": gap_s / max(attempted, 1) * 1e3,
            "errors": errors[:10], "samples": samples}


if __name__ == "__main__":
    result = main(json.loads(sys.argv[1]))
    sys.stdout.write(json.dumps(result) + "\n")
