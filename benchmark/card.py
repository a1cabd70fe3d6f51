"""The card's name, power limit and clocks, read by ``nvidia-smi`` in a
child process that never touches JAX."""

from __future__ import annotations

import statistics
import subprocess

QUERY = "name,power.limit,clocks.sm,power.draw,temperature.gpu"


def card_info() -> str:
    """``name, power limit`` of each card, one line per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


class ClockSampler:
    """Samples clocks and power every 500 ms while the window runs."""

    def __init__(self):
        self._proc = None
        self.summary = "not sampled"

    def __enter__(self):
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None
        return self

    def __exit__(self, *exc):
        if self._proc is None:
            return False
        self._proc.terminate()
        try:
            out, _ = self._proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            out, _ = self._proc.communicate()
        self.summary = summarize(out)
        return False


def summarize(text: str) -> str:
    """Median and range of the SM clock and power draw of the samples."""
    clocks, power = [], []
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < 4:
            continue
        try:
            clocks.append(float(parts[2]))
            power.append(float(parts[3]))
        except ValueError:
            continue
    if not clocks:
        return "no samples"
    return (f"{len(clocks)} samples: sm clock median {statistics.median(clocks)}"
            f" MHz (min {min(clocks)}, max {max(clocks)}), power draw median "
            f"{statistics.median(power)} W (max {max(power)})")
