"""The card: whether it is there, its name, count, power limit and clocks,
and its published peaks (``peaks.json``)."""

from __future__ import annotations

import json
import statistics
import subprocess
from pathlib import Path

import torch

PEAKS = Path(__file__).with_name("peaks.json")


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    """Raise :class:`NoCard` unless ``n`` CUDA cards are visible: a run
    never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} CUDA cards, the cell "
                     f"needs {n}")


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind`` (matched by
    prefix), or None."""
    with open(PEAKS) as f:
        table = json.load(f)
    for name, row in table.items():
        if kind.startswith(name):
            return row
    return None


def _smi(query: str) -> list[str] | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return [s.strip() for s in out.strip().splitlines()[0].split(",")]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _num(s: str) -> float | None:
    try:
        return float(s)
    except ValueError:
        return None


class ClockSampler:
    """The card's SM clock, power draw and temperature from ``nvidia-smi``,
    read just before and just after the measured window: a query during
    the window can stall the card's driver, which a tail latency feels."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self):
        self.samples: list[list[float | None]] = []

    def _sample(self):
        row = _smi(self.QUERY)
        if row is not None:
            self.samples.append([_num(s) for s in row])

    def __enter__(self):
        self._sample()
        return self

    def __exit__(self, *exc):
        self._sample()

    def summary(self) -> dict:
        out = {"samples": len(self.samples)}
        for i, key in enumerate(("sm_clock_mhz", "power_draw_w",
                                 "temperature_c")):
            vals = [s[i] for s in self.samples if s[i] is not None]
            if vals:
                out[key] = {"min": min(vals), "median":
                            statistics.median(vals), "max": max(vals)}
        return out


def info(count: int, peak_bytes: int) -> dict:
    """The result line's ``device`` block."""
    limit = _smi("power.limit")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": _num(limit[0]) if limit else None}
