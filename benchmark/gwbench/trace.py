"""The traced segment: ``torch.profiler`` over the card, reduced to device
intervals and host operations, and the arithmetic on them: the union of
device intervals (busy time, so overlapping streams count once), the idle
gaps and what the host was doing in each, and device time by kernel.
Only the reduction is kept, never a Chrome trace."""

from __future__ import annotations

from dataclasses import dataclass, field

WINDOW_SPAN = "gwbench.traced_window"


@dataclass
class Trace:
    """Seconds on one clock: the traced window, device intervals ``(start,
    end, name)`` and host operations ``(start, end, name)``."""

    window: tuple[float, float]
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self, intervals) -> list:
        lo, hi = self.window
        return [(max(s, lo), min(e, hi), n) for s, e, n in intervals
                if e > lo and s < hi]


def union(intervals) -> list[tuple[float, float]]:
    """Merged ``(start, end)`` of intervals ``(start, end, ...)``."""
    out: list[list[float]] = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def busy_s(tr: Trace) -> float:
    return covered(tr.clipped(tr.device))


def matching(tr: Trace, patterns) -> list:
    """Device intervals whose name holds one of ``patterns``."""
    return [iv for iv in tr.clipped(tr.device)
            if any(p in iv[2] for p in patterns)]


def idle_gaps(tr: Trace) -> list[tuple[float, float]]:
    lo, hi = tr.window
    gaps, t = [], lo
    for s, e in union(tr.clipped(tr.device)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _host_at(tr: Trace, t: float) -> str:
    """The innermost host operation running at ``t`` (latest start)."""
    best = None
    for s, e, n in tr.host:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, n)
    return best[1] if best else "(no host operation)"


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the host operation running at their middles."""
    ops: dict = {}
    for s, e, n in tr.clipped(tr.device):
        ops[n] = ops.get(n, 0.0) + (e - s)
    gaps: dict = {}
    for s, e in idle_gaps(tr):
        n = _host_at(tr, (s + e) / 2)
        gaps[n] = gaps.get(n, 0.0) + (e - s)

    def head(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": head(ops), "idle_gaps": head(gaps)}


def _ns(e, attr: str) -> float:
    return getattr(e, attr)() * 1e-9


def capture(fn) -> tuple[Trace, object]:
    """Run ``fn()`` under the profiler (host and card) inside one span that
    starts and ends on an idle card; returns the reduced trace and
    ``fn``'s result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            out = fn()
            torch.cuda.synchronize()
    window, device, host = None, [], []
    for e in prof.profiler.kineto_results.events():
        s = _ns(e, "start_ns")
        end = s + _ns(e, "duration_ns")
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((s, end, name))
        elif name == WINDOW_SPAN:
            window = (s, end)
        else:
            host.append((s, end, name))
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW_SPAN} span")
    return Trace(window, device, host), out
