"""Device idle time inside ``MicroBatcher`` calls, per call, over the
traced segment: the idle gaps of the union of device intervals (as for
``device_idle.*``) whose middles lie inside one of the program's
``serve.call`` spans, over the calls that overlap the segment. Read in a
serving cell above the knee, where the calls run back to back and the
card waits only on the host's part of each call."""

from gwbench import spans, trace
from gwbench.layers import reads

UNIT = "ms/call"


def read(rec):
    if not reads(rec, "serve"):
        return None
    tr = rec["trace"]
    lo, hi = tr.window
    calls = [(s["start_ns"] * 1e-9, s["end_ns"] * 1e-9)
             for s in spans.named("serve.call")]
    calls = [(s, e) for s, e in calls if e > lo and s < hi]
    if not calls:
        return None
    inside = sum(e - s for s, e in trace.idle_gaps(tr)
                 if any(a <= (s + e) / 2 < b for a, b in calls))
    return 1e3 * inside / len(calls)
