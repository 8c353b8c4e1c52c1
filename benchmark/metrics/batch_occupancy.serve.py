"""Requests per device call over the measured window, from the program's
``MicroBatcher.stats`` counters, in a serving cell below the knee, where
batching sets the wait."""

from gwbench.layers import reads

UNIT = "requests/call"


def read(rec):
    c = rec.get("counters")
    if not reads(rec, "serve", tail=True) or not c or not c["device_calls"]:
        return None
    return c["requests"] / c["device_calls"]
