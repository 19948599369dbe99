"""The share of the device-only pass's window (its traced steps, from
the end of the warm-up to the final synchronize) in which no operation
ran on the card, % (the union of the device intervals)."""
from portbench import profiling


def read(rec):
    return profiling.idle_pct(rec.get("trace"))
