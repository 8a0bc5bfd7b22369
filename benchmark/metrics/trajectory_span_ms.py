"""Median device ms a traced call spends in the program's ``trajectory``
span (``MfccChange.trajectory_tail``: the trajectory low-pass, the
derivative and √Σd²/n, the final filter): from the start of the first
kernel launched inside its range to the end of the last, idle among them
included. None where a traced call lacks the span."""
import statistics

from benchlib.catalog import plugin


def read(view):
    ms = plugin("metrics", "call_device_ms").span_ms(view, "trajectory")
    return statistics.median(ms) if ms else None
