"""Median device ms a traced call spends in the scan route's two filters:
the program's spans ``trajectory.filter.scan`` (the trajectory low-pass)
and ``trajectory.out.scan`` (the final filter), each from the start of the
first kernel launched inside its range to the end of the last
(call_device_ms.span_ms), summed. None where a traced call lacks either
span (a program without them, or a call on another route)."""
import statistics

from benchlib.catalog import plugin

SPANS = ("trajectory.filter.scan", "trajectory.out.scan")


def per_call(view):
    """Each traced call's device ms in the two spans, or None."""
    found = [plugin("metrics", "call_device_ms").span_ms(view, name) for name in SPANS]
    if any(ms is None for ms in found):
        return None
    return [sum(ms) for ms in zip(*found)]


def read(view):
    ms = per_call(view)
    return statistics.median(ms) if ms else None
