"""Median host ms a traced call spends inside the program's ``trajectory``
span's range: the host's time to issue the trajectory stage (under the
profiler, so a little above an untraced call's). None where a traced call
lacks the span."""
import statistics

from benchlib.catalog import plugin


def read(view):
    found = plugin("metrics", "call_device_ms").ranges(view, "trajectory")
    return statistics.median(r.dur * 1e-3 for r in found) if found else None
