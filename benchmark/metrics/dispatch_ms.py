"""Median host time, in ms, from a call's issue to the entry's return (the
enqueue), over the untraced calls of the run: the host clock around the
call, outside the profiler."""
import statistics


def read(view):
    return 1e3 * statistics.median(view.dispatch_s) if view.dispatch_s else None
