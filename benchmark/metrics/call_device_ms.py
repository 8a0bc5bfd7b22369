"""Median device ms of a traced call: from the start of the first kernel
the program's root span ``batched_mfcc_change`` (``utils.obs.span``)
launched to the end of its last, idle among them included; the call's
output copy, which the benchmark's loop issues after the call, is not in
it. A span is a range of the profiler's trace, and the trace's launch
calls tie each kernel to the range open at its launch. None where the
program opens no such range (a program without spans) or the window's
launch calls and kernels do not pair.

``span_ms``, ``ranges`` and ``launches`` are the span readers' shared
part."""
import bisect
import statistics

ROOT = "batched_mfcc_change"
LAUNCH = "LaunchKernel"  # cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel: one kernel each


def launches(view):
    """(the window's kernel launch calls' host times, its kernels), both in
    order: the i-th launch issued the i-th kernel, since the loop's one
    stream runs its kernels in launch order. None where their counts
    differ (a record lost), so no kernel is tied to the wrong range."""
    calls = sorted(op.start for op in view.host_ops if LAUNCH in op.name)
    kernels = sorted(view.kernels, key=lambda op: op.start)
    if not kernels or len(calls) != len(kernels):
        return None
    return calls, kernels


def ranges(view, name):
    """The ranges named ``name`` in the window, in order; None unless there
    is one a traced call."""
    found = sorted((op for op in view.host_ops if op.name == name), key=lambda op: op.start)
    return found if view.n_calls and len(found) == view.n_calls else None


def span_ms(view, name):
    """Each traced call's device ms in its span ``name``: from the first
    kernel launched inside the span's range to the end of the last. None
    where a call lacks the range or launched no kernel inside it."""
    link, found = launches(view), ranges(view, name)
    if link is None or found is None:
        return None
    calls, kernels = link
    out = []
    for r in found:
        a, b = bisect.bisect_left(calls, r.start), bisect.bisect_left(calls, r.end)
        if a == b:
            return None
        out.append((max(k.end for k in kernels[a:b]) - kernels[a].start) * 1e-3)
    return out


def read(view):
    ms = span_ms(view, ROOT)
    return statistics.median(ms) if ms else None
