"""Share, in %, of the traced calls' span entries (the starts of the
program's ranges, ``utils.obs.span``) at which the call's CUDA stream had
already run dry: no device op running, and the last kernel launched
before the entry finished. The card was then idle, waiting for the host
to reach that point of the program. The first traced call is left out:
the tracer opens its window on a drained stream. The profiler slows the
host, so this reads above an untraced call's. None where the program
records no spans or the window's launches and kernels do not pair."""
import bisect

from benchlib.catalog import plugin
from benchlib.trace import merged


def read(view):
    from modulation_mfcc_tpu_torch.utils import obs

    shared = plugin("metrics", "call_device_ms")
    spans = getattr(obs, "spans", None)
    link, roots = shared.launches(view), shared.ranges(view, shared.ROOT)
    if spans is None or link is None or roots is None or len(roots) < 2:
        return None
    names = {r.name for r in spans() if not r.name.startswith("setup.")}
    entries = [op.start for op in view.host_ops if op.name in names and op.start >= roots[1].start]
    if not entries:
        return None
    calls, kernels = link
    busy = merged(view.device_ops)
    ends = [b for _, b in busy]

    def dry(t):
        i = bisect.bisect_left(calls, t)
        j = bisect.bisect_left(ends, t)
        running = j < len(busy) and busy[j][0] <= t
        return not running and (i == 0 or kernels[i - 1].end <= t)

    return 100.0 * sum(map(dry, entries)) / len(entries)
