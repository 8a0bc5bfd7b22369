"""Observability: structured event records and throughput counters.

  * ``log_event`` — one-line JSON records on stderr (machine-parsable);
  * ``ThroughputMeter`` — audio-hours/sec counters (what a corpus sweep
    pays for).
"""
from __future__ import annotations

import json
import sys
import time

__all__ = ["log_event", "ThroughputMeter"]


def log_event(event: str, **fields) -> None:
    rec = {"ts": round(time.time(), 3), "event": event, **fields}
    print(json.dumps(rec), file=sys.stderr, flush=True)


class ThroughputMeter:
    """Accumulates processed audio seconds; reports audio-hours/sec."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.audio_seconds = 0.0
        self.items = 0

    def add(self, audio_seconds: float, items: int = 1):
        self.audio_seconds += audio_seconds
        self.items += items

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def audio_hours_per_sec(self) -> float:
        e = self.elapsed
        return (self.audio_seconds / 3600.0) / e if e > 0 else 0.0

    def report(self) -> dict:
        return {
            "items": self.items,
            "audio_hours": round(self.audio_seconds / 3600.0, 4),
            "elapsed_sec": round(self.elapsed, 3),
            "audio_hours_per_sec": round(self.audio_hours_per_sec, 6),
        }
