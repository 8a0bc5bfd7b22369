"""CSV export of computed curves, peaks, and annotation joins.

Capability parity with the reference's export dialog + writer
(script/main.py:48-151 ExportCSVDialog, :1409-1544 save_curves_to_csv):

  * per-curve x/y columns and min/max peak columns, aligned by row index
    (ragged columns padded with '');
  * per-sample TextGrid interval label columns (the containment join of
    script/main.py:1487-1493, vectorized via IntervalTier.labels_at);
  * duration and per-curve mean aggregated over a selected region or over
    every labeled interval of a tier (script/main.py:1496-1536).
"""
from __future__ import annotations

import csv
from dataclasses import dataclass, field

import numpy as np

from modulation_mfcc_tpu_torch.io.textgrid import IntervalTier, TextGrid

__all__ = ["CurveColumn", "export_curves_csv", "interval_aggregations"]


@dataclass
class CurveColumn:
    """One curve's exportable data."""

    name: str
    times: np.ndarray
    values: np.ndarray
    min_times: np.ndarray = field(default_factory=lambda: np.array([]))
    min_values: np.ndarray = field(default_factory=lambda: np.array([]))
    max_times: np.ndarray = field(default_factory=lambda: np.array([]))
    max_values: np.ndarray = field(default_factory=lambda: np.array([]))

    include_xy: bool = True
    include_min: bool = False
    include_max: bool = False


def interval_aggregations(
    curves: list[CurveColumn],
    tier: IntervalTier,
    *,
    labeled_only: bool = True,
):
    """[(interval_label, start, end, duration, {curve: mean})] per interval."""
    rows = []
    for iv in tier.intervals:
        if labeled_only and not iv.text:
            continue
        means = {}
        for c in curves:
            sel = (c.times >= iv.start) & (c.times <= iv.end)
            means[c.name] = float(np.mean(c.values[sel])) if sel.any() else float("nan")
        rows.append((iv.text, iv.start, iv.end, iv.duration, means))
    return rows


def export_curves_csv(
    path: str,
    curves: list[CurveColumn],
    *,
    textgrid: TextGrid | None = None,
    tier_names: list[str] | None = None,
    region: tuple[float, float] | None = None,
    aggregate_tier: str | None = None,
) -> None:
    """Write the combined table. Row-aligned ragged columns like the
    reference; annotation labels are joined against each curve's own x."""
    headers: list[str] = []
    columns: list[list] = []

    for c in curves:
        if c.include_xy:
            headers += [f"{c.name}_x", f"{c.name}_y"]
            columns += [list(np.asarray(c.times)), list(np.asarray(c.values))]
            if textgrid is not None:
                for tname in tier_names or textgrid.tier_names():
                    tier = textgrid.get_tier(tname)
                    if isinstance(tier, IntervalTier):
                        headers.append(f"{c.name}_{tname}")
                        columns.append(tier.labels_at(np.asarray(c.times)))
        if c.include_min:
            headers += [f"{c.name}_min_x", f"{c.name}_min_y"]
            columns += [list(np.asarray(c.min_times)), list(np.asarray(c.min_values))]
        if c.include_max:
            headers += [f"{c.name}_max_x", f"{c.name}_max_y"]
            columns += [list(np.asarray(c.max_times)), list(np.asarray(c.max_values))]

    if region is not None:
        headers.append("region_duration")
        columns.append([region[1] - region[0]])
        for c in curves:
            sel = (np.asarray(c.times) >= region[0]) & (np.asarray(c.times) <= region[1])
            headers.append(f"{c.name}_region_mean")
            columns.append(
                [float(np.mean(np.asarray(c.values)[sel]))] if sel.any() else [""]
            )

    if aggregate_tier is not None and textgrid is not None:
        tier = textgrid.get_tier(aggregate_tier)
        aggs = interval_aggregations(curves, tier)
        headers += ["interval_label", "interval_start", "interval_end", "interval_duration"]
        columns += [
            [a[0] for a in aggs],
            [a[1] for a in aggs],
            [a[2] for a in aggs],
            [a[3] for a in aggs],
        ]
        for c in curves:
            headers.append(f"{c.name}_interval_mean")
            columns.append([a[4][c.name] for a in aggs])

    n_rows = max((len(col) for col in columns), default=0)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(headers)
        for i in range(n_rows):
            w.writerow([col[i] if i < len(col) else "" for col in columns])
