"""Praat TextGrid I/O + annotation models.

Replaces the reference's external `tgt` dependency and its widget converters
(script/praat_py_ui/textgridtools.py:15-113) and marker models
(script/praat_py_ui/markers.py:8-173): interval/point tiers with sorted
insertion, overlap validation, both Praat text formats (long + short) for
read, long format for write, and the interval-containment join used by CSV
export (script/main.py:1487-1493).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Point",
    "Interval",
    "PointTier",
    "IntervalTier",
    "TextGrid",
    "read_textgrid",
    "write_textgrid",
]


@dataclass
class Point:
    time: float
    text: str = ""

    def __eq__(self, other):  # rounding-based equality like the reference's
        return isinstance(other, Point) and round(self.time, 4) == round(other.time, 4)


@dataclass
class Interval:
    start: float
    end: float
    text: str = ""

    def __post_init__(self):
        if self.end < self.start:
            raise ValueError(f"Interval end {self.end} < start {self.start}")

    def contains(self, t: float) -> bool:
        return self.start <= t <= self.end

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class PointTier:
    name: str = ""
    points: list = field(default_factory=list)
    xmin: float = 0.0
    xmax: float = 0.0

    def add(self, time: float, text: str = "") -> None:
        """Insert keeping time order (MarkerList semantics)."""
        p = Point(time, text)
        if p in self.points:
            return
        self.points.append(p)
        self.points.sort(key=lambda q: q.time)

    def remove(self, time: float) -> None:
        self.points = [p for p in self.points if p != Point(time)]

    def move(self, time: float, new_time: float) -> None:
        """Move a point (draggable point-tier markers), keeping time order."""
        self.remove(time)
        self.add(new_time)


@dataclass
class IntervalTier:
    name: str = ""
    intervals: list = field(default_factory=list)
    xmin: float = 0.0
    xmax: float = 0.0

    def add(self, start: float, end: float, text: str = "") -> None:
        """Insert with overlap validation (IntervalMarkerList semantics)."""
        new = Interval(start, end, text)
        for iv in self.intervals:
            if new.start < iv.end and iv.start < new.end:
                raise ValueError(
                    f"Interval [{start}, {end}] overlaps [{iv.start}, {iv.end}]"
                )
        self.intervals.append(new)
        self.intervals.sort(key=lambda i: i.start)

    MIN_DURATION = 0.01  # the reference widgets' minimal interval span

    def move_boundary(self, index: int, new_time: float, *, min_duration: float | None = None) -> float:
        """Move the boundary between intervals ``index`` and ``index+1``,
        clamped so neither interval shrinks below ``min_duration`` — the
        programmatic equivalent of the reference's draggable tier boundaries
        (praat_py_ui/tiers.py min-interval clamping). Returns the applied time."""
        if not (0 <= index < len(self.intervals) - 1):
            raise IndexError(f"no boundary after interval {index}")
        md = self.MIN_DURATION if min_duration is None else min_duration
        left, right = self.intervals[index], self.intervals[index + 1]
        lo = left.start + md
        hi = right.end - md
        if hi < lo:
            raise ValueError("intervals too short to move this boundary")
        t = min(max(new_time, lo), hi)
        left.end = t
        right.start = t
        return t

    def relabel(self, index: int, text: str) -> None:
        """Edit an interval's label (the widgets' keyboard editing)."""
        self.intervals[index].text = text

    def delete_boundary(self, index: int):
        """Delete the boundary between intervals ``index`` and ``index+1``,
        merging them with concatenated labels — the reference's
        IntervalMarkerList.remove_marker_by_idx semantics
        (praat_py_ui/markers.py:131-146): removing an interval's start
        marker appends its name to the previous marker's. Returns the
        merged Interval."""
        if not (0 <= index < len(self.intervals) - 1):
            raise IndexError(f"no boundary after interval {index}")
        left, right = self.intervals[index], self.intervals.pop(index + 1)
        left.end = right.end
        left.text = left.text + right.text
        return left

    def label_at(self, t: float) -> str:
        """Label of the interval containing t ('' if none) — the per-sample
        word lookup of the reference's CSV export."""
        for iv in self.intervals:
            if iv.contains(t):
                return iv.text
        return ""

    def labels_at(self, times: np.ndarray) -> list[str]:
        """Vectorized containment join: one searchsorted over starts."""
        if not self.intervals:
            return [""] * len(times)
        starts = np.array([iv.start for iv in self.intervals])
        ends = np.array([iv.end for iv in self.intervals])
        texts = [iv.text for iv in self.intervals]
        idx = np.searchsorted(starts, np.asarray(times), side="right") - 1
        out = []
        for t, i in zip(np.asarray(times), idx):
            # at a shared boundary two intervals contain t; the reference's
            # sequential scan (main.py:1487-1493) keeps the *first* one
            if i - 1 >= 0 and starts[i - 1] <= t <= ends[i - 1]:
                out.append(texts[i - 1])
            elif i >= 0 and starts[i] <= t <= ends[i]:
                out.append(texts[i])
            else:
                out.append("")
        return out


@dataclass
class TextGrid:
    tiers: list = field(default_factory=list)
    xmin: float = 0.0
    xmax: float = 0.0

    def tier_names(self) -> list[str]:
        return [t.name for t in self.tiers]

    def get_tier(self, name: str):
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(name)

    def interval_tiers(self) -> list[IntervalTier]:
        return [t for t in self.tiers if isinstance(t, IntervalTier)]


_NUM = r"[-+0-9.eE]+"


def _unquote(s: str) -> str:
    s = s.strip()
    if s.startswith('"') and s.endswith('"'):
        s = s[1:-1]
    return s.replace('""', '"')


def read_textgrid(path: str) -> TextGrid:
    """Read a Praat TextGrid (auto-detects long vs short text format)."""
    with open(path, encoding="utf-8-sig") as f:
        text = f.read()
    if re.search(r"item\s*\[", text):
        return _read_long(text)
    return _read_short(text)


def _read_long(text: str) -> TextGrid:
    def grab(pattern, src, cast=float):
        m = re.search(pattern, src)
        if not m:
            raise ValueError(f"TextGrid parse error: missing {pattern!r}")
        return cast(m.group(1))

    tg = TextGrid(
        xmin=grab(rf"xmin\s*=\s*({_NUM})", text),
        xmax=grab(rf"xmax\s*=\s*({_NUM})", text),
    )
    items = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
    for item in items:
        cls = _unquote(re.search(r'class\s*=\s*("[^"]*")', item).group(1))
        name = _unquote(re.search(r'name\s*=\s*("[^"]*")', item).group(1))
        xmin = grab(rf"xmin\s*=\s*({_NUM})", item)
        xmax = grab(rf"xmax\s*=\s*({_NUM})", item)
        if cls == "IntervalTier":
            tier = IntervalTier(name=name, xmin=xmin, xmax=xmax)
            for m in re.finditer(
                rf'intervals\s*\[\d+\]\s*:\s*xmin\s*=\s*({_NUM})\s*xmax\s*=\s*({_NUM})\s*text\s*=\s*("(?:[^"]|"")*")',
                item,
            ):
                tier.intervals.append(
                    Interval(float(m.group(1)), float(m.group(2)), _unquote(m.group(3)))
                )
        else:
            tier = PointTier(name=name, xmin=xmin, xmax=xmax)
            for m in re.finditer(
                rf'points\s*\[\d+\]\s*:\s*(?:number|time)\s*=\s*({_NUM})\s*(?:mark|text)\s*=\s*("(?:[^"]|"")*")',
                item,
            ):
                tier.points.append(Point(float(m.group(1)), _unquote(m.group(2))))
        tg.tiers.append(tier)
    return tg


def _read_short(text: str) -> TextGrid:
    # short format: sequential tokens after the header
    toks = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("File type") or line.startswith("Object class"):
            continue
        toks.append(line)
    # toks: xmin xmax <exists> ntiers then per tier: class name xmin xmax n then entries
    i = 0
    xmin, xmax = float(toks[0]), float(toks[1])
    i = 2
    if toks[i] == "<exists>":
        i += 1
    ntiers = int(toks[i]); i += 1
    tg = TextGrid(xmin=xmin, xmax=xmax)
    for _ in range(ntiers):
        cls = _unquote(toks[i]); name = _unquote(toks[i + 1])
        txmin, txmax = float(toks[i + 2]), float(toks[i + 3])
        n = int(toks[i + 4]); i += 5
        if cls == "IntervalTier":
            tier = IntervalTier(name=name, xmin=txmin, xmax=txmax)
            for _ in range(n):
                tier.intervals.append(
                    Interval(float(toks[i]), float(toks[i + 1]), _unquote(toks[i + 2]))
                )
                i += 3
        else:
            tier = PointTier(name=name, xmin=txmin, xmax=txmax)
            for _ in range(n):
                tier.points.append(Point(float(toks[i]), _unquote(toks[i + 1])))
                i += 2
        tg.tiers.append(tier)
    return tg


def _q(s: str) -> str:
    return '"' + s.replace('"', '""') + '"'


def write_textgrid(tg: TextGrid, path: str) -> None:
    """Write in Praat's long text format."""
    out = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {tg.xmin}",
        f"xmax = {tg.xmax}",
        "tiers? <exists>",
        f"size = {len(tg.tiers)}",
        "item []:",
    ]
    for ti, tier in enumerate(tg.tiers, 1):
        is_interval = isinstance(tier, IntervalTier)
        out.append(f"    item [{ti}]:")
        out.append(f'        class = {_q("IntervalTier" if is_interval else "TextTier")}')
        out.append(f"        name = {_q(tier.name)}")
        out.append(f"        xmin = {tier.xmin}")
        out.append(f"        xmax = {tier.xmax}")
        if is_interval:
            out.append(f"        intervals: size = {len(tier.intervals)}")
            for ii, iv in enumerate(tier.intervals, 1):
                out.append(f"        intervals [{ii}]:")
                out.append(f"            xmin = {iv.start}")
                out.append(f"            xmax = {iv.end}")
                out.append(f"            text = {_q(iv.text)}")
        else:
            out.append(f"        points: size = {len(tier.points)}")
            for pi, pt in enumerate(tier.points, 1):
                out.append(f"        points [{pi}]:")
                out.append(f"            number = {pt.time}")
                out.append(f"            mark = {_q(pt.text)}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")
