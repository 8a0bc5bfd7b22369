"""Static rendering of the reference's display surface (matplotlib).

Capability-parity with the reference's pyqtgraph stack (SURVEY.md §2c):
  * multi-axis panels — up to 4 independent Y axes per panel sharing X
    (QuadrupleAxisPlotItem, quadruple_axis_plot_item.py:15-184), axis color
    matched to its curve (Panel.update_y_axis_color, :398-421);
  * waveform + spectrogram audio panel (SoundInformation, :447-537);
  * TextGrid interval overlay: dashed boundaries + centered labels
    (Interval/DisplayInterval, :540-605);
  * min/max peak markers (CalculationValues scatters, :187-328);
  * selection-region shading (LinearRegion equivalent).

The output is a figure (PNG/SVG/show) instead of a Qt window — the
interactive event loop is replaced by the Workbench API (models/workbench.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["CurveSpec", "PanelSpec", "render_session"]

_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e", "#8c564b"]


@dataclass
class CurveSpec:
    """One curve on a panel (the reference's dashboard row)."""

    name: str
    times: np.ndarray
    values: np.ndarray
    color: str | None = None
    style: str = "line"  # line | scatter
    min_peaks: tuple | None = None  # (times, values)
    max_peaks: tuple | None = None
    visible: bool = True


@dataclass
class PanelSpec:
    curves: list = field(default_factory=list)

    def add(self, curve: CurveSpec):
        if len([c for c in self.curves if c.visible]) >= 4:
            raise ValueError("Panel full: at most 4 curves per panel (axis rotation)")
        self.curves.append(curve)
        return self


def render_session(
    panels: list,
    *,
    sound=None,
    spectrogram=None,
    textgrid=None,
    region: tuple | None = None,
    out: str | None = None,
    figsize=(14, 10),
    dpi: int = 110,
):
    """Render audio panel + curve panels, x-linked, to a file or figure.

    panels: list of PanelSpec. sound: models.sound.Sound. spectrogram:
    models.sound.Spectrogram. textgrid: io.textgrid.TextGrid (interval tiers
    are drawn as overlays on the audio panel).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_rows = (1 if sound is not None else 0) + len(panels)
    if n_rows == 0:
        raise ValueError("Nothing to render")
    fig, axes = plt.subplots(
        n_rows, 1, sharex=True, figsize=figsize, dpi=dpi, squeeze=False
    )
    axes = [a[0] for a in axes]
    row = 0

    if sound is not None:
        ax = axes[0]
        row = 1
        if spectrogram is not None:
            sp = spectrogram
            ax2 = ax.twinx()
            ax2.imshow(
                sp.data_matrix,
                origin="lower",
                aspect="auto",
                extent=[sp.timestamps[0], sp.timestamps[-1], sp.frequencies[0], sp.frequencies[-1]],
                cmap="Greys",
                alpha=0.9,
            )
            ax2.set_ylabel("Hz")
        amp = sound.amplitudes[0]
        ax.plot(sound.timestamps, amp, lw=0.4, color="#1f77b4", zorder=3)
        ax.set_ylabel("amplitude")
        if textgrid is not None:
            for tier in textgrid.interval_tiers():
                for iv in tier.intervals:
                    ax.axvline(iv.start, ls="--", lw=0.7, color="k", alpha=0.6)
                    ax.axvline(iv.end, ls="--", lw=0.7, color="k", alpha=0.6)
                    if iv.text:
                        ax.text(
                            (iv.start + iv.end) / 2,
                            0.92,
                            iv.text,
                            transform=ax.get_xaxis_transform(),
                            ha="center",
                            fontsize=8,
                        )

    for p_i, panel in enumerate(panels):
        base_ax = axes[row + p_i]
        shown = [c for c in panel.curves if c.visible]
        for c_i, curve in enumerate(shown[:4]):
            color = curve.color or _COLORS[c_i % len(_COLORS)]
            # axis rotation: first curve owns the base axis; each further
            # curve gets its own twinx with a recolored spine (the
            # quad-axis behavior)
            ax = base_ax if c_i == 0 else base_ax.twinx()
            if c_i >= 2:
                ax.spines["right"].set_position(("outward", 45 * (c_i - 1)))
            if curve.style == "scatter":
                ax.plot(curve.times, curve.values, ".", ms=2.5, color=color)
            else:
                ax.plot(curve.times, curve.values, lw=1.0, color=color)
            ax.set_ylabel(curve.name, color=color, fontsize=9)
            ax.tick_params(axis="y", labelcolor=color, labelsize=7)
            for peaks, marker in ((curve.max_peaks, "^"), (curve.min_peaks, "v")):
                if peaks is not None and len(peaks[0]):
                    ax.plot(peaks[0], peaks[1], marker, ms=6, color=color, mec="k", zorder=5)

    if region is not None:
        for ax in axes:
            ax.axvspan(region[0], region[1], color="#ffd54f", alpha=0.25, zorder=0)
    axes[-1].set_xlabel("time (s)")
    fig.tight_layout()
    if out:
        fig.savefig(out)
        plt.close(fig)
        return out
    return fig
