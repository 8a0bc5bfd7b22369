"""AnalysisSession — the MainWindow workflow as a scriptable object.

Everything the reference's GUI shell does (SURVEY.md §2d), without a Qt
event loop: load a WAV (+ TextGrid, + EMA .pos), place feature curves on
panels with derivations, pick min/max peaks in a selection region, and
export CSV — each operation one method call. Curves and the spectrogram are
computed through the port's pipeline (models/pipeline.py) on the session's
device (CUDA by default) and kept on the host as numpy arrays, which the
peak picking, CSV export and rendering read.

Reference mapping:
  * load_audio            → MainWindow.load_audio (script/main.py:1628-1663)
  * add_curve             → dashboard combo change → update_curve (:1736)
  * add_custom_curve      → open_config/add_custom_curve (:1796-1877)
  * load_pos / add_ema_curve → load_pos_file/generate_pos_curve (:1298-1354)
  * analyze_max/min_peaks → :1546-1613 (find_peaks over the region per panel)
  * export_csv            → ExportCSVDialog/save_curves_to_csv (:1409-1544)
  * render                → the whole display surface, as a PNG
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from modulation_mfcc_tpu_torch.models.config import DerivationConfig, PipelineConfig
from modulation_mfcc_tpu_torch.models.pipeline import apply_derivation, extract_feature, resolve_derivation
from modulation_mfcc_tpu_torch.ops.peaks import peaks_in_interval
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["AnalysisSession"]


@dataclass
class _Curve:
    name: str
    feature: str
    panel: int
    times: np.ndarray
    values: np.ndarray
    derivation: int = 0
    color: str | None = None
    visible: bool = True
    min_peaks: tuple = (np.array([]), np.array([]))
    max_peaks: tuple = (np.array([]), np.array([]))


def _host(v) -> np.ndarray:
    """A curve's values as a host array."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class AnalysisSession:
    """One audio file + its computed curves, panels, annotations, region,
    computed on ``device`` (default CUDA; ``device="cpu"`` for the CPU)."""

    def __init__(self, audio_path: str, config: PipelineConfig | None = None, n_panels: int = 4, device=None):
        self.device = resolve_device(device)
        self.audio_path = audio_path
        self.config = config or PipelineConfig()
        self.n_panels = n_panels
        self.curves: dict[str, _Curve] = {}
        self.textgrid = None
        self.ema = None
        self.region: tuple | None = None
        from modulation_mfcc_tpu_torch.models.sound import load_sound, praat_spectrogram

        self.sound = load_sound(audio_path)
        self.spectrogram = praat_spectrogram(
            self.sound.amplitudes, self.sound.sample_rate, device=self.device
        )

    # ---- annotations / articulography -----------------------------------
    def load_textgrid(self, path: str):
        from modulation_mfcc_tpu_torch.io.textgrid import read_textgrid

        self.textgrid = read_textgrid(path)
        return self.textgrid

    def load_pos(self, path: str, target_sample_rate: int | None = None):
        from modulation_mfcc_tpu_torch.io.ag50x import read_ag50x

        rate = target_sample_rate or self.config.ema.target_sample_rate
        self.ema = read_ag50x(path, rate, device=self.device)
        return self.ema

    # ---- curves ----------------------------------------------------------
    def add_curve(
        self,
        feature: str,
        *,
        panel: int = 0,
        derivation: int | None = None,
        name: str | None = None,
        color: str | None = None,
        dcfg: DerivationConfig | None = None,
    ) -> _Curve:
        """Compute + register a standard feature curve (dashboard row).

        ``derivation``/``dcfg`` default to the feature's saved section
        settings in the session config (e.g. a JSON with "F0 velocity, sg"
        yields the sg-derived velocity curve without extra arguments)."""
        self._check_panel(panel)
        derivation, dcfg = resolve_derivation(feature, self.config, derivation, dcfg)
        t, v = extract_feature(
            self.audio_path, feature, self.config, derivation=derivation, dcfg=dcfg, device=self.device
        )
        cname = name or (feature + ("", "_vel", "_acc")[derivation])
        curve = _Curve(cname, feature, panel, np.asarray(t), _host(v), derivation, color)
        self.curves[cname] = curve
        return curve

    def add_custom_curve(self, name: str, times, values, *, panel: int = 0, color=None) -> _Curve:
        """Register an externally computed curve under a name (the custom
        config-driven curves of the reference, main.py:1850-1877)."""
        self._check_panel(panel)
        curve = _Curve(name, "custom", panel, np.asarray(times), _host(values), 0, color)
        self.curves[name] = curve
        return curve

    def add_ema_curve(
        self, channel: int, dim: str = "z", *, panel: int = 0, derivation: int = 0,
        name: str | None = None, dcfg: DerivationConfig | None = None,
    ) -> _Curve:
        """EMA channel curve with optional derivative (generate_pos_curve:
        plots the chosen channel's dimension, default z, main.py:1337-1354)."""
        if self.ema is None:
            raise RuntimeError("No .pos file loaded; call load_pos() first")
        self._check_panel(panel)
        t, v = self.ema.channel(channel, dim)
        dcfg = dcfg or self.config.meta_for("ema").derivation
        t, v = apply_derivation(t, torch.as_tensor(v, device=self.device), derivation, dcfg)
        cname = name or f"ch{channel}_{dim}" + ("", "_vel", "_acc")[derivation]
        curve = _Curve(cname, "ema", panel, np.asarray(t), _host(v), derivation)
        self.curves[cname] = curve
        return curve

    def remove_curve(self, name: str):
        self.curves.pop(name, None)

    def reset_curves(self):
        self.curves.clear()

    def _check_panel(self, panel: int):
        if not (0 <= panel < self.n_panels):
            raise ValueError(f"panel must be in [0, {self.n_panels})")

    # ---- manual point editing (CalculationValues/PointOperation parity,
    # quadruple_axis_plot_item.py:187-328) --------------------------------
    SNAP_THRESHOLD = 0.2  # seconds; the reference's nearest-x click radius

    def add_manual_peak(self, curve_name: str, time: float, *, kind: str = "max"):
        """Add a min/max marker at the curve sample nearest to ``time``
        (within the snap threshold, like the reference's click handling).
        Returns (snapped_time, value) or None when nothing is in range."""
        c = self.curves[curve_name]
        i = int(np.argmin(np.abs(c.times - time)))
        if abs(float(c.times[i]) - time) > self.SNAP_THRESHOLD:
            return None
        t_snap, v = float(c.times[i]), float(c.values[i])
        peaks = c.max_peaks if kind == "max" else c.min_peaks
        pt = np.append(peaks[0], t_snap)
        pv = np.append(peaks[1], v)
        order = np.argsort(pt)
        if kind == "max":
            c.max_peaks = (pt[order], pv[order])
        else:
            c.min_peaks = (pt[order], pv[order])
        return t_snap, v

    def remove_manual_peak(self, curve_name: str, time: float, *, kind: str = "max"):
        """Remove the marker nearest ``time`` (within the snap threshold)."""
        c = self.curves[curve_name]
        peaks = c.max_peaks if kind == "max" else c.min_peaks
        if len(peaks[0]) == 0:
            return False
        i = int(np.argmin(np.abs(peaks[0] - time)))
        if abs(float(peaks[0][i]) - time) > self.SNAP_THRESHOLD:
            return False
        pt = np.delete(peaks[0], i)
        pv = np.delete(peaks[1], i)
        if kind == "max":
            c.max_peaks = (pt, pv)
        else:
            c.min_peaks = (pt, pv)
        return True

    # ---- region + peaks --------------------------------------------------
    def set_region(self, start: float, end: float):
        if end <= start:
            raise ValueError("region end must be > start")
        self.region = (start, end)

    def analyze_max_peaks(self, panel: int | None = None):
        """find_peaks on every (visible) curve of the panel within the
        region (reference analyze_max_peaks, main.py:1546-1579)."""
        return self._analyze(panel, minima=False)

    def analyze_min_peaks(self, panel: int | None = None):
        return self._analyze(panel, minima=True)

    def _analyze(self, panel, minima):
        out = {}
        for c in self.curves.values():
            if panel is not None and c.panel != panel:
                continue
            pt, pv = peaks_in_interval(c.times, c.values, self.region, minima=minima, device=self.device)
            if minima:
                c.min_peaks = (pt, pv)
            else:
                c.max_peaks = (pt, pv)
            out[c.name] = (pt, pv)
        return out

    # ---- export ----------------------------------------------------------
    def export_csv(
        self, path: str, *, tier_names=None, aggregate_tier=None, include_peaks=True
    ):
        from modulation_mfcc_tpu_torch.io.csvexport import CurveColumn, export_curves_csv

        cols = [
            CurveColumn(
                c.name, c.times, c.values,
                min_times=c.min_peaks[0], min_values=c.min_peaks[1],
                max_times=c.max_peaks[0], max_values=c.max_peaks[1],
                include_min=include_peaks and len(c.min_peaks[0]) > 0,
                include_max=include_peaks and len(c.max_peaks[0]) > 0,
            )
            for c in self.curves.values()
        ]
        export_curves_csv(
            path, cols, textgrid=self.textgrid, tier_names=tier_names,
            region=self.region, aggregate_tier=aggregate_tier,
        )
        return path

    # ---- rendering -------------------------------------------------------
    def render_interactive(self, out: str, *, show_spectrogram: bool = True) -> str:
        """Export the session as a self-contained interactive HTML file:
        synced crosshair, drag/wheel zoom with linked panels, spectrogram
        toggle — the reference's Crosshair/SyncCursor/ZoomToolbar
        capabilities without a Qt event loop (viz/interactive.py)."""
        from modulation_mfcc_tpu_torch.viz.interactive import export_interactive_html

        return export_interactive_html(self, out, show_spectrogram=show_spectrogram)

    def render(self, out: str | None = None, show_spectrogram: bool = True):
        from modulation_mfcc_tpu_torch.viz.panels import CurveSpec, PanelSpec, render_session

        panels = []
        for p in range(self.n_panels):
            spec = PanelSpec()
            for c in self.curves.values():
                if c.panel == p and c.visible:
                    spec.curves.append(
                        CurveSpec(
                            c.name, c.times, c.values, color=c.color,
                            style="scatter" if c.feature.startswith("formant") else "line",
                            min_peaks=c.min_peaks if len(c.min_peaks[0]) else None,
                            max_peaks=c.max_peaks if len(c.max_peaks[0]) else None,
                        )
                    )
            if spec.curves:
                panels.append(spec)
        return render_session(
            panels,
            sound=self.sound,
            spectrogram=self.spectrogram if show_spectrogram else None,
            textgrid=self.textgrid,
            region=self.region,
            out=out,
        )
