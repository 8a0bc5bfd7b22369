"""PyTorch port: the AnalysisSession workflow (models/workbench.py) and the
host modules it writes through (io/textgrid.py, io/csvexport.py,
viz/interactive.py, viz/panels.py, io/audio_device.py) against the JAX
package, on the CPU.

The session's curves meet each feature's port bar against JAX's session
(mod_cepstr 1e-5, f0 0.05 Hz, envelope 1e-5 relative, derived curves the
bar times the operator's growth, as tests/test_torch_pipeline.py states
it), and its peaks are scipy's on its own curves. The host copies produce
the same bytes as JAX's on the same input: given JAX's curve values, the
port's session writes JAX's CSV and HTML text exactly."""
import csv
import json
import os
import re

import numpy as np
import pytest
import scipy.signal as sps
import torch

from modulation_mfcc_tpu.io import audio_device as jax_audio_device
from modulation_mfcc_tpu.io import csvexport as jax_csvexport
from modulation_mfcc_tpu.io import textgrid as jax_textgrid
from modulation_mfcc_tpu.io.ag50x import write_ag50x as jax_write_ag50x
from modulation_mfcc_tpu.models.workbench import AnalysisSession as JaxSession
from modulation_mfcc_tpu_torch import AnalysisSession
from modulation_mfcc_tpu_torch.io import audio_device, csvexport, textgrid
from modulation_mfcc_tpu_torch.io.ag50x import write_ag50x
from modulation_mfcc_tpu_torch.io.textgrid import IntervalTier, PointTier, TextGrid, read_textgrid, write_textgrid
from modulation_mfcc_tpu_torch.io.wav import write_wav
from modulation_mfcc_tpu_torch.models.config import DerivationConfig

torch.set_num_threads(1)

BARS = {"mod_cepstr": 1e-5, "f0": 0.05}  # absolute; the envelope's is 1e-5 relative


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    """The JAX workbench test's input: 1.2 s at 10 kHz, a 140 Hz tone under
    a 3 Hz envelope."""
    d = tmp_path_factory.mktemp("wb")
    sr = 10_000
    t = np.arange(int(1.2 * sr)) / sr
    y = 0.7 * np.sin(2 * np.pi * 140 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    p = str(d / "utt.wav")
    write_wav(p, y, sr)
    return p


def _textgrid(path: str, module=textgrid) -> str:
    tg = module.TextGrid(xmin=0, xmax=1.2)
    it = module.IntervalTier(name="words", xmax=1.2)
    it.add(0.1, 0.6, "ba")
    it.add(0.6, 1.1, "da")
    tg.tiers = [it]
    module.write_textgrid(tg, path)
    return path


def _workflow(s, tg_path: str) -> None:
    """JAX tests/test_workbench.py's session workflow."""
    s.add_curve("mod_cepstr", panel=0)
    s.add_curve("envelope", panel=0)
    s.add_curve("f0", panel=1, derivation=0)
    s.add_curve("mod_cepstr", panel=1, derivation=1, name="mod_vel")
    s.add_curve("envelope", panel=2, derivation=2, dcfg=DerivationConfig(derivative_method="sg"), name="env_acc")
    s.load_textgrid(tg_path)
    s.set_region(0.05, 1.15)


def _bar(name: str, want: np.ndarray) -> float:
    if name.startswith("env"):
        return 1e-5 * np.abs(want).max() * (4.0 if name == "env_acc" else 1.0)  # sg deriv 2: [1, −2, 1]
    return BARS["mod_cepstr"] * (2.0 if name == "mod_vel" else 1.0) if name.startswith("mod") else BARS["f0"]


@pytest.fixture(scope="module")
def sessions(wav_path, tmp_path_factory):
    tg_path = _textgrid(str(tmp_path_factory.mktemp("tg") / "utt.TextGrid"))
    ours, theirs = AnalysisSession(wav_path, device="cpu"), JaxSession(wav_path)
    _workflow(ours, tg_path)
    _workflow(theirs, tg_path)
    return ours, theirs


def test_session_curves_and_spectrogram_match_jax(sessions):
    ours, theirs = sessions
    assert ours.sound.sample_rate == theirs.sound.sample_rate == 10_000
    np.testing.assert_array_equal(ours.sound.amplitudes, theirs.sound.amplitudes)
    assert list(ours.curves) == list(theirs.curves) == ["mod_cepstr", "envelope", "f0", "mod_vel", "env_acc"]
    for name, c in ours.curves.items():
        j = theirs.curves[name]
        assert isinstance(c.values, np.ndarray) and (c.feature, c.panel, c.derivation) == (j.feature, j.panel,
                                                                                         j.derivation)
        np.testing.assert_array_equal(c.times, j.times)
        want = np.asarray(j.values, np.float64)
        assert c.values.shape == want.shape
        assert np.max(np.abs(c.values - want)) <= _bar(name, want), name
    g, w = ours.spectrogram.data_matrix, np.asarray(theirs.spectrogram.data_matrix)
    near = w > w.max() - 40.0
    assert g.shape == w.shape and np.abs(g[near] - w[near]).max() <= 1e-4  # dB, tests/test_torch_features.py


def test_session_peaks_export_and_render(sessions, tmp_path):
    """The JAX workflow's checks on the port's own session: peaks in the
    region are scipy's on each curve's region slice; the CSV has the
    joined and aggregated columns; the figure renders."""
    ours, _ = sessions
    res = ours.analyze_max_peaks(panel=0)
    assert set(res) == {"mod_cepstr", "envelope"} and len(res["mod_cepstr"][0]) >= 2
    ours.analyze_min_peaks()
    for c in ours.curves.values():
        sel = (c.times >= 0.05) & (c.times <= 1.15)
        for minima, (pt, pv) in ((True, c.min_peaks), (False, c.max_peaks)):
            if minima or c.panel == 0:
                idx = sps.find_peaks(-c.values[sel] if minima else c.values[sel])[0]
                np.testing.assert_array_equal(pt, c.times[sel][idx])
                np.testing.assert_array_equal(pv, c.values[sel][idx])
    out = str(tmp_path / "out.csv")
    ours.export_csv(out, aggregate_tier="words")
    rows = list(csv.reader(open(out)))
    hdr = rows[0]
    assert any(h.endswith("_words") for h in hdr)
    assert "interval_label" in hdr and "mod_cepstr_max_x" in hdr
    png = str(tmp_path / "fig.png")
    ours.render(out=png)
    assert os.path.getsize(png) > 10_000


def _same_curves(ours, theirs) -> None:
    """Give the port's session JAX's curve values (same times), so its host
    layers run on the same input."""
    for name, c in ours.curves.items():
        c.values = np.asarray(theirs.curves[name].values)


def test_csv_and_html_text_equal_jax(wav_path, tmp_path):
    """Given JAX's curves, the port's session writes JAX's CSV (joined
    tiers, peaks, region and interval aggregates) and interactive HTML
    (without and with the spectrogram image) byte for byte."""
    tg_path = _textgrid(str(tmp_path / "utt.TextGrid"), jax_textgrid)
    ours, theirs = AnalysisSession(wav_path, device="cpu"), JaxSession(wav_path)
    _workflow(ours, tg_path)
    _workflow(theirs, tg_path)
    _same_curves(ours, theirs)
    ours.spectrogram = theirs.spectrogram
    for s in (ours, theirs):
        s.analyze_max_peaks()
        s.analyze_min_peaks(panel=1)
    for kw in ({"aggregate_tier": "words"}, {"tier_names": ["words"], "include_peaks": False}):
        a, b = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
        ours.export_csv(a, **kw)
        theirs.export_csv(b, **kw)
        assert open(a).read() == open(b).read()
    for show in (False, True):
        a, b = str(tmp_path / "port.html"), str(tmp_path / "jax.html")
        ours.render_interactive(a, show_spectrogram=show)
        theirs.render_interactive(b, show_spectrogram=show)
        assert open(a).read() == open(b).read()
        assert ("data:image/png;base64," in open(a).read()) == show


def test_interactive_export_structure(sessions, tmp_path):
    """JAX tests/test_interactive.py's checks on the port's session."""
    ours, _ = sessions
    ours.analyze_max_peaks(0)
    html = open(ours.render_interactive(str(tmp_path / "view.html"))).read()
    data = json.loads(re.search(r"const DATA = (\{.*?\});\n", html, re.S).group(1))
    assert data["duration"] == pytest.approx(1.2) and data["region"] == [0.05, 1.15]
    names = [c["name"] for p in data["panels"] for c in p]
    assert "mod_cepstr" in names and "envelope" in names
    mc = data["panels"][0][0]
    assert len(mc["x"]) == len(mc["y"]) > 50 and len(mc["maxPeaks"][0]) > 0
    assert data["tiers"][0]["intervals"][0][2] == "ba"
    for token in ("mousemove", "dblclick", "wheel", "zreset", "spectoggle", "cursorT"):
        assert token in html


def test_session_ema_flow_matches_jax(wav_path, tmp_path):
    """A .pos file written by JAX: the resampled channel equals JAX's
    (1e-12), its velocity is np.gradient of it, and the finDiff
    acceleration equals JAX's (1e-10)."""
    pos = np.cumsum(np.random.default_rng(20260816).standard_normal((300, 8, 7)), axis=0).astype(np.float32)
    pp = str(tmp_path / "rec.pos")
    jax_write_ag50x(pp, pos, 250)
    ours, theirs = AnalysisSession(wav_path, device="cpu"), JaxSession(wav_path)
    for s in (ours, theirs):
        s.load_pos(pp)
    c = ours.add_ema_curve(2, "z", panel=2)
    assert len(c.times) > 100
    np.testing.assert_allclose(c.values, theirs.add_ema_curve(2, "z", panel=2).values, rtol=0, atol=1e-12)
    cv = ours.add_ema_curve(2, "z", panel=2, derivation=1)
    assert cv.name.endswith("_vel")
    np.testing.assert_allclose(cv.values, np.gradient(c.values), rtol=0, atol=1e-10)
    fd = DerivationConfig(derivative_method="finDiff", fin_diff_acc_order=4)
    got = ours.add_ema_curve(5, "x", panel=3, derivation=2, dcfg=fd)
    want = theirs.add_ema_curve(5, "x", panel=3, derivation=2, dcfg=fd)
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-10)
    ours.load_pos(pp, target_sample_rate=100)
    assert ours.ema.resampled_samplerate == 100


def test_manual_peak_editing(sessions):
    """Snap-to-nearest add and remove (reference quadruple_axis_plot_item.py
    :187-328, threshold 0.2 s), as JAX tests/test_workbench.py checks it."""
    ours, _ = sessions
    c = ours.add_curve("envelope", panel=3, derivation=0, name="env_edit")
    t_mid = float(c.times[len(c.times) // 2])
    t_snap, _ = ours.add_manual_peak("env_edit", t_mid + 0.003, kind="max")
    assert abs(t_snap - t_mid) < 0.011 and len(c.max_peaks[0]) == 1
    assert ours.add_manual_peak("env_edit", t_mid + 5.0) is None
    assert ours.remove_manual_peak("env_edit", t_snap + 0.05, kind="max")
    assert len(c.max_peaks[0]) == 0 and not ours.remove_manual_peak("env_edit", t_mid, kind="max")
    ours.add_manual_peak("env_edit", t_mid, kind="min")
    assert len(c.min_peaks[0]) == 1
    ours.remove_curve("env_edit")
    assert "env_edit" not in ours.curves


def test_session_validation(wav_path):
    s = AnalysisSession(wav_path, device="cpu")
    with pytest.raises(ValueError, match="panel"):
        s.add_curve("envelope", panel=9)
    with pytest.raises(ValueError, match="region"):
        s.set_region(1.0, 0.5)
    with pytest.raises(RuntimeError, match="pos"):
        s.add_ema_curve(0)
    s.add_custom_curve("ramp", np.linspace(0, 1, 50), torch.linspace(0, 1, 50), panel=1)
    assert isinstance(s.curves["ramp"].values, np.ndarray)
    res = s.analyze_max_peaks()  # no region → empty peak sets
    assert all(len(v[0]) == 0 for v in res.values())
    s.reset_curves()
    assert not s.curves


def _sample_tg(module):
    tg = module.TextGrid(xmin=0, xmax=2)
    it = module.IntervalTier(name="words", xmin=0, xmax=2)
    it.add(0.0, 0.5, "hello")
    it.add(0.5, 1.2, "world")
    it.add(1.2, 2.0, "")
    pt = module.PointTier(name="peaks", xmin=0, xmax=2)
    pt.add(0.25, "p1")
    pt.add(0.75, "p2")
    tg.tiers = [it, pt]
    return tg


def test_textgrid_and_csv_copies_write_jax_bytes(tmp_path):
    """write_textgrid and export_curves_csv give JAX's bytes on the same
    input; each package reads the other's TextGrid (long and short
    format) to the same tiers; the tier edits agree."""
    a, b = str(tmp_path / "port.TextGrid"), str(tmp_path / "jax.TextGrid")
    write_textgrid(_sample_tg(textgrid), a)
    jax_textgrid.write_textgrid(_sample_tg(jax_textgrid), b)
    assert open(a).read() == open(b).read()
    short = ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n0\n2\n<exists>\n1\n'
             '"IntervalTier"\n"words"\n0\n2\n2\n0\n1\n"ab"\n1\n2\n"cd"\n')
    sp = tmp_path / "s.TextGrid"
    sp.write_text(short)
    for path in (b, str(sp)):
        got, want = read_textgrid(path), jax_textgrid.read_textgrid(path)
        assert got.tier_names() == want.tier_names()
        for tg, wt in zip(got.tiers, want.tiers):
            items = "intervals" if isinstance(tg, IntervalTier) else "points"
            assert [vars(x) for x in getattr(tg, items)] == [vars(x) for x in getattr(wt, items)]
    times = np.array([0.1, 0.5, 0.9, 1.5, 3.0])
    assert read_textgrid(b).get_tier("words").labels_at(times) == ["hello", "hello", "world", "", ""]
    it, jt = read_textgrid(b).get_tier("words"), jax_textgrid.read_textgrid(b).get_tier("words")
    assert it.move_boundary(0, 0.7, min_duration=0.1) == jt.move_boundary(0, 0.7, min_duration=0.1)
    assert vars(it.delete_boundary(0)) == vars(jt.delete_boundary(0))
    assert isinstance(read_textgrid(b).get_tier("peaks"), PointTier) and isinstance(TextGrid(), TextGrid)
    t = np.linspace(0, 2, 21)
    for mod, tgm, out in ((csvexport, textgrid, "port.csv"), (jax_csvexport, jax_textgrid, "jax.csv")):
        col = mod.CurveColumn(name="mod", times=t, values=np.sin(t), max_times=np.array([0.5]),
                              max_values=np.array([0.9]), include_max=True)
        mod.export_curves_csv(str(tmp_path / out), [col], textgrid=_sample_tg(tgm), tier_names=["words"],
                              region=(0.0, 1.0), aggregate_tier="words")
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    aggs = csvexport.interval_aggregations([csvexport.CurveColumn("mod", t, np.sin(t))],
                                           _sample_tg(textgrid).get_tier("words"))
    assert [a[0] for a in aggs] == ["hello", "world"] and abs(aggs[0][3] - 0.5) < 1e-9


def test_audio_device_is_gated_as_jax(tmp_path):
    """Without sounddevice both packages report no device and refuse to
    record; the playback cursor's sequence is JAX's."""
    assert audio_device.audio_device_available() == jax_audio_device.audio_device_available()
    if not audio_device.audio_device_available():
        with pytest.raises(RuntimeError, match="sounddevice"):
            audio_device.Recorder().start()
    seqs = []
    for mod in (audio_device, jax_audio_device):
        seen, fake_t = [], [0.0]

        def sleep(dt, fake_t=fake_t):
            fake_t[0] += max(dt, 1e-3)

        mod.animate_position(1.0, 1.1, seen.append, fps=60.0, clock=(lambda fake_t=fake_t: fake_t[0], sleep))
        seqs.append(seen)
    assert seqs[0] == seqs[1] and seqs[0][-1] is None
