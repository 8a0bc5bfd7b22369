"""CLI command implementations (extract, plot, sweep, verify, info).

``run_extract``, ``run_plot`` and ``run_sweep`` are the JAX package's, over
this package's pipeline (models/pipeline.py), workbench
(models/workbench.py) and corpus sweep (parallel/corpus.py), on the device
``--device`` names (CUDA by default).

``run_verify`` is the parity harness of the JAX package's
``modulation_mfcc_tpu/runner.py``: every tracker of this package against
its float64 oracle (oracle.py), with the same surfaces, bars and output, on
the device ``--device`` names (CUDA by default, where the kernels run).
"""
from __future__ import annotations

import csv
import json
import struct
import sys

import numpy as np
import torch

# what a bad input file or feature raises (missing or unreadable file,
# truncated WAV header, unknown feature, too short a signal); a device or
# kernel fault is none of these and propagates
INPUT_ERRORS = (OSError, ValueError, struct.error)


def _load_pipeline_config(path: str | None):
    from modulation_mfcc_tpu_torch.models.config import PipelineConfig, load_config

    return PipelineConfig() if path is None else load_config(path)


def run_extract(args) -> int:
    """Extract the requested feature tracks from each WAV → long-format CSV
    (file, feature, time, value), the reference's CSV-export capability
    (script/main.py:1409-1544) in batch form. A file or feature the input
    cannot give (missing or malformed file, unknown feature, too short) is
    reported on stderr and skipped; a device or kernel fault propagates."""
    from modulation_mfcc_tpu_torch.models import pipeline as pl
    from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

    device = resolve_device(args.device)  # no CUDA where it is asked for: raise, not a warning per file
    cfg = _load_pipeline_config(args.config)
    feats = [f.strip() for f in args.features.split(",") if f.strip()]
    rows: list[tuple] = []
    for path in args.inputs:
        for feat in feats:
            try:
                t, v = pl.extract_feature(path, feat, cfg, derivation=args.derivation, device=device)
            except INPUT_ERRORS as e:  # per-file isolation: a bad file skips
                print(f"warning: {path}: {feat}: {e}", file=sys.stderr)
                continue
            t = np.asarray(t).ravel()
            v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            if v.ndim == 2:  # matrix features (mfcc): one row per coefficient
                for k in range(v.shape[1]):
                    for ti, vi in zip(t, v[:, k]):
                        rows.append((path, f"{feat}{k}", float(ti), float(vi)))
            else:
                for ti, vi in zip(t, v.ravel()):
                    rows.append((path, feat, float(ti), float(vi)))
    out = sys.stdout if args.out == "-" else open(args.out, "w", newline="")
    try:
        w = csv.writer(out)
        w.writerow(["file", "feature", "time", "value"])
        w.writerows(rows)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def run_plot(args) -> int:
    """Render the analysis figure (the reference's display) as a PNG."""
    from modulation_mfcc_tpu_torch.models.workbench import AnalysisSession

    cfg = _load_pipeline_config(args.config)
    s = AnalysisSession(args.wav, cfg, device=args.device)
    feats = [f.strip() for f in args.features.split(",") if f.strip()]
    for i, feat in enumerate(feats):
        try:
            s.add_curve(feat, panel=i // 2)
        except INPUT_ERRORS as e:
            print(f"warning: {feat}: {e}", file=sys.stderr)
    if args.textgrid:
        s.load_textgrid(args.textgrid)
    if args.region:
        s.set_region(args.region[0], args.region[1])
        s.analyze_max_peaks()
        s.analyze_min_peaks()
    s.render(out=args.out)
    print(args.out)
    return 0


class _SurfaceEmit(dict):
    """Prints each surface's JSON line the moment it completes, so a run cut
    part way keeps the surfaces that already passed. A surface's dict is
    complete before it is assigned."""

    def __setitem__(self, key, val):
        super().__setitem__(key, val)
        print(json.dumps({"surface": key, **val}), flush=True)


def run_sweep(args) -> int:
    """Corpus sweep over WAV files and directories (searched recursively for
    ``*.wav``) into an ``.npz`` feature store; prints the throughput report.
    ``--num-shards``/``--shard-id``: this process sweeps its round-robin
    share of the manifest (parallel/multislice.shard_manifest)."""
    import glob
    import os

    from modulation_mfcc_tpu_torch.parallel.corpus import CorpusSweep, sweep_mfcc_change
    from modulation_mfcc_tpu_torch.parallel.multislice import shard_manifest

    paths = []
    for inp in args.inputs:
        if os.path.isdir(inp):
            paths.extend(sorted(glob.glob(os.path.join(inp, "**", "*.wav"), recursive=True)))
        else:
            paths.append(inp)
    if not paths:
        print("no input WAVs found", file=sys.stderr)
        return 1
    if args.num_shards > 1:
        paths = shard_manifest(paths, args.num_shards, args.shard_id)
    cfg = _load_pipeline_config(args.config)
    sweep = CorpusSweep(
        out_dir=args.out, cfg=cfg.mfcc, batch_size=args.batch_size, spectrum=args.spectrum,
        resume=not args.no_resume, features=tuple(f.strip() for f in args.features.split(",") if f.strip()),
        device=args.device,
    )
    print(json.dumps(sweep_mfcc_change(paths, sweep)))
    return 0


def _np(t) -> np.ndarray:
    """A tensor (or array) as a float64 numpy array on the host."""
    return t.detach().cpu().double().numpy() if torch.is_tensor(t) else np.asarray(t, np.float64)


def _max_abs(got: np.ndarray, want: np.ndarray) -> tuple[bool, float]:
    """(shapes equal, max |got − want|, inf where the shapes differ)."""
    ok = got.shape == want.shape
    return ok, float(np.max(np.abs(got - want))) if ok else float("inf")


def _track_vs_oracle(got_f0: np.ndarray, want_f0: np.ndarray, min_agree: float = 1.0, max_hz: float = 2.0) -> dict:
    """Voicing-pattern and voiced-Hz bars for Hz tracks where 0 (or NaN)
    marks unvoiced frames. ``min_agree`` < 1 admits rare near-threshold
    voicing ties (minmax_quant only: its second pass runs in a ~1 Hz-wide
    range, so voiced candidates meet the unvoiced floor at float32 margins
    on envelope nulls). The Hz bars hold on the frames both call voiced."""
    got_v = np.nan_to_num(got_f0, nan=0.0) > 20
    want_v = np.nan_to_num(want_f0, nan=0.0) > 20
    shape_ok = got_f0.shape == want_f0.shape
    agree = float(np.mean(got_v == want_v)) if shape_ok else 0.0
    voicing_ok = shape_ok and agree >= min_agree
    both = got_v & want_v if shape_ok else np.zeros(0, bool)
    if voicing_ok and both.any():
        d = np.abs(got_f0[both] - want_f0[both])
        p99, dmax = float(np.quantile(d, 0.99)), float(np.max(d))
    elif voicing_ok:
        p99 = dmax = 0.0  # identical all-unvoiced tracks
    else:
        p99 = dmax = float("inf")
    return {
        "voicing_identical": shape_ok and agree == 1.0, "voicing_agreement": agree,
        "p99_voiced_hz": p99, "max_voiced_hz": dmax,
        "n_voiced": int(want_v.sum()), "n_unvoiced": int((~want_v).sum()),
        "pass": voicing_ok and p99 <= 0.2 and dmax <= max_hz,
    }


def run_verify(args) -> int:
    """Parity harness: every tracker on ``args.device`` against its float64
    oracle. One JSON line per surface as it completes, then the verdict;
    exit 0 iff all pass.

    Surfaces and bars (the JAX package's):
      * mod_cepstr vs get_mfccs_change_np: max-abs ≤ 1e-4
      * intensity vs praat_intensity_np: ≤ 0.01 dB, frame-exact
      * pitch_ac, pitch_cc vs boersma_pitch_np: identical voicing, voiced
        p99 ≤ 0.2 Hz
      * minmax_quant, the two-pass range vs its float64 mirror: voicing ≥ 99 %
        identical, voiced p99 ≤ 0.2 Hz
      * pyin vs pyin_np: identical voicing, ≥ 99 % identical bins (any flip
        ≤ 1 bin, else every flip certified by a decode with the rounding
        boundary moved ±3e-3 bins), same-bin f0 ≤ 1e-5 relative
      * envelope_rms vs a float64 mirror: max-abs ≤ 1e-4
      * envelope_hilbert vs scipy.signal.hilbert: max-abs ≤ 1e-3
      * envelope_rmspraat vs a float64 mirror: ≤ 0.01 dB, frame-exact
      * formants vs praat_formants_np: ≥ 99 % identical formant-count
        pattern, p99 ≤ 2 Hz
      * padded_batch, the masked batch against per-file results: ≤ 1e-4
    """
    import scipy.signal as sps

    from modulation_mfcc_tpu_torch import oracle
    from modulation_mfcc_tpu_torch.models.config import AmplitudeConfig, F0Config, MfccConfig
    from modulation_mfcc_tpu_torch.models.envelope import amplitude_envelope
    from modulation_mfcc_tpu_torch.models.modulation import extract_mfcc_change
    from modulation_mfcc_tpu_torch.models.pitch import extract_f0
    from modulation_mfcc_tpu_torch.models.pitch_adaptive import praat_style_intensity
    from modulation_mfcc_tpu_torch.ops.hilbert import hilbert_envelope
    from modulation_mfcc_tpu_torch.ops.intensity import intensity_db
    from modulation_mfcc_tpu_torch.ops.lpc import lpc_formants
    from modulation_mfcc_tpu_torch.ops.pitch import pitch_ac
    from modulation_mfcc_tpu_torch.ops.yin import pyin_f0
    from modulation_mfcc_tpu_torch.parallel.batch import batched_mfcc_change, pad_batch
    from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

    dev = resolve_device(getattr(args, "device", None) or "cuda")
    # maxFreq as the flagship: min(the reference's 10 kHz, Nyquist)
    sr = int(getattr(args, "sr", None) or 10_000)
    mcfg = MfccConfig(signal_sample_rate=sr, maxFreq=float(min(10_000.0, sr / 2.0))) if sr != 10_000 \
        else MfccConfig()
    if getattr(args, "wav", None):
        from modulation_mfcc_tpu_torch.io.wav import load_channel

        y = load_channel(args.wav, sr)
        if y.ndim > 1:
            y = y[0]
    else:
        rng = np.random.default_rng(0)
        t = np.arange(int(getattr(args, "seconds", 2.0) * sr)) / sr
        y = np.sin(2 * np.pi * 120 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
        y = y + 0.01 * rng.standard_normal(len(t))
    y = np.asarray(y, dtype=np.float64)
    yt = torch.tensor(y, dtype=torch.float32, device=dev)
    results = _SurfaceEmit()

    got, _ = extract_mfcc_change(y, mcfg, device=dev)
    want, _ = oracle.get_mfccs_change_np(y, float(sr), max_freq=mcfg.maxFreq)
    ok, err = _max_abs(_np(got), want)
    results["mod_cepstr"] = {"max_abs_err": err, "tolerance": 1e-4, "pass": ok and err <= 1e-4}

    _, want_db = oracle.praat_intensity_np(y, float(sr))
    ok, err = _max_abs(_np(intensity_db(yt, sr=float(sr))), want_db)
    results["intensity"] = {"max_abs_db": err, "tolerance": 0.01, "pass": ok and err <= 0.01}

    results["pitch_ac"] = _track_vs_oracle(_np(pitch_ac(yt, sr=float(sr))), oracle.boersma_pitch_np(y, float(sr)))
    # To Pitch (cc), the reference's praatcc branch (script/calc.py:535-543)
    results["pitch_cc"] = _track_vs_oracle(_np(pitch_ac(yt, sr=float(sr), method="cc")),
                                           oracle.boersma_pitch_np(y, float(sr), method="cc"))

    # minMaxQuant two-pass (script/calc.py:548-556): pass 1 at the config
    # range, the 5/95 % quantiles of the > 20 Hz frames rounded to 0.1 Hz,
    # then always "To Pitch (ac)"; the oracle re-derives both passes
    qcfg = F0Config(minMaxQuant=(0.05, 0.95), outFilter=None, interpUnvoiced=None)
    got_q, _ = extract_f0(y, float(sr), qcfg, device=dev)  # NaN where unvoiced

    def quant_range(track):
        v = track[track > 20]
        if not v.size:
            return None
        qq = np.quantile(v, [qcfg.minMaxQuant[0], qcfg.minMaxQuant[1]])
        lo, hi = round(float(qq[0]), 1), round(float(qq[1]), 1)
        return (lo, hi) if hi > lo > 0 else None

    want_q = oracle.boersma_pitch_np(y, float(sr), min_pitch=qcfg.minPitch, max_pitch=qcfg.maxPitch)
    # The 0.1 Hz rounding is a step: a quantile within ~1e-3 of a boundary
    # may round apart between the float64 and the float32 first pass. Where
    # the ranges differ by at most one step an end, the pitch arithmetic is
    # certified at the device's range (and the tie recorded); a larger gap
    # keeps the oracle's range, and the surface fails.
    rng_want = quant_range(want_q)
    rng_dev = quant_range(_np(pitch_ac(yt, sr=float(sr), min_pitch=qcfg.minPitch, max_pitch=qcfg.maxPitch)))
    quant_tie, rng = False, rng_want
    if rng_want != rng_dev and rng_want is not None and rng_dev is not None:
        if all(abs(a - b) <= 0.1 + 1e-9 for a, b in zip(rng_want, rng_dev)):
            rng, quant_tie = rng_dev, True
    if rng is not None:
        want_q = oracle.boersma_pitch_np(y, float(sr), min_pitch=rng[0], max_pitch=rng[1])
    # max_hz 5: the second pass's ~1 Hz-wide range bounds candidate swaps on
    # envelope nulls by the range plus the sinc refinement's excursion
    mq = _track_vs_oracle(_np(got_q), want_q, min_agree=0.99, max_hz=5.0)
    if quant_tie:
        mq["quant_boundary_tie"] = True
    results["minmax_quant"] = mq

    hop_samples = int(round(0.01 * sr))
    of0, ovoiced, ostates = oracle.pyin_np(y, sr, hop_length=hop_samples)
    jf0, jstates = pyin_f0(yt, sr=float(sr), return_states=True)
    jf0, jstates = _np(jf0), jstates.cpu().numpy()
    # identical voicing; ≥ 99 % of voiced frames on the identical bin, any
    # other ≤ 1 bin; f0 of same-bin frames ≤ 1e-5 relative (the float32
    # 2^(bin/120) evaluation). A float32 CMNDF value within ~1e-6 of a
    # threshold, or a bin value near the .5 rounding boundary, can move a
    # near-tied decode by a bin; the certificate below tells those apart.
    voicing_ok = jf0.shape == of0.shape and bool(np.array_equal(jf0 > 0, ovoiced))
    if voicing_ok and ovoiced.any():
        b_got = np.round(120.0 * np.log2(jf0[ovoiced] / 75.0))
        b_want = np.round(120.0 * np.log2(of0[ovoiced] / 75.0))
        dbin = np.abs(b_got - b_want)
        bin_agree, max_dbin = float(np.mean(dbin == 0)), float(dbin.max())
        same = dbin == 0
        rel = float(np.max(np.abs(jf0[ovoiced][same] / of0[ovoiced][same] - 1.0))) if same.any() else 0.0
    elif voicing_ok:
        bin_agree, max_dbin, rel = 1.0, 0.0, 0.0  # all unvoiced
    else:
        bin_agree, max_dbin, rel = 0.0, float("inf"), float("inf")
    # Certificate for agreement under 0.99: the float64 oracle decoded with
    # the bin rounding boundary moved by ±3e-3 bins (pyin_np bin_shift);
    # every flipped frame must match one of those decodes. A real decode
    # fault lands on bins no boundary move produces.
    n_flips, n_cert, tie_ok = 0, 0, False
    if voicing_ok and 0.0 < bin_agree < 0.99 and max_dbin <= 1.0:
        flip_ix = np.flatnonzero(jstates != ostates)
        n_flips = len(flip_ix)
        cert = np.zeros(n_flips, dtype=bool)
        for delta in (-3e-3, 3e-3):
            cert |= oracle.pyin_np(y, sr, hop_length=hop_samples, bin_shift=delta)[2][flip_ix] == jstates[flip_ix]
        n_cert, tie_ok = int(cert.sum()), bool(cert.all())
    pyin_res = {
        "voicing_identical": voicing_ok, "bin_agreement": bin_agree, "max_bin_delta": max_dbin,
        "max_rel_same_bin": rel,
        "pass": voicing_ok and (bin_agree >= 0.99 or tie_ok) and max_dbin <= 1.0 and rel <= 1e-5,
    }
    if n_flips:
        pyin_res["bin_flips"] = n_flips
        pyin_res["boundary_certified"] = n_cert
    results["pyin"] = pyin_res

    # RMS envelope (the reference's default method): a float64 mirror of
    # the geometry, centered zero padding and frame starts on the hop grid
    # (reference: mfcc.py:137-150 get_amplitude)
    acfg = AmplitudeConfig()
    w, h = int(acfg.winLen * sr), int(acfg.hopLen * sr)
    yp = np.pad(y, (w // 2, w // 2))
    nf_amp = 1 + (len(y) + 2 * (w // 2) - w) // h
    want_amp = np.sqrt(np.array([np.mean(yp[k * h : k * h + w] ** 2) for k in range(nf_amp)]))
    ok, err = _max_abs(_np(amplitude_envelope(yt, float(sr), acfg)), want_amp)
    results["envelope_rms"] = {"max_abs_err": err, "tolerance": 1e-4, "pass": ok and err <= 1e-4}

    ok, err = _max_abs(_np(hilbert_envelope(yt)), np.abs(sps.hilbert(y)))
    results["envelope_hilbert"] = {"max_abs_err": err, "tolerance": 1e-3, "pass": ok and err <= 1e-3}

    # RMSpraat (reference mfcc.py:190-259): a 50-700 Hz pitch pass, the
    # 25/75 % quantile range [0.75·q25, 2.5·q75], a second pass, then Praat
    # intensity with minPitch = the minimum of the raw second-pass track, or
    # the dense (120 Hz, 1/sr) branch whenever a frame is unvoiced
    got_ra, _ = praat_style_intensity(yt, float(sr))
    f2 = f1 = oracle.boersma_pitch_np(y, float(sr), hop=0.01, min_pitch=50.0, max_pitch=700.0)
    voc = f1[f1 > 20]
    if voc.size:
        qv = np.quantile(voc, [0.25, 0.75])
        lo, hi = 0.75 * float(qv[0]), 2.5 * float(qv[1])
        if hi > lo > 0:
            f2 = oracle.boersma_pitch_np(y, float(sr), hop=0.01, min_pitch=lo, max_pitch=hi)
    min_obs = float(f2.min()) if f2.size else 0.0
    if min_obs > 120.0:
        _, want_ra = oracle.praat_intensity_np(y, float(sr), min_pitch=min_obs, time_step=0.01)
    else:
        _, want_ra = oracle.praat_intensity_np(y, float(sr), min_pitch=120.0, time_step=1.0 / float(sr))
    ok, err = _max_abs(_np(got_ra), want_ra)
    results["envelope_rmspraat"] = {"max_abs_db": err, "tolerance": 0.01, "pass": ok and err <= 0.01}

    # Formants: the Burg chain (pre-emphasis, Gaussian window, Burg, roots,
    # band filter, sort) against the float64 np.roots oracle (reference:
    # calc.py:131-148 to_formant_burg). Marginal frames may flip a root at a
    # band edge; the track as a whole sits at oracle precision.
    _, want_ff, _ = oracle.praat_formants_np(y, float(sr), max_formant=sr / 2)
    got_ff = _np(lpc_formants(yt, sr=float(sr), max_formant=sr / 2)[0])
    if got_ff.shape == want_ff.shape:
        pattern = float((np.isfinite(got_ff) == np.isfinite(want_ff)).mean())
        mf = np.isfinite(got_ff) & np.isfinite(want_ff)
        df = np.abs(got_ff[mf] - want_ff[mf])
        fp99 = float(np.quantile(df, 0.99)) if mf.any() else 0.0
        fmax = float(np.max(df)) if mf.any() else 0.0
    else:
        pattern, fp99, fmax = 0.0, float("inf"), float("inf")
    results["formants"] = {"pattern_agreement": pattern, "p99_hz": fp99, "max_hz": fmax,
                           "pass": pattern >= 0.99 and fp99 <= 2.0 and fmax <= 30.0}

    # The masked batch reproduces the per-file extraction where the mask is
    # live (the masked FIR edges are what a precision change breaks first)
    n = len(y)
    sigs = [y[: int(0.9 * n)], y[: int(0.6 * n)], y]
    tot_b, mask = batched_mfcc_change(pad_batch(sigs, bucket_multiple=2048, device=dev), mcfg)
    tot_b, mask = _np(tot_b), mask.cpu().numpy()
    pb_err, pb_ok = 0.0, True
    for i, s in enumerate(sigs):
        got_i = _np(extract_mfcc_change(np.asarray(s), mcfg, device=dev)[0])
        nf_i = int(mask[i].sum())
        if nf_i != len(got_i):
            pb_ok = False
            break
        pb_err = max(pb_err, float(np.max(np.abs(tot_b[i, :nf_i] - got_i))))
    results["padded_batch"] = {"max_abs_err": pb_err if pb_ok else float("inf"), "tolerance": 1e-4,
                               "pass": pb_ok and pb_err <= 1e-4}

    ok = all(r["pass"] for r in results.values())
    print(json.dumps({"overall_pass": ok}))
    return 0 if ok else 1


def run_info() -> int:
    """The torch and CUDA versions, the cards, and whether the kernel
    library for these sources is built, as one JSON line."""
    from modulation_mfcc_tpu_torch.kernels import _build

    cuda = torch.cuda.is_available()
    lib = _build.library_path()
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda, "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else [],
        "kernels_built": lib.exists(), "kernel_library": str(lib),
    }))
    return 0
