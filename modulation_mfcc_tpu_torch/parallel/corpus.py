"""Corpus-scale extraction: manifest in, feature store out.

The scale layer the reference lacks (it processes one file per GUI
interaction):

  * manifest = list of WAV paths;
  * files are decoded + resampled on the host (a background thread),
    bucketed by length and dtype, padded, and streamed to the card with
    double-buffered prefetch (parallel/prefetch.py);
  * 16-bit-exact batches (16-bit PCM at the analysis rate) upload as int16,
    half the bytes of float32; with a fused spectrum and only the modulation
    cepstrum requested they upload as hop rows (pack_hop_rows), which the
    fused kernel reads directly;
  * extraction is the batched masked modulation pipeline
    (parallel/batch.batched_mfcc_change), two batches in flight: batch k+1
    is dispatched before batch k's result is fetched;
  * results land in per-file ``.npz`` records (times + features), with a
    done-list for resumable sweeps (crash → rerun skips finished files);
  * a file that fails to decode is logged and skipped; it never aborts the
    sweep. The device step is not inside any ``try``.
"""
from __future__ import annotations

import hashlib
import os
import time
from collections import deque
from dataclasses import dataclass, replace

import numpy as np

from modulation_mfcc_tpu_torch.io.wav import load_channel
from modulation_mfcc_tpu_torch.kernels.fused_frontend import pack_hop_rows
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import change_times, min_frames_for_fir
from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch, batched_mfcc_change
from modulation_mfcc_tpu_torch.parallel.prefetch import background_iter, prefetch_to_device
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device, round_up_to_multiple
from modulation_mfcc_tpu_torch.utils.obs import ThroughputMeter, log_event

__all__ = ["CorpusSweep", "sweep_mfcc_change"]

# extra feature tracks of the JAX sweep and the ROADMAP item each waits for
_UNPORTED_FEATURES = {"mfcc39": "A.16", "f0": "A.16", "envelope": "A.16", "formants": "A.16"}


@dataclass
class CorpusSweep:
    """Configuration of one corpus run.

    ``spectrum``: 'fused_i16' is the parity sweep (corpus audio reaches the
    card as int16, the i16 mode's exact domain); 'fused_bf16' the
    throughput mode; 'auto' (default) is 'fused'. ``device``: where the
    sweep computes (default CUDA; "cpu" for the CPU).
    """

    out_dir: str
    cfg: MfccConfig = MfccConfig()
    batch_size: int = 32
    bucket_multiple: int = 16_384
    spectrum: str = "auto"
    resume: bool = True
    use_native_loader: bool = False
    features: tuple = ("mod_cepstr",)
    mesh: object = None
    device: object = None


def _done_path(sweep: CorpusSweep) -> str:
    return os.path.join(sweep.out_dir, "_done.txt")


def _output_names(paths: list[str]) -> dict[str, str]:
    """Collision-free npz name per input path: the basename when unique,
    else the basename plus a short hash of the path."""
    stems: dict[str, int] = {}
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        stems[stem] = stems.get(stem, 0) + 1
    names = {}
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        if stems[stem] > 1:
            stem += "_" + hashlib.sha1(p.encode()).hexdigest()[:8]
        names[p] = stem + ".npz"
    return names


def _load_done(sweep: CorpusSweep) -> set[str]:
    try:
        with open(_done_path(sweep)) as f:
            return {line.strip() for line in f if line.strip()}
    except FileNotFoundError:
        return set()


def _decode_stream(paths, sweep: CorpusSweep):
    """Host stage: decode/resample each file; yield (path, float32 samples),
    or log and skip a file that fails to decode or is too short."""
    for p in paths:
        try:
            y = load_channel(p, sweep.cfg.signal_sample_rate)
            if y.ndim > 1:
                y = y[0]
            if len(y) < sweep.cfg.n_fft:
                raise ValueError(f"too short ({len(y)} samples)")
        except Exception as e:  # a bad file is skipped, never the sweep
            log_event("corpus.skip", file=p, error=f"{type(e).__name__}: {e}")
            continue
        yield p, np.asarray(y, dtype=np.float32)


def _timed_iter(gen, stats: dict, key: str):
    """Accumulate the time the wrapped generator spends producing each item
    into ``stats[key]``."""
    it = iter(gen)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        stats[key] += time.perf_counter() - t0
        yield item


def _bucketed_batches(items, sweep: CorpusSweep, stats: dict, rows_mode: bool):
    """Group decoded files into padded batches of ``batch_size`` by length
    bucket; dtype is part of the key, so each batch uploads in one format."""
    buckets: dict[tuple, list] = {}

    def assemble(group, t_pad):
        t0 = time.perf_counter()
        b = _make_batch(group, t_pad, sweep.cfg if rows_mode else None)
        stats["assemble_busy_s"] += time.perf_counter() - t0
        return b

    for path, y in items:
        key = (round_up_to_multiple(len(y), sweep.bucket_multiple), y.dtype == np.int16)
        buckets.setdefault(key, []).append((path, y))
        if len(buckets[key]) == sweep.batch_size:
            yield assemble(buckets.pop(key), key[0])
    for key, group in buckets.items():
        yield assemble(group, key[0])


def _make_batch(group, t_pad: int, rows_cfg: MfccConfig | None = None):
    """(paths, {"samples", "lengths"}, n_samples of a hop-rows batch or
    None). A batch whose samples all lie on the int16 grid (v·2¹⁵ integral
    and in range: 16-bit PCM at the analysis rate) ships as int16, which the
    card dequantizes exactly; with ``rows_cfg`` such a batch ships as hop
    rows of that configuration's geometry."""
    paths = [p for p, _ in group]
    sigs = [y for _, y in group]
    lengths = np.array([len(s) for s in sigs], dtype=np.int64)
    i16 = all(s.dtype == np.int16 for s in sigs)
    samples = np.zeros((len(sigs), t_pad), dtype=np.int16 if i16 else np.float32)
    for i, s in enumerate(sigs):
        samples[i, : len(s)] = s
    if not i16:
        scaled = samples * np.float32(2.0**15)
        # the cast is defined on [-32768, 32768); NaN fails both tests and keeps float32
        if scaled.min() >= -32768.0 and scaled.max() < 32768.0:
            as_i16 = scaled.astype(np.int16)
            if np.array_equal(as_i16, scaled):
                samples, i16 = as_i16, True
    if i16 and rows_cfg is not None:
        rows = pack_hop_rows(samples, n_fft=rows_cfg.n_fft, hop=rows_cfg.hop_length,
                             win_length=rows_cfg.win_length)
        return paths, {"samples": rows, "lengths": lengths}, t_pad
    return paths, {"samples": samples, "lengths": lengths}, None


def _check_supported(sweep: CorpusSweep) -> None:
    if sweep.use_native_loader:
        raise NotImplementedError("the native decode loader is not ported yet (ROADMAP A.16)")
    if sweep.mesh is not None:
        raise NotImplementedError("mesh-sharded sweeps are not ported yet (ROADMAP A.16)")
    for f in sweep.features:
        if f in _UNPORTED_FEATURES:
            raise NotImplementedError(
                f"sweep feature {f!r} is not ported yet (ROADMAP {_UNPORTED_FEATURES[f]})")
        if f != "mod_cepstr":
            raise ValueError(f"Unknown sweep feature {f!r}")


def sweep_mfcc_change(paths: list[str], sweep: CorpusSweep) -> dict:
    """Run the sweep; returns the throughput report (items, audio hours,
    elapsed, audio-h/s, and the stages' busy seconds under "stages").

    Output: ``<out_dir>/<basename>.npz`` (duplicate basenames get a short
    path-hash suffix) with keys ``times`` and ``mod_cepstr`` per input file,
    plus ``_done.txt`` for resume.
    """
    _check_supported(sweep)
    if sweep.spectrum == "auto":
        sweep = replace(sweep, spectrum="fused")
    device = resolve_device(sweep.device)
    os.makedirs(sweep.out_dir, exist_ok=True)
    cfg = sweep.cfg
    out_names = _output_names(paths)
    done = _load_done(sweep) if sweep.resume else set()
    todo = [p for p in paths if p not in done]
    log_event("corpus.start", files=len(paths), todo=len(todo), resumed=len(paths) - len(todo))

    meter = ThroughputMeter()
    # busy time of each stage as seen from its own thread; the stages
    # overlap, so the fields explain the wall time without summing to it
    # (dispatch_busy_s: the main loop's host time in batched_mfcc_change,
    # which returns before the card is done with the fused kernels but runs
    # the scan filters of short-file batches as a loop of small launches)
    stats = {
        "decode_busy_s": 0.0, "assemble_busy_s": 0.0, "upload_busy_s": 0.0,
        "upload_mb": 0.0, "dispatch_busy_s": 0.0, "fetch_wait_s": 0.0, "write_busy_s": 0.0,
    }
    rows_mode = sweep.spectrum.startswith("fused") and tuple(sweep.features) == ("mod_cepstr",)
    decode = background_iter(_timed_iter(_decode_stream(todo, sweep), stats, "decode_busy_s"),
                             maxsize=2 * sweep.batch_size)
    batches = background_iter(_bucketed_batches(decode, sweep, stats, rows_mode), maxsize=2)
    # (paths, host lengths, hop-rows n_samples) per batch, known before upload
    path_groups: deque = deque()

    def device_stream():
        for paths_b, arrays, t_pad_b in batches:
            path_groups.append((paths_b, arrays["lengths"], t_pad_b))
            yield arrays

    mf = min_frames_for_fir(cfg)
    pending: deque = deque()

    def flush_one(done_f):
        paths_b, lengths_np, tot_d = pending.popleft()
        t0 = time.perf_counter()
        tot = tot_d.cpu().numpy()
        stats["fetch_wait_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, p in enumerate(paths_b):
            n_i = int(lengths_np[i])
            nf = min(1 + n_i // cfg.hop_length, tot.shape[-1])
            np.savez(os.path.join(sweep.out_dir, out_names[p]),
                     times=change_times(n_i, cfg)[:nf], mod_cepstr=tot[i, :nf])
            done_f.write(p + "\n")
            meter.add(n_i / cfg.signal_sample_rate)
        done_f.flush()
        stats["write_busy_s"] += time.perf_counter() - t0

    with open(_done_path(sweep), "a") as done_f:
        for arrays in prefetch_to_device(device_stream(), depth=2, device=device, stats=stats):
            paths_b, lengths_np, t_pad_b = path_groups.popleft()
            fir_ok = mf is not None and 1 + int(lengths_np.min()) // cfg.hop_length >= mf
            t0 = time.perf_counter()
            tot, _mask = batched_mfcc_change(
                AudioBatch(arrays["samples"], arrays["lengths"]), cfg,
                spectrum=sweep.spectrum, masked_fir=fir_ok, n_samples=t_pad_b,
            )
            stats["dispatch_busy_s"] += time.perf_counter() - t0
            pending.append((paths_b, lengths_np, tot))
            if len(pending) >= 2:
                flush_one(done_f)
        while pending:
            flush_one(done_f)
    report = meter.report()
    report["stages"] = {k: round(v, 4) for k, v in stats.items()}
    if stats["upload_busy_s"] > 0:
        report["stages"]["link_mbps"] = round(stats["upload_mb"] / stats["upload_busy_s"], 1)
    log_event("corpus.finish", **report)
    return report
