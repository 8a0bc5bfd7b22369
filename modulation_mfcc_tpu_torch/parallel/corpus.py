"""Corpus-scale extraction: manifest in, feature store out.

The scale layer the reference lacks (it processes one file per GUI
interaction):

  * manifest = list of WAV paths;
  * files are decoded + resampled on the host (the native threaded loader,
    io/native.py, in manifest order, or the Python reader), bucketed by
    length and dtype, padded, and streamed to the card with double-buffered
    prefetch (parallel/prefetch.py);
  * 16-bit-exact batches (16-bit PCM at the analysis rate) upload as int16,
    half the bytes of float32; with a fused spectrum and only the modulation
    cepstrum requested they upload as hop rows (pack_hop_rows), which the
    fused kernel reads directly;
  * extraction is the batched masked modulation pipeline
    (parallel/batch.batched_mfcc_change) plus the requested tracker extras
    (mfcc39, f0, envelope, formants), all dispatched per batch without a
    host sync; two batches in flight: batch k+1 is dispatched before batch
    k's results are fetched, together, in one synchronisation;
  * with ``mesh`` (torch.distributed), every rank decodes and buckets the
    same manifest, computes its block of each batch's rows, and the rows are
    all-gathered; rank 0 alone writes the records;
  * results land in per-file ``.npz`` records (times + features), with a
    done-list for resumable sweeps (crash → rerun skips finished files);
  * a file that fails to decode is logged and skipped; it never aborts the
    sweep. The device step is not inside any ``try``.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
import time
from collections import deque
from dataclasses import dataclass, replace
from fractions import Fraction

import numpy as np
import torch
import torch.distributed as dist

from modulation_mfcc_tpu_torch.io import native
from modulation_mfcc_tpu_torch.io.wav import load_channel
from modulation_mfcc_tpu_torch.kernels.fused_frontend import pack_hop_rows
from modulation_mfcc_tpu_torch.models.config import AmplitudeConfig, F0Config, FormantConfig, MfccConfig
from modulation_mfcc_tpu_torch.models.envelope import extract_envelope
from modulation_mfcc_tpu_torch.models.features import mfcc_with_deltas
from modulation_mfcc_tpu_torch.models.modulation import change_times, mfcc_trajectories, min_frames_for_fir
from modulation_mfcc_tpu_torch.ops.lpc import formant_frames
from modulation_mfcc_tpu_torch.ops.resample import n_resampled, resample_poly_device
from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch, batched_mfcc_change, frame_validity_mask
from modulation_mfcc_tpu_torch.parallel.features_batch import batched_envelope, batched_f0, batched_formants
from modulation_mfcc_tpu_torch.parallel.mesh import all_reduce, axis_index, axis_size, gather_rows, shard_rows
from modulation_mfcc_tpu_torch.parallel.prefetch import background_iter, prefetch_to_device
from modulation_mfcc_tpu_torch.utils.helpers import dequantize_samples, resolve_device, round_up_to_multiple
from modulation_mfcc_tpu_torch.utils.obs import ThroughputMeter, log_event

__all__ = ["CorpusSweep", "sweep_mfcc_change"]

EXTRAS = ("mfcc39", "f0", "envelope", "formants")  # the tracker tracks beside mod_cepstr


@dataclass
class CorpusSweep:
    """Configuration of one corpus run.

    ``spectrum``: 'fused_i16' is the parity sweep (corpus audio reaches the
    card as int16, the i16 mode's exact domain); 'fused_bf16' the
    throughput mode; 'auto' (default) is 'fused'. ``features``: 'mod_cepstr'
    and any of :data:`EXTRAS`, configured by ``f0_cfg``, ``amp_cfg`` and
    ``formant_cfg`` (None: the defaults); RMSpraat envelopes run per file.
    ``use_native_loader`` (default True): decode with the native threaded
    loader (``loader_threads`` threads), or, where it cannot be built, the
    Python reader, as with False. ``mesh``: a torch.distributed DeviceMesh
    (parallel/mesh.make_mesh) whose "data" (and "slice") axes split each
    batch's rows. ``device``: where the sweep computes (default CUDA, the
    rank's own under NCCL; "cpu" for the CPU).
    """

    out_dir: str
    cfg: MfccConfig = MfccConfig()
    batch_size: int = 32
    bucket_multiple: int = 16_384
    spectrum: str = "auto"
    resume: bool = True
    use_native_loader: bool = True
    loader_threads: int = 4
    features: tuple = ("mod_cepstr",)
    f0_cfg: F0Config | None = None
    amp_cfg: AmplitudeConfig | None = None
    formant_cfg: FormantConfig | None = None
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
    """Host stage: decode/resample each file; yield (path, samples) in
    manifest order, or log and skip a file that fails to decode or is too
    short. The native loader where it builds (int16 for 16-bit PCM at the
    analysis rate, else float32), else the Python reader (float32)."""
    if sweep.use_native_loader:
        try:
            native.load_library()
        except (OSError, subprocess.SubprocessError) as e:
            log_event("corpus.native_loader_unavailable", error=f"{type(e).__name__}: {e}")
        else:
            yield from _decode_stream_native(paths, sweep)
            return
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


def _decode_stream_native(paths, sweep: CorpusSweep):
    """The native loader's files, put back in manifest order (the loader
    yields them as its threads finish), so every run and every rank forms
    the same batches."""
    ready: dict[int, np.ndarray | None] = {}
    nxt = 0
    with native.NativeBatchLoader(int(sweep.cfg.signal_sample_rate), n_threads=sweep.loader_threads,
                                  want_i16=True) as loader:
        for i, p in enumerate(paths):
            loader.submit(i, p)
        for idx, samples in loader:
            ready[idx] = samples
            while nxt in ready:
                y, p = ready.pop(nxt), paths[nxt]
                nxt += 1
                if y is None or len(y) < sweep.cfg.n_fft:
                    log_event("corpus.skip", file=p, error="native decode failed or too short")
                    continue
                yield p, y


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


def _features(sweep: CorpusSweep) -> tuple[str, ...]:
    for f in sweep.features:
        if f != "mod_cepstr" and f not in EXTRAS:
            raise ValueError(f"Unknown sweep feature {f!r}")
    return tuple(f for f in EXTRAS if f in sweep.features)


def _extras(samples: torch.Tensor, lengths: torch.Tensor, cfg: MfccConfig, spectrum: str, feats: tuple[str, ...],
            f0cfg: F0Config, acfg: AmplitudeConfig, fmcfg: FormantConfig) -> dict[str, tuple]:
    """The batched extra tracks of a flat batch [B, T] (float32 or int16),
    each as (values [B, NF, ...], valid [B, NF]), dispatched without a host
    sync (JAX corpus._extras_impl). RMSpraat is not here: it runs per file."""
    x = dequantize_samples(samples)
    sr = float(cfg.signal_sample_rate)
    batch = AudioBatch(x, lengths)
    out = {}
    if "mfcc39" in feats:
        mask = frame_validity_mask(lengths, samples.shape[-1], cfg)
        m = mfcc_trajectories(samples if spectrum.startswith("fused") else x, cfg, frame_mask=mask,
                              spectrum=spectrum)
        out["mfcc39"] = (mfcc_with_deltas(m, frame_mask=mask, normalize=True), mask)
    if "f0" in feats:
        out["f0"] = batched_f0(batch, sr, f0cfg)
    if "envelope" in feats:
        out["envelope"] = batched_envelope(batch, sr, acfg)
    if "formants" in feats:
        # Praat's formant step resamples to twice the ceiling (script/calc.py:131-141), on the device here
        frac = Fraction(int(round(2.0 * fmcfg.max_formant)), int(round(sr))).limit_denominator(1000)
        up, dn = frac.numerator, frac.denominator
        xr = resample_poly_device(x, up, dn)
        sr2 = sr * up / dn
        fr, bw = batched_formants(xr, sr2, fmcfg)
        starts, nw, _ = formant_frames(xr.shape[-1], sr2, fmcfg.window_length, fmcfg.time_step)
        fvalid = torch.as_tensor(starts + nw, device=x.device)[None, :] <= n_resampled(lengths, up, dn)[:, None]
        out["formants"] = (fr, fvalid)
        out["formant_bw"] = (bw, fvalid)
    return out


def _rmspraat_rows(samples: torch.Tensor, lengths: torch.Tensor, sr: float, acfg: AmplitudeConfig,
                   width_reduce) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(values [B, W], valid [B, W], per-file hop seconds [B]) of the
    pitch-adaptive RMSpraat envelope, per file (extract_envelope; its rate is
    chosen per file). ``width_reduce`` takes the local width to the width
    every rank pads to."""
    x = dequantize_samples(samples)
    pairs = [extract_envelope(x[i, :n], sr, acfg) for i, n in enumerate(lengths.tolist())]
    width = int(width_reduce(torch.tensor(max(a.shape[-1] for a, _ in pairs), device=x.device)))
    vals = torch.zeros((len(pairs), width), dtype=torch.float32, device=x.device)
    valid = torch.zeros((len(pairs), width), dtype=torch.bool, device=x.device)
    hops = torch.empty(len(pairs), dtype=torch.float64, device=x.device)
    for i, (a, t) in enumerate(pairs):
        vals[i, : a.shape[-1]] = a
        valid[i, : a.shape[-1]] = True
        hops[i] = float(t[1] - t[0]) if len(t) > 1 else acfg.hopLen
    return vals, valid, hops


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Host copies of ``tensors`` after one synchronisation per device."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    for d in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(d)
    return [h.numpy() for h in host]


def sweep_mfcc_change(paths: list[str], sweep: CorpusSweep) -> dict:
    """Run the sweep; returns the throughput report (items, audio hours,
    elapsed, audio-h/s, and the stages' busy seconds under "stages").

    Output: ``<out_dir>/<basename>.npz`` (duplicate basenames get a short
    path-hash suffix) per input file with ``times`` and ``mod_cepstr``, and
    for each extra its track and ``<name>_times`` (``formants`` also
    ``formant_bw``), plus ``_done.txt`` for resume. With a mesh, rank 0
    reads the done-list and tells the other ranks, and writes every record;
    each rank returns its own report.
    """
    feats = _features(sweep)
    if sweep.spectrum == "auto":
        sweep = replace(sweep, spectrum="fused")
    device = resolve_device(sweep.device)
    cfg = sweep.cfg
    mesh = sweep.mesh
    dims = () if mesh is None else tuple(d for d in ("slice", "data") if d in mesh.mesh_dim_names)
    n_blocks, block = (1, 0) if mesh is None else (axis_size(mesh, dims), axis_index(mesh, dims))
    lead = mesh is None or dist.get_rank() == 0
    out_names = _output_names(paths)
    done = _load_done(sweep) if sweep.resume and lead else set()
    todo = [p for p in paths if p not in done]
    if mesh is not None:
        shared = [todo]
        dist.broadcast_object_list(shared, src=0)
        todo = shared[0]
    f0cfg, acfg, fmcfg = sweep.f0_cfg or F0Config(), sweep.amp_cfg or AmplitudeConfig(), sweep.formant_cfg or FormantConfig()
    env_per_file = "envelope" in feats and acfg.method == "RMSpraat"
    if lead:
        os.makedirs(sweep.out_dir, exist_ok=True)
        if env_per_file:  # RMSpraat's envelopes run file by file, host-synchronous
            log_event("corpus.envelope_per_file")
    batched = tuple(f for f in feats if not (f == "envelope" and env_per_file))
    sr = float(cfg.signal_sample_rate)

    def gathered(t: torch.Tensor, b: int) -> torch.Tensor:
        return t if mesh is None else gather_rows(t, mesh, dims)[:b]

    def width_max(w: torch.Tensor) -> torch.Tensor:
        return w if mesh is None else all_reduce(w, mesh, dims, dist.ReduceOp.MAX)

    meter = ThroughputMeter()
    # busy time of each stage as seen from its own thread; the stages
    # overlap, so the fields explain the wall time without summing to it
    # (dispatch_busy_s: the main loop's host time dispatching a batch,
    # which returns before the card is done with the kernels but runs the
    # Praat path finder as a loop of small launches; the scan filters of
    # short-file batches are two kernel launches on CUDA, a per-sample loop
    # only on the CPU)
    stats = {
        "decode_busy_s": 0.0, "assemble_busy_s": 0.0, "upload_busy_s": 0.0,
        "upload_mb": 0.0, "dispatch_busy_s": 0.0, "fetch_wait_s": 0.0, "write_busy_s": 0.0,
    }
    # hop rows only when the modulation cepstrum is the sole feature: the extras take flat samples
    rows_mode = sweep.spectrum.startswith("fused") and not feats
    decode = background_iter(_timed_iter(_decode_stream(todo, sweep), stats, "decode_busy_s"),
                             maxsize=2 * sweep.batch_size)
    batches = background_iter(_bucketed_batches(decode, sweep, stats, rows_mode), maxsize=2)
    # (paths, host lengths, hop-rows n_samples) per batch, known before upload
    path_groups: deque = deque()

    def device_stream():
        for paths_b, arrays, t_pad_b in batches:
            path_groups.append((paths_b, arrays["lengths"], t_pad_b))
            if mesh is not None:  # this rank's block of rows
                arrays = {k: shard_rows(torch.from_numpy(v), n_blocks, block).numpy() for k, v in arrays.items()}
            yield arrays

    mf = min_frames_for_fir(cfg)
    pending: deque = deque()

    # seconds between a track's frames; RMSpraat's are per file
    hops = {"mfcc39": cfg.tStep, "f0": f0cfg.hopSize, "envelope": acfg.hopLen, "formants": fmcfg.time_step,
            "formant_bw": fmcfg.time_step}

    def flush_one(done_f):
        paths_b, lengths_np, tot_d, extras_d, rows = pending.popleft()
        per_file_hops = []
        if env_per_file:  # host-synchronous, after the next batch is dispatched
            vals, valid, hop_s = (gathered(t, len(paths_b)) for t in _rmspraat_rows(*rows, sr, acfg, width_max))
            extras_d = extras_d | {"envelope": (vals, valid)}
            per_file_hops = [hop_s]
        t0 = time.perf_counter()
        if lead:
            tot, *flat = _to_host([tot_d, *(t for v in extras_d.values() for t in v), *per_file_hops])
        stats["fetch_wait_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, p in enumerate(paths_b):
            n_i = int(lengths_np[i])
            meter.add(n_i / cfg.signal_sample_rate)
            if not lead:
                continue
            nf = min(1 + n_i // cfg.hop_length, tot.shape[-1])
            rec = {"times": change_times(n_i, cfg)[:nf], "mod_cepstr": tot[i, :nf]}
            for k, name in enumerate(extras_d):
                vals, valid = flat[2 * k], flat[2 * k + 1]
                nvf = int(valid[i].sum())
                hop = float(flat[-1][i]) if per_file_hops and name == "envelope" else hops[name]
                rec[name] = vals[i, :nvf]
                rec[name + "_times"] = np.arange(nvf) * hop
            np.savez(os.path.join(sweep.out_dir, out_names[p]), **rec)
            done_f.write(p + "\n")
        if lead:
            done_f.flush()
        stats["write_busy_s"] += time.perf_counter() - t0

    with open(_done_path(sweep), "a") if lead else contextlib.nullcontext() as done_f:
        for arrays in prefetch_to_device(device_stream(), depth=2, device=device, stats=stats):
            paths_b, lengths_np, t_pad_b = path_groups.popleft()
            b = len(paths_b)
            fir_ok = mf is not None and 1 + int(lengths_np.min()) // cfg.hop_length >= mf
            t0 = time.perf_counter()
            samples, lengths = arrays["samples"], arrays["lengths"]
            tot, _mask = batched_mfcc_change(AudioBatch(samples, lengths), cfg, spectrum=sweep.spectrum,
                                             masked_fir=fir_ok, n_samples=t_pad_b)
            extras = {}
            if batched:
                extras = {k: tuple(gathered(t, b) for t in v)
                          for k, v in _extras(samples, lengths, cfg, sweep.spectrum, batched, f0cfg, acfg,
                                              fmcfg).items()}
            stats["dispatch_busy_s"] += time.perf_counter() - t0
            # the device rows stay referenced only where the per-file RMSpraat will read them
            pending.append((paths_b, lengths_np, gathered(tot, b), extras, (samples, lengths) if env_per_file else None))
            if len(pending) >= 2:
                flush_one(done_f)
        while pending:
            flush_one(done_f)
    report = meter.report()
    report["stages"] = {k: round(v, 4) for k, v in stats.items()}
    if stats["upload_busy_s"] > 0:
        report["stages"]["link_mbps"] = round(stats["upload_mb"] / stats["upload_busy_s"], 1)
    return report
