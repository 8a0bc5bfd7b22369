#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --frontend DIR

Builds the hand-written CUDA kernels from ``modulation_mfcc_tpu_torch/csrc``
(nvcc, sm_90a, one process per source), checks each against its plain
PyTorch version on the card, drives the three paths of the port at full
size through the kernels and checks them against their plain paths on the
card and against the CPU, and times kernels and paths with CUDA events.
Phases:

  0  card, power limit, versions, TF32 flags (exits 2 without CUDA)
  1  kernel build (the native decode loader's g++ build beside it, timed
     apart), with ptxas's report (registers, spills) of every kernel,
     and a line each for the Viterbi kernels' (the wide and toeplitz ones
     past 1,024 bins too), the tensor-core frontend's
     (fused_mel_bf16 is mode 3, fused_mel_f32 mode 4; the last template
     argument the A source: 0 the span's copies, 1 shifted, 2 streamed), the
     FFT frontend's (fused_mel_fft_kernel<log2 M, input>), the tail's,
     sinc_refine_f32's and burg_lpc_f32's (C, elements a lane)
     instantiations, and the fold kernels' (fused_mel_fold_kernel, the
     FFMA bf16 fold; fused_mel_fold_tc_kernel<planes, m-tiles>, x3 with 2
     planes, f32 with 3, 32-frame plans 1 m-tile); each frontend mode's
     staging plan (tc_plan: full, compact or streamed) and shared memory
     a block at both configurations and at phase 24's, each mode's streamed
     plan, the f32 and x3 folds' plans
     (fold_plan) and the bf16 fold's shared memory at the flagship, at 256
     bands and at phase 18's wide-span geometries (C8's among them), and
     the blocks an SM holds; the
     sinc tiling at the
     tracker's bands and the Burg plan (C, warps a frame, blocks an SM)
     over nw 2..3,632
  2  MFCC kernels vs plain versions on the card, both configurations (the
     'f32' route there, fused_mel_fft_f32, bit for bit its mirror
     fft_frontend_mirror, within 1e-4 relative above the top_db floor of
     the function in float64 from float64 constants and no further from it
     than the plain version; the tensor-core fused_mel_f32 to the split's); the
     tail in both layouts on float32 and bf16 mel, with 32 coefficients, and
     on 126 mel bands (the tile copied by the threads)
  3  MFCC path at full size (mfcc_change, 128 × 30 s at 16 kHz), launch counts
     (fused_mel_fft_f32, not fused_mel_f32), two utterances bit for bit the
     FFT kernel's mirror
  4  single utterances (masked-FIR route, host-tail route)
  5  MFCC times, kernels beside their plain versions and bounds
     (fused_mel_fft_f32 beside its least-work bound, the tensor-core
     fused_mel_f32 and the library's rfft and mel matmul, library_ms;
     fused_mel_f32: the split's tensor-core bound and the FFMA bound of
     the same function); the SM clock; the tail timed on the mel each
     frontend kernel has just written, after a synchronise and an L2
     flush, and after another tail
  6  tracker kernels vs plain versions on the card: sinc_refine_f32 on the
     pitch tracker's own autocorrelation (4 × 30 s at 16 kHz, also at
     veryAccurate depth 70 and at the 10 kHz band), also against the float64
     evaluation of its plain version, on 1 and 1,001 rows (no whole row
     group) and at depths 80 and 200 (the weights streamed in two and four
     chunks of taps); burg_lpc_f32 in both modes on
     lpc_formants' own frames and on the JAX kernel test's input, its plan
     equal to burg_plan over nw 2..3,632, and on 1,001 noise frames at the
     ends of its range (nw 2, 33, 550, 1,500, 3,632; order 1 to 32; one, two
     and four warps a frame) against float64
  7  F0 path at full size: batched_f0 on 32 × 30 s at 16 kHz, praatac and
     praatcc, launch counts, against the plain sinc engine and the CPU
  8  formant path at full size: batched_formants on the same audio resampled
     on the host to 11 kHz, launch counts, against the plain Burg and the CPU
  9  single files: extract_f0 and formants_with_gating on one 30 s
     utterance, the card against the CPU
 10  tracker times: kernels beside plain versions and bounds, both paths
     end to end, the kernels', the Viterbi loop's and
     the root finder's shares, peak memory
 11  pyin Viterbi kernels vs plain versions on the card, bit for bit, both
     given the band: random dense trellises (batched and single; h = n − 1,
     the forward reads log_tri from L2, the backtrace too at n = 360 and
     stages the whole band in shared memory at n ≤ 130), crafted banded ones (a
     random band over a floor that also lies inside it, integer ties with
     fl(gmax + C), h = 0: the forward's band in registers; a band of 81
     sources: in shared memory), pyin's own trellis of 4 × 30 s at 16 kHz
     and at 10 kHz (h = 21, registers; the backtrace's band in shared
     memory), a batch of one; and the backtrace alone on crafted rows that
     set its traps (an out-of-band source tying an in-band one at a lower
     index, −0 against +0, two out-of-band sums that round together), each
     line naming the backtrace's layout; past 1,024 bins (the wide kernels)
     dense, randomly banded and narrow-banded trellises at 1,201, 3,601 and
     6,001 bins and one at 14,497 (the forward's m from the history), bit
     for bit with the launch counts; the 'toeplitz' layout (the window in
     shared memory, a cluster an utterance) on pyin's own transitions at
     1,201, 3,601 and 6,001 bins and a triangle band at 14,497 made on the
     card, the forward at every cluster size with a plan and by the rule,
     bit for bit; batched_f0 pyin at resolution 0.01 (3,601 bins) on 2 × 10 s
     end to end against the plain engine (toeplitz, on a cluster), its time
     and peak memory beside the same call in the wide layouts; both kernels
     timed on pyin's trellises at 3,601 and 6,001 bins (C2-C7), the forward
     at every cluster size, beside their plain versions and bounds
 12  pyin path at full size: batched_f0 pyin on the phase-7 batch, one launch
     of each Viterbi kernel, states and f0 identical to the plain engine on
     the card, against the CPU; the decode of that call makes no device→host
     sync; extract_f0 pyin on one 30 s utterance
 13  pyin times: both kernels beside their plain versions, the forward's
     bounds for its banded work and for the dense function, the path end to
     end with its stage split (CMNDF, candidates and observations, forward,
     backtrace), peak memory, and the device time by kernel of one call
     (torch.profiler through utils.obs.kernel_profile: every kernel the
     call launched in the trace, or the loss reported)
 14  frontend-mode kernels (fused_mel_bf16, _x3, _i16, _i24 on the tensor
     cores, and fused_mel_f32 on int16 input) vs plain versions on the card, both
     configurations, float32, int16 and int16 hop-rows input, a quiet
     (-60 dBFS) int16 utterance for i16; rows equal flat bit for bit; the
     i16 scales exact powers of two; x3 (tensor cores) also against the
     float64 sums of its own products
 15  mfcc_change at 128 × 30 s at 16 kHz on int16 hop rows for each fused
     spectrum: one launch of its frontend kernel per call, against the
     float64 'fft' path; a ragged masked batch against per-file results
 16  the corpus sweep over 256 synthetic int16 WAVs (1.5-35 s, about 0.9 h)
     with 'fused_i16', 'fused_bf16' and 'fused': audio-h/s, stage busy
     times, link rate; resume skips everything; records against per-file
     extract_mfcc_change; the decode time with the native loader (the
     default) and with the Python reader
 17  frontend-mode times: the four kernels beside their plain versions at
     128 × 30 s on int16 rows (and fused_mel_f32's time there), mfcc_change
     end to end per spectrum, peak memory
 18  fold kernels (fused_mel_fold_f32 and _x3 on the tensor cores, _bf16 on
     the CUDA cores) vs plain versions on the card, 4 × 30 s at both
     configurations and at 256 mel bands, and also at 32 kHz with hop 320
     and window 1280, at 48 kHz with hop 384 and window 3840 and at 48 kHz
     with hop 720 and window 1440 (f32 and x3 take 32-frame plans there;
     the last is the widest span, C8's, which f32 fits with one buffer of s
     and d planes and bf16's FFMA block by staging its span as bf16); f32
     against its plain version evaluated in float64 and x3 against the
     float64 sums of its own products (mode_error_ok), each line with its
     plan; the f32 fold vs fused_mel_f32
 19  the fold path at full size: fused_mel_frontend(fold=True) → peak →
     mfcc_tail on 128 × 30 s at 16 kHz, one launch of each fold kernel,
     against the unfolded MFCC and, through the trajectory tail, the
     float64 'fft' path
 20  long-form: a seeded 1 h recording at 48 kHz made on the card →
     resample_device to 16 kHz (checked against the host resampler on a
     30 s excerpt) → chunked_mfcc_change against whole-file mfcc_change;
     extract_mfcc_change takes the chunked route; times and peak memory of
     the chunked and whole-file routes
 21  modulation_spectrum at 128 × 30 s at 16 kHz with 'fused' and
     'fused_bf16' against the float64 'fft' path, one launch of each kernel
 22  times: the fold kernels beside their plain versions and the unfolded
     kernels (each then held to phase 18's bars at full size; a miss fails
     the script after its last phase; for bf16 also, printed, how its plain
     version's DFT sums compare with a row-order FFMA chain and how far the
     float64 DFT's mel lies from it), mfcc_tail_f32
     at full size in both layouts on float32 and
     bf16 mel (checked against its plain version), the fold path and the
     modulation spectrum end to end, bounds (a fold's: its bf16 passes
     over the folded contraction on the tensor cores, six for f32, whose
     bound on the FP32 CUDA cores is printed beside it); fused_mel_fold_f32
     under each rung of its plan ladder at the flagship and at 32 kHz with
     hop 160, each rung's mel bit for bit the ladder's plan's
 23  the f32 MFCC's distance from the float64 'fft' MFCC at 128 x 30 s
     (phase 19's noise and speech-like batches), enforced for
     fused_mel_fft_f32, fused_mel_f32 and fused_mel_fold_f32: on each batch no further than
     its plain version's distance times 1.05. Printed beside them: the
     splits' CPU mirrors (split3_frontend_mirror, split3_fold_mirror) run on
     the card, the unfolded one also with an FP32 mel (the mel's other
     candidate; phase 2 prints both on its input), the
     plain versions in the one-sum order before the 16-row steps, and the
     other routes ('fft' in float32; 'fused_x3' and 'fused_i24' beside the
     plain versions of their kernels), and the f32 kernel's and its plain
     version's mel through the tail's function in float64
 24  every rate and width the reference configures: each frontend mode
     against its plain version (phase 2's and 14's bars) at 11.025 (n_fft
     512), 22.05, 32, 44.1 and 48 kHz (n_fft 1024, 1024, 2048, 2048; hop
     int(0.005 sr), window int(0.025 sr); f32 takes the FFT kernel there,
     and fused_mel_f32 runs beside it on its plan, the compact one), at 44.1 kHz with a 20 ms hop and 48 kHz with
     a 30 ms hop and a 64 ms window (n_fft 2048, 4096; f32 on the streamed
     plan at both, x3 at the second) and at 16 kHz with 256 mel bands and
     40 MFCCs, f32 also at 512 bands, with the plan printed; mfcc_tail_f32
     in both layouts on float32 and bf16 mel at 256 and 512 bands, 40
     coefficients; every mode forced onto the streamed plan at the flagship
     (_launch_tc's plan argument), its mel against the full plan's
     (bit-identical or the max-abs, printed) and its plain version; 'fused'
     mfcc_change on 4 × 30 s at both long hops against the float64 'fft'
     path (phase 15's bar); the fold kernels at 256 bands are in phase 18
 25  'fused' mfcc_change at 128 x 30 s at 44.1 kHz (n_fft 2048) and 11.025
     kHz: one launch of each kernel, times as phase 5, the distance from the
     float64 'fft' MFCC, the 'f32' kernel (fused_mel_fft_f32 at both
     rates) no further than 1.05 x its plain
     version's (phase 23's rule); the streamed plan's times at 128 x 30 s:
     fused_mel_f32 and fused_mel_x3 at the flagship under the full and the
     streamed plan, and at phase 24's long hops, beside plain versions and
     bounds
 26  the verify harness (modmfcc-torch verify) on the card at 10 and 16
     kHz: all eleven surfaces pass against the float64 oracles
 27  envelope times on 32 x 30 s at 16 kHz: batched_envelope RMS and Hilb,
     and RMSpraat per file (extract_envelope)
 28  the analysis workflow: (a) BASELINE #2, 64 speech-like utterances of
     1.5-30 s at 16 kHz padded → frame_validity_mask → 'fused'
     mfcc_trajectories → mfcc_with_deltas(normalize=True), [64, NF, 39]:
     one launch of each MFCC kernel, padded frames 0, each utterance's mean
     0 and std 1, deltas and CMVN against float64, ms, audio-h/s and peak
     memory; (b) peak_mask on the batch's mfcc_change tracks against scipy
     find_peaks row by row; (c) AnalysisSession on a 30 s WAV, a TextGrid and
     a 16-channel .pos file: all eight features and two EMA channels at
     derivations 0-2 by each method against their float64 derivation, peaks,
     the CSV against the curves, the interactive HTML, the sinc and Burg
     kernels launched, pyin's f0 through both Viterbi kernels, and each
     feature's extract_feature latency
 29  the sweep's tracker extras, the loaders, the distributed paths and the
     CLI's sweep: (a) phase 16's corpus with mod_cepstr, mfcc39, f0, envelope
     and formants ('fused', native loader): audio-h/s, stages, launches of
     fused_mel_fft_f32, mfcc_tail_f32, sinc_refine_f32 and burg_lpc_f32, the
     native loader given every file, resume, 12 records against each file
     alone on the card (formants and bandwidths on the file's row of its
     batch, resampled as the sweep resamples it, to 95 % within 0.05 Hz;
     that row within 1e-6 of the file resampled alone); f0 by pyin over 32 files (both Viterbi kernels) and
     RMSpraat over 8; (b) the native and Python loaders decode all 256 files
     alike, with their seconds; (c) dryrun.py's certifications over NCCL at
     world = the cards here (2 and 4 too where the cards exist), and on a
     world of one sharded_mfcc_change at 128 x 15-30 s and
     sharded_longform_mfcc_change on phase 20's hour against their unsharded
     results, then the per-shard step for four shards of the hour in turn
     against whole-file; (d) the CLI's sweep as two manifest shards, whose
     union equals (a)'s mod_cepstr records. The kernels line carries each
     kernel's launches in (a) (the Viterbi kernels': the pyin sweep's) as
     ``extras_sweep_launches``
 30  the public surface closed against the JAX package: (a) extract_mfcc on
     a 30 s utterance at 16 kHz under the flagship configuration and under
     MfccConfig(), on CUDA by default, one launch of each MFCC kernel, bit
     for bit extract_mfcc_matrix, against the CPU within 1e-5 of the
     coefficients' peak, timed; extract_modulation equal to
     extract_mfcc_change; (b) utils.obs.profile_trace around a warmed
     flagship mfcc_change at 128 x 30 s in the script's own, minutes-old
     process, 8 windows: all but at most two hold every kernel the call
     launched, the frontend's and the tail's among them, and a window that
     lost records says so; a plain torch.profiler window beside them (how
     many of the call's kernel records it loses); the call with and
     without the profiler, the trace's size; (c) mfcc_change(frame_mask=...)
     on phase 28's padded batch, every row against itself alone on the card
     and the first, shortest, longest and last against the CPU (1e-5); (d)
     melspectrogram(window='hamming') on the card against the CPU (1e-5 of
     the peak)
 31  the masked routes' trajectory kernels at timit16k.short's size: 1,024
     int16 speech-like utterances of one 65,536-sample bucket as hop rows,
     'fused'; on the scan route (1.02-4.10 s) masked_sosfiltfilt_f64
     launched twice a call and masked_grad_norm_f32 once, on the masked FIR
     route (lengths of at least min_frames_for_fir frames) the norm once
     (counters reset before each call); every launch's operands held to the
     plain version: the filter to the float64 loop bit for bit (float32
     rows; float64 rows give the same result in float64), the norm to its
     torch ops within GRAD_NORM_RTOL; their times (a loop of 20 launches)
     beside the plain versions' and the least-work bounds of
     benchmark/roofline/scan.py's count (the valid frames)

``--frontend DIR`` runs none of these phases. It drives the package of the
checkout at DIR instead of this one's, builds its kernels, times its
frontend kernels at 128 × 30 s at 16 kHz as the frontend rows below are
timed (the 'f32' route, fused_mel_fft_f32 where the package has it, on float32 audio of phase 5's and phase 22's batches,
seeds 0 and 19, in both orders; the f32 fold on both, the bf16 and x3
folds on seed 19, with a digest of each fold's mel and maxima there, so
two packages' folds compare bit for bit; bf16, x3, i16, i24
and f32 on phase 15's int16 hop rows), mfcc_tail_f32 in both layouts on the
float32 mel of seed 0 and the bf16 mel of the rows, 'fused' mfcc_change on
the float32 audio of seed 0 and 'fused_i16' and 'fused_bf16' mfcc_change
on the rows, times sinc_refine_f32 and burg_lpc_f32 on the inputs of
phases 7 and 8 and batched_f0 praatac and batched_formants end to end,
viterbi_fwd_f32 and viterbi_bwd_f32 on
pyin's trellis of phase 7's batch (band derived from the tensor where the
package bands it) and batched_f0 pyin on that batch end to end, and
prints x3's and i24's MFCC distances from the float64 MFCC on phase 23's
two batches, kernel and plain version.
Every line carries DIR's name, the card's name and power limit, and the
SM clock read after it. To compare two commits on one card, unpack the
other (``git archive``) into a git-ignored directory and run parent,
change, change, parent in one machine.

Every frontend kernel row (phases 5, 17, 22) is timed the same way: three
warm-up calls, then the median of 10, CUDA events (kernel_ms); the other
rows one warm-up and the median of 5 (cuda_ms).

Every check raises on failure, so the script exits 0 only when all phases
passed. The line before the last is the card's name and power limit; the
last line is the device JSON. Imports no JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager
from dataclasses import replace
from fractions import Fraction
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as tnf


def package_root(argv: list[str]) -> Path | None:
    """DIR of ``--frontend DIR`` (the checkout whose package the script then
    drives), or None: this checkout's package, all phases."""
    if argv[:1] != ["--frontend"]:
        return None
    if len(argv) != 2:
        sys.exit("usage: chip_smoke.py [--frontend DIR]")
    return Path(argv[1]).resolve()


FRONTEND_ROOT = package_root(sys.argv[1:])
sys.path.insert(0, str(FRONTEND_ROOT or Path(__file__).resolve().parent))

import modulation_mfcc_tpu_torch as mt  # noqa: E402
from modulation_mfcc_tpu_torch.io import native  # noqa: E402
from modulation_mfcc_tpu_torch.io.wav import resample  # noqa: E402
from modulation_mfcc_tpu_torch.kernels import _build  # noqa: E402
from modulation_mfcc_tpu_torch.kernels import burg as BK  # noqa: E402
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff  # noqa: E402
from modulation_mfcc_tpu_torch.kernels import sinc_refine as SK  # noqa: E402
from modulation_mfcc_tpu_torch.kernels import viterbi as VK  # noqa: E402
from modulation_mfcc_tpu_torch.ops import lpc as L  # noqa: E402
from modulation_mfcc_tpu_torch.ops import pitch as P  # noqa: E402
from modulation_mfcc_tpu_torch.ops import yin as Y  # noqa: E402
from modulation_mfcc_tpu_torch.ops.resample import resample_poly_device  # noqa: E402
from modulation_mfcc_tpu_torch.ops.spectral import analysis_window, mel_filterbank  # noqa: E402
from modulation_mfcc_tpu_torch.parallel.batch import batched_mfcc_change  # noqa: E402
from modulation_mfcc_tpu_torch.utils.obs import PROFILER_PAD, kernel_profile, profile_trace  # noqa: E402
from modulation_mfcc_tpu_torch.parallel import streaming  # noqa: E402
from modulation_mfcc_tpu_torch.parallel.corpus import CorpusSweep, sweep_mfcc_change  # noqa: E402

FLAGSHIP = mt.MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0)
DEFAULT_10K = mt.MfccConfig()
BATCH, SECONDS = 128, 30
TRACK_BATCH, TRACK_SR, LPC_SR = 32, 16_000, 11_000.0
CSRC = "modulation_mfcc_tpu_torch/csrc"
SOURCES = {
    "fused_mel_fft_f32": f"{CSRC}/fused_frontend_fft.cu",
    "fused_mel_f32": f"{CSRC}/fused_frontend_tc.cu",
    "mfcc_tail_f32": f"{CSRC}/fused_frontend.cu",
    "sinc_refine_f32": f"{CSRC}/sinc_refine.cu",
    "burg_lpc_f32": f"{CSRC}/burg.cu",
    "viterbi_fwd_f32": f"{CSRC}/viterbi.cu",
    "viterbi_bwd_f32": f"{CSRC}/viterbi.cu",
    "fused_mel_bf16": f"{CSRC}/fused_frontend_tc.cu",
    "fused_mel_x3": f"{CSRC}/fused_frontend_tc.cu",
    "fused_mel_i16": f"{CSRC}/fused_frontend_tc.cu",
    "fused_mel_i24": f"{CSRC}/fused_frontend_tc.cu",
    "fused_mel_fold_f32": f"{CSRC}/fused_frontend_fold_tc.cu",
    "fused_mel_fold_bf16": f"{CSRC}/fused_frontend_fold.cu",
    "fused_mel_fold_x3": f"{CSRC}/fused_frontend_fold_tc.cu",
    "masked_sosfiltfilt_f64": f"{CSRC}/masked_scan.cu",
    "masked_grad_norm_f32": f"{CSRC}/masked_scan.cu",
}
REPLACES = {
    "fused_mel_fft_f32": "modulation_mfcc_tpu/pallas/fused_frontend.py:990 (_kernel, _kernel_pipe, f32; where fft_ok)",
    "fused_mel_f32": "modulation_mfcc_tpu/pallas/fused_frontend.py:990",
    "mfcc_tail_f32": "modulation_mfcc_tpu/pallas/fused_frontend.py:1190",
    "sinc_refine_f32": "modulation_mfcc_tpu/pallas/sinc_refine.py:150",
    "burg_lpc_f32": "modulation_mfcc_tpu/pallas/burg.py:94",
    "viterbi_fwd_f32": "modulation_mfcc_tpu/pallas/viterbi.py:218 and :454",
    "viterbi_bwd_f32": "modulation_mfcc_tpu/pallas/viterbi.py:295 and :492",
    "fused_mel_bf16": "modulation_mfcc_tpu/pallas/fused_frontend.py:990 (_kernel, _kernel_pipe, algorithm bf16)",
    "fused_mel_x3": "modulation_mfcc_tpu/pallas/fused_frontend.py:990 (_kernel, _kernel_pipe, algorithm x3)",
    "fused_mel_i16": "modulation_mfcc_tpu/pallas/fused_frontend.py:990 (_kernel_i16, _kernel_i16_pipe)",
    "fused_mel_i24": "modulation_mfcc_tpu/pallas/fused_frontend.py:990 (_kernel_i24, _kernel_i24_pipe)",
    "fused_mel_fold_f32": "modulation_mfcc_tpu/pallas/fused_frontend.py:1096 (_folded_frontend, _fold_kernel, f32)",
    "fused_mel_fold_bf16": "modulation_mfcc_tpu/pallas/fused_frontend.py:1096 (_folded_frontend, _fold_kernel, bf16)",
    "fused_mel_fold_x3": "modulation_mfcc_tpu/pallas/fused_frontend.py:1096 (_folded_frontend, _fold_kernel, x3)",
    "masked_sosfiltfilt_f64": "modulation_mfcc_tpu/ops/masked.py:123 (masked_sosfiltfilt, a lax.scan)",
    "masked_grad_norm_f32": "modulation_mfcc_tpu/ops/masked.py:203 (masked_gradient) and the norm after it",
}
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s, FP32 CUDA-core FLOP/s,
# dense bf16 tensor-core FLOP/s and int8 tensor-core OP/s
PEAK_BYTES_S, PEAK_FP32_S, PEAK_BF16_S, PEAK_INT8_S = 3.35e12, 67e12, 989e12, 1979e12
MODES = ("bf16", "x3", "i16", "i24")  # the frontend modes of phases 14-17
SPECTRUM = {"f32": "fused", "bf16": "fused_bf16", "x3": "fused_x3", "i16": "fused_i16", "i24": "fused_i24"}
SPECTRUM_ALG = {v: k for k, v in SPECTRUM.items()}
FOLD_MODES = ff.FOLD_ALGORITHMS  # the fold kernels of phases 18-22
TC_FOLDS = ("f32", "x3")  # the tensor-core folds (fold_plan); a literal, as --frontend may import an older package
# the weights each fold kernel reads (phase 22's bytes): the tensor-core folds their layouts
FOLD_READS = {"f32": ("wcs_tc", "melw_tc"), "x3": ("wcs_tc", "melw_tc"), "bf16": ("wc", "ws", "melw")}
LONG_SR, LONG_SECONDS = 48_000, 3600


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


LATE_FAILURES: list[str] = []  # checks whose failure stops the script at its end (check_late)


def check_late(ok: bool, what: str) -> None:
    """A check of a result that nothing later uses: a failure is printed now
    and fails the script after its last phase, so the other phases still
    report."""
    if not ok:
        print(f"check failed (the script fails at its end): {what}")
        LATE_FAILURES.append(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def speechlike(n_utt: int, n: int, sr: int, seed: int) -> np.ndarray:
    """[n_utt, n] float32: amplitude-modulated harmonics with a gliding f0,
    noise, and silent lead-in/out, different per utterance."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / sr
    out = np.empty((n_utt, n), np.float32)
    for b in range(n_utt):
        f0 = rng.uniform(90.0, 220.0) + 30.0 * np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t - np.pi / 2))
        sig = sig * env + rng.uniform(0.003, 0.03) * rng.standard_normal(n)
        sig[: sr // 10] = 0.0
        sig[-(sr // 10) :] = 0.0
        out[b] = sig
    return out


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after ``warm`` warm-up calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn) -> float:
    """How every frontend kernel row is timed: median of 10 after 3 warm-ups."""
    return cuda_ms(fn, reps=10, warm=3)


def sm_clock() -> str:
    """The SM clock, power draw and active throttle reasons, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms on the card, what binds it) for work that moves ``n_bytes``
    and does ``n_ops`` FP32 operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset(*counters: dict) -> None:
    for c in counters:
        for k in c:
            c[k] = 0


@contextmanager
def spy(module, name: str):
    """Record every call of ``module.name`` while the block runs, as
    (args, kwargs, start event, end event), CUDA events around the call;
    the calls themselves go through unchanged."""
    orig = getattr(module, name)
    calls = []

    def recorded(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kw)
        end.record()
        calls.append((args, kw, start, end))
        return out

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def path_ms(fn, stages: list[tuple], reps: int = 5) -> tuple[float, dict[str, float]]:
    """Median milliseconds of ``fn`` end to end and, within the same runs, of
    each (module, name) stage it calls, after one warm-up."""
    fn()
    total, parts = [], {name: [] for _, name in stages}
    for _ in range(reps):
        with ExitStack() as stack:
            calls = {name: stack.enter_context(spy(m, name)) for m, name in stages}
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        total.append(start.elapsed_time(end))
        for name, recs in calls.items():
            parts[name].append(sum(a.elapsed_time(b) for *_, a, b in recs))
    return statistics.median(total), {name: statistics.median(v) for name, v in parts.items()}


# ---------------------------------------------------------------------------
# MFCC path (phases 2-5)
# ---------------------------------------------------------------------------


def frontend_args(cfg: mt.MfccConfig, dev) -> dict:
    """The f32 frontend's weights (``w``: mode_tensors, with the tensor-core
    layouts; ``wri``, ``melw``), the tail's DCT and the left pad."""
    w = mode_weights(cfg, "f32", dev)
    return dict(
        w=w, wri=w["wri"], melw=w["melw"],
        dct=torch.tensor(ff.tail_dct(cfg.n_mfcc, cfg.n_mels), device=dev),
        eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length),
    )


def frontend_kernel(audio, cfg, a):
    return ff.fused_mel_frontend(
        audio, sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=cfg.hop_length,
        win_length=cfg.win_length, weights=a["w"],
    )


def frontend_plain(audio, cfg, a):
    return ff.fused_mel_frontend_reference(
        audio, a["wri"], a["melw"], hop=cfg.hop_length, eff_pad=a["eff_pad"]
    )


def f32_kernel(cfg: mt.MfccConfig) -> str:
    """The kernel the 'f32' frontend launches at this geometry:
    fused_mel_fft_f32 where fft_ok takes it, else fused_mel_f32."""
    fft = ff.fft_ok(cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.n_mels)
    return "fused_mel_fft_f32" if fft else "fused_mel_f32"


def kernel_of(alg: str, cfg: mt.MfccConfig) -> str:
    """The frontend kernel mode ``alg`` launches at this geometry."""
    return f32_kernel(cfg) if alg == "f32" else f"fused_mel_{alg}"


def tc_f32(audio, cfg: mt.MfccConfig, w: dict, n_samples=None):
    """fused_mel_f32, the tensor-core kernel, at a geometry where fft_ok
    routes 'f32' to the FFT kernel: launched under its tc_plan
    (mel_under_plan); no launch counted."""
    return mel_under_plan(audio, cfg, "f32", w, ff.tc_plan("f32", cfg.hop_length, tc_kp(w, "f32"), cfg.n_mels),
                          n_samples)


def fft_mirror(audio, cfg: mt.MfccConfig, w: dict, n_samples=None):
    """fused_mel_fft_f32's mirror (fft_frontend_mirror), on the CPU."""
    return ff.fft_frontend_mirror(audio.cpu(), *(w[k].cpu() for k in ff.FFT_KEYS), hop=cfg.hop_length,
                                  eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length), n_samples=n_samples)


def same_as_mirror(got: tuple, audio, cfg: mt.MfccConfig, w: dict, n_samples=None, rows: int = 2) -> bool:
    """fused_mel_fft_f32's (mel, block maxima) of the first ``rows``
    utterances equal its mirror's bit for bit."""
    want = fft_mirror(audio[:rows], cfg, w, n_samples)
    return all(same_bits(g[:rows].cpu(), x) for g, x in zip(got, want))


def library_mel(audio: torch.Tensor, cfg: mt.MfccConfig, window: torch.Tensor, mel_t: torch.Tensor) -> torch.Tensor:
    """The same mel from PyTorch's library calls, ROADMAP E.1's yardstick
    (library_ms; the port never calls it): centred frames, the window,
    cuFFT's torch.fft.rfft, the power and the dense mel matmul."""
    x = tnf.pad(audio, (cfg.n_fft // 2, cfg.n_fft // 2)).unfold(-1, cfg.n_fft, cfg.hop_length)
    spec = torch.fft.rfft(x * window, dim=-1)
    return (spec.real.square() + spec.imag.square()) @ mel_t


def least_work_bound(cfg: mt.MfccConfig, frames: int, n_bytes: float) -> tuple[float, str]:
    """(least ms, what binds it) of the frontend function, benchmark/roofline/
    frontend.py's count: the window, a real FFT (2.5 N log2 N), 3 flops a
    weighted bin, 2 a mel weight, on the FP32 CUDA cores; or the audio read
    and the mel written once."""
    m = mel_filterbank(cfg.signal_sample_rate, cfg.n_fft, cfg.n_mels, cfg.minFreq, cfg.maxFreq)
    ops = frames * (cfg.win_length + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3.0 * np.count_nonzero(m.any(axis=0))
                    + 2.0 * np.count_nonzero(m))
    return bound(n_bytes, ops)


def split_fp32_mel(audio: torch.Tensor, cfg: mt.MfccConfig, a: dict):
    """The f32 mel's other candidate, mirrored: the split's DFT
    (_split3_matmul) and the plain version's FP32 projection of its power,
    as an FFMA mel in the kernel would compute it (mel, block maxima)."""
    bins = a["melw"].shape[0]
    reim = ff._split3_matmul(ff._frames(audio, a["wri"].shape[0], cfg.hop_length, a["eff_pad"], None),
                             ff._split3(a["wri"]))
    re, im = reim[..., :bins], reim[..., bins:]
    return ff._mel_of_power(re * re + im * im, a["melw"], "f32")


def peak_db(bmax: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(torch.amax(bmax, dim=1), min=1e-10))


def mel_errors(mel_k, bmax_k, mel_p, bmax_p) -> tuple[float, float, float]:
    """(max relative mel error above the top_db floor, max relative peak
    error, max absolute mel error)."""
    peak_p = torch.amax(bmax_p, dim=1)
    live = mel_p > (peak_p * 1e-8)[:, None, None]
    rel = (mel_k - mel_p).abs() / torch.where(live, mel_p, torch.ones_like(mel_p))
    mel_rel = float(torch.where(live, rel, torch.zeros_like(rel)).max())
    peak_rel = float(((torch.amax(bmax_k, dim=1) - peak_p).abs() / peak_p).max())
    return mel_rel, peak_rel, float((mel_k - mel_p).abs().max())


def mfcc_kernel_checks(dev) -> None:
    for name, cfg in (("10k default (packed Nyquist)", DEFAULT_10K), ("16k fmax 8k", FLAGSHIP)):
        sr = cfg.signal_sample_rate
        audio = torch.tensor(speechlike(4, SECONDS * sr, sr, seed=1), device=dev)
        a = frontend_args(cfg, dev)
        mel_k, bmax_k = frontend_kernel(audio, cfg, a)
        mel_p, bmax_p = frontend_plain(audio, cfg, a)
        torch.cuda.synchronize()
        exact = plain64(audio, cfg, a["w"])
        check(f32_kernel(cfg) == "fused_mel_fft_f32", f"{name}: 'f32' takes the FFT kernel")
        same = same_as_mirror((mel_k, bmax_k), audio, cfg, a["w"], rows=audio.shape[0])
        print(f"[2] {name}: fused_mel_fft_f32 vs its mirror (fft_frontend_mirror): "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        check(same, f"fused_mel_fft_f32 {name} bit for bit its mirror")
        ok, text = fft_error_ok(mel_k, bmax_k, mel_p, bmax_p, float64_mel(audio, cfg))
        print(f"[2] {name}: fused_mel_fft_f32 vs plain: {text}")
        check(ok, f"fused_mel_fft_f32 {name}")
        ok, text = mode_error_ok("f32", *tc_f32(audio, cfg, a["w"]), mel_p, bmax_p, exact)
        print(f"[2] {name}: fused_mel_f32 vs plain: {text}")
        check(ok, f"fused_mel_f32 {name}")
        cands = {"(a) the split's mel, the kernel's": ff.split3_frontend_mirror(
            audio, a["wri"], a["melw"], hop=cfg.hop_length, eff_pad=a["eff_pad"]),
                 "(b) an FP32 mel of the split's power": split_fp32_mel(audio, cfg, a)}
        errs = {k: mel_errors(*m, *exact)[:2] for k, m in cands.items()}
        print(f"[2] {name}: the f32 mel's two candidates, mirrored, against the plain version in float64: "
              + "; ".join(f"{k} mel rel err {e[0]:.3e}, peak {e[1]:.3e}" for k, e in errs.items()))
        pk = peak_db(bmax_p)
        dct32 = torch.tensor(ff.tail_dct(32, cfg.n_mels), device=dev)
        narrow = mel_p[..., :126].contiguous()  # a 504-byte row: the threads copy the tiles in
        cases = [(f"{kind} mel, {'coef' if transposed else 'frame'}-major", m, a["dct"], transposed)
                 for kind, m in (("float32", mel_p), ("bf16", mel_p.to(torch.bfloat16)))
                 for transposed in (True, False)]
        cases += [("float32 mel, 32 coefficients, coef-major", mel_p, dct32, True),
                  ("bf16 mel, 32 coefficients, frame-major", mel_p.to(torch.bfloat16), dct32, False),
                  ("126 float32 mel bands, frame-major", narrow, a["dct"][:126], False),
                  ("126 bf16 mel bands, coef-major", narrow.to(torch.bfloat16), a["dct"][:126], True)]
        for label, m, dct, transposed in cases:
            out_k = ff.mfcc_tail(m, pk, dct.shape[1], transposed=transposed, dct=dct.contiguous())
            out_p = ff.mfcc_tail_reference(m, pk, dct, transposed=transposed)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            print(f"[2] {name}: mfcc_tail_f32 on {label} {tuple(m.shape)} vs plain: max-abs {err:.3e} (bar 1e-4)")
            check(out_k.shape == out_p.shape and err <= 1e-4, f"mfcc_tail_f32 {name} {label}")


def mfcc_path(dev, card: str) -> list[dict]:
    """Phases 3-5; the kernel rows of the MFCC path."""
    cfg = FLAGSHIP
    sr = cfg.signal_sample_rate
    y_np = speechlike(BATCH, SECONDS * sr, sr, seed=0)
    y = torch.tensor(y_np, device=dev)
    print(f"[3] mfcc_change on [{BATCH}, {SECONDS * sr}] float32 "
          f"({y.numel() * 4 / 1e6:.1f} MB of audio), sr {sr}, fmax {cfg.maxFreq}")
    reset(ff.LAUNCHES)
    tot = mt.mfcc_change(y, cfg)
    torch.cuda.synchronize()
    launches = dict(ff.LAUNCHES)
    print(f"[3] launches in the main path: {launches}")
    check(launches["fused_mel_fft_f32"] > 0 and launches["fused_mel_f32"] == 0 and launches["mfcc_tail_f32"] > 0,
          "every kernel launched in the main path (the FFT kernel, not the tensor-core one)")
    nf = 1 + y.shape[1] // cfg.hop_length
    check(tot.shape == (BATCH, nf) and bool(torch.isfinite(tot).all()), "finite [B, nf] output")
    tot_plain = mt.mfcc_change(y, cfg, spectrum="matmul")
    torch.cuda.synchronize()
    err_plain = float((tot - tot_plain).abs().max())
    print(f"[3] vs plain torch path on the card (spectrum='matmul'): max-abs {err_plain:.3e} (bar 1e-5)")
    check(err_plain <= 1e-5, "main path vs plain path on the card")
    tot_cpu = mt.mfcc_change(torch.tensor(y_np[:2]), cfg)
    err_cpu = float((tot[:2].cpu() - tot_cpu).abs().max())
    print(f"[3] utterances 0-1 vs the CPU path: max-abs {err_cpu:.3e} (bar 1e-5); "
          f"|tot| max {float(tot.abs().max()):.4f}")
    check(err_cpu <= 1e-5, "main path vs CPU path")
    del tot_plain

    sig = speechlike(1, SECONDS * DEFAULT_10K.signal_sample_rate, DEFAULT_10K.signal_sample_rate, 2)[0]
    for label, cfg1, x in (
        ("30 s at 10 kHz (masked-FIR route)", DEFAULT_10K, sig),
        ("utterance_16k.wav (host-tail route)", FLAGSHIP, read_fixture()),
    ):
        got, t_gpu = mt.extract_mfcc_change(x, cfg1)
        torch.cuda.synchronize()
        check(got.device.type == "cuda", "extract_mfcc_change computes on CUDA by default")
        want, t_cpu = mt.extract_mfcc_change(x, cfg1, device="cpu")
        err = float((got.cpu() - want).abs().max())
        print(f"[4] extract_mfcc_change {label}: {tuple(got.shape)} frames, vs CPU max-abs "
              f"{err:.3e} (bar 1e-5)")
        check(got.shape == want.shape == t_gpu.shape and np.array_equal(t_gpu, t_cpu), label)
        check(bool(torch.isfinite(got).all()) and err <= 1e-5, label)

    a = frontend_args(cfg, dev)
    mel_p, bmax_p = frontend_plain(y, cfg, a)
    mel_k, bmax_k = frontend_kernel(y, cfg, a)
    mel_abs = float((mel_k - mel_p).abs().max())
    tc_abs = float((tc_f32(y, cfg, a["w"])[0] - mel_p).abs().max())
    ok, text = fft_error_ok(mel_k, bmax_k, mel_p, bmax_p, float64_mel(y, cfg))
    same = same_as_mirror((mel_k, bmax_k), y, cfg, a["w"])
    check(same, "fused_mel_fft_f32 at full size: utterances 0-1 bit for bit its mirror")
    torch.cuda.empty_cache()
    pk = peak_db(bmax_k)
    tail_k = ff.mfcc_tail(mel_k, pk, cfg.n_mfcc, transposed=True, dct=a["dct"])
    tail_p = ff.mfcc_tail_reference(mel_k, pk, a["dct"], transposed=True)
    tail_abs = float((tail_k - tail_p).abs().max())
    print(f"[3] fused_mel_fft_f32 at full size vs plain: {text}; utterances 0-1 bit for bit its mirror; "
          f"mfcc_tail_f32 (coef-major) vs plain: max-abs {tail_abs:.3e} (bar 1e-4)")
    check(ok and tail_abs <= 1e-4, "full-size kernels vs plain")
    del mel_p, tail_p
    window = torch.tensor(analysis_window(cfg.n_fft, "hann", cfg.win_length), dtype=torch.float32, device=dev)
    mel_t = torch.tensor(mel_filterbank(sr, cfg.n_fft, cfg.n_mels, cfg.minFreq, cfg.maxFreq).T,
                         dtype=torch.float32, device=dev).contiguous()
    lib_ms = kernel_ms(lambda: library_mel(y, cfg, window, mel_t))
    plain_ms = kernel_ms(lambda: frontend_plain(y, cfg, a))  # both f32 kernels' plain version
    ms = {
        "fused_mel_fft_f32": (kernel_ms(lambda: frontend_kernel(y, cfg, a)), plain_ms),
        "fused_mel_f32": (kernel_ms(lambda: tc_f32(y, cfg, a["w"])), plain_ms),
        "mfcc_tail_f32": (
            cuda_ms(lambda: ff.mfcc_tail(mel_k, pk, cfg.n_mfcc, transposed=True, dct=a["dct"])),
            cuda_ms(lambda: ff.mfcc_tail_reference(mel_k, pk, a["dct"], transposed=True)),
        ),
    }
    model = mt.MfccChange(cfg).to(dev)
    e2e = cuda_ms(lambda: model(y))
    e2e_plain = cuda_ms(lambda: model(y, spectrum="matmul"))
    hours = BATCH * SECONDS / 3600.0
    for k, (t_k, t_p) in ms.items():
        print(f"[5] {k}: {t_k:.3f} ms, plain {t_p:.3f} ms at [{BATCH}, {SECONDS * sr}] ({card}; SM clock, "
              f"power, throttle reasons: {sm_clock()})")
    tail_after_each(y, cfg, a, mel_k, pk, card)
    print(f"[5] mfcc_change end to end: {e2e:.3f} ms = {hours / (e2e / 1e3):.3f} audio-h/s; "
          f"plain spectrum {e2e_plain:.3f} ms = {hours / (e2e_plain / 1e3):.3f} audio-h/s ({card})")
    print(f"[5] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    bsz, nfr, n_mels = mel_k.shape
    k_sup, two_bins = a["wri"].shape
    n_mfcc = a["dct"].shape[1]
    mel_bytes = mel_k.numel() * 4
    f32_bytes = y.numel() * 4 + (a["wri"].numel() + a["melw"].numel()) * 4 + mel_bytes + bmax_k.numel() * 4
    ffma = bound(f32_bytes, 2 * bsz * nfr * k_sup * two_bins + 3 * bsz * nfr * (two_bins // 2)
                 + 2 * bsz * nfr * (two_bins // 2) * n_mels)
    bounds = {
        "fused_mel_fft_f32": least_work_bound(cfg, bsz * nfr, y.numel() * 4 + mel_bytes),
        "fused_mel_f32": split3_bound(f32_bytes, bsz * nfr, k_sup, two_bins // 2, n_mels, dft_passes=6),
        "mfcc_tail_f32": bound(
            mel_bytes + bsz * 4 + a["dct"].numel() * 4 + tail_k.numel() * 4,
            bsz * nfr * n_mels * (2 * n_mfcc + 3),
        ),
    }
    b_fft = bounds["fused_mel_fft_f32"]
    print(f"[5] fused_mel_fft_f32 (the 'f32' route here): {ms['fused_mel_fft_f32'][0]:.3f} ms against its least-work "
          f"bound {b_fft[0]:.4f} ms ({b_fft[1]}; the kernel's share {b_fft[0] / ms['fused_mel_fft_f32'][0]:.1%}), the "
          f"tensor-core fused_mel_f32 {ms['fused_mel_f32'][0]:.3f} ms, the library's rfft and mel matmul (library_ms) "
          f"{lib_ms:.3f} ms ({card})")
    print(f"[5] fused_mel_f32 bounds: the split's six bf16 passes on the tensor cores {bounds['fused_mel_f32'][0]:.3f} "
          f"ms ({bounds['fused_mel_f32'][1]}; the kernel's share {bounds['fused_mel_f32'][0] / ms['fused_mel_f32'][0]:.1%}), "
          f"the same function on the FP32 CUDA cores {ffma[0]:.3f} ms ({ffma[1]}); mfcc_tail_f32 "
          f"{bounds['mfcc_tail_f32'][0]:.3f} ms ({bounds['mfcc_tail_f32'][1]}; its share "
          f"{bounds['mfcc_tail_f32'][0] / ms['mfcc_tail_f32'][0]:.1%})")
    errs = {"fused_mel_fft_f32": mel_abs, "fused_mel_f32": tc_abs, "mfcc_tail_f32": tail_abs}
    rows = [kernel_row(k, launches[k], errs[k], ms[k], bounds[k]) for k in ("fused_mel_fft_f32", "fused_mel_f32",
                                                                           "mfcc_tail_f32")]
    rows[0]["library_ms"] = lib_ms
    return rows


def tail_after_each(y: torch.Tensor, cfg: mt.MfccConfig, a: dict, mel_k: torch.Tensor, pk: torch.Tensor,
                    card: str) -> None:
    """Phase 5: mfcc_tail_f32 timed alone (events around its launch, the
    median of 20 after one) in the places the pipeline and the benchmark put
    it: on the mel that fused_mel_fft_f32 (then fused_mel_f32) has just
    written, enqueued behind it with no synchronise between (the pipeline's
    order: the write-back of its last mel lines is still in L2); on the
    same mel after a synchronise and an L2 flush (a 256 MB write, five times
    the L2); and right after another tail on it (kernel_ms's steady state).
    The SM clock, power and throttle reasons are read after each set."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=y.device)

    def tail(mel: torch.Tensor) -> torch.Tensor:
        return ff.mfcc_tail(mel, pk, cfg.n_mfcc, transposed=True, dct=a["dct"])

    def timed(before) -> float:
        times = []
        for _ in range(21):
            mel = before()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            tail(mel)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            del mel
        return statistics.median(times[1:])

    def flushed() -> torch.Tensor:
        flush.fill_(1.0)
        torch.cuda.synchronize()
        return mel_k

    cases = {
        "right after fused_mel_fft_f32 wrote it": lambda: frontend_kernel(y, cfg, a)[0],
        "right after fused_mel_f32 wrote it": lambda: tc_f32(y, cfg, a["w"])[0],
        "after a synchronise and an L2 flush": flushed,
        "right after another tail on it": lambda: (tail(mel_k), mel_k)[1],
    }
    for label, before in cases.items():
        ms = timed(before)
        print(f"[5] mfcc_tail_f32 on the mel {label}: {ms:.4f} ms ({card}; SM clock, power, throttle reasons: "
              f"{sm_clock()})")
    del flush
    torch.cuda.empty_cache()


def split3_bound(n_bytes: float, frames: int, k: int, bins: int, n_mels: int, dft_passes: int) -> tuple[float, str]:
    """(least ms, what binds it) of fused_mel_f32's work: ``dft_passes``
    bf16 passes of the DFT (six on float32 audio, five on int16, whose lo
    plane is zero) and six of the mel projection on the tensor cores, or the
    bytes it moves."""
    ops = 2.0 * frames * k * 2 * bins * dft_passes + 2.0 * frames * bins * n_mels * 6
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, ops / PEAK_BF16_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name: str, launches: int, err: float, ms: tuple[float, float], b: tuple[float, str]) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": err, "ms": ms[0], "plain_ms": ms[1],
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None}


# ---------------------------------------------------------------------------
# Trackers (phases 6-10)
# ---------------------------------------------------------------------------


def sinc_errors(got: tuple, want: tuple) -> tuple[float, float, float]:
    """(max value error, share of positions off by more than 1e-4, max
    position error): the bars of the JAX kernel test are 1e-5, < 5 %, 0.26."""
    dv = float((got[1] - want[1]).abs().max())
    dp = (got[0] - want[0]).abs()
    return dv, float((dp > 1e-4).float().mean()), float(dp.max())


def sinc_ok(errs: tuple[float, float, float]) -> bool:
    return errs[0] <= 1e-5 and errs[1] < 0.05 and errs[2] <= 0.26


def burg_accuracy(frames: torch.Tensor, levinson: bool) -> tuple[float, float, float]:
    """(max |kernel − plain|, kernel's and plain version's max error against
    the float64 recursion on the same frames)."""
    got = (BK.burg_lpc if levinson else BK.burg_reflections)(frames, 10)
    plain = BK.burg_lpc_reference(frames, 10, levinson=levinson)
    exact = BK.burg_lpc_reference(frames.double(), 10, levinson=levinson)
    return (float((got - plain).abs().max()), float((got.double() - exact).abs().max()),
            float((plain.double() - exact).abs().max()))


def track_agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[int, float, int]:
    """(frames whose voicing differs, max |Δf0| in Hz where both are voiced,
    frames voiced in both)."""
    g, w = got.cpu(), want.cpu()
    both = (g > 0) & (w > 0)
    dmax = float((g - w).abs()[both].max()) if bool(both.any()) else 0.0
    return int(((g > 0) != (w > 0)).sum()), dmax, int(both.sum())


def formant_agreement(got: torch.Tensor, want: torch.Tensor, truth: torch.Tensor) -> tuple[float, int, float]:
    """Formants [..., NF, n] of two float32 chains against each other on the
    frames where float32 is well conditioned: where ``want`` has the float64
    chain's NaN pattern and is within 0.05 Hz of it (quiet frames at silence
    boundaries are not: there Burg in float32 moves with the summation
    order). (share of such frames, how many of them differ in NaN pattern or
    by more than 0.05 Hz, max |Δ| Hz over the others)."""
    g, w, t = got.cpu(), want.cpu(), truth.cpu()
    same_nan = (torch.isfinite(w) == torch.isfinite(t)).all(-1)
    close = torch.where(torch.isfinite(w) & torch.isfinite(t), (w - t).abs(), 0.0).le(0.05).all(-1)
    cond = same_nan & close
    gc, wc = g[cond], w[cond]
    both = torch.isfinite(gc) & torch.isfinite(wc)
    delta = torch.where(both, (gc - wc).abs(), 0.0)
    bad = (torch.isfinite(gc) != torch.isfinite(wc)).any(-1) | delta.gt(0.05).any(-1)
    dmax = float(delta[~bad].max()) if bool((~bad).any()) else 0.0
    return float(cond.float().mean()), int(bad.sum()), dmax


def formants_ok(a: tuple[float, int, float], n_frames: int) -> bool:
    """Bars: > 95 % of frames well conditioned; of those, at most one in
    10,000 (at least one) differs. In float32 a root of a near-double pair
    can move by 0.1-0.2 Hz for a 1e-7 change of the LPC coefficients, and
    the fixed 40 Durand-Kerner iterations leave a rare frame unconverged,
    where the roots depend on rounding; every other frame agrees to 0.05 Hz."""
    return a[0] > 0.95 and a[1] <= max(1, 1e-4 * a[0] * n_frames) and a[2] <= 0.05


def agreement_text(a: tuple[float, int, float]) -> str:
    return (f"well-conditioned frames {a[0]:.4%}, of which {a[1]} differ (bar ≤ 1e-4 of them, at least 1); "
            f"max |Δ| {a[2]:.3e} Hz over the rest (bar 0.05)")


def sinc_float64_check(label: str, args: tuple, kw: dict, got: tuple, plain: tuple) -> None:
    """The kernel's values no further from the float64 evaluation of the
    plain version than the FP32 plain version's, plus 1e-6."""
    r_ext, *rest = args
    exact = SK.refine_sinc_band_reference(r_ext.double(), *rest, **kw)  # the weights cast to float64
    err_k = float((got[1].double() - exact[1]).abs().max())
    err_p = float((plain[1].double() - exact[1]).abs().max())
    print(f"[6] sinc_refine_f32 {label} against its plain version in float64: value err kernel {err_k:.3e}, "
          f"plain {err_p:.3e} (bar: kernel ≤ plain + 1e-6)")
    check(err_k <= err_p + 1e-6, f"sinc_refine_f32 {label} against float64")


def sinc_kernel_checks(dev) -> None:
    """Phase 6, sinc: on the pitch tracker's own autocorrelation at three
    bands, against the plain version and its float64 evaluation; on the
    16 kHz band, rows that fill no whole row group and depths whose taps
    (S = 163, 403) stream the weights in two and four chunks."""
    for label, sr, va in (("16 kHz", 16_000, False), ("16 kHz veryAccurate", 16_000, True), ("10 kHz", 10_000, False)):
        x = torch.tensor(speechlike(4, SECONDS * sr, sr, seed=3), device=dev)
        with spy(P, "refine_sinc_band") as calls:
            P.pitch_ac(x, sr=float(sr), very_accurate=va)
        args, kw = calls[0][:2]
        r_ext, ext_left, lag_lo, lag_max, depth = args
        got, plain = SK.refine_sinc_band(*args, **kw), SK.refine_sinc_band_reference(*args, **kw)
        errs = sinc_errors(got, plain)
        torch.cuda.synchronize()
        plan = SK.sinc_plan(lag_max - lag_lo + 1, 2 * depth + 3)
        print(f"[6] sinc_refine_f32 {label}: r_ext {tuple(r_ext.shape)}, band {lag_lo}..{lag_max}, depth {depth} "
              f"({plan}): value err {errs[0]:.3e} (bar 1e-5), positions off > 1e-4 {errs[1]:.4%} (bar 5 %), "
              f"max position err {errs[2]:.4f} (bar 0.26)")
        check(sinc_ok(errs), f"sinc_refine_f32 {label}")
        sinc_float64_check(label, args, kw, got, plain)
        if label == "16 kHz":
            d_kw = {k: v for k, v in kw.items() if k != "w"}  # the weights designed at each depth
            for deep in (80, 200):  # the same rows zero-padded to fit the wider support
                pad = deep - depth
                d_args = (torch.nn.functional.pad(r_ext, (pad, pad)), ext_left + pad, lag_lo, lag_max, deep)
                d_got, d_plain = SK.refine_sinc_band(*d_args, **d_kw), SK.refine_sinc_band_reference(*d_args, **d_kw)
                errs = sinc_errors(d_got, d_plain)
                print(f"[6] sinc_refine_f32 16 kHz at depth {deep} ({SK.sinc_plan(lag_max - lag_lo + 1, 2 * deep + 3)}"
                      f"): value err {errs[0]:.3e}, positions off > 1e-4 {errs[1]:.4%}, max position err "
                      f"{errs[2]:.4f} (bars 1e-5, 5 %, 0.26)")
                check(sinc_ok(errs), f"sinc_refine_f32 at depth {deep}")
                sinc_float64_check(f"16 kHz at depth {deep}", d_args, d_kw, d_got, d_plain)
                del d_args, d_got, d_plain
            flat = r_ext.reshape(-1, r_ext.shape[-1])
            for m in (1, 1001):  # no whole row group of 32; 1001 leaves 9 rows in the last
                part = (flat[:m], *args[1:])
                errs = sinc_errors(SK.refine_sinc_band(*part, **kw), SK.refine_sinc_band_reference(*part, **kw))
                print(f"[6] sinc_refine_f32 16 kHz, the first {m} rows: value err {errs[0]:.3e}, positions off "
                      f"> 1e-4 {errs[1]:.4%}, max position err {errs[2]:.4f} (bars 1e-5, 5 %, 0.26)")
                check(sinc_ok(errs), f"sinc_refine_f32 on {m} rows")


def burg_range_checks(dev) -> None:
    """Phase 6, Burg at the ends of the kernel's range (nw 2 .. 3,632, order
    1 .. 32; one, two and four warps a frame) on 1,001 seeded noise frames
    (no whole block of frames), against float64; and the library's plan
    equal to burg_plan over the whole range of nw."""
    off = [nw for nw in range(2, BK._MAX_NW + 1) if BK.library_plan(nw, 1) != BK.burg_plan(nw, 1)]
    print(f"[6] burg_lpc_f32 plans for nw 2..{BK._MAX_NW}: {len(off)} differ from burg_plan")
    check(not off, "burg_lpc_f32: the launcher's plan is burg_plan's")
    rng = np.random.default_rng(11)
    for nw, order in ((2, 1), (33, 32), (550, 10), (550, 32), (1500, 16), (3632, 32)):
        frames = torch.tensor(rng.standard_normal((1001, nw)).astype(np.float32) * 0.3, device=dev)
        for levinson in (True, False):
            got = (BK.burg_lpc if levinson else BK.burg_reflections)(frames, order)
            plain = BK.burg_lpc_reference(frames, order, levinson=levinson)
            exact = BK.burg_lpc_reference(frames.double(), order, levinson=levinson)
            err_k = float((got.double() - exact).abs().max())
            err_p = float((plain.double() - exact).abs().max())
            torch.cuda.synchronize()
            print(f"[6] burg_lpc_f32 nw {nw}, order {order}, levinson={levinson} ({BK.burg_plan(nw, order)}): "
                  f"max-abs vs plain {float((got - plain).abs().max()):.3e}; against float64 kernel {err_k:.3e}, "
                  f"plain {err_p:.3e} (bar: kernel ≤ 2 × plain + 2e-6)")
            check(err_k <= 2 * err_p + 2e-6, f"burg_lpc_f32 nw {nw} order {order}")


def tracker_kernel_checks(dev) -> None:
    """Phase 6: both tracker kernels against their plain versions on the
    inputs their paths hand them, and at the ends of their ranges."""
    sinc_kernel_checks(dev)

    test_frames = torch.tensor(np.random.default_rng(0).standard_normal((3, 41, 213)).astype(np.float32) * 0.3,
                               device=dev)
    for levinson in (True, False):
        err = float(((BK.burg_lpc if levinson else BK.burg_reflections)(test_frames, 10)
                     - BK.burg_lpc_reference(test_frames, 10, levinson=levinson)).abs().max())
        print(f"[6] burg_lpc_f32 levinson={levinson} on the JAX kernel test's frames: max-abs {err:.3e} (bar 2e-6)")
        check(err <= 2e-6, "burg_lpc_f32 on the JAX test's frames")
    x = torch.tensor(speechlike(4, SECONDS * TRACK_SR, TRACK_SR, seed=3), dtype=torch.float64)
    xr = torch.tensor(resample(x.numpy(), TRACK_SR, LPC_SR), dtype=torch.float32, device=dev)
    with spy(BK, "burg_lpc") as calls:
        L.lpc_formants(xr, sr=LPC_SR)
    frames = calls[0][0][0]
    for levinson in (True, False):
        diff, err_k, err_p = burg_accuracy(frames, levinson)
        torch.cuda.synchronize()
        print(f"[6] burg_lpc_f32 levinson={levinson} on lpc_formants' frames {tuple(frames.shape)}: "
              f"max-abs vs plain {diff:.3e}; against float64 kernel {err_k:.3e}, plain {err_p:.3e} "
              f"(bar: kernel ≤ 2 × plain + 2e-6)")
        check(err_k <= 2 * err_p + 2e-6, "burg_lpc_f32 as accurate as its plain version")
    burg_range_checks(dev)


def f0_path(dev, y_np: np.ndarray, batch: mt.AudioBatch, card: str) -> tuple[dict, dict]:
    """Phase 7: the F0 path at full size. (launches, captured inputs)."""
    launches, inputs = 0, {}
    for method in ("praatac", "praatcc"):
        cfg = mt.F0Config(method=method)
        reset(SK.LAUNCHES)
        with spy(P, "refine_sinc_band") as sinc_calls:
            f0, valid = mt.batched_f0(batch, TRACK_SR, cfg)
            torch.cuda.synchronize()
        n = SK.LAUNCHES["sinc_refine_f32"]
        launches += n
        print(f"[7] batched_f0 {method} on {tuple(batch.samples.shape)}: f0 {tuple(f0.shape)}, "
              f"voiced {float((f0 > 0).float().mean()):.3f}, sinc_refine_f32 launches {n}")
        check(n > 0, f"sinc_refine_f32 launched in the {method} path")
        check(bool(torch.isfinite(f0).all()) and bool(valid.all()), f"finite {method} tracks, all frames valid")
        inputs[method] = sinc_calls[0][:2]
        plain, _ = mt.batched_f0(batch, TRACK_SR, cfg, sinc_engine="plain")
        flips, dmax, nboth = track_agreement(f0, plain)
        print(f"[7] {method} vs sinc_engine='plain' on the card: {flips} voicing flips of {f0.numel()}, "
              f"max |Δf0| {dmax:.3e} Hz over {nboth} voiced frames (bars 0, 0.05 Hz)")
        check(flips == 0 and dmax <= 0.05, f"{method} path vs plain sinc engine")
        cpu, _ = mt.batched_f0(mt.pad_batch(list(y_np[:2]), bucket_multiple=1, device="cpu"), TRACK_SR, cfg)
        flips, dmax, nboth = track_agreement(f0[:2], cpu)
        print(f"[7] {method} utterances 0-1 vs the CPU path: {flips} voicing flips, max |Δf0| {dmax:.3e} Hz "
              f"(bars 0, 0.05 Hz)")
        check(flips == 0 and dmax <= 0.05, f"{method} path vs the CPU")
    return {"sinc_refine_f32": launches}, inputs


def formant_path(dev, xr_np: np.ndarray) -> tuple[dict, tuple]:
    """Phase 8: the formant path at full size. (launches, captured inputs)."""
    xr = torch.tensor(xr_np, device=dev)
    reset(BK.LAUNCHES)
    with spy(BK, "burg_lpc") as burg_calls:
        freqs, bw = mt.batched_formants(xr, LPC_SR, mt.FormantConfig())
        torch.cuda.synchronize()
    n = BK.LAUNCHES["burg_lpc_f32"]
    print(f"[8] batched_formants on {tuple(xr.shape)} at {LPC_SR:.0f} Hz: freqs {tuple(freqs.shape)}, "
          f"finite {float(torch.isfinite(freqs).float().mean()):.3f}, burg_lpc_f32 launches {n}")
    check(n > 0, "burg_lpc_f32 launched in the formant path")
    check(bool(torch.isfinite(bw[torch.isfinite(freqs)]).all()), "finite bandwidths of finite formants")
    plain, _ = mt.batched_formants(xr, LPC_SR, mt.FormantConfig(), burg_engine="plain")
    truth, _ = mt.batched_formants(xr.double(), LPC_SR, mt.FormantConfig(), burg_engine="plain")
    agree = formant_agreement(freqs, plain, truth)
    print(f"[8] vs burg_engine='plain' on the card: {agreement_text(agree)}")
    check(formants_ok(agree, freqs.shape[0] * freqs.shape[1]), "formant path vs plain Burg")
    x2 = torch.tensor(xr_np[:2])
    cpu, _ = mt.batched_formants(x2, LPC_SR, mt.FormantConfig())
    truth2, _ = mt.batched_formants(x2.double(), LPC_SR, mt.FormantConfig())
    agree = formant_agreement(freqs[:2], cpu, truth2)
    print(f"[8] utterances 0-1 vs the CPU path: {agreement_text(agree)}")
    check(formants_ok(agree, 2 * freqs.shape[1]), "formant path vs the CPU")
    return {"burg_lpc_f32": n}, burg_calls[0][:2]


def single_files(y: np.ndarray) -> None:
    """Phase 9: one 30 s utterance through the per-file entry points, on the
    card (the default device) against the CPU."""
    got, t = mt.extract_f0(y, TRACK_SR, mt.F0Config())
    want, t_cpu = mt.extract_f0(y, TRACK_SR, mt.F0Config(), device="cpu")
    g, w = got.cpu().numpy(), want.numpy()
    same_nan = np.array_equal(np.isnan(g), np.isnan(w))
    err = float(np.nanmax(np.abs(g - w)))
    print(f"[9] extract_f0 (interp + iir) on 30 s: {g.shape[0]} frames on {got.device}, vs CPU max |Δ| "
          f"{err:.3e} Hz (bar 0.05), NaN patterns equal {same_nan}")
    check(got.device.type == "cuda" and np.array_equal(t, t_cpu) and same_nan and err <= 0.05, "extract_f0")
    t_g, f_g, keep_g = mt.formants_with_gating(y, TRACK_SR)
    t_c, f_c, keep_c = mt.formants_with_gating(y, TRACK_SR, device="cpu")
    kept = torch.as_tensor(keep_c)
    truth = mt.FormantTracker(mt.FormantConfig(), TRACK_SR)
    truth = truth.lpc(torch.tensor(truth.resample(y.astype(np.float64))))[0][:, :3]
    agree = formant_agreement(torch.stack(f_g, -1).cpu()[kept], torch.stack(f_c, -1)[kept], truth[kept])
    print(f"[9] formants_with_gating on 30 s: {len(t_g)} frames, {int(keep_g.sum())} kept; kept frames vs CPU: "
          f"{agreement_text(agree)}")
    check(np.array_equal(t_g, t_c) and np.array_equal(keep_g, keep_c) and formants_ok(agree, int(kept.sum())),
          "formants_with_gating")
    t_e, f_e = mt.extract_formants(y, TRACK_SR)
    check(np.array_equal(t_e, t_g[keep_g]) and f_e[0].device.type == "cuda", "extract_formants")


def tracker_times(batch: mt.AudioBatch, xr: torch.Tensor, f0_inputs: dict, lpc_inputs: tuple, card: str):
    """Phase 10: (kernel ms pairs, kernel errors at full size, bounds)."""
    hours = TRACK_BATCH * SECONDS / 3600.0
    s_args, s_kw = f0_inputs["praatac"]
    sinc_k = SK.refine_sinc_band(*s_args, **s_kw)
    sinc_p = SK.refine_sinc_band_reference(*s_args, **s_kw)
    sinc_err = sinc_errors(sinc_k, sinc_p)
    check(sinc_ok(sinc_err), "sinc_refine_f32 at full size")
    b_frames = lpc_inputs[0][0]
    burg_err = float((BK.burg_lpc(b_frames, 10) - BK.burg_lpc_reference(b_frames, 10)).abs().max())
    del sinc_k, sinc_p
    r_ext, _, lag_lo, lag_max, depth = s_args
    m_rows, length = r_ext.shape[0] * r_ext.shape[1], r_ext.shape[-1]
    nl, s = lag_max - lag_lo + 1, 2 * depth + 3
    m_fr, nw = b_frames.shape[0] * b_frames.shape[1], b_frames.shape[-1]
    bounds = {
        "sinc_refine_f32": bound(m_rows * length * 4 + s * SK.GRID * 4 + 2 * m_rows * nl * 4,
                                 2 * m_rows * nl * s * SK.GRID),
        "burg_lpc_f32": bound(m_fr * nw * 4 + m_fr * 10 * 4, m_fr * sum(10 * (nw - 1 - m) for m in range(10))),
    }
    ms = {
        "sinc_refine_f32": (cuda_ms(lambda: SK.refine_sinc_band(*s_args, **s_kw)),
                            cuda_ms(lambda: SK.refine_sinc_band_reference(*s_args, **s_kw))),
        "burg_lpc_f32": (cuda_ms(lambda: BK.burg_lpc(b_frames, 10)),
                         cuda_ms(lambda: BK.burg_lpc_reference(b_frames, 10))),
    }
    for k, (t_k, t_p) in ms.items():
        b_ms, by = bounds[k]
        print(f"[10] {k}: {t_k:.3f} ms, plain {t_p:.3f} ms, bound {b_ms:.3f} ms ({by}), {b_ms / t_k:.1%} of it "
              f"({card}; {sm_clock()})")
    for method in ("praatac", "praatcc"):
        cfg = mt.F0Config(method=method)
        torch.cuda.reset_peak_memory_stats()
        e2e, parts = path_ms(lambda: mt.batched_f0(batch, TRACK_SR, cfg),
                             [(P, "refine_sinc_band"), (P, "viterbi_path")])
        peak = torch.cuda.max_memory_allocated() / 2**30
        sinc_ms, vit_ms = parts["refine_sinc_band"], parts["viterbi_path"]
        print(f"[10] batched_f0 {method} end to end: {e2e:.3f} ms = {hours / (e2e / 1e3):.3f} audio-h/s; within it "
              f"sinc_refine_f32 {sinc_ms:.3f} ms ({sinc_ms / e2e:.1%}), the Viterbi loop {vit_ms:.3f} ms "
              f"({vit_ms / e2e:.1%}), the rest {e2e - sinc_ms - vit_ms:.3f} ms; peak memory {peak:.2f} GiB ({card})")
    torch.cuda.reset_peak_memory_stats()
    e2e, parts = path_ms(lambda: mt.batched_formants(xr, LPC_SR, mt.FormantConfig()),
                         [(BK, "burg_lpc"), (L, "poly_roots_dk")])
    peak = torch.cuda.max_memory_allocated() / 2**30
    burg_ms, roots = parts["burg_lpc"], parts["poly_roots_dk"]
    print(f"[10] batched_formants end to end: {e2e:.3f} ms = {hours / (e2e / 1e3):.3f} audio-h/s; within it "
          f"burg_lpc_f32 {burg_ms:.3f} ms ({burg_ms / e2e:.1%}), poly_roots_dk {roots:.3f} ms ({roots / e2e:.1%}), "
          f"the rest {e2e - burg_ms - roots:.3f} ms; peak memory {peak:.2f} GiB ({card})")
    return ms, {"sinc_refine_f32": sinc_err[0], "burg_lpc_f32": burg_err}, bounds


def tracker_paths(dev, card: str) -> list[dict]:
    """Phases 6-10; the kernel rows of the tracker paths."""
    tracker_kernel_checks(dev)
    y_np = speechlike(TRACK_BATCH, SECONDS * TRACK_SR, TRACK_SR, seed=5)
    batch = mt.pad_batch(list(y_np), bucket_multiple=1, device=dev)
    f0_launches, f0_inputs = f0_path(dev, y_np, batch, card)
    t0 = time.perf_counter()
    xr_np = resample(y_np.astype(np.float64), TRACK_SR, LPC_SR).astype(np.float32)
    print(f"[8] host resampling {y_np.shape} → {xr_np.shape} ({time.perf_counter() - t0:.3f} s, outside the timed window)")
    lpc_launches, lpc_inputs = formant_path(dev, xr_np)
    single_files(y_np[0])
    xr = torch.tensor(xr_np, device=dev)
    ms, errs, bounds = tracker_times(batch, xr, f0_inputs, lpc_inputs, card)
    launches = {**f0_launches, **lpc_launches}
    rows = [kernel_row(k, launches[k], errs[k], ms[k], bounds[k]) for k in ("sinc_refine_f32", "burg_lpc_f32")]
    del xr
    torch.cuda.empty_cache()
    viterbi_kernel_checks(dev)
    wide_viterbi_checks(dev)
    toeplitz_checks(dev)
    wide_pyin(dev, card)
    torch.cuda.empty_cache()
    vit_launches, vit_inputs = pyin_path(dev, y_np, batch)
    ms, errs, bounds = pyin_times(batch, vit_inputs, card)
    return rows + [kernel_row(k, vit_launches[k], errs[k], ms[k], bounds[k]) for k in VK.LAUNCHES]


# ---------------------------------------------------------------------------
# pyin (phases 11-13)
# ---------------------------------------------------------------------------


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (±0 told apart)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def viterbi_compare(args: tuple, band: tuple) -> tuple[float, float, tuple]:
    """Both kernels against their plain versions on one trellis (log_obs,
    delta0, log_tri, c_stay, c_sw), both given ``band``: (0 when δ_f and the
    history are the plain forward's bit for bit, else their max |Δ| (inf
    where they differ only in bits), max |Δ| of the state paths, the plain
    forward's (δ_f, history)). The backtrace runs on the plain forward's
    output; the fused decode is compared too."""
    f_k, h_k = VK.viterbi_forward(*args, band)
    f_p, h_p = VK.viterbi_forward_reference(*args)
    path_k = VK.viterbi_backtrace(h_p, f_p, *args[2:], band)
    path_p = VK.viterbi_backtrace_reference(h_p, f_p, *args[2:])
    dec_k = VK.viterbi_decode(*args, band)
    torch.cuda.synchronize()
    delta_err = 0.0
    if not (same_bits(f_k, f_p) and same_bits(h_k, h_p)):
        delta_err = max(float((f_k - f_p).abs().max()), float((h_k - h_p).abs().max())) or float("inf")
    path_err = float(torch.maximum((path_k - path_p).abs(), (dec_k - path_p).abs()).max())
    return delta_err, path_err, (f_p, h_p)


def banded_trellis(kind: str, rng: np.random.Generator, dev) -> tuple[tuple, int]:
    """Crafted banded trellises on the card, (args, h), batch 3, 200 frames:
    'floor' a random band of half-width 21 over a floor C = −87.3, with C at
    a fifth of the entries inside the band too, n = 361 (pyin's shape);
    'wide' the same with h = 40 (81 sources: too wide for registers);
    'ties' small integers everywhere (band entries −8..−1 over C = −8,
    observations −3..0, c_stay = −1, c_sw = −2), so band terms tie with each
    other and with fl(gmax + C), n = 361, h = 5; 'diagonal' h = 0, n = 100."""
    n, h, floor = {"floor": (361, 21, -87.3), "wide": (361, 40, -87.3), "ties": (361, 5, -8.0),
                   "diagonal": (100, 0, -20.0)}[kind]
    dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    lt = np.full((n, n), floor, np.float32)
    nf, inside = 200, dist <= h
    if kind == "ties":
        lt[inside] = rng.integers(-8, 0, int(inside.sum()))
        lt[dist == h] = -1.0  # the band reaches h
        log_obs = rng.integers(-3, 1, (3, nf, 2 * n)).astype(np.float32)
        delta0 = rng.integers(-3, 1, (3, 2 * n)).astype(np.float32)
        c_stay, c_sw = -1.0, -2.0
    else:
        lt[inside] = rng.uniform(-10.0, 0.0, int(inside.sum()))
        if kind in ("floor", "wide"):
            lt[inside & (dist > 0) & (rng.random((n, n)) < 0.2)] = floor
            lt[dist == h] = -5.0
        log_obs = np.log(rng.random((3, nf, 2 * n)) + 1e-12).astype(np.float32)
        delta0 = np.log(rng.random((3, 2 * n)) + 1e-12).astype(np.float32)
        c_stay, c_sw = float(np.log(np.float32(0.99))), float(np.log(np.float32(0.01)))
    args = (torch.tensor(log_obs, device=dev), torch.tensor(delta0, device=dev), torch.tensor(lt, device=dev),
            c_stay, c_sw)
    return args, h


def viterbi_kernel_checks(dev) -> None:
    """Phase 11: both Viterbi kernels bit for bit against their plain
    versions, on the random dense trellises of the CPU test (h = n − 1,
    log_tri from L2), on crafted banded trellises (each layout of the band)
    and pyin's own (the band in registers) and on a batch of one."""
    rng = np.random.default_rng(11)
    c_stay, c_sw = float(np.log(np.float32(0.99))), float(np.log(np.float32(0.01)))
    for n_bins, nf, nb in ((360, 40, 3), (130, 7, 3), (37, 25, 3), (40, 600, 3), (360, 40, None), (40, 1, 2)):
        lead = () if nb is None else (nb,)
        tri = rng.random((n_bins, n_bins))
        args = (torch.tensor(np.log(rng.random((*lead, nf, 2 * n_bins)) + 1e-12), dtype=torch.float32, device=dev),
                torch.tensor(np.log(rng.random((*lead, 2 * n_bins)) + 1e-12), dtype=torch.float32, device=dev),
                torch.tensor(np.log(tri / tri.sum(0) + 1e-30), dtype=torch.float32, device=dev), c_stay, c_sw)
        band = VK.viterbi_band(args[2])
        h = band[0]
        check(h == n_bins - 1 and VK.band_layout(n_bins, h) == "L2", f"the dense trellis n={n_bins} is read from L2")
        if nf == 1:
            f_k, h_k = VK.viterbi_forward(*args)
            f_p, h_p = VK.viterbi_forward_reference(*args)
            torch.cuda.synchronize()
            ok = same_bits(f_k, f_p) and h_k.shape == h_p.shape == (nb, 0, 2 * n_bins)
            print(f"[11] viterbi_fwd_f32 on one frame, batch {nb}: δ_f identical {ok}")
            check(ok, "viterbi_fwd_f32 on one frame")
            continue
        err, path_err, _ = viterbi_compare(args, band)
        print(f"[11] random trellis n={n_bins} NF={nf} batch {nb or 'none'}, h={h}, band in "
              f"{VK.band_layout(n_bins, h)}, backtrace's in {VK.backtrace_layout(n_bins, h)}: δ max |Δ| {err:.3e}, "
              f"state paths max |Δ| {path_err:.0f} (bars 0, 0)")
        check(err == 0.0 and path_err == 0.0, f"Viterbi kernels on the random trellis n={n_bins} NF={nf}")
    for kind, where in (("floor", "registers"), ("wide", "shared"), ("ties", "registers"), ("diagonal", "registers")):
        args, h = banded_trellis(kind, rng, dev)
        n = args[2].shape[0]
        band = VK.viterbi_band(args[2])
        check(band == (h, float(args[2].min())) and VK.band_layout(n, h) == where, f"the band of the {kind} trellis")
        err, path_err, _ = viterbi_compare(args, band)
        print(f"[11] banded trellis '{kind}' n={n} h={h} C={band[1]}, band in {where}, backtrace's in "
              f"{VK.backtrace_layout(n, h)}: δ max |Δ| {err:.3e}, state paths max |Δ| {path_err:.0f} (bars 0, 0)")
        check(err == 0.0 and path_err == 0.0, f"Viterbi kernels on the banded trellis {kind}")
    for sr in (16_000, 10_000):
        x = torch.tensor(speechlike(4, SECONDS * sr, sr, seed=3), device=dev)
        with spy(Y, "viterbi_decode") as calls:
            Y.pyin_f0(x, sr=float(sr))
        *args, band = calls[0][0]
        n = args[2].shape[0]
        check(band[0] == 21 and band == VK.viterbi_band(args[2]) and VK.band_layout(n, band[0]) == "registers",
              f"pyin's band at {sr} Hz")
        err, path_err, _ = viterbi_compare(args, band)
        check(VK.backtrace_layout(n, band[0]) == "shared", f"pyin's backtrace band at {sr} Hz in shared memory")
        print(f"[11] pyin's trellis at {sr} Hz, log_obs {tuple(args[0].shape)}, band h={band[0]} C={band[1]} in "
              f"{VK.band_layout(n, band[0])}, backtrace's in {VK.backtrace_layout(n, band[0])}: δ max |Δ| {err:.3e}, "
              f"state paths max |Δ| {path_err:.0f} (bars 0, 0)")
        check(err == 0.0 and path_err == 0.0, f"Viterbi kernels on pyin's trellis at {sr} Hz")
        one = (args[0][:1].contiguous(), args[1][:1].contiguous(), *args[2:])
        single = (args[0][0].contiguous(), args[1][0].contiguous(), *args[2:])
        ok = viterbi_compare(one, band)[:2] == (0.0, 0.0) and viterbi_compare(single, band)[:2] == (0.0, 0.0)
        ok = ok and torch.equal(VK.viterbi_decode(*one, band)[0], VK.viterbi_decode(*single, band))
        print(f"[11] a batch of one and a single trellis at {sr} Hz: identical to the plain versions {ok}")
        check(ok, f"Viterbi kernels on a batch of one at {sr} Hz")
    for kind in ("ties", "rounding"):
        hist, delta_f, lt, c_stay, c_sw, want = backtrace_traps(kind, rng, dev)
        n = lt.shape[0]
        band = VK.viterbi_band(lt)
        check(band == (21, float(lt.min())) and VK.backtrace_layout(n, 21) == "shared", f"the band of the {kind} traps")
        got = VK.viterbi_backtrace(hist, delta_f, lt, c_stay, c_sw, band)
        plain = VK.viterbi_backtrace_reference(hist, delta_f, lt, c_stay, c_sw)
        torch.cuda.synchronize()
        err = int((got - plain).abs().max())
        designed = torch.equal(plain.cpu().long(), want)
        print(f"[11] backtrace traps '{kind}' {tuple(hist.shape)}, n={n} h=21, backtrace's band in "
              f"{VK.backtrace_layout(n, 21)}: state paths max |Δ| {err} (bar 0); the plain path is the designed "
              f"one {designed}")
        check(err == 0 and designed, f"viterbi_bwd_f32 on the {kind} traps")


# Phase 11's trellises past 1,024 bins (C10): librosa's C2-C7 at resolution
# 0.05 and F0Config's 75-600 Hz and C2-C7 at 0.01, each dense (h = n - 1,
# a short NF), banded with pyin's band there over a floor, and with a band
# narrow enough for shared memory; and 14,497 bins, one past the forward's
# m in shared memory (its 'history' layout). (n, pyin's h, dense NF)
WIDE_BINS = ((1201, 43, 6), (3601, 215, 6), (6001, 215, 4))
HISTORY_BINS = 14_497


def wide_trellis(n: int, h: int | None, nf: int, batch: int, seed: int, dev) -> tuple:
    """A trellis made on the card, (log_obs [B, NF, 2n], delta0, log_tri,
    c_stay, c_sw): h None a random column-normalized log_tri (the dense
    recursion), else a random band of half-width h over the floor C =
    -87.3, C also at a fifth of the band's entries off the diagonal and the
    band reaching h (banded_trellis's 'floor' at n bins)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if h is None:
        tri = torch.rand((n, n), generator=g, device=dev)
        lt = torch.log(tri / tri.sum(0) + 1e-30)
        del tri
    else:
        idx = torch.arange(n, device=dev)
        dist = (idx[:, None] - idx[None, :]).abs()
        inside = dist <= h
        lt = torch.where(inside, torch.rand((n, n), generator=g, device=dev) * -10.0, -87.3)
        lt = torch.where(inside & (dist > 0) & (torch.rand((n, n), generator=g, device=dev) < 0.2), -87.3, lt)
        lt = torch.where(dist == h, -5.0, lt)
        del dist, inside
    return (*random_obs(n, nf, batch, g), lt.contiguous(), *SWITCH)


# (c_stay, c_sw) of the random trellises: log(0.99) and log(0.01) in float32
SWITCH = (float(np.log(np.float32(0.99))), float(np.log(np.float32(0.01))))


def random_obs(n: int, nf: int, batch: int, g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(log_obs [B, NF, 2n], delta0 [B, 2n]): logs of uniform noise, made on the card."""
    log_obs = torch.log(torch.rand((batch, nf, 2 * n), generator=g, device=g.device) + 1e-12)
    return log_obs, torch.log(torch.rand((batch, 2 * n), generator=g, device=g.device) + 1e-12)


def wide_viterbi_checks(dev) -> None:
    """Phase 11 past 1,024 bins: both kernels bit for bit against their
    plain versions on WIDE_BINS' dense, pyin-banded and narrow-banded
    trellises and at HISTORY_BINS, each line naming both layouts, the
    launch counters moving on each."""
    cases = [(n, h_case, nf if h_case is None else 100, 2)
             for n, h_pyin, nf in WIDE_BINS for h_case in (None, h_pyin, 2)]
    cases.append((HISTORY_BINS, 2, 12, 1))
    for i, (n, h, nf, batch) in enumerate(cases):
        args = wide_trellis(n, h, nf, batch, seed=110 + i, dev=dev)
        band = VK.viterbi_band(args[2])
        check(band[0] == (n - 1 if h is None else h), f"the band of the {n}-bin trellis")
        fwd, bwd = VK.band_layout(n, band[0]), VK.backtrace_layout(n, band[0])
        reset(VK.LAUNCHES)
        err, path_err, _ = viterbi_compare(args, band)
        launched = dict(VK.LAUNCHES)
        print(f"[11] {'dense' if h is None else 'banded'} trellis n={n} NF={nf} batch {batch}, h={band[0]}, band in "
              f"{fwd} ({VK.forward_bytes(n, band[0], fwd)} bytes), backtrace's in {bwd} "
              f"({VK.backtrace_bytes(n, band[0], bwd)} bytes): δ max |Δ| {err:.3e}, state paths max |Δ| "
              f"{path_err:.0f} (bars 0, 0); launches {launched}")
        check(err == 0.0 and path_err == 0.0, f"Viterbi kernels on the {n}-bin trellis h={band[0]}")
        check(launched == {"viterbi_fwd_f32": 2, "viterbi_bwd_f32": 2}, f"Viterbi kernels launched at n={n}")
        del args
        torch.cuda.empty_cache()
    check(VK.band_layout(HISTORY_BINS, 2) == "history", "the forward's history layout at 14,497 bins")


# Phase 11's Toeplitz trellises (the 'toeplitz' layout): pyin's own log_tri
# at 16 kHz, (fmin, fmax, resolution) -> its bins, and a librosa triangle of
# 2 x 215 + 1 bins (pyin's at resolution 0.01) over 14,497 bins, made on
# the card; every cluster size up to 16 that has a plan
TOEPLITZ_PYIN = ((65.406, 2093.0, 0.05), (75.0, 600.0, 0.01), (65.406, 2093.0, 0.01))
TOEPLITZ_CLUSTERS = (1, 2, 4, 8, 16)


def triangle_log_tri(n: int, h: int, dev) -> torch.Tensor:
    """librosa's transition_local triangle (window 2h + 1, each row
    truncated at the matrix's edges and normalised by its own sum) over n
    bins, log(· + tiny) in float32, made on the card; every row's sum is
    taken from the prefix sums of the one window, so the interior rows are
    the same floats."""
    win = torch.tensor(Y._triang_window(2 * h + 1), dtype=torch.float64, device=dev)
    prefix = torch.cat([win.new_zeros(1), torch.cumsum(win, 0)])
    u = torch.arange(n, device=dev)
    row_sum = prefix[torch.clamp(n - 1 - u + h, max=2 * h) + 1] - prefix[torch.clamp(h - u, min=0)]
    k = u[None, :] - u[:, None] + h  # column v of row u: window entry v - u + h
    inside = (k >= 0) & (k <= 2 * h)
    tri = torch.where(inside, win[k.clamp(0, 2 * h)], 0.0) / row_sum[:, None]
    del k, inside
    return torch.log(tri + float(torch.finfo(torch.float32).tiny)).to(torch.float32)


def clusters_of(n: int, band) -> list[int]:
    """The cluster sizes with a plan for this Toeplitz band."""
    return [g for g in TOEPLITZ_CLUSTERS if VK.cluster_plan(n, band[0], band.rows, g) is not None]


def toeplitz_checks(dev) -> None:
    """Phase 11, the 'toeplitz' layout: both kernels bit for bit against
    their plain versions on pyin's own transitions at 1,201, 3,601 and 6,001
    bins and a triangle band at 14,497 (random observations), the forward at
    every cluster size with a plan and by the rule, each line naming the
    layout, the cluster and the bytes; launch counts moving on each."""
    cases = [(Y._log_tri(Y.pyin_geometry(float(TRACK_SR), *geo[:2], resolution=geo[2]), torch.float32), 100, 2)
             for geo in TOEPLITZ_PYIN]
    cases.append((None, 12, 1))
    for i, (lt_np, nf, batch) in enumerate(cases):
        lt = triangle_log_tri(HISTORY_BINS, 215, dev) if lt_np is None else torch.tensor(lt_np, device=dev)
        n = lt.shape[0]
        band = VK.viterbi_band(lt)
        h = band[0]
        fwd, bwd = VK.band_layout(n, h, band.rows), VK.backtrace_layout(n, h, band.rows)
        check(band.rows == (h, n - 1 - h) and fwd == bwd == "toeplitz", f"the Toeplitz band of {n} bins")
        args = (*random_obs(n, nf, batch, torch.Generator(device=dev).manual_seed(130 + i)), lt, *SWITCH)
        f_p, h_p = VK.viterbi_forward_reference(*args)
        path_p = VK.viterbi_backtrace_reference(h_p, f_p, *args[2:])
        rule = VK.cluster_plan(n, h, band.rows)
        for g in [None, *clusters_of(n, band)]:
            reset(VK.LAUNCHES)
            got = VK.viterbi_forward(*args, band, cluster=g)
            torch.cuda.synchronize()
            ok = same_bits(got[0], f_p) and same_bits(got[1], h_p)
            err = 0.0
            if not ok:  # inf where they differ only in bits (±0)
                err = max(float((got[0] - f_p).abs().max()), float((got[1] - h_p).abs().max())) or float("inf")
            plan = rule if g is None else VK.cluster_plan(n, h, band.rows, g)
            print(f"[11] Toeplitz trellis n={n} NF={nf} batch {batch}, h={h}, forward in {fwd}, cluster "
                  f"{plan.g}{' (the rule)' if g is None else ''}, ranks {plan.bounds}, {plan.smem} bytes a block: δ "
                  f"max |Δ| {err:.3e} (bar 0); launches {dict(VK.LAUNCHES)}")
            check(ok and VK.LAUNCHES["viterbi_fwd_f32"] == 1, f"viterbi_fwd_f32 toeplitz at n={n}, cluster {plan.g}")
        reset(VK.LAUNCHES)
        path_k = VK.viterbi_backtrace(h_p, f_p, *args[2:], band)
        dec_k = VK.viterbi_decode(*args, band)
        torch.cuda.synchronize()
        path_err = float(torch.maximum((path_k - path_p).abs(), (dec_k - path_p).abs()).max())
        print(f"[11] Toeplitz trellis n={n}: backtrace in {bwd} ({VK.backtrace_bytes(n, h, bwd)} bytes), state paths "
              f"max |Δ| {path_err:.0f} (bar 0); launches {dict(VK.LAUNCHES)}")
        check(path_err == 0.0 and VK.LAUNCHES == {"viterbi_fwd_f32": 1, "viterbi_bwd_f32": 2},
              f"viterbi_bwd_f32 toeplitz at n={n}")
        del args, lt, f_p, h_p
        torch.cuda.empty_cache()


def viterbi_bounds(log_obs: torch.Tensor, hist: torch.Tensor, n: int, h: int) -> tuple[tuple, tuple]:
    """(forward, backtrace) bounds of one trellis: the banded work, as phase 13 counts it."""
    nb, nf, _ = log_obs.shape
    v = np.arange(n)
    pairs = int((np.minimum(n - 1, v + h) - np.maximum(0, v - h) + 1).sum())
    state_bytes = nb * 2 * n * 4
    b_f = bound(log_obs.numel() * 4 + 2 * state_bytes + hist.numel() * 4 + pairs * 4,
                nb * (nf - 1) * (4 * pairs + 18 * n))
    # the backtrace reads only the band of log_tri: the pairs the forward's bound counts
    b_b = bound(hist.numel() * 4 + state_bytes + pairs * 4 + nb * nf * 4, nb * (nf - 1) * 5 * n)
    return b_f, b_b


def wide_pyin(dev, card: str) -> None:
    """Phase 11: batched_f0 pyin at resolution 0.01 (75-600 Hz: 3,601 bins,
    h = 215) on 2 × 10 s at 16 kHz end to end: one launch of each Viterbi
    kernel, the forward in the 'toeplitz' layout on a cluster, f0 and states
    identical to the plain engine on the card, its time and peak memory
    beside the same call with the band given as a plain (h, C) pair (the
    wide layouts and the transposed log_tri); then at 3,601 and 6,001 bins
    (librosa's C2-C7 at 0.01) both kernels timed on pyin's trellis beside
    their plain versions and bounds, the forward at every cluster size with
    a plan and in the wide layout."""
    sr, cfg = TRACK_SR, mt.F0Config(method="pyin", resolution=0.01)
    y = speechlike(2, 10 * sr, sr, seed=111)
    batch = mt.pad_batch(list(y), bucket_multiple=1, device=dev)
    reset(VK.LAUNCHES)
    with spy(Y, "viterbi_decode") as calls:
        f0, valid = mt.batched_f0(batch, sr, cfg)
        torch.cuda.synchronize()
    launches = dict(VK.LAUNCHES)
    *args, band = calls[0][0]
    n = args[2].shape[0]
    plan = VK.cluster_plan(n, band[0], band.rows)
    tracker = mt.PyinTracker(cfg, sr).to(dev)
    f0_k, st_k = tracker(batch.samples, return_states=True)
    f0_p, st_p = tracker(batch.samples, return_states=True, viterbi_engine="plain")
    torch.cuda.synchronize()
    same = torch.equal(f0_k, f0_p) and torch.equal(st_k, st_p) and torch.equal(f0_k, f0)
    e2e = cuda_ms(lambda: mt.batched_f0(batch, sr, cfg))
    peak = peak_gib(lambda: mt.batched_f0(batch, sr, cfg))[1] * 1024  # MiB above what was live, warmed
    fwd, bwd = VK.band_layout(n, band[0], band.rows), VK.backtrace_layout(n, band[0], band.rows)
    print(f"[11] batched_f0 pyin at resolution 0.01 on {tuple(batch.samples.shape)}: {n} bins, band h={band[0]} "
          f"rows {band.rows} (forward's in {fwd}, cluster {plan.g}, ranks {plan.bounds}; backtrace's in {bwd}), f0 "
          f"{tuple(f0.shape)}, voiced {float((f0 > 0).float().mean()):.3f}, launches {launches}; vs "
          f"viterbi_engine='plain' on the card: f0 and states identical {same}; end to end {e2e:.3f} ms, peak "
          f"memory above what was live before the call {peak:.1f} MiB ({card})")
    check(n == 3601 and band[0] == 215, "pyin's 3,601 bins at resolution 0.01")
    check(fwd == bwd == "toeplitz" and plan.g > 1, "pyin at resolution 0.01 in the toeplitz layout on a cluster")
    check(launches == {"viterbi_fwd_f32": 1, "viterbi_bwd_f32": 1}, "one launch of each Viterbi kernel at 3,601 bins")
    check(bool(torch.isfinite(f0).all()) and bool(valid.all()) and same, "pyin at resolution 0.01 vs the plain engine")
    design = Y.pyin_band
    Y.pyin_band = lambda *a: tuple(design(*a))  # the band without its window: the wide layouts
    try:
        f0_w = mt.batched_f0(batch, sr, cfg)[0]
        e2e_w = cuda_ms(lambda: mt.batched_f0(batch, sr, cfg), reps=3)
        peak_w = peak_gib(lambda: mt.batched_f0(batch, sr, cfg))[1] * 1024
    finally:
        Y.pyin_band = design
    print(f"[11] the same call with the band as a plain (h, C) pair (forward's in {VK.band_layout(n, band[0])}, "
          f"backtrace's in {VK.backtrace_layout(n, band[0])}, log_tri transposed): end to end {e2e_w:.3f} ms, peak "
          f"memory above what was live before the call {peak_w:.1f} MiB; f0 identical {torch.equal(f0_w, f0)} "
          f"({card})")
    check(torch.equal(f0_w, f0), "pyin at resolution 0.01 in the wide layouts")
    viterbi_times(args, band, "75-600 Hz", card)
    cfg6 = mt.F0Config(method="pyin", resolution=0.01, minPitch=65.406, maxPitch=2093.0)
    with spy(Y, "viterbi_decode") as calls:
        mt.batched_f0(batch, sr, cfg6)
    *args6, band6 = calls[0][0]
    check(args6[2].shape[0] == 6001 and band6.rows == (215, 5785), "pyin's 6,001 bins at C2-C7, resolution 0.01")
    viterbi_times(args6, band6, "C2-C7", card)


def viterbi_times(args: list, band, what: str, card: str) -> None:
    """Phase 11: both kernels timed on one pyin trellis, the forward at every
    cluster size with a plan (and the rule's) and in the wide layout (the
    band as a plain pair), beside their plain versions and bounds."""
    log_obs = args[0]
    n, h = args[2].shape[0], band[0]
    delta_f, hist = VK.viterbi_forward_reference(*args)
    rest = args[2:]
    b_f, b_b = viterbi_bounds(log_obs, hist, n, h)
    plain_f = cuda_ms(lambda: VK.viterbi_forward_reference(*args), 3)
    rule = VK.cluster_plan(n, h, band.rows).g
    for g in clusters_of(n, band):
        t_k = cuda_ms(lambda: VK.viterbi_forward(*args, band, cluster=g))
        print(f"[11] viterbi_fwd_f32 at {n} bins ({what}) on pyin's trellis {tuple(log_obs.shape)}, toeplitz, cluster "
              f"{g}{' (the rule)' if g == rule else ''}: {t_k:.3f} ms, plain {plain_f:.3f} ms, bound {b_f[0]:.3f} ms "
              f"({b_f[1]}; {b_f[0] / t_k:.2%}) ({card})")
    wide = tuple(band)
    t_w = cuda_ms(lambda: VK.viterbi_forward(*args, wide), 3)
    print(f"[11] viterbi_fwd_f32 at {n} bins ({what}), the band as a plain pair ({VK.band_layout(n, h)}): {t_w:.3f} ms "
          f"({b_f[0] / t_w:.2%} of the bound) ({card})")
    t_b = cuda_ms(lambda: VK.viterbi_backtrace(hist, delta_f, *rest, band))
    plain_b = cuda_ms(lambda: VK.viterbi_backtrace_reference(hist, delta_f, *rest), 3)
    t_bw = cuda_ms(lambda: VK.viterbi_backtrace(hist, delta_f, *rest, wide), 3)
    print(f"[11] viterbi_bwd_f32 at {n} bins ({what}) on that trellis: toeplitz {t_b:.3f} ms, the band as a plain pair "
          f"({VK.backtrace_layout(n, h)}) {t_bw:.3f} ms, plain {plain_b:.3f} ms, bound {b_b[0]:.3f} ms ({b_b[1]}; "
          f"{b_b[0] / t_b:.2%}) ({card})")


def backtrace_traps(kind: str, rng: np.random.Generator, dev, n: int = 361, h: int = 21, steps: int = 300,
                    batch: int = 3) -> tuple:
    """Crafted backtrace inputs on the card (tests/test_torch_viterbi.py's
    backtrace_traps at pyin's shape): (hist [B, steps, 2n], delta_f [B, 2n],
    log_tri [n, n], c_stay, c_sw, the designed path [B, steps + 1] on the
    host). Each row, from the last back, is made for the state the step
    after it takes, so that its first maximum is a trap: 'ties' (c_stay =
    −0, in-band entries −0, C = −10) an out-of-band source at a lower index
    tying the best in-band score, or −0 against +0 in band; 'rounding'
    (in-band −1, C = −1000) two out-of-band m of 0.5 − 2⁻¹⁷ and 0.5 whose
    sums with C round together, above the band."""
    dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    if kind == "ties":
        c_stay, c_sw, floor, inner, low = -0.0, -2.0, -10.0, -0.0, -40.0
    else:
        c_stay, c_sw, floor, inner, low = -1.0, -2.0, -1000.0, -1.0, -3000.0
    lt = np.where(dist <= h, np.float32(inner), np.float32(floor)).astype(np.float32)
    hist = np.full((batch, steps, 2 * n), low, np.float32)
    delta_f = np.full((batch, 2 * n), -100.0, np.float32)
    want = np.empty((batch, steps + 1), np.int64)
    for b in range(batch):
        state = int(rng.integers(2 * n))
        delta_f[b, state] = 0.0
        want[b, steps] = state
        for t in range(steps - 1, -1, -1):
            row, pos = hist[b, t], state % n
            adds = (c_stay, c_sw) if state < n else (c_sw, c_stay)

            def put(u: int, m: float, block: int) -> None:
                row[block * n + u] = np.float32(m - adds[block])

            block = int(rng.integers(2))
            if kind == "rounding":
                put(pos, -998.75, int(rng.integers(2)))
                u1, u2 = sorted(rng.choice(np.flatnonzero(dist[pos] > h), 2, replace=False))
                put(int(u1), 0.5 - 2.0**-17, block)
                put(int(u2), 0.5, int(rng.integers(2)))
                win = int(u1)
            elif pos > h and rng.random() < 0.5:
                put(pos, -1.0, int(rng.integers(2)))
                win = int(rng.integers(pos - h))
                put(win, 9.0, block)
            else:
                block = 0 if state < n else 1
                win, u2 = sorted(rng.choice(np.flatnonzero(dist[pos] <= h), 2, replace=False))
                row[block * n + win], row[block * n + u2] = np.float32(-0.0), np.float32(0.0)
                win = int(win)
            state = win + n * block
            want[b, t] = state
    return (torch.tensor(hist, device=dev), torch.tensor(delta_f, device=dev), torch.tensor(lt, device=dev),
            c_stay, c_sw, torch.tensor(want))


def state_agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int, int]:
    """(frames whose decoded state differs, of them where voicing differs, frames)."""
    g, w = got.cpu(), want.cpu()
    n_bins = Y.pyin_geometry(float(TRACK_SR)).n_bins
    return int((g != w).sum()), int(((g < n_bins) != (w < n_bins)).sum()), g.numel()


def pyin_path(dev, y_np: np.ndarray, batch: mt.AudioBatch) -> tuple[dict, tuple]:
    """Phase 12: the pyin path at full size. (launches, captured trellis)."""
    cfg = mt.F0Config(method="pyin")
    torch.cuda.reset_peak_memory_stats()
    reset(VK.LAUNCHES)
    with spy(Y, "viterbi_decode") as calls:
        f0, valid = mt.batched_f0(batch, TRACK_SR, cfg)
        torch.cuda.synchronize()
    launches = dict(VK.LAUNCHES)
    print(f"[12] batched_f0 pyin on {tuple(batch.samples.shape)}: f0 {tuple(f0.shape)}, voiced "
          f"{float((f0 > 0).float().mean()):.3f}, launches {launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == {"viterbi_fwd_f32": 1, "viterbi_bwd_f32": 1}, "one launch of each Viterbi kernel per call")
    check(bool(torch.isfinite(f0).all()) and bool(valid.all()), "finite pyin tracks, all frames valid")
    tracker = mt.PyinTracker(cfg, TRACK_SR).to(dev)
    f0_k, st_k = tracker(batch.samples, return_states=True)
    f0_p, st_p = tracker(batch.samples, return_states=True, viterbi_engine="plain")
    torch.cuda.synchronize()
    same = torch.equal(f0_k, f0_p) and torch.equal(st_k, st_p) and torch.equal(f0_k, f0)
    print(f"[12] vs viterbi_engine='plain' on the card: f0 and states identical {same} (bar: identical)")
    check(same, "pyin path vs the plain Viterbi engine")
    f0_c, st_c = mt.PyinTracker(cfg, TRACK_SR)(torch.tensor(y_np[:2]), return_states=True)
    diff, vflips, total = state_agreement(st_k[:2], st_c)
    flips, dmax, nboth = track_agreement(f0_k[:2], f0_c)
    print(f"[12] utterances 0-1 vs the CPU path: states differ on {diff} of {total} frames ({vflips} in voicing; "
          f"bar ≤ 0.1 %), max |Δf0| {dmax:.3e} Hz over {nboth} frames voiced in both")
    check(diff <= 1e-3 * total, "pyin path vs the CPU")
    *args, band = calls[0][0]
    first = VK.viterbi_decode(*args, band)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = VK.viterbi_decode(*args, band)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(again, first), "the decode of pyin's trellis again")
    print("[12] the decode of that call (band from the host design) under set_sync_debug_mode('error'): "
          "no device→host sync")

    y = y_np[0]
    raw = mt.F0Config(method="pyin", interpUnvoiced=None, outFilter=None)
    got, t = mt.extract_f0(y, TRACK_SR, raw)
    want, t_cpu = mt.extract_f0(y, TRACK_SR, raw, device="cpu")
    g, w = got.cpu().numpy(), want.numpy()
    n_diff = int(np.sum(np.isnan(g) != np.isnan(w)) + np.sum(np.abs(g - w) > 1e-3 * np.abs(w)))
    print(f"[12] extract_f0 pyin (raw) on 30 s: {g.shape[0]} frames on {got.device}, frames differing from the "
          f"CPU {n_diff} (bar ≤ 0.1 %)")
    check(got.device.type == "cuda" and np.array_equal(t, t_cpu) and n_diff <= 1e-3 * g.shape[0], "extract_f0 pyin")
    got, _ = mt.extract_f0(y, TRACK_SR, mt.F0Config(method="pyin"))
    want, _ = mt.extract_f0(y, TRACK_SR, mt.F0Config(method="pyin"), device="cpu")
    err = float(np.max(np.abs(got.cpu().numpy() - want.numpy())))
    print(f"[12] extract_f0 pyin (linear interp + iir) on 30 s vs CPU: max |Δ| {err:.3e} Hz "
          f"(bar 0.05 Hz when the raw tracks agree on every frame)")
    check(bool(torch.isfinite(got).all()) and (n_diff > 0 or err <= 0.05), "extract_f0 pyin, interpolated and filtered")
    return launches, calls[0][0]  # the trellis and its band


def traced_launches(events: list[dict]) -> tuple[list[dict], list[dict], int, int]:
    """(the kernel launches a Chrome trace holds after utils.obs's pad, the
    kernel events of those launches, the pad's launches, those of them
    whose kernel event is missing). Launches are the CUDA API's kernel
    launch calls, each paired with its kernel by correlation id; without a
    pad range every launch counts as the block's."""
    pad = [e for e in events if e.get("name") == PROFILER_PAD and e.get("cat") == "user_annotation"]
    pad_end = max((e["ts"] + e["dur"] for e in pad), default=float("-inf"))
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "Launch" in e.get("name", "") and "Kernel" in e.get("name", "")]
    kernels = {e["args"].get("correlation"): e for e in events if e.get("cat") == "kernel"}
    block = [e for e in calls if e["ts"] >= pad_end]
    pad_calls = [e for e in calls if e["ts"] < pad_end]
    lost_pad = sum(e["args"].get("correlation") not in kernels for e in pad_calls)
    traced = [kernels[e["args"]["correlation"]] for e in block if e["args"].get("correlation") in kernels]
    return block, traced, len(pad_calls), lost_pad


@contextmanager
def obs_events():
    """The utils.obs events logged while the block runs [(event, fields)],
    each still printed."""
    from modulation_mfcc_tpu_torch.utils import obs

    seen, log = [], obs.log_event

    def spy(event: str, **fields) -> None:
        seen.append((event, fields))
        log(event, **fields)

    obs.log_event = spy
    try:
        yield seen
    finally:
        obs.log_event = log


def trace_events(prof) -> list[dict]:
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
        return json.loads(Path(d, "trace.json").read_text())["traceEvents"]


def device_breakdown(fn, top: int = 10) -> tuple[float, list[tuple[str, float]], int, int, tuple[int, int]]:
    """(device-busy ms, the ``top`` kernels by device time [(name, ms)], the
    call's kernel launches, the kernel events traced of them, (the pad's
    launches, those the profiler lost)) of one call of ``fn`` inside
    utils.obs.kernel_profile, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    with kernel_profile() as prof:
        fn()
    launched, kernels, pad, lost_pad = traced_launches(trace_events(prof))
    by_name: dict[str, float] = {}
    for k in kernels:
        by_name[k["name"][:70]] = by_name.get(k["name"][:70], 0.0) + k["dur"] / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(by_name.values()), ranked[:top], len(launched), len(kernels), (pad, lost_pad)


def pyin_times(batch: mt.AudioBatch, captured: tuple, card: str):
    """Phase 13: (kernel ms pairs, kernel errors at full size, bounds)."""
    hours = TRACK_BATCH * SECONDS / 3600.0
    *args, band = captured
    fwd_err, bwd_err, (delta_f, hist) = viterbi_compare(args, band)
    rest = args[2:]
    check(fwd_err == 0.0 and bwd_err == 0.0, "Viterbi kernels at full size")
    ms = {
        "viterbi_fwd_f32": (cuda_ms(lambda: VK.viterbi_forward(*args, band)),
                            cuda_ms(lambda: VK.viterbi_forward_reference(*args))),
        "viterbi_bwd_f32": (cuda_ms(lambda: VK.viterbi_backtrace(hist, delta_f, *rest, band)),
                            cuda_ms(lambda: VK.viterbi_backtrace_reference(hist, delta_f, *rest))),
    }
    for k, (t_k, t_p) in ms.items():
        print(f"[13] {k}: {t_k:.3f} ms, plain {t_p:.3f} ms ({card})")
    g = torch.Generator(device=args[0].device).manual_seed(13)
    tri = torch.rand(args[2].shape, generator=g, device=args[0].device)
    dense_tri = torch.log(tri / tri.sum(0) + 1e-30)
    h_dense = VK.viterbi_band(dense_tri)[0]
    check(VK.band_layout(dense_tri.shape[0], h_dense) == "L2", "a random transition is read from L2")
    dense_ms = cuda_ms(lambda: VK.viterbi_forward(args[0], args[1], dense_tri, *args[3:]))
    print(f"[13] viterbi_fwd_f32 on pyin's observations with a random dense transition (h={h_dense}, log_tri from "
          f"L2), the dense recursion: {dense_ms:.3f} ms ({card})")
    del tri, dense_tri
    cfg = mt.F0Config(method="pyin")
    torch.cuda.reset_peak_memory_stats()
    stages = [(Y, "_sliding_cmndf"), (Y, "pyin_observations"), (VK, "viterbi_forward"), (VK, "viterbi_backtrace")]
    e2e, parts = path_ms(lambda: mt.batched_f0(batch, TRACK_SR, cfg), stages)
    peak = torch.cuda.max_memory_allocated() / 2**30
    split = ", ".join(f"{name} {t:.3f} ms ({t / e2e:.1%})" for name, t in parts.items())
    print(f"[13] batched_f0 pyin end to end: {e2e:.3f} ms = {hours / (e2e / 1e3):.3f} audio-h/s; within it {split}, "
          f"the rest {e2e - sum(parts.values()):.3f} ms; peak memory {peak:.2f} GiB ({card})")

    with obs_events() as seen:
        busy, top, launched, traced, (pad, lost_pad) = device_breakdown(lambda: mt.batched_f0(batch, TRACK_SR, cfg))
    reported = sum(f["lost"] for e, f in seen if e == "profile.kernel_records_lost")
    print(f"[13] torch.profiler (utils.obs.kernel_profile), one batched_f0 pyin call: device busy {busy:.3f} ms; "
          f"{traced} of its {launched} kernel launches traced (the window's pad of {pad} launches lost {lost_pad}; "
          f"records lost as reported {reported}); "
          f"by kernel: "
          + "; ".join(f"{name} {t:.3f} ms" for name, t in top))
    check_late(launched > 0 and (traced < launched) == (reported > 0),
               "phase 13's profile holds every kernel the call launched, or says it lost some")

    log_obs, _, log_tri = args[:3]
    nb, nf, two_n = log_obs.shape
    n = two_n // 2
    state_bytes = nb * two_n * 4
    h = band[0]
    v = np.arange(n)
    pairs = int((np.minimum(n - 1, v + h) - np.maximum(0, v - h) + 1).sum())  # (u, v) within the band
    io_bytes = log_obs.numel() * 4 + 2 * state_bytes + hist.numel() * 4
    # per step: an add and a max per band pair and half; per target and half the fl(gmax + C) term, the
    # observation and m (6 ops), and the max that forms gmax
    fwd_banded = bound(io_bytes + pairs * 4, nb * (nf - 1) * (4 * pairs + 18 * n))
    fwd_dense = bound(io_bytes + log_tri.numel() * 4, nb * (nf - 1) * (4 * n * n + 8 * n))
    print(f"[13] viterbi_fwd_f32 bounds: the banded work (h={h}, {pairs} band pairs, the band in "
          f"{VK.band_layout(n, h)}) {fwd_banded[0]:.3f} ms "
          f"({fwd_banded[1]}); the dense function {fwd_dense[0]:.3f} ms ({fwd_dense[1]}); the kernel "
          f"{ms['viterbi_fwd_f32'][0]:.3f} ms = {fwd_banded[0] / ms['viterbi_fwd_f32'][0]:.1%} of the banded bound "
          f"({card})")
    bounds = {
        "viterbi_fwd_f32": fwd_banded,
        "viterbi_bwd_f32": bound(hist.numel() * 4 + state_bytes + pairs * 4 + nb * nf * 4,
                                 nb * (nf - 1) * 5 * n),
    }
    return ms, {"viterbi_fwd_f32": fwd_err, "viterbi_bwd_f32": bwd_err}, bounds


# ---------------------------------------------------------------------------
# Frontend modes and the corpus sweep (phases 14-17)
# ---------------------------------------------------------------------------


def mode_weights(cfg: mt.MfccConfig, alg: str, dev) -> dict:
    """The mode's mode_tensors at this geometry, with the tensor-core
    layouts for 'f32' where it takes the FFT kernel too (tc_f32 launches the
    tensor-core kernel beside it)."""
    w = ff.mode_tensors(alg, dev, cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq,
                        cfg.maxFreq, hop=cfg.hop_length)
    return w | ff.tc_layouts(alg, w) if alg == "f32" else w


def mode_kernel(audio, cfg, alg, w, n_samples=None):
    return ff.fused_mel_frontend(
        audio, sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length,
        algorithm=alg, n_samples=n_samples, weights=w,
    )


def mode_plain(audio, cfg, alg, w, n_samples=None):
    return ff.fused_mel_frontend_reference(
        audio, w["planes"] if alg in ("i16", "i24") else w["wri"], w["melw"], hop=cfg.hop_length,
        eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length), algorithm=alg, n_samples=n_samples,
        sw=w.get("sw"), corr=w.get("corr"),
    )


def rows_of(pcm: np.ndarray, cfg: mt.MfccConfig, dev) -> torch.Tensor:
    return torch.tensor(ff.pack_hop_rows(pcm, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length),
                        device=dev)


def bf16_ulps(mel_k: torch.Tensor, mel_p: torch.Tensor) -> tuple[float, float]:
    """(max |kernel − plain| of two bf16 mels in units of the plain value's
    bf16 ulp, 2^(e−8) for a value m·2^e with m in [0.5, 1); share of entries
    more than one ulp apart)."""
    k, p = mel_k.float(), mel_p.float()
    ulp = torch.ldexp(torch.ones_like(p), torch.frexp(p)[1] - 8)
    d = (k - p).abs()
    u = torch.where(p > 0, d / ulp, torch.where(d > 0, torch.inf, 0.0))
    return float(u.max()), float((u > 1.0).float().mean())


def x3_exact_mel(audio: torch.Tensor, cfg: mt.MfccConfig, w: dict, n_samples: int | None = None) -> torch.Tensor:
    """The mel of the x3 arithmetic with every sum taken in float64: the
    frames and the basis split into bf16 (hi, lo) as the mode splits them,
    hi·Whi + hi·Wlo + lo·Whi summed in float64, the power rounded to
    float32 and split, and the mel's three products summed in float64; one
    utterance at a time. Audio as the frontends take it."""
    from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
    from modulation_mfcc_tpu_torch.utils.helpers import dequantize_samples

    bsz, hop = audio.shape[0], cfg.hop_length
    k, bins = w["wri"].shape[-2], w["melw"].shape[-2]
    if audio.ndim == 3:
        t, flat, left = n_samples, dequantize_samples(audio).reshape(bsz, -1), 0
    else:
        t, flat, left = audio.shape[1], dequantize_samples(audio), ff.eff_pad(cfg.n_fft, cfg.win_length)
    nf = 1 + t // hop
    right = max(0, (nf - 1) * hop + k - left - flat.shape[1])

    def x3(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
        hi = x.to(torch.bfloat16).float()
        lo = (x - hi).to(torch.bfloat16).double()
        hi, planes = hi.double(), planes.double()
        return (hi @ planes[0] + hi @ planes[1]) + lo @ planes[0]

    out = []
    for b in range(bsz):
        reim = x3(frame_by_slices(tnf.pad(flat[b : b + 1], (left, right)), 0, nf, k, hop), w["wri"])
        out.append(x3((reim[..., :bins] ** 2 + reim[..., bins:] ** 2).float(), w["melw"]))
    return torch.cat(out)


def rel_above_floor(mel: torch.Tensor, ref: torch.Tensor) -> float:
    """Max relative error of ``mel`` against ``ref`` over the entries of
    ``ref`` above 1e-8 of its utterance's peak (the top_db floor)."""
    live = ref > (ref.amax(dim=(1, 2)) * 1e-8)[:, None, None]
    rel = (mel.double() - ref).abs() / torch.where(live, ref, torch.ones_like(ref))
    return float(torch.where(live, rel, torch.zeros_like(rel)).max())


def plain64(audio: torch.Tensor, cfg: mt.MfccConfig, w: dict, n_samples: int | None = None):
    """fused_mel_f32's plain version evaluated in float64: the same function
    (fused_mel_frontend_reference, the DFT in 16-row steps) on the same
    float32 samples and weights, widened exactly."""
    from modulation_mfcc_tpu_torch.utils.helpers import dequantize_samples

    return ff.fused_mel_frontend_reference(
        dequantize_samples(audio).double(), w["wri"].double(), w["melw"].double(), hop=cfg.hop_length,
        eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length), n_samples=n_samples,
    )


def mode_error_ok(alg: str, mel_k, bmax_k, mel_p, bmax_p, exact=None) -> tuple[bool, str]:
    """Phase 2's bars (mel ≤ 1e-4 relative above the top_db floor, peak ≤
    1e-5) for i16 and i24, whose power is the plain version's to f32
    rounding (bit for bit).

    fused_mel_f32 and fused_mel_fold_f32 (``exact`` given: plain64, or
    fold64, of the same input, the plain version's (mel, block maxima) in
    float64) run an exact three-plane bf16 split on the tensor cores (the
    TPU's own f32, Precision.HIGHEST), whose products are exact and whose
    hi·hi step sums round far less than the plain version's FP32 GEMMs.
    Where a bin's power is 80 dB below its utterance's peak, FP32 leaves the plain
    version several times further from float64 than the split (each
    distance is printed), so the two differ there by more than 1e-4 though
    the kernel is the nearer. Its mel bar is therefore stated against the float64 evaluation:
    the kernel no further from it than the plain version (above the floor);
    its peak bar stays 1e-5 of the plain version's. x3 splits the power into bf16 hi
    and lo before the mel projection: a one-ulp f32 difference in a bin's
    power (the DFT's sum order) can move the split, which changes that
    product's dropped lo·lo term and lo's rounding by up to 2^-17 of the
    bin's share: peak bar 2^-16. For bf16 the power is rounded to bf16
    before the mel projection, so an f32 sum-order difference of 1e-7 in the
    DFT can move one bin's power by a bf16 ulp (2^-8), which moves the mel
    bands it dominates by up to one ulp more, and the peak (taken before the
    mel's own rounding) by up to 2^-8: bars 2 ulps, at most 0.1 % of entries
    beyond 1 ulp, and a peak within 2^-8.

    fused_mel_x3 and fused_mel_fold_x3 (``exact`` given: x3_exact_mel, or
    x3_exact_fold_mel, of the same input) run on
    the tensor cores, which sum each 16-row MMA in an order and rounding of
    their own; the plain versions sum in cuBLAS FP32 GEMMs. At the top_db
    floor each of the two is up to ~2e-4 from the float64 sums of the same
    x3 products (measured on the H100 at 16 kHz, phases 14 and 17: plain
    1.7e-4 on 4 × 30 s and 2.3e-4 on 128 × 30 s, the kernel 1.3e-4 and
    1.7e-4), so the two differ by up to the sum of both, beyond 1e-4. Its mel bar is therefore
    restated against those float64 sums: the kernel no further from them
    than twice the plain version; its peak bar stays 2^-16 of the plain
    version's. The x3 fold's half-length sums leave its plain version
    7.9e-5 and the kernel 1.1e-4 from float64 on 4 × 30 s at 16 kHz (the
    H100), 1.2e-4 apart: the same restated bar holds it."""
    mel_rel, peak_rel, _ = mel_errors(mel_k.float(), bmax_k, mel_p.float(), bmax_p)
    if alg == "f32" and exact is not None:
        rel_k, peak_k, _ = mel_errors(mel_k, bmax_k, *exact)
        rel_p, peak_p, _ = mel_errors(mel_p, bmax_p, *exact)
        return rel_k <= rel_p and peak_rel <= 1e-5, (
            f"against the plain version in float64: kernel mel rel err {rel_k:.3e}, peak {peak_k:.3e}; plain "
            f"{rel_p:.3e}, peak {peak_p:.3e} (bar: kernel ≤ plain); against the plain version: mel rel err "
            f"{mel_rel:.3e}, peak rel err {peak_rel:.3e} (bar 1e-5)")
    if alg == "x3" and exact is not None:
        rel_k, rel_p = rel_above_floor(mel_k, exact), rel_above_floor(mel_p, exact)
        return rel_k <= 2.0 * rel_p and peak_rel <= 2.0**-16, (
            f"mel rel err {mel_rel:.3e}; against the float64 sums of the same x3 products: kernel {rel_k:.3e}, "
            f"plain {rel_p:.3e} (bar: kernel ≤ 2 × plain); peak rel err {peak_rel:.3e} (bar 2^-16)")
    if alg == "x3":
        return mel_rel <= 1e-4 and peak_rel <= 2.0**-16, (f"mel rel err {mel_rel:.3e} (bar 1e-4), peak rel err "
                                                          f"{peak_rel:.3e} (bar 2^-16)")
    if alg == "bf16":
        ulps, share = bf16_ulps(mel_k, mel_p)
        ok = ulps <= 2.0 and share <= 1e-3 and peak_rel <= 2.0**-8
        return ok, (f"mel {ulps:.2f} bf16 ulp (bar 2), {share:.2e} of entries beyond 1 ulp (bar 1e-3), "
                    f"peak rel err {peak_rel:.3e} (bar 2^-8)")
    return mel_rel <= 1e-4 and peak_rel <= 1e-5, (f"mel rel err {mel_rel:.3e} (bar 1e-4), peak rel err "
                                                   f"{peak_rel:.3e} (bar 1e-5)")


def float64_mel(audio: torch.Tensor, cfg: mt.MfccConfig, n_samples: int | None = None):
    """(mel, block maxima) of the 'f32' frontend's function in float64 from
    float64 constants, fused_mel_fft_f32's yardstick: the same float32 (or
    dequantised int16) samples, centred frames, the float64 analysis
    window, cuFFT's float64 rfft, the power, and the design's mel weights
    (their float32 values, widened) over every bin; 16 utterances at a
    time."""
    from modulation_mfcc_tpu_torch.utils.helpers import dequantize_samples

    x = dequantize_samples(audio)
    if x.ndim == 3:  # hop rows: the audio sits at eff_pad
        pad = ff.eff_pad(cfg.n_fft, cfg.win_length)
        x = x.reshape(x.shape[0], -1)[:, pad : pad + n_samples]
    window = torch.tensor(analysis_window(cfg.n_fft, "hann", cfg.win_length), dtype=torch.float64, device=x.device)
    bank = mel_filterbank(cfg.signal_sample_rate, cfg.n_fft, cfg.n_mels, cfg.minFreq, cfg.maxFreq)
    mel_t = torch.tensor(bank.astype(np.float32).T, device=x.device).double()
    return ff._with_block_max(torch.cat([library_mel(x[i : i + 16].double(), cfg, window, mel_t)
                                         for i in range(0, x.shape[0], 16)]))


def fft_error_ok(mel_k, bmax_k, mel_p, bmax_p, exact) -> tuple[bool, str]:
    """fused_mel_fft_f32's bars against ``exact`` (float64_mel: the
    function in float64 from float64 constants): above the top_db floor its
    mel within 1e-4 relative of it and no further from it than the plain
    version (the stepped FP32 DFT); its peak within 1e-6 of it, and within
    1e-5 of the plain version's (the f32 mode's peak bar). The kernel's FFT
    runs in FP64, so it is the float64 function to the float32 rounding of
    its power and mel sum (~3e-7 above the floor on the CPU tests' signals),
    where the plain version, and an FFT in FP32, land 1e-4 to 5e-4 away."""
    rel_k, peak_k, _ = mel_errors(mel_k, bmax_k, *exact)
    rel_p, peak_p, _ = mel_errors(mel_p, bmax_p, *exact)
    peak_rel = mel_errors(mel_k.float(), bmax_k, mel_p.float(), bmax_p)[1]
    return rel_k <= min(1e-4, rel_p) and peak_k <= 1e-6 and peak_rel <= 1e-5, (
        f"against the float64 function: mel rel err above the top_db floor kernel {rel_k:.3e}, plain {rel_p:.3e} "
        f"(bar: kernel ≤ 1e-4 and ≤ plain), peak kernel {peak_k:.3e} (bar 1e-6), plain {peak_p:.3e}; against the "
        f"plain version: peak rel err {peak_rel:.3e} (bar 1e-5)")


def is_pow2(s: torch.Tensor) -> bool:
    return bool((torch.frexp(s)[0] == 0.5).all())


def mode_kernel_checks(dev) -> None:
    """Phase 14: every frontend kernel against its plain version on float32,
    int16 and int16 hop-rows input at both configurations."""
    for name, cfg in (("10k default (packed Nyquist)", DEFAULT_10K), ("16k fmax 8k", FLAGSHIP)):
        sr = cfg.signal_sample_rate
        y = speechlike(4, SECONDS * sr, sr, seed=1) * 0.5
        pcm = np.round(y * 32767.0).astype(np.int16)
        quiet = np.random.default_rng(7).integers(-33, 34, (1, SECONDS * sr)).astype(np.int16)  # about -60 dBFS
        n = pcm.shape[1]
        inputs = {
            "float32": (torch.tensor(y, device=dev), None),
            "int16": (torch.tensor(pcm, device=dev), None),
            "int16 rows": (rows_of(pcm, cfg, dev), n),
            "quiet int16 rows": (rows_of(quiet, cfg, dev), n),
        }
        exact = {}  # x3: the float64 sums of its products, per distinct input (int16 flat and rows are one)
        for alg in ("f32",) + MODES:
            w = mode_weights(cfg, alg, dev)
            flat_k = None
            for label, (x, ns) in inputs.items():
                if (alg == "f32" and label == "float32") or (label.startswith("quiet") and alg != "i16"):
                    continue  # f32 on float32 is phase 2; the quiet utterance is the i16 mode's worst case
                mel_k, bmax_k = mode_kernel(x, cfg, alg, w, ns)
                mel_p, bmax_p = mode_plain(x, cfg, alg, w, ns)
                torch.cuda.synchronize()
                fft = alg == "f32" and f32_kernel(cfg) == "fused_mel_fft_f32"
                ex = (float64_mel(x, cfg, ns) if fft else plain64(x, cfg, w, ns)) if alg == "f32" else None
                if alg == "x3":
                    key = "float32" if label == "float32" else "int16"
                    if key not in exact:
                        exact[key] = x3_exact_mel(x, cfg, w, ns)
                    ex = exact[key]
                ok, text = (fft_error_ok if fft else partial(mode_error_ok, alg))(mel_k, bmax_k, mel_p, bmax_p, ex)
                extra = ""
                if label == "int16":
                    flat_k = (mel_k, bmax_k)
                elif label == "int16 rows":
                    same = torch.equal(mel_k, flat_k[0]) and torch.equal(bmax_k, flat_k[1])
                    extra = f"; identical to the flat int16 launch {same}"
                    ok = ok and same
                if alg == "i16":
                    sc = ff.quant_scales(x, "i16", w["sw"])
                    extra += f"; s16 powers of two {is_pow2(sc[:, 0])} ({sc[:, 0].tolist()})"
                    ok = ok and is_pow2(sc[:, 0])
                kname = kernel_of(alg, cfg)
                print(f"[14] {name}: {kname} on {label} {tuple(x.shape)} vs plain: {text}{extra}")
                check(ok, f"{kname} {name} {label}")


def modes_path(dev) -> tuple[dict, torch.Tensor, int]:
    """Phase 15: (launches per kernel in one mfcc_change call, the int16
    rows batch, its n_samples)."""
    cfg = FLAGSHIP
    sr = cfg.signal_sample_rate
    pcm = np.round(speechlike(BATCH, SECONDS * sr, sr, seed=0) * 0.5 * 32767.0).astype(np.int16)
    n = pcm.shape[1]
    rows = rows_of(pcm, cfg, dev)
    print(f"[15] int16 hop rows {tuple(rows.shape)} ({rows.numel() * 2 / 1e6:.1f} MB) of [{BATCH}, {n}]")
    y64 = torch.tensor(pcm, device=dev).double() / 32768.0
    want = mt.mfcc_change(y64, cfg, spectrum="fft")
    del y64
    launches = {}
    for alg in ("f32",) + MODES:
        reset(ff.LAUNCHES)
        tot = mt.mfcc_change(rows, cfg, spectrum=SPECTRUM[alg], n_samples=n)
        torch.cuda.synchronize()
        counts = dict(ff.LAUNCHES)
        kname = kernel_of(alg, cfg)
        launches[kname] = counts[kname]
        others = {k: v for k, v in counts.items() if k not in (kname, "mfcc_tail_f32")}
        err = float((tot.double() - want).abs().max())
        bar = 1e-1 if alg == "bf16" else 1e-4
        print(f"[15] mfcc_change spectrum={SPECTRUM[alg]!r} on the rows: launches {kname} {counts[kname]}, "
              f"mfcc_tail_f32 {counts['mfcc_tail_f32']}; vs the float64 'fft' path max-abs {err:.3e} (bar {bar:g})")
        check(counts[kname] == 1 and counts["mfcc_tail_f32"] == 1 and not any(others.values()),
              f"one launch of {kname} per mfcc_change call")
        check(tot.shape == want.shape and bool(torch.isfinite(tot).all()) and err <= bar, f"{SPECTRUM[alg]} vs fft")
    del want, tot

    rng = np.random.default_rng(15)
    lens = rng.integers(int(1.5 * sr), int(9.0 * sr), 8)
    lens[0] = int(8.5 * sr)  # one utterance on the masked-FIR route per file
    t_pad = int(-(-lens.max() // 16_384) * 16_384)
    src = np.round(speechlike(8, t_pad, sr, seed=151) * 0.5 * 32767.0).astype(np.int16)
    ragged = np.zeros((8, t_pad), np.int16)
    for i, m in enumerate(lens):
        ragged[i, :m] = src[i, :m]
    r_rows = rows_of(ragged, cfg, dev)
    lengths = torch.tensor(lens, device=dev)
    for alg in ("f32",) + MODES:
        spec = SPECTRUM[alg]
        tot, mask = batched_mfcc_change(mt.AudioBatch(r_rows, lengths), cfg, spectrum=spec, masked_fir=False,
                                        n_samples=t_pad)
        err = 0.0
        for i, m in enumerate(lens):
            single, _ = mt.extract_mfcc_change(src[i, :m].astype(np.float32) / 32768.0, cfg, spectrum=spec,
                                               device=dev)
            nf = single.shape[0]
            err = max(err, float((tot[i, :nf] - single).abs().max()))
            check(float(mask[i].sum()) == nf and not bool(tot[i, nf:].any()), f"ragged batch item {i} frames")
        print(f"[15] ragged masked batch (8 utterances, {lens.min() / sr:.2f}-{lens.max() / sr:.2f} s, scan filters) "
              f"spectrum={spec!r} vs per-file extract_mfcc_change: max-abs {err:.3e} (bar 1e-5)")
        check(err <= 1e-5, f"ragged batch {spec} vs per-file")
    return launches, rows, n


def write_corpus(root: str, n_files: int, sr: int, seed: int, max_s: float = 35.0) -> tuple[list[str], float]:
    """``n_files`` 16-bit WAVs of speech-like audio with seeded lengths of
    1.5-35 s (mean about 12.5 s, LibriSpeech's range); (paths, hours)."""
    import scipy.io.wavfile as wavfile

    rng = np.random.default_rng(seed)
    secs = np.clip(rng.gamma(2.2, 5.7, n_files), 1.5, max_s)
    paths = []
    for i, s in enumerate(secs):
        y = speechlike(1, int(s * sr), sr, seed=seed + 1 + i)[0] * 0.5
        p = os.path.join(root, f"spk{i % 16:02d}", f"utt{i:04d}.wav")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        wavfile.write(p, sr, np.round(y * 32767.0).astype(np.int16))
        paths.append(p)
    return paths, float(secs.sum()) / 3600.0


def sweep_phase(dev, card: str) -> None:
    """Phase 16: the corpus sweep on the card, three spectra, resume, and
    its records against per-file extract_mfcc_change."""
    from modulation_mfcc_tpu_torch.io.wav import load_channel
    from modulation_mfcc_tpu_torch.parallel.corpus import _output_names

    cfg = FLAGSHIP
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths, hours = write_corpus(os.path.join(tmp, "wav"), 256, cfg.signal_sample_rate, seed=16)
        print(f"[16] wrote {len(paths)} int16 WAVs, {hours:.4f} h of audio, in {time.perf_counter() - t0:.3f} s")
        names = _output_names(paths)
        picks = [int(i) for i in np.random.default_rng(161).choice(len(paths), 12, replace=False)]
        for spec in ("fused_i16", "fused_bf16", "fused"):
            out = os.path.join(tmp, spec)
            reset(ff.LAUNCHES)
            rep = sweep_mfcc_change(paths, CorpusSweep(out, cfg=cfg, spectrum=spec, device=dev))
            kname = kernel_of(SPECTRUM_ALG[spec], cfg)
            n_launch = ff.LAUNCHES[kname]
            print(f"[16] sweep {spec!r}: {rep['items']} files, {rep['audio_hours']} h in {rep['elapsed_sec']} s = "
                  f"{rep['audio_hours_per_sec']} audio-h/s; {kname} launches {n_launch}; stages {rep['stages']} "
                  f"({card})")
            check(rep["items"] == len(paths) and n_launch > 0, f"sweep {spec} ran every file through {kname}")
            again = sweep_mfcc_change(paths, CorpusSweep(out, cfg=cfg, spectrum=spec, device=dev))
            check(again["items"] == 0, f"resumed sweep {spec} skips every finished file")
            err = 0.0
            for i in picks:
                rec = np.load(os.path.join(out, names[paths[i]]))
                y = load_channel(paths[i], cfg.signal_sample_rate).astype(np.float32)
                single, t = mt.extract_mfcc_change(y, cfg, spectrum=spec, device=dev)
                check(np.array_equal(rec["times"], t) and rec["mod_cepstr"].shape == tuple(single.shape),
                      f"sweep record {i} layout")
                err = max(err, float(np.abs(rec["mod_cepstr"] - single.cpu().numpy()).max()))
            print(f"[16] resume: second run processed {again['items']} files; {len(picks)} records vs per-file "
                  f"extract_mfcc_change: max-abs {err:.3e} (bar 1e-5)")
            check(err <= 1e-5, f"sweep {spec} records vs per-file")
        py = sweep_mfcc_change(paths, CorpusSweep(os.path.join(tmp, "python_loader"), cfg=cfg, spectrum="fused",
                                                  device=dev, use_native_loader=False))
        print(f"[16] decode_busy_s of the 'fused' sweep: native loader (the default) {rep['stages']['decode_busy_s']} "
              f"s, Python reader {py['stages']['decode_busy_s']} s; the Python reader's sweep "
              f"{py['audio_hours_per_sec']} audio-h/s, stages {py['stages']} ({card})")


def modes_times(dev, rows: torch.Tensor, n: int, launches: dict, card: str) -> list[dict]:
    """Phase 17: the kernel rows of the four frontend modes."""
    cfg = FLAGSHIP
    hours = BATCH * SECONDS / 3600.0
    out = []
    model = mt.MfccChange(cfg).to(dev)
    for alg in MODES:
        kname = f"fused_mel_{alg}"
        w = mode_weights(cfg, alg, dev)
        mel_k, bmax_k = mode_kernel(rows, cfg, alg, w, n)
        mel_p, bmax_p = mode_plain(rows, cfg, alg, w, n)
        ex = x3_exact_mel(rows, cfg, w, n) if alg == "x3" else None
        ok, text = mode_error_ok(alg, mel_k, bmax_k, mel_p, bmax_p, ex)
        del ex
        err = float((mel_k.float() - mel_p.float()).abs().max())
        print(f"[17] {kname} at full size vs plain: {text}; max-abs {err:.3e}")
        check(ok, f"{kname} at full size")
        del mel_p, bmax_p
        t_k = kernel_ms(lambda: mode_kernel(rows, cfg, alg, w, n))
        torch.cuda.empty_cache()
        t_p = kernel_ms(lambda: mode_plain(rows, cfg, alg, w, n))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        e2e = cuda_ms(lambda: model(rows, spectrum=SPECTRUM[alg], n_samples=n))
        peak = torch.cuda.max_memory_allocated() / 2**30
        bsz, nf, n_mels = mel_k.shape
        k = (w["planes"] if alg in ("i16", "i24") else w["wri"]).shape[-2]
        bins = w["melw"].shape[-2]
        two_bins = 2 * bins
        dft = 2.0 * bsz * nf * k * two_bins  # one K-row pass
        mel_ops = 2.0 * bsz * nf * bins * n_mels
        t_ops = {"bf16": (dft + mel_ops) / PEAK_BF16_S, "x3": 3 * (dft + mel_ops) / PEAK_BF16_S,
                 "i16": 5 * dft / PEAK_INT8_S + 3 * mel_ops / PEAK_BF16_S,
                 "i24": 6 * dft / PEAK_INT8_S + 3 * mel_ops / PEAK_BF16_S}[alg] * 1e3
        n_bytes = (rows.numel() * rows.element_size() + sum(v.numel() * v.element_size() for v in w.values())
                   + mel_k.numel() * mel_k.element_size() + bmax_k.numel() * 4)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        b = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"[17] {kname}: {t_k:.3f} ms, plain {t_p:.3f} ms, bound {b[0]:.3f} ms ({b[1]}); mfcc_change "
              f"spectrum={SPECTRUM[alg]!r} on the rows end to end {e2e:.3f} ms = {hours / (e2e / 1e3):.3f} audio-h/s, "
              f"peak memory {peak:.2f} GiB ({card})")
        out.append(kernel_row(kname, launches[kname], err, (t_k, t_p), b))
        del mel_k, bmax_k
        torch.cuda.empty_cache()
    w = mode_weights(cfg, "f32", dev)
    mel_k, bmax_k = mode_kernel(rows, cfg, "f32", w, n)
    t_k = kernel_ms(lambda: mode_kernel(rows, cfg, "f32", w, n))
    t_tc = kernel_ms(lambda: tc_f32(rows, cfg, w, n))
    bsz, nf, n_mels = mel_k.shape
    n_bytes = rows.numel() * 2 + (w["wri"].numel() + w["melw"].numel()) * 4 + mel_k.numel() * 4 + bmax_k.numel() * 4
    b = split3_bound(n_bytes, bsz * nf, w["wri"].shape[0], w["melw"].shape[0], n_mels, dft_passes=5)
    b_fft = least_work_bound(cfg, bsz * nf, rows.numel() * 2 + mel_k.numel() * 4)
    print(f"[17] {f32_kernel(cfg)} on the rows: {t_k:.3f} ms, least-work bound {b_fft[0]:.4f} ms ({b_fft[1]}), "
          f"{b_fft[0] / t_k:.1%} of it; fused_mel_f32 {t_tc:.3f} ms, bound {b[0]:.3f} ms ({b[1]}; five bf16 passes "
          f"of the DFT, six of the mel), {b[0] / t_tc:.1%} of it ({card}; {sm_clock()})")
    del mel_k, bmax_k
    e2e = cuda_ms(lambda: model(rows, spectrum="fused", n_samples=n))
    print(f"[17] mfcc_change spectrum='fused' on the rows end to end {e2e:.3f} ms = "
          f"{hours / (e2e / 1e3):.3f} audio-h/s ({card})")
    return out


def frontend_modes(dev, card: str) -> list[dict]:
    """Phases 14-17; the kernel rows of the four frontend modes."""
    mode_kernel_checks(dev)
    launches, rows, n = modes_path(dev)
    torch.cuda.empty_cache()
    sweep_phase(dev, card)
    torch.cuda.empty_cache()
    return modes_times(dev, rows, n, launches, card)


# ---------------------------------------------------------------------------
# The folded frontend, long-form and the modulation spectrum (phases 18-22)
# ---------------------------------------------------------------------------


def fold_weights(cfg: mt.MfccConfig, alg: str, dev) -> dict:
    return ff.fold_tensors(alg, dev, cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels,
                           cfg.minFreq, cfg.maxFreq)


def fold_kernel(audio, cfg, alg, w):
    return ff.fused_mel_frontend(
        audio, sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length,
        algorithm=alg, weights=w, fold=True,
    )


def fold_plain(audio, cfg, alg, w):
    return ff.fused_mel_fold_reference(audio, w["wc"], w["ws"], w["melw"], hop=cfg.hop_length,
                                       eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length), algorithm=alg)


# Phase 18's geometries beyond the flagship's, where fold_plan takes 32
# frames a block for f32 and x3, whose FFMA kernels' spans overflowed shared
# memory there: 32 kHz with tStep 0.01 and winLen 0.04, JAX's own fold
# example of hop 384 with a 3,840-sample window at n_fft 4096 (here at 48
# kHz), and 48 kHz with tStep 0.015 and winLen 0.03, a span of 46,801
# samples (C8), which the f32 fold fits with one buffer of s and d planes
# and the bf16 fold's FFMA block by staging it as bf16
FOLD_COMPACT = (("32 kHz, hop 320, window 1280", mt.MfccConfig(signal_sample_rate=32_000, tStep=0.01, winLen=0.04,
                                                               n_fft=2048)),
                ("48 kHz, hop 384, window 3840", mt.MfccConfig(signal_sample_rate=48_000, tStep=0.008, winLen=0.08,
                                                               n_fft=4096)),
                ("48 kHz, hop 720, window 1440", mt.MfccConfig(signal_sample_rate=48_000, tStep=0.015, winLen=0.03,
                                                               n_fft=2048)))


def fold_plan_text(cfg: mt.MfccConfig, alg: str) -> str:
    if alg not in TC_FOLDS:
        return "FFMA"
    plan = ff.fold_plan(alg, cfg.hop_length, cfg.win_length, cfg.n_mels)
    return f"plan {plan.frames}/{plan.stages}/{plan.buffers} {tuple(plan)}"


def x3_exact_fold_mel(audio: torch.Tensor, cfg: mt.MfccConfig, w: dict) -> torch.Tensor:
    """The fold counterpart of x3_exact_mel: the mel of the folded x3
    arithmetic with every sum taken in float64. s and d as the plain version
    forms them (fold_operands, float32), split into bf16 (hi, lo); hi·Whi +
    hi·Wlo + lo·Whi against wc and ws summed in float64; the power rounded
    to float32 and split; the mel's three products summed in float64; one
    utterance at a time."""

    def x3(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
        hi = x.to(torch.bfloat16).float()
        lo = (x - hi).to(torch.bfloat16).double()
        hi, planes = hi.double(), planes.double()
        return (hi @ planes[0] + hi @ planes[1]) + lo @ planes[0]

    out = []
    for b in range(audio.shape[0]):
        s, d = ff.fold_operands(audio[b : b + 1], w["wc"].shape[-2], hop=cfg.hop_length,
                                eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length), algorithm="x3")
        re, im = x3(s, w["wc"]), x3(d, w["ws"])
        im = tnf.pad(im, (0, re.shape[-1] - im.shape[-1]))
        out.append(x3((re * re + im * im).float(), w["melw"]))
    return torch.cat(out)


def fold64(audio: torch.Tensor, cfg: mt.MfccConfig, w: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 fold's plain version evaluated in float64: the same function
    (fused_mel_fold_reference, the DFT in 16-row steps) on the same float32
    samples and weights, widened exactly; (mel, block maxima)."""
    return ff.fused_mel_fold_reference(audio.double(), w["wc"].double(), w["ws"].double(), w["melw"].double(),
                                       hop=cfg.hop_length, eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))


def fold_exact(audio: torch.Tensor, cfg: mt.MfccConfig, alg: str, w: dict):
    """The float64 evaluation a fold is held against (mode_error_ok):
    x3_exact_fold_mel for x3, fold64 for f32; None for bf16, which is held
    to its plain version alone."""
    if alg == "x3":
        return x3_exact_fold_mel(audio, cfg, w)
    return fold64(audio, cfg, w) if alg == "f32" else None


def fold_kernel_checks(dev) -> None:
    """Phase 18: the fold kernels against their plain versions (the
    unfolded modes' bars, mode_error_ok; f32 as fused_mel_f32, against its
    plain version in float64; x3 as fused_mel_x3, against the float64 sums
    of its own products), each under the plan it takes, and the f32 fold
    against fused_mel_f32 on the same audio (the JAX fold test's bar: 1e-5
    of the largest mel), also at 256 mel bands (two groups of 128); every
    fold also at FOLD_COMPACT, where f32 and x3 take 32-frame plans."""
    for name, cfg in (("10k default (packed Nyquist)", DEFAULT_10K), ("16k fmax 8k", FLAGSHIP),
                      ("16k, 256 mel bands", WIDE)) + FOLD_COMPACT:
        sr = cfg.signal_sample_rate
        audio = torch.tensor(speechlike(4, SECONDS * sr, sr, seed=18), device=dev)
        for alg in FOLD_MODES:
            w = fold_weights(cfg, alg, dev)
            reset(ff.LAUNCHES)
            mel_k, bmax_k = fold_kernel(audio, cfg, alg, w)
            torch.cuda.synchronize()
            check(ff.LAUNCHES[f"fused_mel_fold_{alg}"] == 1, f"fused_mel_fold_{alg} {name} launched")
            mel_p, bmax_p = fold_plain(audio, cfg, alg, w)
            ex = fold_exact(audio, cfg, alg, w)
            ok, text = mode_error_ok(alg, mel_k, bmax_k, mel_p, bmax_p, ex)
            del ex
            print(f"[18] {name}: fused_mel_fold_{alg} on {tuple(audio.shape)}, hop {cfg.hop_length}, window "
                  f"{cfg.win_length}, {fold_plan_text(cfg, alg)} vs plain: {text}")
            check(ok, f"fused_mel_fold_{alg} {name}")
            del mel_k, bmax_k, mel_p, bmax_p
            torch.cuda.empty_cache()
        if any(cfg is c for _, c in FOLD_COMPACT):
            continue
        mel_f, _ = fold_kernel(audio, cfg, "f32", fold_weights(cfg, "f32", dev))
        mel_u, _ = mode_kernel(audio, cfg, "f32", mode_weights(cfg, "f32", dev))
        torch.cuda.synchronize()
        rel = float((mel_f - mel_u).abs().max() / mel_u.abs().max())
        print(f"[18] {name}: fused_mel_fold_f32 vs fused_mel_f32 on the same audio: max-abs {rel:.3e} of the "
              f"largest mel (bar 1e-5)")
        check(rel <= 1e-5, f"fold vs unfolded {name}")


def fold_mfcc(y, cfg, alg, w, dct) -> torch.Tensor:
    """The fold path: folded frontend → peak of the block maxima → tail, coef-major."""
    mel, bmax = fold_kernel(y, cfg, alg, w)
    return ff.mfcc_tail(mel, peak_db(bmax), cfg.n_mfcc, transposed=True, dct=dct)


def fold_path(dev, y: torch.Tensor) -> dict:
    """Phase 19: the fold path at full size; launches per kernel."""
    cfg = FLAGSHIP
    model = mt.MfccChange(cfg).to(dev)
    ws = {alg: fold_weights(cfg, alg, dev) for alg in FOLD_MODES}
    reset(ff.LAUNCHES)
    mf = {alg: fold_mfcc(y, cfg, alg, ws[alg], model.dct) for alg in FOLD_MODES}
    torch.cuda.synchronize()
    counts = dict(ff.LAUNCHES)
    launches = {f"fused_mel_fold_{alg}": counts[f"fused_mel_fold_{alg}"] for alg in FOLD_MODES}
    print(f"[19] fold path on {tuple(y.shape)}, one call per mode: launches {counts}")
    check(all(v == 1 for v in launches.values()) and counts["mfcc_tail_f32"] == len(FOLD_MODES)
          and not any(counts[f"fused_mel_{a}"] for a in ff.ALGORITHMS), "one launch of each fold kernel")
    nf = 1 + y.shape[1] // cfg.hop_length
    check(mf["f32"].shape == (BATCH, cfg.n_mfcc, nf) and bool(torch.isfinite(mf["f32"]).all()), "fold MFCC shape")
    # The fold and the direct DFT sum in other orders. Where a bin's power is
    # many decades below its frame's energy (a narrow low mel band of a noise
    # frame that happens to be near zero, or a quiet band of a loud speech
    # frame), float32 rounding is a large part of it, and the two differ
    # there by up to ~1e-3 at the MFCC over 768,000 frames. The bar: the
    # fold's MFCC no further from the float64 'fft' MFCC than twice the
    # unfolded FP32 route's, fused_mel_f32's plain version (the fold's own
    # arithmetic, FP32 in 16-row steps; the unfolded kernel's split is
    # printed beside it and sits nearer)
    g = torch.Generator(device="cuda").manual_seed(191)
    noise = 0.3 * torch.randn(y.shape, generator=g, device="cuda")
    a = frontend_args(cfg, dev)
    for label, x, fold_m in (("speech-like", y, mf["f32"]), ("noise", noise, None)):
        if fold_m is None:
            fold_m = fold_mfcc(x, cfg, "f32", ws["f32"], model.dct)
        unf = mt.mfcc_trajectories(x, cfg, spectrum="fused", coef_major=True)
        f64 = mt.mfcc_trajectories(x.double(), cfg, spectrum="fft", coef_major=True)
        d = (fold_m - unf).abs()
        e_fold, e_unf = float((fold_m.double() - f64).abs().max()), float((unf.double() - f64).abs().max())
        e_plain = float((via_tail(frontend_plain(x, cfg, a), cfg, model).double() - f64).abs().max())
        print(f"[19] fold f32 MFCC vs mfcc_trajectories(spectrum='fused', coef_major=True) on the {label} batch "
              f"{tuple(x.shape)}: max-abs {float(d.max()):.3e}, {float((d > 1e-4).float().mean()):.2e} of entries "
              f"beyond 1e-4; against the float64 'fft' MFCC: fold {e_fold:.3e}, the unfolded FP32 route "
              f"(fused_mel_f32's plain version) {e_plain:.3e} (bar: fold ≤ 2 × that), the unfolded kernel {e_unf:.3e}")
        check(e_fold <= 2.0 * e_plain, f"fold MFCC as accurate as the unfolded FP32 route on the {label} batch")
        del unf, f64, d
    del noise
    torch.cuda.empty_cache()
    want = mt.mfcc_change(y.double(), cfg, spectrum="fft")
    for alg in FOLD_MODES:
        tot = model.trajectory_tail(mf[alg])
        err = float((tot.double() - want).abs().max())
        bar = 1e-1 if alg == "bf16" else 1e-4  # phase 15's bars for the unfolded modes
        print(f"[19] fold {alg} MFCC through the trajectory tail vs the float64 'fft' mfcc_change: max-abs "
              f"{err:.3e} (bar {bar:g})")
        check(tot.shape == want.shape and bool(torch.isfinite(tot).all()) and err <= bar, f"fold {alg} vs fft")
    return launches


def speechlike_on_card(n: int, sr: int, seed: int) -> torch.Tensor:
    """[n] float32 made on the card from a seed: harmonics of a gliding f0
    under a 4 Hz envelope that changes rate every minute, plus noise."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64, device="cuda") / sr
    minute = (t // 60.0).long()
    rates = torch.rand(int(minute.max()) + 1, generator=g, device="cuda", dtype=torch.float64)
    f0 = 100.0 + 80.0 * rates[minute] + 30.0 * torch.sin(2 * np.pi * 2.5 * t)
    phase = 2 * np.pi * torch.cumsum(f0, 0) / sr
    sig = sum((0.6 / k) * torch.sin(k * phase) for k in range(1, 6))
    env = 0.5 * (1 + torch.sin(2 * np.pi * (3.0 + 2.0 * rates[minute]) * t - np.pi / 2))
    noise = torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    return (sig * env + 0.01 * noise).to(torch.float32)


def peak_gib(fn) -> tuple[float, float]:
    """(ms of one call, GiB it allocated above what was live before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (torch.cuda.max_memory_allocated() - base) / 2**30


def longform(dev, card: str) -> None:
    """Phase 20: one hour at 48 kHz, resampled on the card, through the
    chunked route; its times and peak memory beside the whole-file route."""

    cfg = FLAGSHIP
    n48 = LONG_SR * LONG_SECONDS
    t0 = time.perf_counter()
    y48 = speechlike_on_card(n48, LONG_SR, seed=20)
    torch.cuda.synchronize()
    print(f"[20] made a {LONG_SECONDS} s recording at {LONG_SR} Hz on the card: {n48} samples "
          f"({y48.numel() * 4 / 1e6:.1f} MB) in {time.perf_counter() - t0:.3f} s")
    x = y48[600 * LONG_SR : 630 * LONG_SR].contiguous()
    host = torch.tensor(resample(x.double().cpu().numpy(), LONG_SR, cfg.signal_sample_rate))
    flat = mt.resample_device(x, LONG_SR, cfg.signal_sample_rate)
    blocked = resample_poly_device(x, 1, 3, block_threshold=0)
    torch.cuda.synchronize()
    err, err_b = float((flat.cpu().double() - host).abs().max()), float((blocked - flat).abs().max())
    print(f"[20] resample_device on a 30 s excerpt vs the host resampler (float64): max-abs {err:.3e} (bar 1e-5); "
          f"blocked form vs flat: {err_b:.3e} (bar 1e-5)")
    check(flat.shape == host.shape and err <= 1e-5 and err_b <= 1e-5, "resample_device vs the host resampler")

    t_rs, gib_rs = peak_gib(lambda: mt.resample_device(y48, LONG_SR, cfg.signal_sample_rate))
    y16 = mt.resample_device(y48, LONG_SR, cfg.signal_sample_rate)
    del y48, x
    torch.cuda.empty_cache()
    nf = 1 + y16.shape[0] // cfg.hop_length
    print(f"[20] resample_device 48 → 16 kHz of the hour: {y16.shape[0]} samples in {t_rs:.3f} ms, "
          f"{gib_rs:.2f} GiB above its input ({card})")
    with spy(streaming, "chunked_mfcc_change") as calls:
        routed, times = mt.extract_mfcc_change(y16, cfg)
        torch.cuda.synchronize()
    chunked = mt.chunked_mfcc_change(y16, cfg)
    whole = mt.mfcc_change(y16, cfg, spectrum="fft")
    torch.cuda.synchronize()
    err = float((chunked - whole).abs().max())
    same = float((routed - chunked).abs().max())
    print(f"[20] chunked_mfcc_change [{nf}] vs whole-file mfcc_change(spectrum='fft'): max-abs {err:.3e} "
          f"(bar 1e-5); extract_mfcc_change took the chunked route {len(calls)} time(s), max-abs {same:.3e} "
          f"from chunked_mfcc_change (bar 1e-6), {len(times)} time anchors")
    check(chunked.shape == whole.shape == (nf,) and bool(torch.isfinite(chunked).all()) and err <= 1e-5,
          "chunked vs whole-file")
    check(len(calls) == 1 and same <= 1e-6 and len(times) == nf, "extract_mfcc_change takes the chunked route")
    del whole, routed
    torch.cuda.empty_cache()
    for label, fn in (("chunked_mfcc_change", lambda: mt.chunked_mfcc_change(y16, cfg)),
                      ("whole-file mfcc_change spectrum='fused'", lambda: mt.mfcc_change(y16, cfg)),
                      ("whole-file mfcc_change spectrum='fft'", lambda: mt.mfcc_change(y16, cfg, spectrum="fft"))):
        fn()
        ms_, gib = peak_gib(fn)
        ms_med = cuda_ms(fn, reps=3)
        print(f"[20] {label} on the hour: {ms_med:.3f} ms (median of 3; one call {ms_:.3f} ms) = "
              f"{1.0 / (ms_med / 1e3):.3f} audio-h/s; {gib:.2f} GiB above its input ({card})")
        torch.cuda.empty_cache()


def modspec(dev, y: torch.Tensor) -> None:
    """Phase 21: the modulation spectrum at full size against the float64
    'fft' path."""
    cfg = FLAGSHIP
    want = mt.modulation_spectrum(y.double(), cfg, spectrum="fft")
    m_want = mt.mfcc_trajectories(y.double(), cfg, spectrum="fft")
    peak = want.amax(dim=(1, 2, 3))
    for spec in ("fused", "fused_bf16"):
        kname = kernel_of(SPECTRUM_ALG[spec], cfg)
        reset(ff.LAUNCHES)
        got = mt.modulation_spectrum(y, cfg, spectrum=spec)
        torch.cuda.synchronize()
        counts = dict(ff.LAUNCHES)
        others = {k: v for k, v in counts.items() if k not in (kname, "mfcc_tail_f32")}
        check(counts[kname] == 1 and counts["mfcc_tail_f32"] == 1 and not any(others.values()),
              f"one launch of {kname} and of mfcc_tail_f32 per modulation_spectrum call")
        check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"modulation_spectrum {spec} shape")
        delta = (got.double() - want).abs()
        rel = float((delta.amax(dim=(1, 2, 3)) / peak).max())
        if spec == "fused":
            print(f"[21] modulation_spectrum spectrum='fused' {tuple(got.shape)}: launches {kname} 1, mfcc_tail_f32 1; "
                  f"vs the float64 'fft' path max-abs {rel:.3e} of each utterance's peak (bar 1e-4)")
            check(rel <= 1e-4, "modulation_spectrum fused vs fft")
            continue
        # bf16's bar from its own MFCC error e: the mean-removed trajectory is
        # off by at most 2e, so each windowed sum by at most E = 2e·Σw (Σw =
        # n/2 for the periodic Hann), and |X + dX|² − |X|² by at most
        # 2|X|E + E²; plus 1e-4 of the peak for float32 rounding
        e = float((mt.mfcc_trajectories(y, cfg, spectrum=spec).double()[..., 1:] - m_want[..., 1:]).abs().max())
        big_e = 2.0 * e * 64.0
        bound_ = 2.0 * want.sqrt() * big_e + big_e**2 + 1e-4 * peak[:, None, None, None]
        over = float((delta / bound_).max())
        print(f"[21] modulation_spectrum spectrum='fused_bf16': launches {kname} 1, mfcc_tail_f32 1; MFCC max-abs "
              f"{e:.3e} against float64; spectrum max-abs {rel:.3e} of each utterance's peak, at most {over:.3f} of "
              f"the bound 2·sqrt(P)·E + E² + 1e-4·peak with E = 2·64·e (bar 1)")
        check(over <= 1.0, "modulation_spectrum fused_bf16 within its MFCC error's bound")


def bf16_fold_order_report(y: torch.Tensor, cfg: mt.MfccConfig, w: dict, mel_p: torch.Tensor) -> None:
    """Why the bf16 fold sums on the CUDA cores (PERF.md §6): the
    plain version's DFT (an FP32 GEMM) against a row-order FFMA chain,
    emulated in float64 with a rounding to float32 a row, on utterance 0;
    and the mel of the float64 DFT (the power rounded as the plain version
    rounds it, the plain version's mel GEMM) against the plain version's
    mel, over the batch, in bf16 ulps. Printed, not gated."""
    k = w["wc"].shape[-2]
    pad = ff.eff_pad(cfg.n_fft, cfg.win_length)
    s, d = (ff._bf16r(v)[0] for v in ff.fold_operands(y[:1], k, hop=cfg.hop_length, eff_pad=pad, algorithm="bf16"))
    equal = []
    for x, wt in ((s, w["wc"]), (d, w["ws"])):
        acc = torch.zeros((x.shape[0], wt.shape[1]), dtype=torch.float64, device=x.device)
        for u in range(k):
            acc = (acc + x[:, u : u + 1].double() * wt[u].double()).float().double()
        equal.append(float((acc.float() == x @ wt).float().mean()))
    rows = []
    for b in range(y.shape[0]):
        s, d = (ff._bf16r(v).double() for v in ff.fold_operands(y[b : b + 1], k, hop=cfg.hop_length, eff_pad=pad,
                                                                 algorithm="bf16"))
        re, im = s @ w["wc"].double(), d @ w["ws"].double()
        im = tnf.pad(im, (0, re.shape[-1] - im.shape[-1]))
        rows.append((ff._bf16r((re * re + im * im).float()) @ w["melw"]).to(torch.bfloat16))
    ulps, share = bf16_ulps(torch.cat(rows), mel_p)
    print(f"[22] fused_mel_fold_bf16's plain version: its DFT sums equal a row-order FFMA chain's in {equal[0]:.6f} "
          f"(re) and {equal[1]:.6f} (im) of utterance 0's entries; the float64 DFT's mel is {ulps:.2f} bf16 ulp from "
          f"it, {share:.2e} of entries beyond 1 ulp")


def fold_times(dev, y: torch.Tensor, launches: dict, card: str) -> list[dict]:
    """Phase 22: the kernel rows of the fold kernels, the frame-major tail's
    time, and the new paths end to end."""
    cfg = FLAGSHIP
    hours = BATCH * SECONDS / 3600.0
    rows = []
    for alg in FOLD_MODES:
        kname = f"fused_mel_fold_{alg}"
        w = fold_weights(cfg, alg, dev)
        mel_k, bmax_k = fold_kernel(y, cfg, alg, w)
        mel_p, bmax_p = fold_plain(y, cfg, alg, w)
        ex = fold_exact(y, cfg, alg, w)
        ok, text = mode_error_ok(alg, mel_k, bmax_k, mel_p, bmax_p, ex)
        del ex
        err = float((mel_k.float() - mel_p.float()).abs().max())
        print(f"[22] {kname} at full size vs plain: {text}; max-abs {err:.3e}")
        if alg == "bf16":
            bf16_fold_order_report(y, cfg, w, mel_p)
        del mel_p, bmax_p
        wu = mode_weights(cfg, alg, dev)
        t_k = kernel_ms(lambda: fold_kernel(y, cfg, alg, w))
        t_u = kernel_ms(lambda: mode_kernel(y, cfg, alg, wu))
        torch.cuda.empty_cache()
        t_p = kernel_ms(lambda: fold_plain(y, cfg, alg, w))
        torch.cuda.empty_cache()
        bsz, nf, n_mels = mel_k.shape
        k, bins = w["wc"].shape[-2:]
        im_cols = w["ws"].shape[-1]
        dft = 2.0 * bsz * nf * k * (bins + im_cols)  # one pass of the folded contraction, K × (bins + im_cols)
        mel_ops = 2.0 * bsz * nf * bins * n_mels
        passes = {"f32": 6, "bf16": 1, "x3": 3}[alg]  # bf16 passes on the tensor cores (bf16: its bound there)
        # bytes: the audio, the weights the kernel reads (FOLD_READS) at their element size, mel and maxima
        n_bytes = (y.numel() * 4 + sum(w[key].numel() * w[key].element_size() for key in FOLD_READS[alg])
                   + mel_k.numel() * mel_k.element_size() + bmax_k.numel() * 4)
        t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, passes * (dft + mel_ops) / PEAK_BF16_S * 1e3
        b = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        extra = ""
        if alg == "f32":  # the same function on the FP32 CUDA cores, the parent FFMA kernel's unit
            ffma = (dft + 2.0 * bsz * nf * k + 3.0 * bsz * nf * bins + mel_ops) / PEAK_FP32_S * 1e3
            extra = f"; the same function on the FP32 CUDA cores {ffma:.3f} ms, {ffma / t_k:.1%} of it"
        print(f"[22] {kname} ({fold_plan_text(cfg, alg)}): {t_k:.3f} ms, plain {t_p:.3f} ms, unfolded "
              f"fused_mel_{alg} {t_u:.3f} ms, bound {b[0]:.3f} ms ({b[1]}, {passes} bf16 pass(es) of K × (bins + "
              f"im_cols) and the mel), {b[0] / t_k:.1%} of it{extra}; the fold {t_u / t_k:.3f} × as fast as the "
              f"unfolded kernel ({card}; {sm_clock()})")
        check_late(ok, f"{kname} at full size")
        rows.append(kernel_row(kname, launches[kname], err, (t_k, t_p), b))
        del mel_k, bmax_k
        torch.cuda.empty_cache()

    model = mt.MfccChange(cfg).to(dev)
    for alg in ("f32", "bf16"):
        mel, bmax = mode_kernel(y, cfg, alg, mode_weights(cfg, alg, dev))
        pk = peak_db(bmax)
        for transposed in (True, False):
            layout = f"{'coef' if transposed else 'frame'}-major"
            out_k = ff.mfcc_tail(mel, pk, cfg.n_mfcc, transposed=transposed, dct=model.dct)
            out_p = ff.mfcc_tail_reference(mel, pk, model.dct, transposed=transposed)
            err = float((out_k - out_p).abs().max())
            check(out_k.shape == out_p.shape and err <= 1e-4, f"{layout} mfcc_tail_f32 on {alg} mel at full size")
            t_k = cuda_ms(lambda: ff.mfcc_tail(mel, pk, cfg.n_mfcc, transposed=transposed, dct=model.dct))
            t_p = cuda_ms(lambda: ff.mfcc_tail_reference(mel, pk, model.dct, transposed=transposed))
            bsz, nf, n_mels = mel.shape
            b = bound(mel.numel() * mel.element_size() + bsz * 4 + model.dct.numel() * 4 + out_k.numel() * 4,
                      bsz * nf * n_mels * (2 * cfg.n_mfcc + 3))
            print(f"[22] mfcc_tail_f32 {layout} on {mel.dtype} mel {tuple(out_k.shape)}: {t_k:.3f} ms, plain "
                  f"{t_p:.3f} ms, bound {b[0]:.3f} ms ({b[1]}), {b[0] / t_k:.1%} of it; max-abs vs plain {err:.3e} "
                  f"(bar 1e-4) ({card}; {sm_clock()})")
            del out_k, out_p
        del mel, bmax
        torch.cuda.empty_cache()
    w = fold_weights(cfg, "f32", dev)
    e2e = cuda_ms(lambda: fold_mfcc(y, cfg, "f32", w, model.dct))
    print(f"[22] fold path (f32) end to end: {e2e:.3f} ms = {hours / (e2e / 1e3):.3f} audio-h/s ({card})")
    for spec in ("fused", "fused_bf16"):
        torch.cuda.reset_peak_memory_stats()
        e2e = cuda_ms(lambda: mt.modulation_spectrum(y, cfg, spectrum=spec))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[22] modulation_spectrum spectrum={spec!r} end to end: {e2e:.3f} ms = "
              f"{hours / (e2e / 1e3):.3f} audio-h/s, peak memory {peak:.2f} GiB ({card})")
    return rows


def fold_rungs(dev, y: torch.Tensor, card: str) -> None:
    """Phase 22: fused_mel_fold_f32 under every rung of its ladder
    (fold_plan) that fits a block, on 128 × 30 s at the flagship (``y``) and
    at 32 kHz with hop 160 and window 800, where the ladder takes 64 frames
    with two stages: each rung's time, and its mel and block maxima against
    the ladder's own plan's, bit for bit (a plan changes no sum's order)."""
    cfg32 = mt.MfccConfig(signal_sample_rate=32_000, tStep=0.005, winLen=0.025, n_fft=1024)
    y32 = speechlike_on_card(BATCH * SECONDS * 32_000, 32_000, seed=22).reshape(BATCH, -1)
    ladder = ff.fold_plan
    try:
        for label, cfg, x in (("16 kHz flagship", FLAGSHIP, y), ("32 kHz, hop 160, window 800", cfg32, y32)):
            ff.fold_plan = ladder
            w = fold_weights(cfg, "f32", dev)
            want = fold_kernel(x, cfg, "f32", w)
            chosen = ladder("f32", cfg.hop_length, cfg.win_length, cfg.n_mels)
            parts, equal = [], True
            for rung in ff._FOLD_LADDER["f32"]:
                plan = ff._fold_plan_for("f32", cfg.hop_length, cfg.win_length, cfg.n_mels, *rung)
                if plan.shared_bytes > ff.SHARED_MAX:
                    continue
                ff.fold_plan = lambda *_, plan=plan: plan
                got = fold_kernel(x, cfg, "f32", w)
                same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                check_late(same, f"fused_mel_fold_f32 plan {rung} at {label} equals the ladder's plan's mel")
                equal &= same
                del got
                t = kernel_ms(lambda: fold_kernel(x, cfg, "f32", w))
                parts.append(f"{rung[0]}/{rung[1]}/{rung[2]}{' (the ladder)' if plan == chosen else ''} {t:.3f} ms")
            print(f"[22] fused_mel_fold_f32 by plan (frames/stages/buffers) at {label} on {tuple(x.shape)}: "
                  + "; ".join(parts) + f"; mel and maxima of each equal the ladder's plan's: {equal} ({card}; "
                  f"{sm_clock()})")
            del want
    finally:
        ff.fold_plan = ladder
    del y32
    torch.cuda.empty_cache()


def via_tail(mel_bmax, cfg: mt.MfccConfig, model) -> torch.Tensor:
    """The coef-major MFCC of a frontend's (mel, block maxes), through mfcc_tail_f32."""
    mel, bmax = mel_bmax
    return ff.mfcc_tail(mel, peak_db(bmax), cfg.n_mfcc, transposed=True, dct=model.dct)


def c2_batches(y: torch.Tensor) -> tuple[tuple[str, torch.Tensor], ...]:
    """Phase 23's two batches: the speech-like ``y`` and noise of its shape (seed 191)."""
    g = torch.Generator(device="cuda").manual_seed(191)
    return ("speech-like", y), ("noise", 0.3 * torch.randn(y.shape, generator=g, device="cuda"))


def tc_mode_distances(x: torch.Tensor, cfg: mt.MfccConfig, model, ws: dict, err) -> list[str]:
    """x3's and i24's MFCC distance ``err`` from float64: the kernel (their
    spectrum's mfcc_change trajectories) and its plain version through the
    tail; ``ws`` maps the mode to its mode_weights."""
    parts = []
    for alg in ("x3", "i24"):
        kernel = model.trajectories(x, spectrum=f"fused_{alg}", coef_major=True)
        parts.append(f"spectrum='fused_{alg}' {err(kernel):.3e}")
        plain = via_tail(mode_plain(x, cfg, alg, ws[alg]), cfg, model)
        parts.append(f"fused_mel_{alg}'s plain version {err(plain):.3e}")
        del kernel, plain
        torch.cuda.empty_cache()
    return parts


def c2_distances(dev, y: torch.Tensor, card: str) -> None:
    """Phase 23: the f32 MFCC against the float64 'fft' MFCC on phase 19's
    two batches (BASELINE.md's bar: max-abs 1e-4, which no float32 route
    meets at this size, ROADMAP C2). fused_mel_f32 runs the exact three-plane
    bf16 split on the tensor cores, its hi·hi sum added in 16-row steps; its
    plain version is a true FP32 GEMM in those steps; fused_mel_fold_f32
    runs the same split over the folded operands, its plain version the
    FP32 fold in those steps. Enforced: on each batch each kernel's MFCC no
    further from float64 than its plain version's, times 1.05. Printed
    beside them: the splits mirrored in float32 matmuls
    (split3_frontend_mirror, split3_fold_mirror, the CPU tests' proofs) run
    on the card, the plain versions in the one-sum order they had before the
    steps, the other routes (x3 and i24 with their kernels' plain versions),
    the f32 kernel's and its plain version's mel through the tail in float64
    (what the tail's FP32 chains add), and the fused design's own floor (its
    float32-stored weights with every sum in float64)."""
    cfg = FLAGSHIP
    model = mt.MfccChange(cfg).to(dev)
    a, wf = frontend_args(cfg, dev), fold_weights(cfg, "f32", dev)
    ws = {alg: mode_weights(cfg, alg, dev) for alg in ("x3", "i24")}
    kernel, plain = "fused_mel_fft_f32 (kernel)", "the 'f32' plain version"
    tc_k = "fused_mel_f32 (kernel)"
    fold_k, fold_p = "fused_mel_fold_f32 (kernel)", "fused_mel_fold_f32's plain version"
    routes = {
        kernel: lambda x: model.trajectories(x, coef_major=True),
        tc_k: lambda x: via_tail(tc_f32(x, cfg, a["w"]), cfg, model),
        plain: lambda x: via_tail(frontend_plain(x, cfg, a), cfg, model),
        "the split's mirror": lambda x: via_tail(ff.split3_frontend_mirror(
            x, a["wri"], a["melw"], hop=cfg.hop_length, eff_pad=a["eff_pad"]), cfg, model),
        "the split's mirror with an FP32 mel": lambda x: via_tail(split_fp32_mel(x, cfg, a), cfg, model),
        fold_k: lambda x: fold_mfcc(x, cfg, "f32", wf, model.dct),
        fold_p: lambda x: via_tail(fold_plain(x, cfg, "f32", wf), cfg, model),
        "the fold split's mirror": lambda x: via_tail(ff.split3_fold_mirror(
            x, wf["wc"], wf["ws"], wf["melw"], hop=cfg.hop_length, eff_pad=a["eff_pad"]), cfg, model),
    }
    for label, x in c2_batches(y):
        f64 = model.trajectories(x.double(), spectrum="fft", coef_major=True)

        def err(m: torch.Tensor) -> float:
            check(m.shape == f64.shape and bool(torch.isfinite(m).all()), f"phase 23 {label} MFCC shape")
            return float((m.double() - f64).abs().max())

        dist = {name: err(fn(x)) for name, fn in routes.items()}
        torch.cuda.empty_cache()
        parts = [f"{name} {d:.3e}" for name, d in dist.items()]
        stepped = ff._stepped_matmul
        ff._stepped_matmul = lambda u, w: u @ w  # the order before the repair: one K-term sum
        try:
            parts += [f"{name} in one sum {err(fn(x)):.3e}" for name, fn in routes.items()
                      if "plain" in name or name in ("the split's mirror", "the fold split's mirror")]
        finally:
            ff._stepped_matmul = stepped
        parts.append(f"spectrum='fft' {err(model.trajectories(x, spectrum='fft', coef_major=True)):.3e}")
        parts += tc_mode_distances(x, cfg, model, ws, err)
        # the fused design's own floor: its float32-stored weights, every sum in float64
        mel64, bmax64 = ff.fused_mel_frontend_reference(x.double(), a["wri"].double(), a["melw"].double(),
                                                        hop=cfg.hop_length, eff_pad=a["eff_pad"])
        db64 = torch.maximum(10.0 * torch.log10(torch.clamp(mel64, min=1e-10)), (peak_db(bmax64) - 80.0)[:, None, None])
        parts.append(f"the fused design in float64 {err((db64 @ model.dct.double()).transpose(-1, -2)):.3e}")
        del mel64, bmax64, db64
        # each route's mel through the tail's function in float64, which shows what the
        # tail's FP32 chains (the plain version's order) add
        tail64 = []
        for name, mel_bmax in (("fused_mel_fft_f32 (kernel)", frontend_kernel(x, cfg, a)),
                               ("its plain version", frontend_plain(x, cfg, a))):
            m, bm = mel_bmax
            t64 = ff.mfcc_tail_reference(m.double(), peak_db(bm).double(), model.dct.double(), transposed=True)
            tail64.append(f"{name} {err(t64):.3e}")
            del m, bm, t64
        parts.append("with the tail in float64: " + ", ".join(tail64))
        torch.cuda.empty_cache()
        print(f"[23] f32 MFCC on the {label} batch {tuple(x.shape)} against the float64 'fft' MFCC, max-abs "
              f"(BASELINE bar 1e-4; the f32 routes in 16-row steps): " + "; ".join(parts) + f" ({card})")
        for k_name, p_name in ((kernel, plain), (tc_k, plain), (fold_k, fold_p)):
            ratio = dist[k_name] / dist[p_name]
            name = k_name.removesuffix(" (kernel)")
            print(f"[23] {label}: {name} {dist[k_name]:.3e} = {ratio:.4f} × its plain version's {dist[p_name]:.3e} "
                  f"(bar 1.05)")
            check(ratio <= 1.05, f"phase 23 {label}: {name} no further from float64 than 1.05 × its plain version")
        del f64
        torch.cuda.empty_cache()


def fold_longform_modspec(dev, card: str) -> list[dict]:
    """Phases 18-23; the kernel rows of the fold kernels."""
    fold_kernel_checks(dev)
    sr = FLAGSHIP.signal_sample_rate
    y = torch.tensor(speechlike(BATCH, SECONDS * sr, sr, seed=19), device=dev)
    launches = fold_path(dev, y)
    torch.cuda.empty_cache()
    longform(dev, card)
    torch.cuda.empty_cache()
    modspec(dev, y)
    torch.cuda.empty_cache()
    rows = fold_times(dev, y, launches, card)
    fold_rungs(dev, y, card)
    c2_distances(dev, y, card)
    return rows


def tracker_report(label: str, batch: mt.AudioBatch, y_np: np.ndarray, card: str) -> None:
    """``--frontend``: sinc_refine_f32 and burg_lpc_f32 on the inputs of
    phases 7 and 8, and batched_f0 praatac and batched_formants end to end."""
    praatac = mt.F0Config(method="praatac")
    with spy(P, "refine_sinc_band") as calls:
        mt.batched_f0(batch, TRACK_SR, praatac)
    s_args, s_kw = calls[0][:2]
    ms = cuda_ms(lambda: SK.refine_sinc_band(*s_args, **s_kw))
    print(f"[{label}] sinc_refine_f32 on r_ext {tuple(s_args[0].shape)}: {ms:.3f} ms ({card}; {sm_clock()})")
    ms = cuda_ms(lambda: mt.batched_f0(batch, TRACK_SR, praatac))
    print(f"[{label}] batched_f0 praatac on {tuple(batch.samples.shape)} end to end: {ms:.3f} ms "
          f"({card}; {sm_clock()})")
    del s_args, s_kw, calls
    xr = torch.tensor(resample(y_np.astype(np.float64), TRACK_SR, LPC_SR).astype(np.float32), device=batch.samples.device)
    with spy(BK, "burg_lpc") as calls:
        mt.batched_formants(xr, LPC_SR, mt.FormantConfig())
    frames, order = calls[0][0]
    ms = cuda_ms(lambda: BK.burg_lpc(frames, order))
    print(f"[{label}] burg_lpc_f32 on frames {tuple(frames.shape)}: {ms:.3f} ms ({card}; {sm_clock()})")
    ms = cuda_ms(lambda: mt.batched_formants(xr, LPC_SR, mt.FormantConfig()))
    print(f"[{label}] batched_formants on {tuple(xr.shape)} end to end: {ms:.3f} ms ({card}; {sm_clock()})")
    del frames, calls, xr
    torch.cuda.empty_cache()


def frontend_report(root: Path) -> int:
    """``--frontend DIR``: the frontend kernel times, the pyin forward's and
    two paths' times, and x3's and i24's MFCC distances of the package at
    ``root`` (see the module docstring)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    card, label = card_line(), f"F {root.name}"
    cfg = FLAGSHIP
    sr = cfg.signal_sample_rate

    def line(what: str, fn) -> None:
        ms = kernel_ms(fn)
        print(f"[{label}] {what}: {ms:.3f} ms ({card}; {sm_clock()})", flush=True)

    ys = {s: torch.tensor(speechlike(BATCH, SECONDS * sr, sr, seed=s), device=dev) for s in (0, 19)}
    w32, wf = mode_weights(cfg, "f32", dev), fold_weights(cfg, "f32", dev)
    # the kernel 'f32' takes in that package (one without the FFT kernel has only the tensor-core one)
    f32_name = f32_kernel(cfg) if hasattr(ff, "fft_ok") else "fused_mel_f32"
    for s in (0, 19, 19, 0):
        line(f"{f32_name}, float32, seed {s}", lambda: mode_kernel(ys[s], cfg, "f32", w32))
    for s in (0, 19):
        line(f"fused_mel_fold_f32, float32, seed {s}", lambda: fold_kernel(ys[s], cfg, "f32", wf))
    for alg in ("bf16", "x3"):
        w = fold_weights(cfg, alg, dev)
        line(f"fused_mel_fold_{alg}, float32, seed 19", lambda: fold_kernel(ys[19], cfg, alg, w))
        del w
    for alg in FOLD_MODES:  # two packages whose folds compute alike print the same digests
        mel, bmax = fold_kernel(ys[19], cfg, alg, wf if alg == "f32" else fold_weights(cfg, alg, dev))
        digest = hashlib.sha256(mel.float().cpu().numpy().tobytes() + bmax.cpu().numpy().tobytes())
        print(f"[{label}] fused_mel_fold_{alg} mel and block maxima of seed 19: sha256 {digest.hexdigest()[:16]}")
        del mel, bmax
    dct = torch.tensor(ff.tail_dct(cfg.n_mfcc, cfg.n_mels), device=dev)

    def tail_lines(what: str, mel_bmax) -> None:
        mel, pk = mel_bmax[0], peak_db(mel_bmax[1])
        for transposed in (True, False):
            line(f"mfcc_tail_f32 {'coef' if transposed else 'frame'}-major, {what} {tuple(mel.shape)}",
                 lambda: ff.mfcc_tail(mel, pk, cfg.n_mfcc, transposed=transposed, dct=dct))

    tail_lines("float32 mel of seed 0", mode_kernel(ys[0], cfg, "f32", w32))
    model = mt.MfccChange(cfg).to(dev)
    ms = cuda_ms(lambda: model(ys[0]))
    print(f"[{label}] mfcc_change spectrum='fused' on float32 seed 0 end to end: {ms:.3f} ms ({card}; {sm_clock()})")
    y = ys.pop(19)
    del ys
    torch.cuda.empty_cache()
    pcm = np.round(speechlike(BATCH, SECONDS * sr, sr, seed=0) * 0.5 * 32767.0).astype(np.int16)
    rows, n = rows_of(pcm, cfg, dev), pcm.shape[1]
    ws = {alg: mode_weights(cfg, alg, dev) for alg in ("bf16", "x3", "i16", "i24", "f32")}
    for alg, w in ws.items():
        line(f"fused_mel_{alg}, int16 hop rows", lambda: mode_kernel(rows, cfg, alg, w, n))
    tail_lines("bf16 mel of the rows", mode_kernel(rows, cfg, "bf16", ws["bf16"], n))
    torch.cuda.empty_cache()
    for spec in ("fused_i16", "fused_bf16"):
        ms = cuda_ms(lambda: model(rows, spectrum=spec, n_samples=n))
        print(f"[{label}] mfcc_change spectrum={spec!r} on the rows end to end: {ms:.3f} ms ({card}; {sm_clock()})")
    del rows
    torch.cuda.empty_cache()
    y_np = speechlike(TRACK_BATCH, SECONDS * TRACK_SR, TRACK_SR, seed=5)
    batch = mt.pad_batch(list(y_np), bucket_multiple=1, device=dev)
    tracker_report(label, batch, y_np, card)
    pyin = mt.F0Config(method="pyin")
    with spy(Y, "viterbi_decode") as calls:
        mt.batched_f0(batch, TRACK_SR, pyin)
    trellis = calls[0][0][:5]
    line(f"viterbi_fwd_f32, pyin's trellis {tuple(trellis[0].shape)}", lambda: VK.viterbi_forward(*trellis))
    delta_f, hist = VK.viterbi_forward(*trellis)
    banded = hasattr(VK, "backtrace_layout")  # a package from before the banded backtrace reads log_tri whole
    line(f"viterbi_bwd_f32, pyin's trellis {tuple(trellis[0].shape)} ({'banded' if banded else 'dense'})",
         lambda: VK.viterbi_backtrace(hist, delta_f, *trellis[2:]))
    del delta_f, hist
    ms = cuda_ms(lambda: mt.batched_f0(batch, TRACK_SR, pyin))
    print(f"[{label}] batched_f0 pyin on {tuple(batch.samples.shape)} end to end: {ms:.3f} ms ({card}; {sm_clock()})")
    del batch, trellis, calls
    torch.cuda.empty_cache()
    for what, x in c2_batches(y):
        f64 = model.trajectories(x.double(), spectrum="fft", coef_major=True)

        def err(m: torch.Tensor) -> float:
            check(m.shape == f64.shape and bool(torch.isfinite(m).all()), f"{what} MFCC shape")
            return float((m.double() - f64).abs().max())

        print(f"[{label}] MFCC on the {what} batch {tuple(x.shape)} against the float64 'fft' MFCC, max-abs: "
              + "; ".join(tc_mode_distances(x, cfg, model, ws, err)) + f" ({card})", flush=True)
        del f64
        torch.cuda.empty_cache()
    return 0


# ---------------------------------------------------------------------------
# Every rate and width the reference configures (phases 24-25)
# ---------------------------------------------------------------------------

# (label, sample rate, n_fft): the reference's defaults at common rates, hop
# int(0.005 sr), window int(0.025 sr), n_fft the smallest power of two ≥ the
# window (512 at 11.025 kHz, whose window is 275)
GEOMETRIES = (("11.025 kHz", 11_025, 512), ("22.05 kHz", 22_050, 1024), ("32 kHz", 32_000, 1024),
              ("44.1 kHz", 44_100, 2048), ("48 kHz", 48_000, 2048))
WIDE = mt.MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0, n_mels=256, n_mfcc=40)  # C4: past 128 and 32
# long hops (C9), where the span outgrows the full and compact plans:
# fused_mel_f32 takes the streamed plan at both, fused_mel_x3 at the second
LONG_HOPS = (("44.1 kHz, 20 ms hop", mt.MfccConfig(signal_sample_rate=44_100, n_fft=2048, tStep=0.02)),
             ("48 kHz, 30 ms hop, 64 ms window",
              mt.MfccConfig(signal_sample_rate=48_000, n_fft=4096, tStep=0.03, winLen=0.064)))


def geometry_configs() -> list[tuple[str, mt.MfccConfig]]:
    """Phase 24's configurations: GEOMETRIES, LONG_HOPS, then WIDE."""
    return ([(label, mt.MfccConfig(signal_sample_rate=sr, n_fft=n_fft)) for label, sr, n_fft in GEOMETRIES]
            + list(LONG_HOPS) + [("16 kHz, 256 mel bands, 40 MFCCs", WIDE)])


def rung(plan) -> str:
    """The ladder rung of a tc_plan: full, compact or streamed."""
    return "streamed" if plan.streamed else "compact" if plan.shifted else "full"


def tc_kp(w: dict, alg: str) -> int:
    """Kp of a mode's tensor-core basis layout."""
    return w["wri_tc" if alg in ("f32", "bf16", "x3") else "planes_tc"].shape[1] * ff._TC_STEP[alg]


def streamed_plan(alg: str, cfg: mt.MfccConfig, kp: int):
    """The streamed rung at this geometry, whatever tc_plan takes there."""
    return ff._plan_for(alg, cfg.hop_length, kp, cfg.n_mels, ff.BLOCK_FRAMES, False, ff._TC_STAGES, streamed=True)


def mel_under_plan(audio, cfg: mt.MfccConfig, alg: str, w: dict, plan, n_samples=None):
    """fused_mel_{alg}'s (mel, block maxima) under ``plan`` (_launch_tc's
    private plan argument, which the launcher checks), launched as
    fused_mel_frontend launches it; no launch counted."""
    t, buf_len, off = ff._geometry(audio, cfg.hop_length, cfg.n_fft, cfg.win_length, n_samples)
    nf = 1 + t // cfg.hop_length
    k = (w["planes"] if alg in ("i16", "i24") else w["wri"]).shape[-2]
    bins_pad, n_mels = w["melw"].shape[-2:]
    mel = torch.empty((audio.shape[0], nf, n_mels), dtype=torch.bfloat16 if alg == "bf16" else torch.float32,
                      device=audio.device)
    rc, bmax = ff._launch_tc(f"fused_mel_{alg}", audio, int(audio.dtype == torch.int16), w, mel, buf_len, k,
                             cfg.hop_length, off, nf, bins_pad, n_mels, plan=plan)
    ff.raise_on(rc, f"fused_mel_{alg}")
    return mel, bmax


def same_mel(a: tuple, b: tuple) -> str:
    """'bit-identical', or the max-abs of two (mel, block maxima) pairs."""
    if all(x.shape == y.shape and torch.equal(x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32),
                                              y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32))
           for x, y in zip(a, b)):
        return "bit-identical"
    return f"max-abs {max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)):.3e}"


def geometry_checks(dev) -> None:
    """Phase 24: every frontend mode against its plain version at each of
    geometry_configs (4 × 30 s: f32 on float32 audio, every mode on int16
    hop rows) by phase 2's and phase 14's bars, under the plan tc_plan
    gives (printed with its bytes), and mfcc_tail_f32 in both layouts on
    float32 and bf16 mel at WIDE's 256 bands and 40 coefficients, and on 512
    bands (f32 frontend and tail)."""
    for name, cfg in geometry_configs() + [("16 kHz, 512 mel bands, 40 MFCCs", replace(WIDE, n_mels=512))]:
        sr = cfg.signal_sample_rate
        y = speechlike(4, SECONDS * sr, sr, seed=24) * 0.5
        pcm = np.round(y * 32767.0).astype(np.int16)
        inputs = {"float32": (torch.tensor(y, device=dev), None), "int16 rows": (rows_of(pcm, cfg, dev), pcm.shape[1])}
        algs = ("f32",) if cfg.n_mels == 512 else ff.ALGORITHMS
        for alg in algs:
            w = mode_weights(cfg, alg, dev)
            kp = tc_kp(w, alg)
            plan = ff.tc_plan(alg, cfg.hop_length, kp, cfg.n_mels)
            for label, (x, ns) in inputs.items():
                if label == "float32" and alg != "f32":
                    continue
                kname = kernel_of(alg, cfg)
                reset(ff.LAUNCHES)
                mel_k, bmax_k = mode_kernel(x, cfg, alg, w, ns)
                torch.cuda.synchronize()
                check(ff.LAUNCHES[kname] == 1, f"{kname} {name} launched")
                mel_p, bmax_p = mode_plain(x, cfg, alg, w, ns)
                ex = plain64(x, cfg, w, ns) if alg == "f32" else x3_exact_mel(x, cfg, w, ns) if alg == "x3" else None
                runs = [(kname, (mel_k, bmax_k))]
                if kname == "fused_mel_fft_f32":  # the tensor-core kernel's plan at this geometry too
                    runs.append(("fused_mel_f32", tc_f32(x, cfg, w, ns)))
                for rname, got in runs:
                    fft = rname == "fused_mel_fft_f32"
                    ok, text = (partial(fft_error_ok, exact=float64_mel(x, cfg, ns)) if fft
                                else partial(mode_error_ok, alg, exact=ex))(*got, mel_p, bmax_p)
                    where = "" if fft else f", {rung(plan)} plan {tuple(plan)}"
                    print(f"[24] {name}: {rname} on {label} {tuple(x.shape)}, hop {cfg.hop_length}, Kp {kp}, "
                          f"{cfg.n_mels} mel bands{where}: {text}")
                    check(ok, f"{rname} {name} {label}")
                del mel_k, bmax_k, mel_p, bmax_p, ex, runs
            torch.cuda.empty_cache()
        if cfg.n_mels <= 128:
            continue
        w = mode_weights(cfg, "f32", dev)
        mel, bmax = mode_plain(inputs["float32"][0], cfg, "f32", w)
        pk = peak_db(bmax)
        dct = torch.tensor(ff.tail_dct(cfg.n_mfcc, cfg.n_mels), device=dev)
        for kind, m in (("float32", mel), ("bf16", mel.to(torch.bfloat16))):
            for transposed in (True, False):
                out_k = ff.mfcc_tail(m, pk, cfg.n_mfcc, transposed=transposed, dct=dct)
                out_p = ff.mfcc_tail_reference(m, pk, dct, transposed=transposed)
                torch.cuda.synchronize()
                err = float((out_k - out_p).abs().max())
                print(f"[24] {name}: mfcc_tail_f32 on {kind} mel {tuple(m.shape)}, {cfg.n_mfcc} coefficients, "
                      f"{'coef' if transposed else 'frame'}-major, vs plain: max-abs {err:.3e} (bar 1e-4)")
                check(out_k.shape == out_p.shape and err <= 1e-4, f"mfcc_tail_f32 {name} {kind} {transposed}")
    streamed_rung_checks(dev)
    long_hop_paths(dev)


def streamed_rung_checks(dev) -> None:
    """Phase 24: every mode under the streamed plan forced at the 16 kHz
    flagship (4 × 30 s: f32 on float32 audio, every mode on int16 hop rows),
    its mel and block maxima against the full plan's (printed: bit-identical
    or the max-abs) and against its plain version by phases 2's and 14's
    bars."""
    cfg = FLAGSHIP
    sr = cfg.signal_sample_rate
    y = speechlike(4, SECONDS * sr, sr, seed=24) * 0.5
    pcm = np.round(y * 32767.0).astype(np.int16)
    inputs = {"float32": (torch.tensor(y, device=dev), None), "int16 rows": (rows_of(pcm, cfg, dev), pcm.shape[1])}
    for alg in ff.ALGORITHMS:
        w = mode_weights(cfg, alg, dev)
        kp = tc_kp(w, alg)
        full, streamed = ff.tc_plan(alg, cfg.hop_length, kp, cfg.n_mels), streamed_plan(alg, cfg, kp)
        check(rung(full) == "full", f"fused_mel_{alg} keeps the full plan at the flagship")
        for label, (x, ns) in inputs.items():
            if label == "float32" and alg != "f32":
                continue
            got = mel_under_plan(x, cfg, alg, w, streamed, ns)
            want = mel_under_plan(x, cfg, alg, w, full, ns)
            mel_p, bmax_p = mode_plain(x, cfg, alg, w, ns)
            torch.cuda.synchronize()
            ex = plain64(x, cfg, w, ns) if alg == "f32" else x3_exact_mel(x, cfg, w, ns) if alg == "x3" else None
            ok, text = mode_error_ok(alg, *got, mel_p, bmax_p, ex)
            print(f"[24] 16 kHz flagship: fused_mel_{alg} on {label} under the streamed plan forced "
                  f"{tuple(streamed)} against the full plan {tuple(full)}: {same_mel(got, want)}; against its plain "
                  f"version: {text}")
            check(ok, f"fused_mel_{alg} streamed at the flagship {label}")
            del got, want, mel_p, bmax_p, ex
        torch.cuda.empty_cache()


def long_hop_paths(dev) -> None:
    """Phase 24: 'fused' mfcc_change at each of LONG_HOPS on 4 × 30 s of
    float32 audio end to end (fused_mel_f32 on the streamed plan): one
    launch of each MFCC kernel, against the float64 'fft' path by phase
    15's bar (1e-4)."""
    for label, cfg in LONG_HOPS:
        sr = cfg.signal_sample_rate
        y = torch.tensor(speechlike(4, SECONDS * sr, sr, seed=241), device=dev)
        kp = -(-cfg.win_length // 32) * 32
        plan = ff.tc_plan("f32", cfg.hop_length, kp, cfg.n_mels)
        reset(ff.LAUNCHES)
        tot = mt.mfcc_change(y, cfg)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        want = mt.mfcc_change(y.double(), cfg, spectrum="fft")
        err = float((tot.double() - want).abs().max())
        print(f"[24] {label}: mfcc_change 'fused' on [4, {y.shape[1]}] float32, fused_mel_f32 {rung(plan)} plan "
              f"{tuple(plan)}, launches {launches}; vs the float64 'fft' path max-abs {err:.3e} (bar 1e-4)")
        check(rung(plan) == "streamed", f"fused_mel_f32 streamed at {label}")
        check(launches == {"fused_mel_f32": 1, "mfcc_tail_f32": 1}, f"{label}: one launch of each MFCC kernel")
        check(tot.shape == want.shape and bool(torch.isfinite(tot).all()) and err <= 1e-4, f"{label} vs fft")
        del y, tot, want
        torch.cuda.empty_cache()


def f64_distance(model, x: torch.Tensor, routes: dict, chunk: int = 16) -> dict[str, float]:
    """Each route's coef-major MFCC's max-abs distance from the float64
    'fft' MFCC of the same audio (phase 23's measure), the float64 path run
    ``chunk`` utterances at a time to bound its memory."""
    got = {name: fn(x) for name, fn in routes.items()}
    dist = dict.fromkeys(routes, 0.0)
    for i in range(0, x.shape[0], chunk):
        f64 = model.trajectories(x[i : i + chunk].double(), spectrum="fft", coef_major=True)
        for name, m in got.items():
            part = m[i : i + chunk]
            check(part.shape == f64.shape and bool(torch.isfinite(part).all()), f"{name} MFCC shape")
            dist[name] = max(dist[name], float((part.double() - f64).abs().max()))
        del f64
        torch.cuda.empty_cache()
    return dist


def rate_paths(dev, card: str) -> None:
    """Phase 25: 'fused' mfcc_change at full width (128 × 30 s) at 44.1 kHz
    (n_fft 2048) and 11.025 kHz, where fused_mel_f32 takes the compact
    plan, and at 16 kHz with 256 mel bands and 40 MFCCs (two mel groups,
    two coefficient groups): one launch of each kernel, times as phase 5
    prints them, and the MFCC's distance from the float64 'fft' path,
    fused_mel_f32 no further than 1.05 × its plain version's (phase 23's
    rule); at 16 kHz also mfcc_tail_f32 with 40 coefficients of 128 mel
    bands, both layouts."""
    configs = [(label, mt.MfccConfig(signal_sample_rate=sr, n_fft=n_fft)) for label, sr, n_fft in
               (GEOMETRIES[3], GEOMETRIES[0])] + [("16 kHz, 256 mel bands, 40 MFCCs", WIDE)]
    for label, cfg in configs:
        sr, n_fft = cfg.signal_sample_rate, cfg.n_fft
        y = torch.tensor(speechlike(BATCH, SECONDS * sr, sr, seed=25), device=dev)
        reset(ff.LAUNCHES)
        tot = mt.mfcc_change(y, cfg)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        nf = 1 + y.shape[1] // cfg.hop_length
        kname = f32_kernel(cfg)
        check(launches == {kname: 1, "mfcc_tail_f32": 1}, f"{label}: one launch of each MFCC kernel")
        check(tot.shape == (BATCH, nf) and bool(torch.isfinite(tot).all()), f"{label}: finite [B, nf] output")
        model = mt.MfccChange(cfg).to(dev)
        a = frontend_args(cfg, dev)
        kp = a["w"]["wri_tc"].shape[1] * ff._TC_STEP["f32"]
        plan = ff.tc_plan("f32", cfg.hop_length, kp, cfg.n_mels)
        mel_k, bmax_k = frontend_kernel(y, cfg, a)
        pk = peak_db(bmax_k)
        ms = {
            kname: (kernel_ms(lambda: frontend_kernel(y, cfg, a)), kernel_ms(lambda: frontend_plain(y, cfg, a))),
            "mfcc_tail_f32": (cuda_ms(lambda: ff.mfcc_tail(mel_k, pk, cfg.n_mfcc, transposed=True, dct=a["dct"])),
                              cuda_ms(lambda: ff.mfcc_tail_reference(mel_k, pk, a["dct"], transposed=True))),
        }
        if cfg is WIDE:
            m128 = frontend_kernel(y, FLAGSHIP, frontend_args(FLAGSHIP, dev))[0]
            dct40 = torch.tensor(ff.tail_dct(WIDE.n_mfcc, 128), device=dev)
            for name, m, d in ((f"{WIDE.n_mels} mel bands", mel_k, a["dct"]), ("128 mel bands", m128, dct40)):
                for transposed in (True, False):
                    out_k = ff.mfcc_tail(m, pk, WIDE.n_mfcc, transposed=transposed, dct=d)
                    err = float((out_k - ff.mfcc_tail_reference(m, pk, d, transposed=transposed)).abs().max())
                    t_k = cuda_ms(lambda: ff.mfcc_tail(m, pk, WIDE.n_mfcc, transposed=transposed, dct=d))
                    t_p = cuda_ms(lambda: ff.mfcc_tail_reference(m, pk, d, transposed=transposed))
                    b = bound(m.numel() * 4 + m.shape[0] * 4 + d.numel() * 4 + out_k.numel() * 4,
                              m.numel() * (2 * WIDE.n_mfcc + 3))
                    print(f"[25] {label}: mfcc_tail_f32 with {WIDE.n_mfcc} coefficients of {name} "
                          f"{tuple(m.shape)}, {'coef' if transposed else 'frame'}-major: {t_k:.3f} ms, plain "
                          f"{t_p:.3f} ms, bound {b[0]:.3f} ms ({b[1]}; {b[0] / t_k:.1%}), vs plain max-abs {err:.3e} "
                          f"(bar 1e-4) ({card})")
                    check(err <= 1e-4, f"mfcc_tail_f32 {name} 40 coefficients")
                    del out_k
            del m128
        e2e, e2e_plain = cuda_ms(lambda: model(y)), cuda_ms(lambda: model(y, spectrum="matmul"))
        hours = BATCH * SECONDS / 3600.0
        bsz, nfr, n_mels = mel_k.shape
        k_sup, two_bins = a["wri"].shape
        f32_bytes = (y.numel() * 4 + (a["wri"].numel() + a["melw"].numel()) * 4 + mel_k.numel() * 4
                     + bmax_k.numel() * 4)
        b_f32 = (least_work_bound(cfg, bsz * nfr, y.numel() * 4 + mel_k.numel() * 4) if kname == "fused_mel_fft_f32"
                 else split3_bound(f32_bytes, bsz * nfr, k_sup, two_bins // 2, n_mels, dft_passes=6))
        print(f"[25] {label} (hop {cfg.hop_length}, window {cfg.win_length}, n_fft {n_fft}, Kp {kp}, bins_pad "
              f"{two_bins // 2}): mfcc_change 'fused' on [{BATCH}, {y.shape[1]}] float32, launches {launches}; "
              f"fused_mel_f32's plan there {tuple(plan)}")
        for k, (t_k, t_p) in ms.items():
            print(f"[25] {label}: {k}: {t_k:.3f} ms, plain {t_p:.3f} ms ({card}; SM clock, power, throttle "
                  f"reasons: {sm_clock()})")
        print(f"[25] {label}: {kname} bound {b_f32[0]:.3f} ms ({b_f32[1]}; the kernel's share "
              f"{b_f32[0] / ms[kname][0]:.1%}); mfcc_change end to end: {e2e:.3f} ms = "
              f"{hours / (e2e / 1e3):.3f} audio-h/s; plain spectrum {e2e_plain:.3f} ms = "
              f"{hours / (e2e_plain / 1e3):.3f} audio-h/s ({card})")
        del mel_k, bmax_k, tot
        torch.cuda.empty_cache()
        kernel, plain = f"{kname} (kernel)", "the 'f32' plain version"
        dist = f64_distance(model, y, {kernel: lambda x: model.trajectories(x, coef_major=True),
                                       plain: lambda x: via_tail(frontend_plain(x, cfg, a), cfg, model)})
        ratio = dist[kernel] / dist[plain]
        print(f"[25] {label}: the MFCC against the float64 'fft' MFCC, max-abs: {kname} {dist[kernel]:.3e} = "
              f"{ratio:.4f} × its plain version's {dist[plain]:.3e} (bar 1.05)")
        check(ratio <= 1.05, f"phase 25 {label}: {kname} no further from float64 than 1.05 × its plain version")
        del y, model, a
        torch.cuda.empty_cache()
    streamed_times(dev, card)


def streamed_times(dev, card: str) -> None:
    """Phase 25: the streamed plan's times at 128 × 30 s. At the 16 kHz
    flagship fused_mel_f32 (float32 audio) and fused_mel_x3 (int16 hop rows)
    under the full plan and forced onto the streamed one (their mel and
    maxima bit-identical, or the max-abs, printed); at LONG_HOPS under
    tc_plan's plan (f32 streamed at both, x3 at the second; x3's compact
    plan at the first forced onto the streamed one too); each beside its
    plain version (median of 3) and its bound, as phases 5 and 17 bound
    them."""
    for label, cfg in [("16 kHz flagship", FLAGSHIP)] + list(LONG_HOPS):
        sr = cfg.signal_sample_rate
        y = speechlike(BATCH, SECONDS * sr, sr, seed=25) * 0.5
        pcm = np.round(y * 32767.0).astype(np.int16)
        for alg, x, ns in (("f32", torch.tensor(y, device=dev), None), ("x3", rows_of(pcm, cfg, dev), pcm.shape[1])):
            w = mode_weights(cfg, alg, dev)
            kp = tc_kp(w, alg)
            plan = ff.tc_plan(alg, cfg.hop_length, kp, cfg.n_mels)
            plans = [plan] + ([streamed_plan(alg, cfg, kp)] if rung(plan) != "streamed" else [])
            mels = [mel_under_plan(x, cfg, alg, w, p, ns) for p in plans]
            times = [kernel_ms(lambda: mel_under_plan(x, cfg, alg, w, p, ns)) for p in plans]
            t_p = cuda_ms(lambda: mode_plain(x, cfg, alg, w, ns), reps=3)
            mel = mels[0][0]
            bsz, nf, n_mels = mel.shape
            k, bins = w["wri"].shape[-2], w["melw"].shape[-2]
            weights = sum(w[key].numel() * w[key].element_size() for key in ("wri", "melw"))
            n_bytes = x.numel() * x.element_size() + weights + mel.numel() * 4 + mels[0][1].numel() * 4
            if alg == "f32":
                b = split3_bound(n_bytes, bsz * nf, k, bins, n_mels, dft_passes=6)
            else:
                t_ops = 3 * (2.0 * bsz * nf * k * 2 * bins + 2.0 * bsz * nf * bins * n_mels) / PEAK_BF16_S * 1e3
                t_bytes = n_bytes / PEAK_BYTES_S * 1e3
                b = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            parts = [f"{rung(p)} plan {tuple(p)} {t:.3f} ms ({b[0] / t:.1%} of the bound)"
                     for p, t in zip(plans, times)]
            same = f"; the streamed plan's mel against the {rung(plan)} plan's: {same_mel(mels[1], mels[0])}" if (
                len(plans) > 1) else ""
            print(f"[25] {label} (hop {cfg.hop_length}, Kp {kp}, bins_pad {bins}): fused_mel_{alg} on "
                  f"{'float32' if ns is None else 'int16 rows'} {tuple(x.shape)}: " + "; ".join(parts)
                  + f"; plain {t_p:.3f} ms; bound {b[0]:.3f} ms ({b[1]}){same} ({card}; {sm_clock()})")
            del mels, x, w
            torch.cuda.empty_cache()


def verify_on_card() -> None:
    """Phase 26: the verify harness (modmfcc-torch verify) on the card at
    10 and 16 kHz: every one of its eleven surfaces passes."""
    import argparse
    import io
    from contextlib import redirect_stdout

    from modulation_mfcc_tpu_torch.runner import run_verify

    for sr in (10_000, 16_000):
        reset(ff.LAUNCHES, SK.LAUNCHES, BK.LAUNCHES, VK.LAUNCHES)
        out = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(out):
            rc = run_verify(argparse.Namespace(sr=sr, seconds=2.0, wav=None, device="cuda"))
        lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
        for line in lines:
            print(f"[26] verify --sr {sr}: {json.dumps(line)}")
        launched = sorted(k for c in (ff.LAUNCHES, SK.LAUNCHES, BK.LAUNCHES, VK.LAUNCHES) for k, v in c.items() if v)
        print(f"[26] verify --sr {sr}: {time.perf_counter() - t0:.3f} s, kernels launched {launched}")
        surfaces = {line["surface"] for line in lines if "surface" in line and line["pass"]}
        check(rc == 0 and len(surfaces) == 11 and lines[-1] == {"overall_pass": True}, f"verify --sr {sr}")


def envelope_times(dev, card: str) -> None:
    """Phase 27: the amplitude envelopes on 32 × 30 s at 16 kHz beside the
    trackers of phase 10: batched_envelope 'RMS' and 'Hilb' (one warm-up,
    median of 5), and 'RMSpraat', which is per file (extract_envelope over
    the 32 utterances, one pass after a warm-up file); the RMS batch against
    the CPU on utterance 0 (1e-4), Hilb's interior against the CPU (2e-2,
    the padded width's edge ripple)."""
    from modulation_mfcc_tpu_torch.models.envelope import rms_envelope
    from modulation_mfcc_tpu_torch.ops.hilbert import hilbert_envelope

    sr = TRACK_SR
    y_np = speechlike(TRACK_BATCH, SECONDS * sr, sr, seed=27)
    batch = mt.pad_batch(list(y_np), device=dev)
    hours = TRACK_BATCH * SECONDS / 3600.0
    for method in ("RMS", "Hilb"):
        cfg = mt.AmplitudeConfig(method=method)
        amp, valid = mt.batched_envelope(batch, sr, cfg)
        torch.cuda.synchronize()
        n = int(valid[0].sum())
        x0 = torch.tensor(y_np[0])
        want = (rms_envelope(x0, int(cfg.winLen * sr), int(cfg.hopLen * sr)) if method == "RMS"
                else hilbert_envelope(x0))
        m = 0 if method == "RMS" else n // 10
        err = float((amp[0, m : n - m].cpu() - want[m : n - m]).abs().max())
        bar = 1e-4 if method == "RMS" else 2e-2
        t = cuda_ms(lambda: mt.batched_envelope(batch, sr, cfg))
        print(f"[27] batched_envelope {method} on {tuple(batch.samples.shape)}: {t:.3f} ms = "
              f"{hours / (t / 1e3):.3f} audio-h/s; utterance 0 vs the CPU max-abs {err:.3e} (bar {bar:g}) ({card})")
        check(bool(torch.isfinite(amp).all()) and err <= bar, f"batched_envelope {method}")
    cfg = mt.AmplitudeConfig(method="RMSpraat")
    mt.extract_envelope(y_np[0], sr, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amps = [mt.extract_envelope(u, sr, cfg, device=dev)[0] for u in y_np]
    torch.cuda.synchronize()
    t = (time.perf_counter() - t0) * 1e3
    check(all(bool(torch.isfinite(a).all()) for a in amps), "RMSpraat envelopes")
    print(f"[27] extract_envelope RMSpraat over the {TRACK_BATCH} utterances one by one: {t:.3f} ms = "
          f"{hours / (t / 1e3):.3f} audio-h/s (host clock, one pass; {amps[0].shape[-1]} frames each) ({card})")


# Phase 28: BASELINE #2 (64 utterances of 1.5-30 s at 16 kHz, mfcc39) and the workbench's files
WF_BATCH, WF_MIN_S, WF_MAX_S, WF_SECONDS, WF_REPS = 64, 1.5, 30.0, 30, 5
WF_FEATURES = ("mod_cepstr", "mfcc", "envelope", "f0", "formant1", "formant2", "formant3", "soundwave")
WF_METHODS = ("gradient", "sg", "finDiff")


def derivative_f64(x: np.ndarray, d: int, dcfg) -> np.ndarray:
    """Velocity (d = 1) or acceleration (d = 2) along the last axis of a
    float64 host array, as the reference computes it at sr = 1:
    np.gradient applied d times, scipy's savgol_filter, or the Fornberg
    stencils of findiff (central inside, one-sided at the ends)."""
    import scipy.signal as sps

    from modulation_mfcc_tpu_torch.ops.derivatives import findiff_stencils

    if dcfg.derivative_method == "gradient":
        for _ in range(d):
            x = np.gradient(x, axis=-1)
        return x
    if dcfg.derivative_method == "sg":
        # scipy's correlation coefficients inside, its edge fits (savgol_filter on each end's window) at
        # the ends; a window holding a NaN (a formant track's missing frame) gives NaN, as a matmul does
        w, p = dcfg.sg_width, dcfg.sg_poly_order
        inside = np.lib.stride_tricks.sliding_window_view(x, w, axis=-1) @ sps.savgol_coeffs(w, p, d, use="dot")

        def edge(seg: np.ndarray, part: slice) -> np.ndarray:
            if not np.isfinite(seg).all():
                return np.full(seg.shape[:-1] + (w // 2,), np.nan)
            return sps.savgol_filter(seg, w, p, deriv=d, axis=-1, mode="interp")[..., part]

        return np.concatenate([edge(x[..., :w], slice(None, w // 2)), inside,
                               edge(x[..., -w:], slice(w - w // 2, None))], axis=-1)
    central, fwd, bwd, half = findiff_stencils(d, dcfg.fin_diff_acc_order, 1.0)
    t, n = x.shape[-1], len(fwd)
    interior = np.lib.stride_tricks.sliding_window_view(x, len(central), axis=-1) @ central
    lefts = [x[..., i : i + n] @ fwd for i in range(half)]
    rights = [x[..., t - (half - i) - n + 1 : t - (half - i) + 1] @ bwd for i in range(half)]
    return np.concatenate([np.stack(lefts, -1), interior, np.stack(rights, -1)], axis=-1)


def cmvn_f64(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """models/features.cmvn over valid frames, in float64 on the host."""
    w = mask[..., :, None]
    n = np.maximum(w.sum(-2, keepdims=True), 1.0)
    mu = (x * w).sum(-2, keepdims=True) / n
    var = ((x - mu) ** 2 * w).sum(-2, keepdims=True) / n
    return (x - mu) * w / (np.sqrt(var) + 1e-8) * w


def mfcc39_f64(m: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """mfcc_with_deltas(normalize=True) of an MFCC [B, NF, n_mfcc] over the
    valid frames [B, NF], in float64 on the host: scipy's savgol deltas
    (width 9), then CMVN."""
    import scipy.signal as sps

    m = m.astype(np.float64)
    d1 = sps.savgol_filter(m, 9, 1, deriv=1, axis=1, mode="interp")
    d2 = sps.savgol_filter(m, 9, 2, deriv=2, axis=1, mode="interp")
    return cmvn_f64(np.concatenate([m, d1, d2], -1), valid.astype(np.float64))


def mfcc39_batch(dev, card: str) -> tuple[mt.AudioBatch, np.ndarray]:
    """Phase 28 (a): BASELINE #2, the padded mfcc39 batch: 64 speech-like
    utterances, lengths uniform over 1.5-30 s at 16 kHz, through pad_batch →
    frame_validity_mask → mfcc_trajectories('fused') → mfcc_with_deltas
    (normalize=True): one launch of each MFCC kernel, padded frames exactly
    0, each utterance's valid frames of mean 0 (1e-5) and std 1 (1e-4), and
    the deltas and CMVN within 1e-4 of their float64 evaluation on the
    kernel's own MFCC (the new code alone).

    The kernels' MFCC is held, over the valid frames, to two routes that
    share none of its launches: the float64 'fft' MFCC of the same padded
    batch and mask (its own framing, STFT and masked top_db peak), and
    fused_mel_f32's and mfcc_tail_f32's plain versions with the peak masked
    as fused_mfcc masks it. Phase 23's bar: the kernels no further from
    float64 than 1.05 × the plain versions are (C2: on speech-like audio
    every float32 route is ~1.2e-3 from float64, the tail's FP32 DCT chains).
    The whole output is then held to mfcc39_f64 of the float64 MFCC at the
    same bar against the plain versions' MFCC through mfcc_with_deltas."""
    cfg, sr = FLAGSHIP, FLAGSHIP.signal_sample_rate
    rng = np.random.default_rng(28)
    lengths = rng.integers(int(WF_MIN_S * sr), int(WF_MAX_S * sr) + 1, size=WF_BATCH)
    signals = [speechlike(1, int(n), sr, seed=2800 + i)[0] for i, n in enumerate(lengths)]
    hours = float(lengths.sum()) / sr / 3600.0
    batch = mt.pad_batch(signals, device=dev)
    mask = mt.frame_validity_mask(batch.lengths, batch.samples.shape[-1], cfg)

    def mfcc39():
        m = mt.mfcc_trajectories(batch.samples, cfg, spectrum="fused", frame_mask=mask)
        return m, mt.mfcc_with_deltas(m, frame_mask=mask, normalize=True)

    reset(ff.LAUNCHES)
    m, out = mfcc39()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    print(f"[28] mfcc39 on {tuple(batch.samples.shape)} ({WF_BATCH} utterances, {hours:.4f} audio-h unpadded): "
          f"output {tuple(out.shape)}, launches {launches}")
    check(launches == {f32_kernel(cfg): 1, "mfcc_tail_f32": 1}, "mfcc39: one launch of each MFCC kernel")
    nf = mask.shape[-1]
    check(out.shape == (WF_BATCH, nf, 3 * cfg.n_mfcc) and bool(torch.isfinite(out).all()), "mfcc39 shape")
    valid = mask.cpu().numpy().astype(bool)
    got = out.cpu().numpy()
    check(not got[~valid].any(), "mfcc39: every padded frame exactly 0")
    mean_err = max(float(np.abs(got[b, valid[b]].astype(np.float64).mean(0)).max()) for b in range(WF_BATCH))
    std_err = max(float(np.abs(got[b, valid[b]].astype(np.float64).std(0) - 1.0).max()) for b in range(WF_BATCH))
    f64_err = float(np.abs(got - mfcc39_f64(m.cpu().numpy(), valid)).max())
    print(f"[28] mfcc39 over valid frames: per-utterance |mean| ≤ {mean_err:.3e} (bar 1e-5), |std − 1| ≤ "
          f"{std_err:.3e} (bar 1e-4); deltas + CMVN vs float64 on the kernel's MFCC max-abs {f64_err:.3e} (bar 1e-4)")
    check(mean_err <= 1e-5 and std_err <= 1e-4, "mfcc39: zero mean and unit std over each utterance's valid frames")
    check(f64_err <= 1e-4, "mfcc39: deltas and CMVN within 1e-4 of float64")

    ref = mt.mfcc_trajectories(batch.samples.double(), cfg, spectrum="fft", frame_mask=mask)
    a = frontend_args(cfg, dev)
    mel_p, _ = frontend_plain(batch.samples, cfg, a)
    live = mask[:, : mel_p.shape[1], None] > 0
    peak_p = 10.0 * torch.log10(torch.clamp(torch.amax(torch.where(live, mel_p, 0.0), dim=(1, 2)), min=1e-10))
    plain = ff.mfcc_tail_reference(mel_p, peak_p, a["dct"], transposed=False)
    out_p = mt.mfcc_with_deltas(plain, frame_mask=mask, normalize=True)
    torch.cuda.synchronize()
    check(plain.shape == m.shape == ref.shape and bool(torch.isfinite(ref).all()), "mfcc39: the MFCC routes' shapes")
    vt = mask.bool()
    e_k = float((m.double() - ref).abs()[vt].max())
    e_p = float((plain.double() - ref).abs()[vt].max())
    e_kp = float((m - plain).abs()[vt].max())
    ref39 = mfcc39_f64(ref.cpu().numpy(), valid)
    o_k = float(np.abs(got - ref39).max())
    o_p = float(np.abs(out_p.cpu().numpy() - ref39).max())
    print(f"[28] mfcc39's MFCC over valid frames against the float64 'fft' MFCC of the same padded batch and mask, "
          f"max-abs: the kernels {e_k:.3e}, their plain versions {e_p:.3e} (bar: kernels ≤ 1.05 × plain); kernels vs "
          f"plain {e_kp:.3e}. The [64, NF, 39] output against float64 deltas + CMVN of the float64 MFCC: the kernels' "
          f"{o_k:.3e}, the plain versions' {o_p:.3e} (bar: ≤ 1.05 × plain)")
    check(e_k <= 1.05 * e_p, "mfcc39: the kernels' MFCC no further from float64 than 1.05 × the plain versions'")
    check(o_k <= 1.05 * o_p, "mfcc39: the output no further from float64 than 1.05 × the plain versions'")
    del m, out, got, ref, ref39, mel_p, plain, out_p
    torch.cuda.empty_cache()
    t = cuda_ms(lambda: mfcc39())
    _, gib = peak_gib(lambda: mfcc39())
    m = mt.mfcc_trajectories(batch.samples, cfg, spectrum="fused", frame_mask=mask)
    t_mfcc = cuda_ms(lambda: mt.mfcc_trajectories(batch.samples, cfg, spectrum="fused", frame_mask=mask))
    t_deltas = cuda_ms(lambda: mt.mfcc_with_deltas(m, frame_mask=mask, normalize=True))
    print(f"[28] mfcc39 (BASELINE #2) at {WF_BATCH} × 1.5-30 s: {t:.3f} ms = {hours / (t / 1e3):.3f} audio-h/s over "
          f"the unpadded lengths (mfcc_trajectories {t_mfcc:.3f} ms, mfcc_with_deltas {t_deltas:.3f} ms alone); "
          f"peak device memory {gib:.3f} GiB above the batch ({card})")
    return batch, lengths


def peaks_at_batch_width(batch: mt.AudioBatch) -> None:
    """Phase 28 (b): peak_mask on the batch's [64, NF] mfcc_change tracks,
    padded frames set to +inf (never a peak, and the last valid frame never
    one either), equals scipy.signal.find_peaks on each row's valid frames."""
    import scipy.signal as sps

    tot, tmask = batched_mfcc_change(batch, FLAGSHIP)
    valid = tmask.bool()
    pm = mt.peak_mask(torch.where(valid, tot, torch.inf))
    torch.cuda.synchronize()
    tot_np, pm_np, n_valid = tot.cpu().numpy(), pm.cpu().numpy(), valid.sum(-1).cpu().numpy()
    n_peaks = 0
    for b in range(batch.batch_size):
        want = sps.find_peaks(tot_np[b, : n_valid[b]])[0]
        check(np.array_equal(np.flatnonzero(pm_np[b]), want), f"peak_mask row {b} equals scipy find_peaks")
        n_peaks += len(want)
    t = cuda_ms(lambda: mt.peak_mask(torch.where(valid, tot, torch.inf)))
    print(f"[28] peak_mask on {tuple(tot.shape)} mfcc_change tracks: {n_peaks} peaks, every row equal to "
          f"scipy.signal.find_peaks over its valid frames; {t:.3f} ms")


def workbench_files(root: str) -> tuple[str, str, str]:
    """A 30 s speech-like WAV at 16 kHz, a TextGrid of 30 one-second word
    intervals and an AG50x .pos file of 16 channels at 250 Hz over 30 s."""
    from modulation_mfcc_tpu_torch.io.ag50x import write_ag50x
    from modulation_mfcc_tpu_torch.io.textgrid import IntervalTier, TextGrid, write_textgrid
    from modulation_mfcc_tpu_torch.io.wav import write_wav

    sr = FLAGSHIP.signal_sample_rate
    wav, tg_path, pos_path = (os.path.join(root, name) for name in ("utt.wav", "utt.TextGrid", "utt.pos"))
    write_wav(wav, speechlike(1, WF_SECONDS * sr, sr, seed=2828)[0], sr)
    tg = TextGrid(xmin=0.0, xmax=float(WF_SECONDS))
    tier = IntervalTier(name="words", xmin=0.0, xmax=float(WF_SECONDS))
    for i in range(WF_SECONDS):
        tier.add(float(i), float(i + 1), f"w{i:02d}")
    tg.tiers = [tier]
    write_textgrid(tg, tg_path)
    walk = np.random.default_rng(2829).standard_normal((WF_SECONDS * 250, 16, 7)).cumsum(0).astype(np.float32)
    write_ag50x(pos_path, walk, 250)
    return wav, tg_path, pos_path


def workbench_session(dev, card: str) -> None:
    """Phase 28 (c): the workbench (AnalysisSession) on its files: every
    feature at derivations 0, 1 and 2 with each derivative method, two EMA
    channels likewise, region, max and min peaks, CSV with the word tier's
    aggregates, the interactive HTML; each derived curve within 1e-5 of its
    largest magnitude from the float64 derivation of its own trajectory,
    the CSV's columns equal to the session's curves, sinc_refine_f32 and
    burg_lpc_f32 launched, pyin's f0 through both Viterbi kernels, and each
    feature's extract_feature latency on the host clock (median, min and
    max of WF_REPS warm calls)."""
    import csv
    from dataclasses import replace as dc_replace

    from modulation_mfcc_tpu_torch.models.config import DerivationConfig, PipelineConfig

    cfg = PipelineConfig(mfcc=FLAGSHIP)
    with tempfile.TemporaryDirectory() as root:
        wav, tg_path, pos_path = workbench_files(root)
        reset(ff.LAUNCHES, SK.LAUNCHES, BK.LAUNCHES, VK.LAUNCHES)
        t0 = time.perf_counter()
        s = mt.AnalysisSession(wav, cfg, device=dev)
        s.load_textgrid(tg_path)
        s.load_pos(pos_path)
        traj, derived = {}, []
        for i, feature in enumerate(WF_FEATURES + ("ema3", "ema11")):
            for d in (0, 1, 2):
                for method in WF_METHODS if d else WF_METHODS[:1]:
                    dcfg = DerivationConfig(derivative_method=method)
                    name = f"{feature}_d{d}_{method}"
                    if feature.startswith("ema"):
                        c = s.add_ema_curve(int(feature[3:]), "z", panel=i % 4, derivation=d, name=name, dcfg=dcfg)
                    else:
                        c = s.add_curve(feature, panel=i % 4, derivation=d, dcfg=dcfg, name=name)
                    if d:
                        derived.append((c, feature, d, dcfg))
                    else:
                        traj[feature] = c
        torch.cuda.synchronize()
        session_s = time.perf_counter() - t0
        launches = {k: v for c in (ff.LAUNCHES, SK.LAUNCHES, BK.LAUNCHES, VK.LAUNCHES) for k, v in c.items() if v}
        print(f"[28] workbench: {len(s.curves)} curves of {len(WF_FEATURES)} features and 2 EMA channels at "
              f"derivations 0-2 ({', '.join(WF_METHODS)}) in {session_s:.3f} s (host clock); launches {launches}")
        check(all(launches.get(k, 0) >= 1 for k in ("fused_mel_fft_f32", "mfcc_tail_f32", "sinc_refine_f32",
                                                     "burg_lpc_f32")), "workbench: the MFCC, sinc and Burg kernels")
        worst = 0.0
        for c, feature, d, dcfg in derived:
            base = traj[feature]
            want = derivative_f64(base.values.astype(np.float64), d, dcfg)
            check(c.values.shape == want.shape and np.array_equal(np.isnan(c.values), np.isnan(want)),
                  f"{c.name}: shape and NaN pattern")
            rel = float(np.nanmax(np.abs(c.values - want)) / max(np.nanmax(np.abs(want)), 1e-30))
            worst = max(worst, rel)
            check(rel <= 1e-5, f"{c.name} within 1e-5 relative of its float64 derivation ({rel:.3e})")
        print(f"[28] workbench: {len(derived)} velocity and acceleration curves against their float64 derivation "
              f"(np.gradient, scipy savgol_filter, Fornberg stencils): worst {worst:.3e} of the curve's largest "
              f"magnitude (bar 1e-5)")
        for name in [n for n, c in s.curves.items() if c.feature in ("mfcc", "soundwave")]:
            s.remove_curve(name)  # the matrix and the 480,000-sample wave stay out of the table and the HTML
        s.set_region(2.0, 28.0)
        maxima, minima = s.analyze_max_peaks(), s.analyze_min_peaks()
        n_max, n_min = sum(len(v[0]) for v in maxima.values()), sum(len(v[0]) for v in minima.values())
        check(n_max > 0 and n_min > 0, "workbench: peaks in the region")
        out_csv = s.export_csv(os.path.join(root, "session.csv"), aggregate_tier="words")
        with open(out_csv, newline="") as f:
            rows = list(csv.reader(f))
        header, body = rows[0], rows[1:]
        for c in s.curves.values():
            for col, want in ((f"{c.name}_x", c.times), (f"{c.name}_y", c.values)):
                j = header.index(col)
                cells = [r[j] for r in body[: len(want)]]
                check(np.array_equal(np.array(cells, dtype=want.dtype), want, equal_nan=True)
                      and all(r[j] == "" for r in body[len(want):]), f"CSV column {col} equals the session's curve")
        check("interval_label" in header and [r[header.index("interval_label")] for r in body[:WF_SECONDS]]
              == [f"w{i:02d}" for i in range(WF_SECONDS)], "CSV word aggregates")
        html = s.render_interactive(os.path.join(root, "session.html"), show_spectrogram=False)
        html_bytes = os.path.getsize(html)
        check(html_bytes > 10_000, "interactive HTML written")
        print(f"[28] workbench: region 2-28 s, {n_max} maxima and {n_min} minima; CSV {len(header)} columns × "
              f"{len(body)} rows, every curve column equal to the session's curve; HTML {html_bytes} bytes")
        for feature in WF_FEATURES:
            ms = []
            for _ in range(1 + WF_REPS):  # one warm-up call, then WF_REPS timed
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                mt.extract_feature(wav, feature, cfg, derivation=0, device=dev)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            ms = ms[1:]
            print(f"[28] extract_feature {feature!r} on the {WF_SECONDS} s file: median {statistics.median(ms):.3f} ms "
                  f"of {WF_REPS} warm calls (min {min(ms):.3f}, max {max(ms):.3f}; host clock) ({card})")
        reset(VK.LAUNCHES)
        pyin_cfg = dc_replace(cfg, f0=dc_replace(cfg.f0, method="pyin"))
        t, f0 = mt.extract_feature(wav, "f0", pyin_cfg, derivation=1, device=dev)
        torch.cuda.synchronize()
        f0 = f0.cpu().numpy()
        print(f"[28] extract_feature 'f0' velocity with f0.method='pyin': {len(t)} frames, "
              f"{int(np.isfinite(f0).sum())} finite; launches {dict(VK.LAUNCHES)}")
        check(VK.LAUNCHES["viterbi_fwd_f32"] >= 1 and VK.LAUNCHES["viterbi_bwd_f32"] >= 1,
              "pyin f0 through both Viterbi kernels")
        check(f0.shape == t.shape and np.isfinite(f0).sum() > len(t) // 2, "pyin f0 velocity")


def analysis_workflow(dev, card: str) -> mt.AudioBatch:
    """Phase 28: the reference's analysis workflow on the card; its padded
    batch, on the host (phase 30 reads it)."""
    batch, _ = mfcc39_batch(dev, card)
    peaks_at_batch_width(batch)
    padded = mt.AudioBatch(batch.samples.cpu(), batch.lengths.cpu())
    del batch
    torch.cuda.empty_cache()
    workbench_session(dev, card)
    return padded


# ---------------------------------------------------------------------------
# Phase 29: the sweep's tracker extras, the loaders, the distributed paths, the CLI's sweep
# ---------------------------------------------------------------------------

EXTRAS = ("mod_cepstr", "mfcc39", "f0", "envelope", "formants")
EXTRA_KERNELS = ("fused_mel_fft_f32", "mfcc_tail_f32", "sinc_refine_f32", "burg_lpc_f32")


def counters() -> tuple[dict, ...]:
    """Every kernel module's launch counter (masked_scan imported here, not
    at the top, as --frontend may drive a package without it)."""
    from modulation_mfcc_tpu_torch.kernels import masked_scan as MS

    return ff.LAUNCHES, SK.LAUNCHES, BK.LAUNCHES, VK.LAUNCHES, MS.LAUNCHES


def launch_counts() -> dict[str, int]:
    return {k: v for c in counters() for k, v in c.items()}


@contextmanager
def native_spy():
    """The paths the native loader was given while the block runs."""
    orig, submitted = native.NativeBatchLoader, []

    class Spy(orig):
        def submit(self, index: int, path: str) -> None:
            submitted.append(path)
            super().submit(index, path)

    native.NativeBatchLoader = Spy
    try:
        yield submitted
    finally:
        native.NativeBatchLoader = orig


def voiced_agreement(rec: np.ndarray, single: np.ndarray) -> tuple[float, float]:
    """(share of frames with the same voicing, max |Hz| where both are voiced)."""
    both = (rec > 0) & (single > 0)
    return float(((rec > 0) == (single > 0)).mean()), float(np.abs(rec[both] - single[both]).max(initial=0.0))


def formants_close(got: np.ndarray, want: np.ndarray) -> tuple[bool, float]:
    """(same NaN pattern, share of frames whose values all lie within 0.05 Hz)."""
    same = np.array_equal(np.isfinite(got), np.isfinite(want))
    close = np.all(np.where(np.isfinite(want), np.abs(got - want), 0.0) <= 0.05, axis=-1)
    return same, float(close.mean())


def record_vs_per_file(rec, y: np.ndarray, dev, t_pad: int, xr_row: torch.Tensor) -> dict[str, float]:
    """One extras-sweep record against its file computed alone on the card.
    The sweep frames f0 and formants on the grid of the bucket's padded
    width (Praat's centred grid, as in the JAX sweep), so those, and mfcc39
    (whose deltas and CMVN see the padded frames), are held against the file
    alone zero-padded to that width, a batch of one: batched_f0,
    resample_poly_device → batched_formants, mfcc_trajectories →
    mfcc_with_deltas. The RMS envelope is frame-exact: extract_envelope.
    Formants and bandwidths are held on ``xr_row``, the file's row of its
    batch resampled as corpus._extras resamples it, through batched_formants
    alone; that row against the file resampled alone, and the formants of
    the file resampled alone, are held too (bandwidths there reported).
    extract_f0's raw first pass (post-processing off), on the file's own
    grid, is reported beside them."""
    cfg, sr = FLAGSHIP, FLAGSHIP.signal_sample_rate
    out = {}
    n = len(y)
    pcm = torch.zeros((1, t_pad), dtype=torch.int16, device=dev)
    pcm[0, :n] = torch.tensor(np.round(y * 32768.0).astype(np.int16), device=dev)
    one = mt.AudioBatch(pcm.float() * 2.0**-15, torch.tensor([n], device=dev))
    f0, valid = mt.batched_f0(one, sr, mt.F0Config())
    single = f0[0, : int(valid[0].sum())].cpu().numpy()
    check(single.shape == rec["f0"].shape, "f0 record length")
    out["f0_voicing"], out["f0_hz"] = voiced_agreement(rec["f0"], single)
    raw, _ = mt.extract_f0(y, sr, mt.F0Config(interpUnvoiced=None, outFilter=None), device=dev)
    raw = np.nan_to_num(raw.cpu().numpy(), nan=0.0)[: len(single)]
    both = (raw > 0) & (single > 0)
    out["own_grid_voicing"] = float(((raw > 0) == (single > 0)).mean())
    out["own_grid_median_hz"] = float(np.median(np.abs(raw[both] - single[both]))) if both.any() else 0.0
    amp, _ = mt.extract_envelope(y, sr, device=dev)
    nvf = len(rec["envelope"])
    out["envelope"] = float(np.abs(rec["envelope"] - amp[:nvf].cpu().numpy()).max())
    mask = mt.frame_validity_mask(one.lengths, t_pad, cfg)
    m39 = mt.mfcc_with_deltas(mt.mfcc_trajectories(pcm, cfg, frame_mask=mask), frame_mask=mask, normalize=True)
    nvf = len(rec["mfcc39"])
    out["mfcc39"] = float(np.abs(rec["mfcc39"] - m39[0, :nvf].cpu().numpy()).max())
    fm = mt.FormantConfig()
    up, dn = formant_ratio(sr, fm)
    alone = resample_poly_device(one.samples, up, dn)
    out["resample"] = float((alone[0] - xr_row).abs().max())
    nvf = len(rec["formants"])
    for prefix, xr in (("", xr_row[None]), ("alone_", alone)):
        fr, bw = mt.batched_formants(xr, sr * up / dn, fm)
        for key, got in (("formants", fr), ("formant_bw", bw)):
            same, close = formants_close(rec[key], got[0, :nvf].cpu().numpy())
            out[f"{prefix}{key}_nan_same"], out[f"{prefix}{key}_close"] = same, close
    return out


def formant_ratio(sr: float, fm: mt.FormantConfig) -> tuple[int, int]:
    """corpus._extras's resampling ratio for formants: 2 × max_formant
    over the rate, as a Fraction of denominator at most 1000."""
    frac = Fraction(int(round(2.0 * fm.max_formant)), int(round(sr))).limit_denominator(1000)
    return frac.numerator, frac.denominator


def resampled_rows(paths: list[str], picks: set[str], sweep: CorpusSweep, dev) -> dict[str, torch.Tensor]:
    """Each picked file's row of its sweep batch, resampled for formants as
    corpus._extras resamples the whole batch: the sweep's own decode and
    bucketing (corpus._decode_stream, corpus._bucketed_batches), then
    resample_poly_device on the dequantized [B, T] batch."""
    from modulation_mfcc_tpu_torch.parallel.corpus import _bucketed_batches, _decode_stream
    from modulation_mfcc_tpu_torch.utils.helpers import dequantize_samples

    up, dn = formant_ratio(sweep.cfg.signal_sample_rate, sweep.formant_cfg or mt.FormantConfig())
    rows = {}
    for group, arrays, _ in _bucketed_batches(_decode_stream(paths, sweep), sweep, {"assemble_busy_s": 0.0}, False):
        if picks.intersection(group):
            xr = resample_poly_device(dequantize_samples(torch.as_tensor(arrays["samples"], device=dev)), up, dn)
            rows.update({p: xr[k] for k, p in enumerate(group) if p in picks})
    return rows


def extras_sweep(dev, card: str, paths: list[str], hours: float, tmp: str) -> tuple[dict, str]:
    """Phase 29 (a): the sweep with every extra over the 256-file corpus,
    'fused', native loader; its launches and output directory."""
    from modulation_mfcc_tpu_torch.io.wav import load_channel
    from modulation_mfcc_tpu_torch.parallel.corpus import _output_names
    from modulation_mfcc_tpu_torch.utils.helpers import round_up_to_multiple

    cfg = FLAGSHIP
    out = os.path.join(tmp, "extras")
    sweep = CorpusSweep(out, cfg=cfg, spectrum="fused", features=EXTRAS, device=dev)
    reset(*counters())
    with native_spy() as submitted:
        rep = sweep_mfcc_change(paths, sweep)
    launches = launch_counts()
    print(f"[29] extras sweep {list(EXTRAS)} 'fused' over {len(paths)} files ({hours:.4f} h): {rep['items']} files, "
          f"{rep['audio_hours']} h in {rep['elapsed_sec']} s = {rep['audio_hours_per_sec']} audio-h/s; stages "
          f"{rep['stages']}; launches {({k: launches[k] for k in EXTRA_KERNELS})} ({card})")
    print(f"[29] the native loader ran: NativeBatchLoader was given {len(submitted)} of {len(paths)} files, in "
          f"manifest order: {submitted == paths}")
    check(rep["items"] == len(paths) and all(launches[k] > 0 for k in EXTRA_KERNELS), "extras sweep launches")
    check(submitted == paths, "the extras sweep decoded every file with the native loader")
    again = sweep_mfcc_change(paths, sweep)
    print(f"[29] resume: a second run processed {again['items']} files")
    check(again["items"] == 0, "resumed extras sweep skips every finished file")

    names = _output_names(paths)
    picks = [paths[i] for i in np.random.default_rng(291).choice(len(paths), 12, replace=False)]
    rows = resampled_rows(paths, set(picks), sweep, dev)
    worst: dict[str, float] = {}
    for p in picks:
        rec = np.load(os.path.join(out, names[p]))
        y = load_channel(p, cfg.signal_sample_rate).astype(np.float32)
        got = record_vs_per_file(rec, y, dev, round_up_to_multiple(len(y), sweep.bucket_multiple), rows[p])
        for k, v in got.items():
            worst[k] = min(worst.get(k, v), v) if k.endswith(("voicing", "close", "same")) else max(worst.get(k, v), v)
    print(f"[29] 12 records vs each file alone on the card (worst of 12): f0 voicing agreement "
          f"{worst['f0_voicing']:.4f} (bar 1), voiced Hz {worst['f0_hz']:.3e} (bar 0.05); envelope "
          f"{worst['envelope']:.3e} (bar 1e-6); mfcc39 {worst['mfcc39']:.3e} (bar 1e-5); the file's row of its batch "
          f"resampled as the sweep resamples it, through batched_formants alone: formants NaN pattern same "
          f"{bool(worst['formants_nan_same'])}, frames within 0.05 Hz {worst['formants_close']:.4f}; bandwidths NaN "
          f"pattern same {bool(worst['formant_bw_nan_same'])}, frames within 0.05 Hz {worst['formant_bw_close']:.4f} "
          f"(bars 0.95); that row against the file resampled alone: max-abs {worst['resample']:.3e} (bar 1e-6; "
          f"the resampling GEMM at another row count); the file resampled alone: formants NaN pattern same "
          f"{bool(worst['alone_formants_nan_same'])}, within 0.05 Hz {worst['alone_formants_close']:.4f} (bar 0.95), "
          f"bandwidths NaN pattern same {bool(worst['alone_formant_bw_nan_same'])}, within 0.05 Hz "
          f"{worst['alone_formant_bw_close']:.4f} (reported: Burg in float32 turns the resampling's last bits into "
          f"bandwidths); extract_f0's raw pass on the file's own grid: voicing agreement "
          f"{worst['own_grid_voicing']:.4f}, median |Hz| {worst['own_grid_median_hz']:.3f} (reported, no bar: another "
          f"frame grid)")
    check(worst["f0_voicing"] == 1.0 and worst["f0_hz"] <= 0.05 and worst["envelope"] <= 1e-6
          and worst["mfcc39"] <= 1e-5 and worst["formants_nan_same"] and worst["formants_close"] >= 0.95
          and worst["formant_bw_nan_same"] and worst["formant_bw_close"] >= 0.95 and worst["resample"] <= 1e-6
          and worst["alone_formants_nan_same"] and worst["alone_formants_close"] >= 0.95
          and worst["alone_formant_bw_nan_same"], "extras records vs per file")

    for label, subset, kw in (("f0 pyin", paths[:32], dict(features=("mod_cepstr", "f0"),
                                                            f0_cfg=mt.F0Config(method="pyin"))),
                              ("envelope RMSpraat", paths[:8], dict(features=("mod_cepstr", "envelope"),
                                                                     amp_cfg=mt.AmplitudeConfig(method="RMSpraat")))):
        d = os.path.join(tmp, label.replace(" ", "_"))
        reset(*counters())
        rep = sweep_mfcc_change(subset, CorpusSweep(d, cfg=cfg, spectrum="fused", device=dev, **kw))
        got = {k: v for k, v in launch_counts().items() if v}
        key = kw["features"][1]
        recs = [np.load(os.path.join(d, names[p])) for p in subset]
        ok = all(np.isfinite(r[key]).all() and len(r[key]) == len(r[key + "_times"]) > 0 for r in recs)
        print(f"[29] sweep {label} over {len(subset)} files: {rep['audio_hours']} h in {rep['elapsed_sec']} s = "
              f"{rep['audio_hours_per_sec']} audio-h/s; launches {got}; records finite with their times: {ok} ({card})")
        check(rep["items"] == len(subset) and ok, f"sweep {label}")
        if key == "f0":
            check(got.get("viterbi_fwd_f32", 0) > 0 and got.get("viterbi_bwd_f32", 0) > 0, "pyin sweep Viterbi kernels")
            launches["viterbi_fwd_f32"], launches["viterbi_bwd_f32"] = got.get("viterbi_fwd_f32", 0), got.get("viterbi_bwd_f32", 0)
        else:
            y = load_channel(subset[0], cfg.signal_sample_rate).astype(np.float32)
            amp, _ = mt.extract_envelope(y, cfg.signal_sample_rate, mt.AmplitudeConfig(method="RMSpraat"), device=dev)
            err = float(np.abs(recs[0]["envelope"] - amp.cpu().numpy()).max())
            print(f"[29] RMSpraat record vs extract_envelope of its file: max-abs {err:.3e} dB (bar 1e-5)")
            check(recs[0]["envelope"].shape == tuple(amp.shape) and err <= 1e-5, "RMSpraat record vs per file")
    return launches, out


def loaders(paths: list[str]) -> None:
    """Phase 29 (b): the native and Python loaders decode every file alike."""
    from modulation_mfcc_tpu_torch.parallel.corpus import _decode_stream

    decoded, secs = {}, {}
    for use in (True, False):
        t0 = time.perf_counter()
        decoded[use] = list(_decode_stream(paths, CorpusSweep("unused", cfg=FLAGSHIP, use_native_loader=use)))
        secs[use] = time.perf_counter() - t0
    same = [p for p, _ in decoded[True]] == [p for p, _ in decoded[False]] == paths and all(
        np.array_equal(a.astype(np.float32) / (32768.0 if a.dtype == np.int16 else 1.0), b)
        for (_, a), (_, b) in zip(decoded[True], decoded[False]))
    dtypes = sorted({str(a.dtype) for _, a in decoded[True]})
    print(f"[29] loaders over {len(paths)} files: native {secs[True]:.3f} s ({dtypes}), Python {secs[False]:.3f} s "
          f"(host clock); every file decoded identically: {same}")
    check(same, "native and Python loaders decode alike")


def distributed(dev, card: str, tmp: str) -> None:
    """Phase 29 (c): the dry run's certifications over NCCL at world =
    the cards here; sharded_mfcc_change and sharded_longform_mfcc_change at
    full size on a world of one; the per-shard step for four shards of the
    hour on this card."""
    from modulation_mfcc_tpu_torch import dryrun
    from modulation_mfcc_tpu_torch.parallel.batch import sharded_mfcc_change
    from modulation_mfcc_tpu_torch.parallel.mesh import make_mesh
    from modulation_mfcc_tpu_torch.parallel.multislice import init_distributed

    n_gpu = torch.cuda.device_count()
    worlds = [w for w in (n_gpu, 2, 4) if w <= n_gpu]
    for w in sorted(set(worlds)):
        t0 = time.perf_counter()
        errs = dryrun.dryrun_multichip(w, "cuda")
        print(f"[29] dryrun certify over NCCL, world {w}: every check passed in {time.perf_counter() - t0:.3f} s "
              f"(host clock, spawn included); max-abs {errs}")
    if n_gpu < 2:
        print(f"[29] worlds of 2 and 4 ranks not run: {n_gpu} card here, NCCL needs a card a rank")

    cfg, sr = FLAGSHIP, FLAGSHIP.signal_sample_rate
    check(init_distributed(f"file://{tmp}/store", 1, 0, backend="nccl"), "world of one")
    try:
        mesh = make_mesh(1, 1, device_type="cuda")
        lengths = np.random.default_rng(29).integers(15 * sr, SECONDS * sr + 1, size=BATCH)
        y = speechlike_on_card(BATCH * SECONDS * sr, sr, seed=29).reshape(BATCH, SECONDS * sr)
        y = y * (torch.arange(SECONDS * sr, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None])
        batch = mt.AudioBatch(y, torch.tensor(lengths, device=dev))
        tot, mask, mean = sharded_mfcc_change(batch, cfg, mesh, masked_fir=True)
        ref, ref_mask = batched_mfcc_change(batch, cfg, masked_fir=True)
        ref_mean = float((ref.double() * ref_mask).sum() / ref_mask.sum())
        err = float(((tot - ref) * mask).abs().max())
        ms_s = cuda_ms(lambda: sharded_mfcc_change(batch, cfg, mesh, masked_fir=True))
        ms_b = cuda_ms(lambda: batched_mfcc_change(batch, cfg, masked_fir=True))
        print(f"[29] sharded_mfcc_change on [{BATCH}, {SECONDS * sr}] (15-30 s) at world 1 vs batched_mfcc_change: "
              f"max-abs {err:.3e} (bar 0), masks equal {bool(torch.equal(mask, ref_mask))}, corpus mean "
              f"{float(mean):.6f} vs {ref_mean:.6f}; {ms_s:.3f} ms vs {ms_b:.3f} ms ({card})")
        check(err == 0.0 and torch.equal(mask, ref_mask) and abs(float(mean) - ref_mean) <= 1e-5 * abs(ref_mean),
              "sharded_mfcc_change at world 1")
        del y, batch, tot, mask, ref, ref_mask
        torch.cuda.empty_cache()

        y16 = mt.resample_device(speechlike_on_card(LONG_SR * LONG_SECONDS, LONG_SR, seed=20), LONG_SR, sr)
        whole = mt.mfcc_change(y16, cfg)
        got = streaming.sharded_longform_mfcc_change(y16, cfg, mesh)
        err = float((got - whole).abs().max())
        ms_l = cuda_ms(lambda: streaming.sharded_longform_mfcc_change(y16, cfg, mesh), reps=3)
        ms_w = cuda_ms(lambda: mt.mfcc_change(y16, cfg), reps=3)
        print(f"[29] sharded_longform_mfcc_change on the hour at world 1 [{got.shape[0]}] vs whole-file 'fused': "
              f"max-abs {err:.3e} (bar 1e-5); {ms_l:.3f} ms vs {ms_w:.3f} ms whole-file (medians of 3) ({card})")
        check(got.shape == whole.shape and err <= 1e-5, "time-sharded hour vs whole-file")
    finally:
        torch.distributed.destroy_process_group()

    n_t = 4
    g = streaming.longform_shards(y16.shape[0], cfg, n_t)
    reset(ff.LAUNCHES)
    t0 = time.perf_counter()
    mels = [streaming.shard_mel(streaming.extended_shard(y16, i, g), i, n_t, g.t_true, cfg) for i in range(n_t)]
    peak = torch.stack([p for _, p in mels]).max()
    m = torch.cat([streaming.shard_mfcc(mel, peak, i, n_t, g.t_true, cfg) for i, (mel, _) in enumerate(mels)])
    got = streaming._trajectory_postprocess(m[: g.nf_total], cfg)
    torch.cuda.synchronize()
    err = float((got - whole).abs().max())
    print(f"[29] per-shard step, {n_t} shards of the hour in turn on this card (halos {g.pad} + {g.halo_r} samples "
          f"sliced from the whole signal, the max of the 4 peaks): max-abs {err:.3e} from whole-file (bar 1e-5); "
          f"launches {dict(ff.LAUNCHES)}; {time.perf_counter() - t0:.3f} s (host clock)")
    check(err <= 1e-5 and ff.LAUNCHES[f32_kernel(cfg)] == n_t and ff.LAUNCHES["mfcc_tail_f32"] == n_t,
          "four-shard step vs whole-file")


def cli_shards(card: str, root: str, paths: list[str], extras_out: str, tmp: str) -> None:
    """Phase 29 (d): the CLI's sweep in two manifest shards at the flagship
    configuration (a reference-schema JSON), run together; their union
    against the extras sweep's mod_cepstr records."""
    from modulation_mfcc_tpu_torch.parallel.corpus import _output_names

    outs = [os.path.join(tmp, f"cli{k}") for k in (0, 1)]
    config = mt.save_config(mt.PipelineConfig(mfcc=FLAGSHIP), os.path.join(tmp, "flagship.json"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "modulation_mfcc_tpu_torch.cli", "sweep", root, "--out", outs[k],
                               "--config", config, "--num-shards", "2", "--shard-id", str(k)],
                              cwd=Path(__file__).resolve().parent,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for k in (0, 1)]
    results = [p.communicate(timeout=600) for p in procs]
    wall = time.perf_counter() - t0
    for k, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        check(p.returncode == 0, f"cli sweep shard {k} exited {p.returncode}: {stderr[-2000:]}")
        print(f"[29] cli sweep --num-shards 2 --shard-id {k}: {stdout.strip().splitlines()[-1]}")
    names = set(_output_names(paths).values())
    union = [set(n for n in os.listdir(o) if n.endswith(".npz")) for o in outs]
    covered = (union[0] | union[1]) == names and not (union[0] & union[1])
    err = 0.0
    for o, shard in zip(outs, union):
        for n in shard:
            got, want = np.load(os.path.join(o, n)), np.load(os.path.join(extras_out, n))
            check(np.array_equal(got["times"], want["times"]), f"cli record {n} times")
            err = max(err, float(np.abs(got["mod_cepstr"] - want["mod_cepstr"]).max()))
    print(f"[29] cli shards: {len(union[0])} + {len(union[1])} records in {wall:.3f} s (host clock, both processes "
          f"together); union equals the extras sweep's {len(names)} records: {covered}; mod_cepstr max-abs "
          f"{err:.3e} (bar 1e-5) ({card})")
    check(covered and err <= 1e-5, "cli shards vs the sweep")


def sweep_extras_and_distributed(dev, card: str) -> dict:
    """Phase 29; the launches of its extras sweep (the pyin sweep's for the
    Viterbi kernels)."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "wav")
        paths, hours = write_corpus(root, 256, FLAGSHIP.signal_sample_rate, seed=16)
        launches, extras_out = extras_sweep(dev, card, paths, hours, tmp)
        loaders(paths)
        torch.cuda.empty_cache()
        distributed(dev, card, tmp)
        torch.cuda.empty_cache()
        cli_shards(card, root, paths, extras_out, tmp)
    return launches


# ---------------------------------------------------------------------------
# Phase 30: the public surface closed against the JAX package
# ---------------------------------------------------------------------------

SURFACE_REL = 1e-5  # phase 30's bar, relative to the peak, for float32 results the card and the CPU compute apart


def rel_to_peak(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max-abs difference, that over the peak |want|), the card's result
    brought to the CPU."""
    err = float((got.cpu().double() - want.double()).abs().max())
    return err, err / float(want.abs().max())


def extract_mfcc_phase(y: np.ndarray, card: str) -> None:
    """Phase 30 (a): extract_mfcc on one utterance under the flagship
    configuration and under MfccConfig() (cfg left out): on CUDA by
    default, one launch of each MFCC kernel, bit for bit
    extract_mfcc_matrix on the card, against the port on the CPU within
    SURFACE_REL of the coefficients' peak; its time; extract_modulation
    equal to extract_mfcc_change."""
    for label, cfg, args in (("flagship", FLAGSHIP, (FLAGSHIP,)), ("MfccConfig()", DEFAULT_10K, ())):
        reset(ff.LAUNCHES)
        t, m = mt.extract_mfcc(y, *args)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        t_m, m_m = mt.models.modulation.extract_mfcc_matrix(y, cfg)
        t_c, m_c = mt.extract_mfcc(y, *args, device="cpu")
        nf = 1 + len(y) // cfg.hop_length
        err, rel = rel_to_peak(m, m_c)
        ms = cuda_ms(lambda: mt.extract_mfcc(y, *args))
        print(f"[30] extract_mfcc on {len(y) / FLAGSHIP.signal_sample_rate:.0f} s ({len(y)} samples) under {label}: "
              f"{tuple(m.shape)} on {m.device}, launches {launches}; bit for bit extract_mfcc_matrix on the card "
              f"{torch.equal(m, m_m)}; vs the CPU max-abs {err:.3e} dB, {rel:.3e} of the peak "
              f"{float(m_c.abs().max()):.3f} (bar {SURFACE_REL:g}); {ms:.3f} ms ({card})")
        check(m.device.type == "cuda" and m.shape == m_c.shape == (nf, cfg.n_mfcc) and bool(torch.isfinite(m).all()),
              f"extract_mfcc under {label}: on CUDA, [NF, n_mfcc], finite")
        check(launches == {f32_kernel(cfg): 1, "mfcc_tail_f32": 1}, f"extract_mfcc under {label}: one launch each")
        check(np.array_equal(t, t_m) and np.array_equal(t, t_c) and torch.equal(m, m_m),
              f"extract_mfcc under {label} is extract_mfcc_matrix")
        check(rel <= SURFACE_REL, f"extract_mfcc under {label} vs the CPU")
    tot, t = mt.extract_modulation(y)
    want, t_w = mt.extract_mfcc_change(y)
    print(f"[30] extract_modulation on the same utterance (MfccConfig()): {tuple(tot.shape)}, equal to "
          f"extract_mfcc_change {torch.equal(tot, want) and np.array_equal(t, t_w)}")
    check(tot.device.type == "cuda" and torch.equal(tot, want) and np.array_equal(t, t_w),
          "extract_modulation is extract_mfcc_change")


TRACED_KERNELS = ("fused_mel_fft_kernel", "mfcc_tail_kernel")  # the __global__ names of fused_mel_fft_f32, mfcc_tail_f32


def profiled_mfcc_change(y: torch.Tensor) -> dict:
    """One flagship mfcc_change of ``y`` inside utils.obs.profile_trace: its
    ms (CUDA events), the block's host seconds (the pad's count, the pad
    and the trace's writing included), its launches, the trace's bytes and
    events, the call's kernel launches and the kernel events traced of
    them, the pad's launches lost, and the kernel names holding
    TRACED_KERNELS."""
    with tempfile.TemporaryDirectory() as d:
        reset(ff.LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with profile_trace(d):
            start.record()
            mt.mfcc_change(y, FLAGSHIP)
            end.record()
        wall = time.perf_counter() - t0
        files = list(Path(d).glob("*.pt.trace.json"))
        check(len(files) == 1, f"profile_trace wrote one trace under its directory: {[f.name for f in files]}")
        events = json.loads(files[0].read_text())["traceEvents"]
        size = files[0].stat().st_size
    launched, kernels, pad, lost_pad = traced_launches(events)
    names = [k["name"] for k in kernels]
    return {"ms": start.elapsed_time(end), "wall_s": wall, "launches": {k: v for k, v in ff.LAUNCHES.items() if v},
            "bytes": size, "events": len(events), "launched": len(launched), "traced": len(kernels),
            "pad": pad, "lost_pad": lost_pad,
            "ours": {base: sorted({k for k in names if base in k}) for base in TRACED_KERNELS}}


def flagship_batch() -> torch.Tensor:
    sr = FLAGSHIP.signal_sample_rate
    return speechlike_on_card(BATCH * SECONDS * sr, sr, seed=30).reshape(BATCH, SECONDS * sr)


def unpadded_records(y: torch.Tensor) -> tuple[int, int]:
    """(kernel launches, of them traced) of one flagship mfcc_change in a
    plain torch.profiler window, without kernel_profile's pad."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mt.mfcc_change(y, FLAGSHIP)
        torch.cuda.synchronize()
    launched, kernels, _, _ = traced_launches(trace_events(prof))
    return len(launched), len(kernels)


TRACE_WINDOWS = 8  # phase 30 (b)'s profile_trace windows, each after an untraced call


def traced_mfcc_change(card: str) -> None:
    """Phase 30 (b): profile_trace around a warmed flagship mfcc_change at
    128 x 30 s in this script's process, minutes old by now, in
    TRACE_WINDOWS windows, each after an untraced call: at least all but
    two traces hold every kernel the call launched, the tensor-core
    frontend's and the tail's __global__ kernels (launched through ctypes)
    among them, and every window that lost any said so
    (``profile.kernel_records_lost``). Beside them the same call in a plain
    torch.profiler window, which in a process this old loses its first
    launches' records (the ones utils.obs.kernel_profile's pad takes); the
    call's time with and without the profiler, and the trace's size."""
    y = flagship_batch()
    ms = cuda_ms(lambda: mt.mfcc_change(y, FLAGSHIP))
    runs = []
    for _ in range(TRACE_WINDOWS):
        mt.mfcc_change(y, FLAGSHIP)
        with obs_events() as seen:
            r = profiled_mfcc_change(y)
        r["reported"] = sum(f["lost"] for e, f in seen if e == "profile.kernel_records_lost")
        runs.append(r)
    mt.mfcc_change(y, FLAGSHIP)
    plain_launched, plain_traced = unpadded_records(y)
    whole = [r for r in runs if r["traced"] == r["launched"] > 0]
    r = whole[0] if whole else runs[0]
    print(f"[30] profile_trace around a warmed mfcc_change at [{BATCH}, {SECONDS * FLAGSHIP.signal_sample_rate}] in "
          f"this process, {TRACE_WINDOWS} windows: every kernel of the call traced in {len(whole)}; per window traced/"
          f"launched (pad launches, of them lost; records lost as reported) "
          + ", ".join(f"{q['traced']}/{q['launched']} ({q['pad']}, {q['lost_pad']}; {q['reported']})" for q in runs)
          + f". A plain torch.profiler window, no pad: {plain_traced} of {plain_launched} traced ({card})")
    print(f"[30] one whole trace: {r['events']} events, {r['bytes']} bytes; launches {r['launches']}; the frontend's "
          f"kernel {r['ours'][TRACED_KERNELS[0]]}, the tail's {r['ours']['mfcc_tail_kernel']}; the call "
          f"{r['ms']:.3f} ms under profile_trace (CUDA events; median over the windows "
          f"{statistics.median(q['ms'] for q in runs):.3f}; the block {r['wall_s']:.3f} s on the host clock, the pad's "
          f"count, the pad and the trace's writing included), {ms:.3f} ms without (median of 5) ({card})")
    check(all(q["launches"] == {f32_kernel(FLAGSHIP): 1, "mfcc_tail_f32": 1} for q in runs)
          and len(whole) >= TRACE_WINDOWS - 2 and all(all(q["ours"].values()) for q in whole),
          "profile_trace: every kernel of the call in the trace, the frontend's and the tail's among them")
    check(all((q["traced"] < q["launched"]) == (q["reported"] > 0) for q in runs),
          "profile_trace: a window that lost kernel records said so, and no other did")


def masked_and_hamming(dev, padded: mt.AudioBatch) -> None:
    """Phase 30 (c): mfcc_change(frame_mask=...) on phase 28's padded batch
    on the card, phase 15's rule: every row against that row run alone on
    the card (each row sets its own top_db peak from its own row of the
    mask; the filters run unmasked), 1e-5; and its first, shortest, longest
    and last rows against the port on the CPU, 1e-5. (d)
    melspectrogram(window='hamming') on frames of 4 x 30 s on the card
    against the CPU, both spectra, SURFACE_REL of the peak."""
    from modulation_mfcc_tpu_torch.ops import spectral
    from modulation_mfcc_tpu_torch.ops.framing import frame_signal

    cfg = FLAGSHIP
    x = padded.samples.to(dev)
    mask = mt.frame_validity_mask(padded.lengths.to(dev), x.shape[-1], cfg)
    reset(ff.LAUNCHES)
    got = mt.mfcc_change(x, cfg, frame_mask=mask)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    alone = max(float((got[i] - mt.mfcc_change(x[i:i + 1], cfg, frame_mask=mask[i:i + 1])[0]).abs().max())
                for i in range(x.shape[0]))
    lens = padded.lengths.numpy()
    rows = sorted({0, int(lens.argmin()), int(lens.argmax()), x.shape[0] - 1})
    want = mt.mfcc_change(padded.samples[rows], cfg, frame_mask=mask[rows].cpu())
    err = float((got[rows].cpu() - want).abs().max())
    sr = cfg.signal_sample_rate
    print(f"[30] mfcc_change(frame_mask=...) on phase 28's padded batch {tuple(x.shape)} "
          f"({lens.min() / sr:.2f}-{lens.max() / sr:.2f} s): {tuple(got.shape)}, "
          f"launches {launches}; all {x.shape[0]} rows vs each row alone on the card max-abs {alone:.3e} (bar 1e-5); "
          f"rows {rows} (first, shortest, longest, last) vs the CPU max-abs {err:.3e} (bar 1e-5)")
    check(got.shape == mask.shape and bool(torch.isfinite(got).all()) and launches == {
        f32_kernel(cfg): 1, "mfcc_tail_f32": 1} and alone <= 1e-5 and err <= 1e-5,
          "mfcc_change(frame_mask=...): every row vs itself alone, sampled rows vs the CPU")
    del x, got
    frames = frame_signal(speechlike_on_card(4 * SECONDS * cfg.signal_sample_rate, cfg.signal_sample_rate, seed=31)
                          .reshape(4, -1), cfg.n_fft, cfg.hop_length)
    kw = dict(sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, n_mels=cfg.n_mels, fmin=cfg.minFreq, fmax=cfg.maxFreq,
              window="hamming", win_length=cfg.win_length)
    for use_fft in (True, False):
        mel = spectral.melspectrogram(frames, use_fft=use_fft, **kw)
        mel_c = spectral.melspectrogram(frames.cpu(), use_fft=use_fft, **kw)
        err, rel = rel_to_peak(mel, mel_c)
        print(f"[30] melspectrogram(window='hamming', use_fft={use_fft}) on {tuple(frames.shape)} frames: "
              f"{tuple(mel.shape)}, vs the CPU max-abs {err:.3e}, {rel:.3e} of the peak (bar {SURFACE_REL:g})")
        check(mel.is_cuda and mel.shape == mel_c.shape and rel <= SURFACE_REL, "melspectrogram hamming vs the CPU")


def public_surface(dev, card: str, padded: mt.AudioBatch) -> None:
    """Phase 30."""
    t0 = time.perf_counter()
    sr = FLAGSHIP.signal_sample_rate
    extract_mfcc_phase(speechlike(1, SECONDS * sr, sr, seed=30)[0], card)
    traced_mfcc_change(card)
    torch.cuda.empty_cache()
    masked_and_hamming(dev, padded)
    torch.cuda.empty_cache()
    print(f"[30] phase 30 took {time.perf_counter() - t0:.3f} s (host clock)")


# ---------------------------------------------------------------------------
# Phase 31: the masked routes' trajectory kernels at timit16k.short's size
# ---------------------------------------------------------------------------

SCAN_BATCH, SCAN_BUCKET = 1024, 65_536  # timit16k.short: 1,024 utterances of one 4.1 s bucket a batch
# the gradient norm against its torch ops (tests/test_torch_masked_scan.py): C = 12 squares summed in another
# order, each order within C - 1 units of roundoff, the root and the division two more each way
GRAD_NORM_RTOL = ((12 - 1) + 4) * 2.0**-24


def once_ms(fn) -> tuple[object, float]:
    """(fn's result, its CUDA-event ms), one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def launch_ms(fn, n: int = 20) -> float:
    """ms a launch of ``fn``, over a loop of ``n`` (median of 5), so the
    wrapper's host work hides behind the kernels before it."""
    return cuda_ms(lambda: [fn() for _ in range(n)]) / n


def timit_batch(pcm: torch.Tensor, lengths: torch.Tensor) -> mt.AudioBatch:
    """``pcm`` [B, SCAN_BUCKET] int16 zeroed at and past each of ``lengths``,
    as hop rows."""
    cfg = FLAGSHIP
    pcm = pcm.masked_fill(torch.arange(SCAN_BUCKET, device=pcm.device)[None, :] >= lengths[:, None], 0)
    rows = ff.pack_hop_rows(pcm, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length)
    return mt.AudioBatch(rows.contiguous(), lengths)


def scan_route(dev, card: str) -> list[dict]:
    """Phase 31 (see the module docstring); the two kernels' rows."""
    from modulation_mfcc_tpu_torch.kernels import masked_scan as MS
    from modulation_mfcc_tpu_torch.models import modulation as MM
    from modulation_mfcc_tpu_torch.ops.masked import masked_gradient, masked_sosfiltfilt

    cfg, hop = FLAGSHIP, FLAGSHIP.hop_length
    min_frames = MM.min_frames_for_fir(cfg)
    y = speechlike_on_card(SCAN_BATCH * SCAN_BUCKET, cfg.signal_sample_rate, seed=31)
    pcm = (y.clamp(-1.5, 1.5) * (32767 / 1.5)).round().to(torch.int16).view(SCAN_BATCH, SCAN_BUCKET)
    del y
    g = torch.Generator().manual_seed(31)
    lengths = {"scan": torch.randint(SCAN_BUCKET // 4 + 1, SCAN_BUCKET + 1, (SCAN_BATCH,), generator=g),
               "fir": torch.randint((min_frames - 1) * hop, SCAN_BUCKET + 1, (SCAN_BATCH,), generator=g)}
    check(1 + int(lengths["scan"].min()) // hop < min_frames <= 1 + int(lengths["fir"].min()) // hop,
          "phase 31: the scan batch has an utterance under min_frames_for_fir frames, the FIR batch none")
    calls = {}
    for route, n in lengths.items():
        batch = timit_batch(pcm, n.to(dev))
        kw = dict(spectrum="fused", masked_fir=route == "fir", n_samples=SCAN_BUCKET)
        batched_mfcc_change(batch, cfg, **kw)
        torch.cuda.synchronize()
        reset(MS.LAUNCHES)
        with spy(MM, "masked_sosfiltfilt_f64") as filt, spy(MM, "masked_grad_norm") as norm:
            tot, _ = batched_mfcc_change(batch, cfg, **kw)
        torch.cuda.synchronize()
        want = {"masked_sosfiltfilt_f64": 0 if route == "fir" else 2, "masked_grad_norm_f32": 1}
        print(f"[31] {route} route: {SCAN_BATCH} int16 utterances of {int(n.min())}-{int(n.max())} samples as hop "
              f"rows, 'fused': launches {dict(MS.LAUNCHES)} (want {want}), tot_change {tuple(tot.shape)} finite "
              f"{bool(torch.isfinite(tot).all())} ({card})")
        check(MS.LAUNCHES == want and bool(torch.isfinite(tot).all()), f"phase 31 {route} route launches")
        calls[route] = filt, norm
    # the filter: its two launches of a scan-route call (the 12 trajectories, then tot_change)
    ms = plain_ms = least_bytes = least_ops = err = 0.0
    for args, _, _, _ in calls["scan"][0]:
        sos, zi, padlen, x, frames = args
        got = MS.masked_sosfiltfilt_f64(*args)
        length = frames[:, None] if x.ndim == 3 else frames
        want, t_plain = once_ms(lambda: masked_sosfiltfilt(sos, zi, padlen, x.double(), length).to(torch.float32))
        got64 = MS.masked_sosfiltfilt_f64(sos, zi, padlen, x.double(), frames)
        rows_a = x.shape[1] if x.ndim == 3 else 1
        t_kernel = launch_ms(lambda: MS.masked_sosfiltfilt_f64(*args))
        print(f"[31] masked_sosfiltfilt_f64 on {tuple(x.shape)} (strides {x.stride()}), padlen {padlen}, "
              f"{sos.shape[0]} sections: bit for bit the float64 loop {same_bits(got, want)}, float64 rows give it "
              f"in float64 {torch.equal(got64, got.double())}; {t_kernel:.4f} ms a launch, the loop {t_plain:.3f} "
              f"ms once ({card})")
        check(same_bits(got, want) and torch.equal(got64, got.double()),
              f"phase 31 masked_sosfiltfilt_f64 on {tuple(x.shape)} bit for bit the loop")
        valid = float(frames.sum())
        ms, plain_ms = ms + t_kernel, plain_ms + t_plain
        least_bytes += 8.0 * rows_a * valid  # each row's valid frames read and written once, float32
        least_ops += 9.0 * 2 * sos.shape[0] * rows_a * valid  # 9 flops a section a frame each way
    rows = [kernel_row("masked_sosfiltfilt_f64", 2, 0.0, (ms, plain_ms), bound(least_bytes, least_ops))]
    # the norm: its launch on each masked route
    for route in ("scan", "fir"):
        (args, _, _, _), = calls[route][1]
        x, frames = args
        got = MS.masked_grad_norm(x, frames)

        def plain():
            d = masked_gradient(x, frames[:, None])
            return torch.sqrt(torch.sum(d * d, dim=-2)) / x.shape[-2]

        want = plain()
        close = bool(torch.allclose(got, want, rtol=GRAD_NORM_RTOL, atol=0.0))
        same64 = torch.equal(MS.masked_grad_norm(x.double(), frames), got.double())
        e = float((got - want).abs().max())
        t_kernel, t_plain = launch_ms(lambda: MS.masked_grad_norm(x, frames)), cuda_ms(plain)
        print(f"[31] masked_grad_norm_f32 on the {route} route's {tuple(x.shape)}: within {GRAD_NORM_RTOL:.3e} "
              f"relative of its torch ops {close} (max-abs {e:.3e}), float64 rows give it in float64 {same64}; "
              f"{t_kernel:.4f} ms a launch, the torch ops {t_plain:.4f} ms ({card})")
        check(close and same64, f"phase 31 masked_grad_norm_f32 on the {route} route against its torch ops")
        if route == "scan":
            c, valid = x.shape[1], float(frames.sum())
            # c trajectories read and tot written once, float32; a frame's difference, halving, square and sum
            # for each, then the root and the division
            b = bound(4.0 * (c + 1) * valid, (4.0 * c + 2) * valid)
            rows.append(kernel_row("masked_grad_norm_f32", 1, e, (t_kernel, t_plain), b))
    return rows


def build_native_loader() -> tuple[Path, float]:
    """The native decode loader's library, built and loaded; (path, seconds)."""
    t0 = time.perf_counter()
    so = native.build()
    native.load_library()
    return so, time.perf_counter() - t0


def ptxas_lines(report: str, bases: tuple[str, ...]) -> list[str]:
    """'kernel<template args>: registers, spill bytes' for each entry
    function of ptxas's report whose name holds one of ``bases``."""
    out, name, spills = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = next((b for b in bases if b in mangled), None)
            rest = base and mangled.split(base, 1)[1]
            name = base and (base + "<" + rest.split("EEv")[0] + ">" if rest.startswith("I") else base)
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split('Used', 1)[1].split(',')[0].strip()}; {spills}")
            name = None
    return out


def tracker_plans() -> None:
    """Phase 1: the tracker kernels' plans. sinc_refine_f32's tiling for
    the tracker's bands; burg_lpc_f32's C and warps a frame over nw."""
    for nl, s in ((189, 73), (189, 143), (119, 73)):
        p = SK.sinc_plan(nl, s)
        print(f"[1] sinc_refine_f32 tiling at nl {nl}, S {s}: J {SK.LAGS_PER_THREAD}, {p.lag_blocks} × "
              f"{p.lag_block} lags, {p.shared_bytes} bytes")
    spans: dict = {}
    for nw in range(2, BK._MAX_NW + 1):
        spans.setdefault(BK.burg_plan(nw, 1), []).append(nw)
    print("[1] burg_lpc_f32 plans: " + "; ".join(
        f"C {p.chunk}, {p.warps_per_frame} warp(s) a frame, ≥ {p.blocks_per_sm} blocks an SM, {p.shared_bytes} bytes: "
        f"nw {v[0]}..{v[-1]}" for p, v in spans.items()))


def shared_report() -> None:
    """Phase 1: each tensor-core frontend mode's staging plan (tc_plan:
    frames a block, shifted, stages, copies, span, mel groups) and shared
    memory a block (the launcher's sum) at both configurations and at each
    of phase 24's, and how many blocks an SM's 228 KB hold (1 KB of each
    reserved)."""
    for label, cfg in [("10k default", DEFAULT_10K), ("16k flagship", FLAGSHIP)] + geometry_configs():
        kp = -(-(cfg.win_length or cfg.n_fft) // 32) * 32
        parts = []
        for alg in ff.ALGORITHMS:
            plan = ff.tc_plan(alg, cfg.hop_length, kp, cfg.n_mels)
            check(plan.shared_bytes <= ff.SHARED_MAX, f"fused_mel_{alg} shared memory at hop {cfg.hop_length}")
            parts.append(f"fused_mel_{alg} {rung(plan)} {tuple(plan)}, {plan.shared_bytes} bytes "
                         f"({233_472 // (plan.shared_bytes + 1024)} an SM by shared memory)")
        print(f"[1] {label}: plan (frames, shifted, streamed, stages, copies, span, mel groups, bytes) and shared "
              f"memory a block at hop {cfg.hop_length}, Kp {kp}, {cfg.n_mels} mel bands (at most {ff.SHARED_MAX}): "
              + "; ".join(parts))
    kp = -(-FLAGSHIP.win_length // 32) * 32
    print("[1] the streamed plan of each mode, the same at every hop and window (phase 24 forces it at the "
          "flagship): " + "; ".join(f"fused_mel_{alg} {tuple(streamed_plan(alg, FLAGSHIP, kp))}"
                                    for alg in ff.ALGORITHMS))
    fold_geoms = [("16k flagship", FLAGSHIP), ("16k, 256 mel bands", WIDE)] + list(FOLD_COMPACT)
    for label, cfg in fold_geoms:
        parts = []
        for alg in TC_FOLDS:
            plan = ff.fold_plan(alg, cfg.hop_length, cfg.win_length, cfg.n_mels)
            check(plan.shared_bytes <= ff.SHARED_MAX, f"fused_mel_fold_{alg} shared memory at {label}")
            parts.append(f"fused_mel_fold_{alg} {plan.frames}/{plan.stages}/{plan.buffers} {tuple(plan)}, "
                         f"{plan.shared_bytes} bytes ({233_472 // (plan.shared_bytes + 1024)} an SM by shared memory)")
        n = ff.ffma_fold_bytes("bf16", cfg.hop_length, cfg.win_length)
        check(n <= ff.SHARED_MAX, f"fused_mel_fold_bf16 shared memory at {label}")
        parts.append(f"fused_mel_fold_bf16 (FFMA) {n} bytes ({233_472 // (n + 1024)} an SM by shared memory)")
        print(f"[1] {label}: fold plan (frames/stages/buffers: frames, stages, buffers, span, mel groups, bytes) and "
              f"shared memory a block at hop {cfg.hop_length}, window {cfg.win_length}, {cfg.n_mels} mel bands: "
              + "; ".join(parts))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    # parity paths run in true FP32: no TF32 in matmuls or (unused) convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[0] card: {card}")
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"[0] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the native decode loader's g++ build runs beside nvcc, so no phase times it inside a sweep
        loader_build = pool.submit(build_native_loader)
        lib_path = _build.build(verbose=True)
        _build.load_library()
        print(f"[1] built {lib_path.name} from {CSRC}/*.cu (nvcc {' '.join(_build.NVCC_FLAGS)}, one process "
              f"per source) in {time.perf_counter() - t0:.3f} s")
        so, native_s = loader_build.result()
    print(f"[1] built {so.name} from {native.SOURCE.relative_to(native.SOURCE.parents[1])} (g++ "
          f"{' '.join(native.GXX_FLAGS)}, beside nvcc) and loaded it in {native_s:.3f} s")
    for line in ptxas_lines(lib_path.with_suffix(".ptxas.txt").read_text(),
                            ("viterbi_fwd_f32_kernel", "viterbi_bwd_f32_kernel", "viterbi_fwd_wide_kernel",
                             "viterbi_bwd_wide_kernel", "viterbi_fwd_toeplitz_kernel", "viterbi_bwd_toeplitz_kernel",
                             "fused_mel_tc_kernel", "fused_mel_fft_kernel",
                             "fused_mel_fold_tc_kernel", "fused_mel_fold_kernel", "mfcc_tail_kernel",
                             "sinc_refine_f32_kernel", "burg_lpc_f32_kernel")):
        print(f"[1] ptxas {line}")
    shared_report()
    tracker_plans()

    mfcc_kernel_checks(dev)
    rows = mfcc_path(dev, card)
    torch.cuda.empty_cache()
    rows += tracker_paths(dev, card)
    torch.cuda.empty_cache()
    rows += frontend_modes(dev, card)
    torch.cuda.empty_cache()
    rows += fold_longform_modspec(dev, card)
    torch.cuda.empty_cache()
    geometry_checks(dev)
    torch.cuda.empty_cache()
    rate_paths(dev, card)
    torch.cuda.empty_cache()
    verify_on_card()
    envelope_times(dev, card)
    torch.cuda.empty_cache()
    padded = analysis_workflow(dev, card)
    torch.cuda.empty_cache()
    p29 = sweep_extras_and_distributed(dev, card)
    public_surface(dev, card, padded)
    torch.cuda.empty_cache()
    rows += scan_route(dev, card)
    rows = [r | {"extras_sweep_launches": p29.get(r["name"], 0)} for r in rows]
    print(json.dumps({"kernels": rows}))
    print(card_line())
    check(not LATE_FAILURES, f"{len(LATE_FAILURES)} check(s) reported above: {'; '.join(LATE_FAILURES)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def read_fixture() -> np.ndarray:
    import scipy.io.wavfile as wavfile

    sr, data = wavfile.read(Path(__file__).resolve().parent / "tests" / "fixtures" / "utterance_16k.wav")
    check(sr == FLAGSHIP.signal_sample_rate, "fixture sample rate")
    return data.astype(np.float32) / 32768.0


if __name__ == "__main__":
    sys.exit(frontend_report(FRONTEND_ROOT) if FRONTEND_ROOT else main())
