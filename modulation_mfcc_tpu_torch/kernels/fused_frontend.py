"""Fused spectral frontend: audio → mel power → MFCC, through CUDA kernels.

Hand-written kernels carry the MFCC stage on the GPU, one frontend kernel
per arithmetic mode of the JAX frontend and one tail kernel:

  * ``fused_mel_f32``, ``fused_mel_bf16``, ``fused_mel_x3``,
    ``fused_mel_i16``, ``fused_mel_i24`` (csrc/fused_frontend_tc.cu, the
    modes of one kernel on the tensor cores), all behind
    :func:`fused_mel_frontend`,
    replace the Pallas frontend of modulation_mfcc_tpu/pallas/
    fused_frontend.py (``fused_mel_frontend`` → ``_launch`` → ``_kernel``,
    ``_kernel_pipe``, ``_kernel_i16(_pipe)``, ``_kernel_i24(_pipe)``; the
    pipelined kernels compute their plain kernels' numbers bit for bit).
    Frames are built in shared memory from the contiguous audio span of a
    64-frame block, so no frame matrix exists in device memory; the
    windowed real DFT, power and mel projection run in the mode's
    arithmetic, and each block writes the max of its valid frames for the
    top_db clip:

      - 'f32': each operand split exactly into three bf16 planes (hi, mid,
        lo; :func:`_split3`), six of the nine plane products per term as
        bf16 tensor-core MMAs, the hi·hi products added per 16-row step in
        FP32 and the smaller ones summed apart (the TPU's own f32: six bf16
        passes); its plain version is a true FP32 GEMM in 16-row steps
        (:func:`_stepped_matmul`), and :func:`_split3_matmul` mirrors the
        kernel's arithmetic on the CPU;
      - 'bf16': operands rounded to bf16, products accumulated in f32 as
        bf16 tensor-core MMAs; mel stored as bf16 (the corpus throughput
        mode);
      - 'x3': each operand split into bf16 (hi, lo), three products
        hi·Whi + hi·Wlo + lo·Whi per term, for the DFT and the mel, as
        bf16 tensor-core MMAs;
      - 'i16' / 'i24': a fixed-point DFT. Samples are scaled per utterance
        (:func:`quant_scales`) and split into two (i16) or three (i24) int8
        digits; the windowed-DFT matrix into three int8 planes
        (:func:`int8_weight_planes`). The digit products are exact int32
        sums of int8 tensor-core MMAs, recombined in f32; the mel
        projection runs as x3 on the bf16 tensor cores.

    The tensor-core kernels read their weights in a layout of their own
    (:func:`tc_layouts`: :func:`pack_tc_basis`, :func:`pack_tc_mel`), which
    :func:`mode_tensors` and the ``MfccChange`` module build once.
  * ``fused_mel_fold_f32`` and ``fused_mel_fold_x3``
    (csrc/fused_frontend_fold_tc.cu, on the tensor cores) and
    ``fused_mel_fold_bf16`` (csrc/fused_frontend_fold.cu, FFMA), behind
    ``fused_mel_frontend(fold=True)``, replace the Pallas folded frontend
    (``_folded_frontend`` → ``_fold_kernel``): the windowed real DFT
    folded about the window's centre, re = s·wc and im = d·ws with
    s, d = x[a+u] ± x[a+sup−u], half the contraction. The tensor-core
    folds build s and d per 32-row chunk in shared memory, split them as
    their unfolded modes split frames (f32 into three exact bf16 planes,
    x3 into two), and read the cosine and sine bases in a layout of their
    own (:func:`fold_layouts`, which :func:`fold_tensors` builds), under a
    staging plan (:func:`fold_plan`); :func:`split3_fold_mirror` mirrors
    the f32 fold's arithmetic on the CPU. The bf16 fold sums its DFT and
    mel as FFMA chains in row order, the order of its plain version's FP32
    GEMMs, so its bf16 power rounds as the plain version's does.

    Bound: the DFT's operations (~315 GFLOP + ~50 GFLOP of mel per
    128 × 30 s batch at 16 kHz and pass), on the unit each mode's arithmetic
    runs on (bf16 tensor cores for f32's six passes, bf16 and x3, int8 for
    i16 and i24).
  * ``mfcc_tail_f32`` (wrapper :func:`mfcc_tail`) replaces the Pallas tail
    kernels (``mfcc_tail`` → ``_tail_kernel_t`` / ``_tail_kernel``):
    10·log10(max(mel, 1e-10)), the clip at peak − 80 dB, and the DCT-II,
    written coef-major [B, n_mfcc, NF] or frame-major [B, NF, n_mfcc]; it
    reads a float32 or a bf16 mel of up to 512 bands, n_mfcc ≤ n_mels.
    Bound: the one read of the mel tensor;
    a ring of bulk copies keeps it in flight while the lanes of a warp
    share a frame's log10f and DCT.

Every frontend takes float32 or int16 audio (int16 is dequantized as
v·2⁻¹⁵, exact), flat [B, T] or as hop rows [B, rows, hop]
(:func:`pack_hop_rows`, the corpus sweep's upload format) with
``n_samples``. Beside each wrapper is its plain PyTorch version
(:func:`fused_mel_frontend_reference`, :func:`fused_mel_fold_reference`,
:func:`mfcc_tail_reference`). A
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches, so a run can show that its main path went through the kernels.

The host designs (window-support trim, zero-mel-bin trim, Nyquist packing,
the int8 weight planes, the bf16 and x3 weight stacks, the i16 offset
correction, the per-utterance scales and the hop-rows geometry) are
verbatim ports of the JAX frontend's host code (fused_mel_frontend, lines
698-866, _int8_weight_planes, _stack_weights, hop_rows_geometry,
pack_hop_rows; the fold's design of _folded_frontend): they decide the
numbers, so both packages compute from identical constants.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.kernels._launch import check_cuda, raise_on, route, stream_of
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.ops.spectral import dct_matrix, dft_bases, mel_filterbank
from modulation_mfcc_tpu_torch.ops.windows import hann
from modulation_mfcc_tpu_torch.utils import obs
from modulation_mfcc_tpu_torch.utils.helpers import dequantize_samples, round_up_to_multiple

__all__ = [
    "ALGORITHMS", "FOLD_ALGORITHMS", "LAUNCHES", "frontend_weights", "mode_weights", "int8_weight_planes",
    "quant_scales", "tail_dct", "eff_pad", "hop_rows_geometry", "pack_hop_rows", "fold_ok", "fold_weights",
    "tc_layouts", "tc_planes", "TcPlan", "tc_plan", "pack_tc_basis", "unpack_tc_basis",
    "fold_tensors", "fold_layouts", "pack_fold_basis", "unpack_fold_basis", "FoldPlan", "fold_plan",
    "ffma_fold_bytes",
    "pack_tc_mel", "unpack_tc_mel", "fused_mel_frontend", "fused_mel_frontend_reference",
    "split3_frontend_mirror", "fold_operands", "fused_mel_fold_reference", "split3_fold_mirror",
    "mfcc_tail", "mfcc_tail_reference", "fused_mfcc",
]

ALGORITHMS = ("f32", "bf16", "x3", "i16", "i24")
FOLD_ALGORITHMS = ("f32", "bf16", "x3")
TC_FOLD_ALGORITHMS = ("f32", "x3")  # the folds on the tensor cores (fold_layouts, fold_plan)
LAUNCHES = ({f"fused_mel_{a}": 0 for a in ALGORITHMS} | {"mfcc_tail_f32": 0}
            | {f"fused_mel_fold_{a}": 0 for a in FOLD_ALGORITHMS})

BLOCK_FRAMES = 64  # frames per frontend block: one bmax entry each (kBF in the .cu)
_BIN_TILE = 128    # bins_pad must be a multiple (kBT)
_MEL_MAX = 128     # mel columns of a group (kMelCols; the fold's kMelMax)
MEL_LIMIT = 512    # mel bands the tensor-core frontend and the tail take (kMelLimit, kTailMelLimit)
_KC = 16           # contraction rows per step of the f32 sums and per bf16 MMA (kKC in fused_frontend_fold.cu)
_TC_COLS = 128                                # DFT columns per tile (kCols): re and im of 64 bins
_TC_STEP = {"f32": 16, "bf16": 16, "x3": 16, "i16": 32, "i24": 32}  # contraction rows per MMA (Mode::kStep)
_TC_BF16 = ("f32", "bf16", "x3")              # the modes whose basis is bf16 (int8 for the others)
# (span, basis, mel) planes of each mode (Mode::kSpanPlanes, kBasisPlanes, kMelPlanes)
_TC_PLANES = {"f32": (3, 3, 3), "bf16": (1, 1, 1), "x3": (2, 2, 2), "i16": (2, 3, 2), "i24": (3, 3, 2)}
_TC_CHUNK = 32                      # contraction rows per pipeline stage (kChunkRows)
_TC_STAGES = 4                      # pipeline stages of the basis ring in the full plan (kStages)
_TC_PITCH = 80                      # bf16 elements per row of the power tile (kPitch)
_FOLD_GROUP = 8                     # bins a cosine (then sine) column group of the fold basis (an MMA n-tile)
_MEL_STEP = 16                      # bins per MMA of the mel projection (kMelStep)
SHARED_MAX = 232_448                # bytes of shared memory a block may use on the H100 (kSharedMax)
ROWS_BLKF = 1024   # the JAX frontend's default frame block, which sizes a hop-rows batch
_TAIL_ROWS = 16    # spare hop rows after the last block (JAX _TAIL_ROWS)
_I24_FULL = 127.0 * 65536.0 - 33000.0  # 24-bit quantization full scale (exact in f32)


# ---------------------------------------------------------------------------
# Host design (numpy, verbatim from the JAX frontend)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def frontend_weights(
    sr: float,
    n_fft: int = 512,
    win_length: int | None = None,
    n_mels: int = 128,
    fmin: float = 100.0,
    fmax: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(wri [K, 2·bins_pad], melw [bins_pad, n_mels]), both float32.

    K is the trimmed window support (win_length). Columns [0, bins_pad) of
    ``wri`` are the real DFT bases and [bins_pad, 2·bins_pad) the imaginary
    ones; trailing bins with zero mel weight are trimmed, and when every bin
    is live the Nyquist real column rides the always-zero im₀ slot with its
    mel weight moved onto the DC power row.
    """
    win_length = win_length or n_fft
    pw = (n_fft - win_length) // 2
    sup = win_length
    wr, wi = dft_bases(n_fft, "hann", win_length)
    n_bins_full = wr.shape[1]
    wr = wr[pw : pw + sup]
    wi = wi[pw : pw + sup]
    m_full = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    nz = np.flatnonzero(np.abs(m_full).sum(axis=0) > 0)
    n_bins = int(nz[-1]) + 1 if nz.size else n_bins_full
    half = n_fft // 2
    packed = (
        n_bins == half + 1
        and half % 128 == 0
        and nz.size
        and int(nz[0]) >= 1
    )
    if packed:
        bins_pad = half
        wr_eff = wr[:, :half].copy()
        wr_eff[:, 0] = 0.0  # DC power must not pollute the Nyquist slot
        wi_eff = wi[:, :half].copy()
        wi_eff[:, 0] = wr[:, half]  # Nyquist re rides the im₀ column
        m_p = np.zeros((bins_pad, n_mels), np.float32)
        m_p[:half, :] = m_full.T[:half]
        m_p[0, :] = m_full.T[half]  # DC power slot now carries Nyquist power
    else:
        bins_pad = round_up_to_multiple(n_bins, 128)
        wr_eff = wr[:, :n_bins]
        wi_eff = wi[:, :n_bins]
        m_p = np.zeros((bins_pad, n_mels), np.float32)
        m_p[:n_bins, :] = m_full.T[:n_bins]
    ncol = wr_eff.shape[1]
    wri_p = np.zeros((sup, 2 * bins_pad), np.float32)
    wri_p[:, :ncol] = wr_eff
    wri_p[:, bins_pad : bins_pad + ncol] = wi_eff
    return wri_p, m_p


def int8_weight_planes(w: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Balanced base-256 digit planes of a weight matrix: ``(w2, w1, w0, Sw)``
    int8 arrays with ``w ≈ (w2·65536 + w1·256 + w0) / Sw`` to ±0.5/Sw
    (≈ 2⁻²⁴·max|w|), every plane in [−128, 127]. Host-side, float64,
    ``np.round``'s half-to-even rule (JAX _int8_weight_planes)."""
    maxw = float(np.max(np.abs(w))) or 1.0
    sw = (127.0 * 65536.0 - 33000.0) / maxw
    r = np.round(np.asarray(w, np.float64) * sw).astype(np.int64)
    w0 = ((r + 128) % 256) - 128
    r1 = (r - w0) // 256
    w1 = ((r1 + 128) % 256) - 128
    w2 = (r1 - w1) // 256
    if np.abs(w2).max() > 127:
        raise ValueError("int8 plane overflow")
    return w2.astype(np.int8), w1.astype(np.int8), w0.astype(np.int8), sw


def _bf16_round(a) -> np.ndarray:
    """float32 values rounded to bf16 (nearest even), kept as float32."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _split3(x: torch.Tensor) -> torch.Tensor:
    """[3, ...] float32: the exact three-plane bf16 split of float32 ``x``,
    hi = bf16(x), mid = bf16(x − hi), lo = bf16(x − hi − mid), as
    fused_mel_f32 splits its samples, power and weights (planes_of). Each
    residue is exact in float32 and has at most 16, then 8 significant bits,
    so hi + mid + lo == x for every normal float32; v·2⁻¹⁵ of an int16 has
    at most 16, so its lo is zero."""
    hi = _bf16r(x)
    r = x - hi
    mid = _bf16r(r)
    return torch.stack([hi, mid, _bf16r(r - mid)])


def _x3_stack(w: np.ndarray) -> np.ndarray:
    """[2, ...] float32: the bf16 (hi, lo) split of ``w`` (JAX _stack_weights x3)."""
    hi = _bf16_round(w)
    return np.stack([hi, _bf16_round(np.asarray(w, np.float32) - hi)])


@lru_cache(maxsize=32)
def mode_weights(
    algorithm: str,
    sr: float,
    n_fft: int = 512,
    win_length: int | None = None,
    n_mels: int = 128,
    fmin: float = 100.0,
    fmax: float | None = None,
) -> dict[str, np.ndarray]:
    """The constants one frontend mode computes from, as numpy arrays:

    * 'f32': ``wri`` [K, 2·bins_pad], ``melw`` [bins_pad, n_mels];
    * 'bf16': the same rounded to bf16 (held as float32);
    * 'x3': ``wri`` [2, K, 2·bins_pad] and ``melw`` [2, bins_pad, n_mels],
      the (hi, lo) bf16 splits;
    * 'i16' / 'i24': ``planes`` int8 [3, K, 2·bins_pad] (w2, w1, w0 of
      :func:`int8_weight_planes`), ``sw`` (Sw as a float32 scalar, the
      value the device scale arithmetic uses), ``melw`` as for 'x3'; and
      for 'i16' ``corr`` [2·bins_pad] float32 = 128·Σ_k round(W·Sw), the
      low digit's +128 offset (float64 sum, then float32).
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"Unknown algorithm {algorithm!r}; one of {', '.join(ALGORITHMS)}")
    wri, melw = frontend_weights(sr, n_fft, win_length, n_mels, fmin, fmax)
    if algorithm == "f32":
        return {"wri": wri, "melw": melw}
    if algorithm == "bf16":
        return {"wri": _bf16_round(wri), "melw": _bf16_round(melw)}
    if algorithm == "x3":
        return {"wri": _x3_stack(wri), "melw": _x3_stack(melw)}
    w2, w1, w0, sw = int8_weight_planes(wri)
    out = {"planes": np.stack([w2, w1, w0]), "sw": np.asarray(sw, np.float32), "melw": _x3_stack(melw)}
    if algorithm == "i16":
        r_int = w2.astype(np.float64) * 65536.0 + w1.astype(np.float64) * 256.0 + w0.astype(np.float64)
        out["corr"] = (128.0 * r_int.sum(axis=0)).astype(np.float32)
    return out


def mode_tensors(algorithm: str, device, sr: float, n_fft: int = 512, win_length: int | None = None,
                 n_mels: int = 128, fmin: float = 100.0, fmax: float | None = None) -> dict[str, torch.Tensor]:
    """:func:`mode_weights` as tensors on ``device``, with the tensor-core
    kernel's layouts of them (:func:`tc_layouts`)."""
    w = mode_weights(algorithm, sr, n_fft, win_length, n_mels, fmin, fmax)
    t = {k: torch.as_tensor(v, device=device) for k, v in w.items()}
    return t | tc_layouts(algorithm, t)


def _interleave(w: torch.Tensor) -> torch.Tensor:
    """[..., 2·B] columns (re₀..re_B−1 | im₀..im_B−1) → (re₀, im₀, re₁, im₁, ...)."""
    b = w.shape[-1] // 2
    return torch.stack([w[..., :b], w[..., b:]], dim=-1).reshape(*w.shape[:-1], 2 * b)


def pack_tc_basis(algorithm: str, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernels' basis layout of the mode's planes ``w``
    [P, K, 2·bins_pad] (f32: ``_split3(wri)``, its (hi, mid, lo) planes;
    bf16: ``wri[None]``, the bf16-rounded basis held as float32; x3:
    ``wri``, its (hi, lo) bf16 splits; i16, i24: ``planes``, int8 w2, w1,
    w0): columns interleaved re/im, K zero-padded to Kp, a multiple of 32,
    then [tiles, Kp/step, P, 128, step] with 128 interleaved columns a tile
    and step = 16 (f32, bf16, x3) or 32 (i16, i24) rows an MMA, so one
    32-row chunk of a tile is contiguous; bf16 for f32, bf16 and x3 (exact:
    the planes are bf16 values), int8 for i16 and i24."""
    cols, step = _TC_COLS, _TC_STEP[algorithm]
    p, k, c = w.shape
    kp = round_up_to_multiple(k, _TC_CHUNK)
    x = tnf.pad(_interleave(w), (0, 0, 0, kp - k)).reshape(p, kp // step, step, c // cols, cols)
    return x.permute(3, 1, 0, 4, 2).contiguous().to(torch.bfloat16 if algorithm in _TC_BF16 else torch.int8)


def unpack_tc_basis(algorithm: str, packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_tc_basis`: [P, K, 2·bins_pad], float32 for f32, bf16 and x3."""
    tiles, ks, p, cols, step = packed.shape
    x = packed.permute(2, 1, 4, 0, 3).reshape(p, ks * step, tiles * cols)[:, :k]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return x.to(torch.float32) if algorithm in _TC_BF16 else x


def pack_tc_mel(melw: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernels' mel layout of the mel weights' P bf16 planes
    ``melw`` [P, bins_pad, n_mels] (bf16: one, the rounded weights; f32:
    the three of :func:`_split3`; the others: the x3 stack's (hi, lo)): mel
    columns zero-padded to G groups of 128 (one up to 128 bands), then
    [G·bins_pad/16, P, 128, 16] bf16, group-major (16 bins a step, each
    column's 16 bins contiguous)."""
    p, bins, n = melw.shape
    groups = -(-n // _MEL_MAX)
    x = tnf.pad(melw, (0, groups * _MEL_MAX - n)).reshape(p, bins // _MEL_STEP, _MEL_STEP, groups, _MEL_MAX)
    return x.permute(3, 1, 0, 4, 2).reshape(groups * bins // _MEL_STEP, p, _MEL_MAX, _MEL_STEP).contiguous() \
        .to(torch.bfloat16)


def unpack_tc_mel(packed: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Inverse of :func:`pack_tc_mel`: [P, bins_pad, n_mels] float32."""
    rows, p, cols, step = packed.shape
    groups = -(-n_mels // _MEL_MAX)
    x = packed.reshape(groups, rows // groups, p, cols, step).permute(2, 1, 4, 0, 3)
    return x.reshape(p, rows // groups * step, -1)[..., :n_mels].to(torch.float32)


def tc_planes(algorithm: str, w: torch.Tensor) -> torch.Tensor:
    """The planes the tensor-core kernel reads of one of the mode's weights
    [P, ...]: f32 splits its float32 matrix into three (:func:`_split3`),
    bf16's single matrix gains a plane axis, the others are stacks already."""
    if algorithm == "f32":
        return _split3(w)
    return w if w.ndim == 3 else w[None]


def tc_layouts(algorithm: str, weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The tensor-core kernel's layouts of the mode's weights on their
    device: ``wri_tc`` (f32, bf16, x3) or ``planes_tc`` (i16, i24) from
    :func:`pack_tc_basis`, and ``melw_tc`` from :func:`pack_tc_mel`."""
    basis = "wri" if algorithm in _TC_BF16 else "planes"
    return {f"{basis}_tc": pack_tc_basis(algorithm, tc_planes(algorithm, weights[basis])),
            "melw_tc": pack_tc_mel(tc_planes(algorithm, weights["melw"]))}


class TcPlan(NamedTuple):
    """The staging plan of a tensor-core frontend launch (the launcher's
    ``TcPlan``, passed by value in this field order, which it checks)."""

    frames: int        # frames a block: 64 (full, streamed) or 32 (compact)
    shifted: int       # 1: one span copy, rows aligned in registers (compact)
    streamed: int      # 1: no span; each stage holds its chunk's A tile beside the basis (streamed)
    stages: int        # stages of the ring: 4 (full, streamed), 2 to 4 (compact)
    n_copies: int      # span copies, copy c shifted by c·gcd(hop, 8 bytes); 0 (streamed)
    span_pad: int      # elements of a span copy; 0 (streamed)
    mel_groups: int    # groups of 128 mel columns: the grid's z
    shared_bytes: int


def _plan_for(algorithm: str, hop: int, kp: int, n_mels: int, frames: int, shifted: bool, stages: int,
              streamed: bool = False) -> TcPlan:
    """The plan with these choices and the launcher's sum of its shared
    memory: 128 bytes of barriers and warp maxima, the ring of basis chunks
    (streamed: each stage with its chunk's A tile, the planes of 64 frames ×
    32 rows), a tile's mel weights, the power tile and the span planes in
    their copies (none when streamed)."""
    span_planes, basis_planes, mel_planes = _TC_PLANES[algorithm]
    esize = 2 if algorithm in _TC_BF16 else 1
    al = 8 // esize
    n_copies = 0 if streamed else 1 if shifted else al // int(np.gcd(hop, al))
    span_pad = 0 if streamed else -(-((frames - 1) * hop + kp + (al if shifted else 0)) // 16) * 16
    stage = _TC_CHUNK * _TC_COLS * basis_planes * esize + (span_planes * frames * _TC_CHUNK * esize if streamed else 0)
    mel = _TC_COLS // 2 * mel_planes * _MEL_MAX * 2
    power = mel_planes * frames * _TC_PITCH * 2
    smem = 128 + stages * stage + mel + power + span_planes * n_copies * span_pad * esize
    return TcPlan(frames, int(shifted), int(streamed), stages, n_copies, span_pad, -(-n_mels // _MEL_MAX), smem)


def tc_plan(algorithm: str, hop: int, kp: int, n_mels: int = 128) -> TcPlan:
    """The staging plan of the tensor-core kernel in ``algorithm`` at this
    hop, padded support Kp and mel width, the first of three rungs that fits
    a block's shared memory: the full plan (64 frames a block, the span in
    its shifted copies, four stages); else the compact plan (32 frames, one
    span copy whose rows the threads align in registers) with the most
    stages, four to two, that fit; else the streamed plan (64 frames, four
    stages, no span: each stage holds its chunk's A tile), whose bytes do
    not depend on the hop or Kp and fit every mode (f32: 227,456). The span
    of the first two grows with the hop and the window, so at long hops
    (f32 from 22.05 kHz with a 30 ms hop, x3 at 44.1-48 kHz with 30 ms)
    only the streamed plan fits. Raises for n_mels outside 1..512."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"Unknown algorithm {algorithm!r}; one of {', '.join(ALGORITHMS)}")
    if not 1 <= n_mels <= MEL_LIMIT:
        raise ValueError(f"fused_mel_{algorithm}: n_mels must be in 1..{MEL_LIMIT}, got {n_mels}")
    plans = [_plan_for(algorithm, hop, kp, n_mels, BLOCK_FRAMES, False, _TC_STAGES)]
    plans += [_plan_for(algorithm, hop, kp, n_mels, BLOCK_FRAMES // 2, True, s) for s in range(_TC_STAGES, 1, -1)]
    plans += [_plan_for(algorithm, hop, kp, n_mels, BLOCK_FRAMES, False, _TC_STAGES, streamed=True)]
    return _first_fitting(plans, f"fused_mel_{algorithm}", f"hop {hop}, Kp {kp}")


def _first_fitting(plans: list, name: str, where: str):
    """The first of ``plans`` (a ladder, its last rung the smallest) within
    a block's shared memory; raises where none fits."""
    for plan in plans:
        if plan.shared_bytes <= SHARED_MAX:
            return plan
    raise ValueError(f"{name}: no staging plan fits {SHARED_MAX} bytes of shared memory at {where} (the last "
                     f"rung needs {plans[-1].shared_bytes})")


def fold_ok(n_fft: int, hop: int, win_length: int | None) -> bool:
    """Whether the folded frontend takes this geometry: an even support
    that is a whole number of hops, at most 16 of them, and a fold centre
    inside the FFT frame (the JAX frontend's rule)."""
    sup = win_length or n_fft
    pw = (n_fft - sup) // 2
    return sup % hop == 0 and sup % 2 == 0 and sup // hop <= _TAIL_ROWS and n_fft // 2 - pw >= 1


@lru_cache(maxsize=32)
def fold_weights(
    sr: float,
    n_fft: int = 512,
    win_length: int | None = None,
    n_mels: int = 128,
    fmin: float = 100.0,
    fmax: float | None = None,
    algorithm: str = "f32",
) -> dict[str, np.ndarray]:
    """The folded frontend's constants for ``algorithm`` ∈
    :data:`FOLD_ALGORITHMS`, float32 numpy arrays:

    * ``wc`` [K, re_cols]: C[u, b] = w[u]·cos(2πb(u + pw)/N), u ∈ [0, K),
      K = sup/2 + 1, with w the periodic Hann taper of the support and
      w[sup/2] halved (the self-point of the fold);
    * ``ws`` [K, im_cols]: S = −w·sin(·), zero at u = sup/2, the Nyquist
      column dropped (its sine is zero);
    * ``melw`` [re_cols, n_mels].

    Trailing bins with zero mel weight are trimmed. When every bin is live,
    the Nyquist cosine column rides C's dead DC slot and mel row 0 takes the
    Nyquist weights. 'bf16' rounds the three to bf16; 'x3' stacks each as
    [2, ...] (hi, lo) bf16 splits. Verbatim from the JAX frontend's
    _folded_frontend and _stack_weights.
    """
    if algorithm not in FOLD_ALGORITHMS:
        raise ValueError(f"fold=True takes algorithm {', '.join(FOLD_ALGORITHMS)}, got {algorithm!r}")
    sup = win_length or n_fft
    pw = (n_fft - sup) // 2
    half = n_fft // 2
    k_half = sup // 2 + 1
    w = np.zeros(k_half, np.float64)
    w_full = hann(sup, periodic=True)
    w[: sup // 2] = w_full[: sup // 2]
    w[sup // 2] = 0.5 * w_full[sup // 2]
    m_full = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    nz = np.flatnonzero(np.abs(m_full).sum(axis=0) > 0)
    n_bins = int(nz[-1]) + 1 if nz.size else half + 1
    th = 2.0 * np.pi * np.outer(np.arange(k_half) + pw, np.arange(n_bins)) / n_fft
    c = w[:, None] * np.cos(th)
    s = -w[:, None] * np.sin(th)
    s[sup // 2, :] = 0.0  # the self-point is cosine-only
    packed = n_bins == half + 1 and half % 128 == 0 and nz.size and int(nz[0]) >= 1
    if packed:
        re_cols = half
        c[:, 0] = c[:, half]  # the Nyquist cosine column rides the DC slot
        c = c[:, :half]
        m_p = np.zeros((re_cols, n_mels), np.float32)
        m_p[:half, :] = m_full.T[:half]
        m_p[0, :] = m_full.T[half]
    else:
        re_cols = round_up_to_multiple(n_bins, 128)
        c = np.pad(c, ((0, 0), (0, re_cols - n_bins)))
        m_p = np.zeros((re_cols, n_mels), np.float32)
        m_p[:n_bins, :] = m_full.T[:n_bins]
    nb_im = min(n_bins, half)  # the Nyquist sine is identically zero
    im_cols = round_up_to_multiple(nb_im, 128)
    s = np.pad(s[:, :nb_im], ((0, 0), (0, im_cols - nb_im)))
    out = {"wc": c.astype(np.float32), "ws": s.astype(np.float32), "melw": m_p}
    if algorithm == "bf16":
        return {k: _bf16_round(v) for k, v in out.items()}
    if algorithm == "x3":
        return {k: _x3_stack(v) for k, v in out.items()}
    return out


def fold_tensors(algorithm: str, device, sr: float, n_fft: int = 512, win_length: int | None = None,
                 n_mels: int = 128, fmin: float = 100.0, fmax: float | None = None) -> dict[str, torch.Tensor]:
    """:func:`fold_weights` as tensors on ``device``, with the tensor-core
    fold kernel's layouts of them (:func:`fold_layouts`; f32 and x3)."""
    w = fold_weights(sr, n_fft, win_length, n_mels, fmin, fmax, algorithm)
    t = {k: torch.as_tensor(v, device=device) for k, v in w.items()}
    return t | fold_layouts(algorithm, t)


def pack_fold_basis(wc: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The tensor-core fold kernels' basis layout of the cosine planes ``wc``
    [P, K, bins_pad] and the sine planes ``ws`` [P, K, im_cols] (f32: the
    three planes of :func:`_split3`; x3: the (hi, lo) stacks): the sine
    columns zero-padded to bins_pad, then in groups of 16 columns, the 8
    cosine columns of 8 bins and the 8 sine columns of the same bins (an MMA
    n-tile each, so that one thread holds re and im of a bin); K
    zero-padded to Kp, a multiple of 32; then [bins_pad/64, Kp/16, P, 128,
    16] bf16 (exact: the planes are bf16 values), so one 32-row chunk of a
    64-bin tile is contiguous."""
    p, k, bins = wc.shape
    ws = tnf.pad(ws, (0, bins - ws.shape[-1]))
    g = _FOLD_GROUP
    w = torch.stack([wc.reshape(p, k, bins // g, g), ws.reshape(p, k, bins // g, g)], dim=3).reshape(p, k, 2 * bins)
    kp = round_up_to_multiple(k, _TC_CHUNK)
    x = tnf.pad(w, (0, 0, 0, kp - k)).reshape(p, kp // _KC, _KC, 2 * bins // _TC_COLS, _TC_COLS)
    return x.permute(3, 1, 0, 4, 2).contiguous().to(torch.bfloat16)


def unpack_fold_basis(packed: torch.Tensor, k: int, im_cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_fold_basis`: (wc [P, K, bins_pad], ws [P, K,
    im_cols]) float32."""
    tiles, ks, p, cols, step = packed.shape
    x = packed.permute(2, 1, 4, 0, 3).reshape(p, ks * step, tiles * cols)[:, :k].to(torch.float32)
    bins = tiles * cols // 2
    x = x.reshape(p, k, bins // _FOLD_GROUP, 2, _FOLD_GROUP)
    return x[:, :, :, 0].reshape(p, k, bins), x[:, :, :, 1].reshape(p, k, bins)[..., :im_cols]


def fold_layouts(algorithm: str, weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The tensor-core fold kernel's layouts of the mode's :func:`fold_weights`
    on their device: ``wcs_tc`` (:func:`pack_fold_basis`) and ``melw_tc``
    (:func:`pack_tc_mel`) of their planes (:func:`tc_planes`) for 'f32' and
    'x3'; none for 'bf16', whose FFMA kernel reads ``wc``, ``ws`` and
    ``melw`` as they are."""
    if algorithm not in TC_FOLD_ALGORITHMS:
        return {}
    return {"wcs_tc": pack_fold_basis(tc_planes(algorithm, weights["wc"]), tc_planes(algorithm, weights["ws"])),
            "melw_tc": pack_tc_mel(tc_planes(algorithm, weights["melw"]))}


class FoldPlan(NamedTuple):
    """The staging plan of a tensor-core fold launch (the launcher's
    ``FoldPlan``, passed by value in this field order, which it checks)."""

    frames: int        # frames a block: 64 or 32 (one MMA tile a warp)
    stages: int        # stages of the basis ring: 2 to 4
    buffers: int       # buffers of a chunk's s and d planes: 2, or 1 (f32's last rung)
    span_pad: int      # FP32 samples of the staged span
    mel_groups: int    # groups of 128 mel columns: the grid's z
    shared_bytes: int


# Each tensor-core fold's ladder of (frames, stages, buffers), tried in this
# order: x3's full plan, then 32 frames; f32, whose planes, ring and power
# tile take half as much again, first gives up stages, then frames, then the
# second buffer of its s and d planes (48 kHz at hop 720, window 1440).
_FOLD_LADDER = {
    "x3": ((BLOCK_FRAMES, _TC_STAGES, 2),) + tuple((BLOCK_FRAMES // 2, s, 2) for s in range(_TC_STAGES, 1, -1)),
    "f32": tuple((f, s, 2) for f in (BLOCK_FRAMES, BLOCK_FRAMES // 2) for s in range(_TC_STAGES, 1, -1))
    + ((BLOCK_FRAMES // 2, 2, 1),),
}


def _fold_plan_for(algorithm: str, hop: int, sup: int, n_mels: int, frames: int, stages: int,
                   buffers: int = 2) -> FoldPlan:
    """The plan with these choices and the launcher's sum of its shared
    memory (shared_bytes in the source), all of it dynamic: 128 bytes of
    barriers and warp maxima, the ring of basis chunks, a tile's mel weights,
    the power tile, one or two buffers of the s and d planes of a chunk and
    the FP32 span, each of the bf16 parts in the mode's planes (x3 two, f32
    three)."""
    planes = _TC_PLANES[algorithm][1]
    span_pad = -(-((frames - 1) * hop + sup + 1) // 4) * 4
    smem = (128 + stages * _TC_CHUNK * _TC_COLS * planes * 2 + _TC_COLS // 2 * planes * _MEL_MAX * 2
            + planes * frames * _TC_PITCH * 2 + buffers * 2 * planes * _TC_CHUNK * frames * 2 + 4 * span_pad)
    return FoldPlan(frames, stages, buffers, span_pad, -(-n_mels // _MEL_MAX), smem)


def fold_plan(algorithm: str, hop: int, sup: int, n_mels: int = 128) -> FoldPlan:
    """The staging plan of ``fused_mel_fold_{algorithm}`` (f32 or x3) at this
    hop, window support and mel width: the first rung of the mode's ladder
    that fits a block's shared memory (x3: 64 frames with four stages, then
    32 frames with four to two; f32: 64 frames with four to two stages, then
    32 frames with four to two, then 32 frames, two stages and one buffer of
    s and d planes); raises where none fits, for the FFMA fold (bf16, which
    has no plan) or for n_mels outside 1..512."""
    if algorithm not in TC_FOLD_ALGORITHMS:
        raise ValueError(f"fold_plan: the tensor-core folds are {', '.join(TC_FOLD_ALGORITHMS)}, got {algorithm!r}")
    if not 1 <= n_mels <= MEL_LIMIT:
        raise ValueError(f"fused_mel_fold_{algorithm}: n_mels must be in 1..{MEL_LIMIT}, got {n_mels}")
    plans = [_fold_plan_for(algorithm, hop, sup, n_mels, *rung) for rung in _FOLD_LADDER[algorithm]]
    return _first_fitting(plans, f"fused_mel_fold_{algorithm}", f"hop {hop}, window {sup}")


def ffma_fold_bytes(algorithm: str, hop: int, sup: int) -> int:
    """Shared memory a block of the FFMA fold (``fused_mel_fold_bf16``)
    takes at this hop and window support, the launcher's sum (shared_bytes
    in csrc/fused_frontend_fold.cu): the space the basis slices, the s and d
    slices and the power tile share, the [64, 128] FP32 mel accumulator, and
    the span of 63·hop + sup + 1 bf16 samples (padded to 4). The launcher
    refuses a block past :data:`SHARED_MAX`."""
    if algorithm != "bf16":
        raise ValueError(f"ffma_fold_bytes: the FFMA fold is 'bf16', got {algorithm!r}")
    pitch = BLOCK_FRAMES + 4
    shared = max(2 * _KC * 2 * _BIN_TILE + 2 * _KC * pitch, _BIN_TILE * pitch)
    span_pad = -(-((BLOCK_FRAMES - 1) * hop + sup + 1) // 4) * 4
    return 4 * (shared + BLOCK_FRAMES * _MEL_MAX) + 2 * span_pad


@lru_cache(maxsize=16)
def tail_dct(n_mfcc: int, n_mels: int) -> np.ndarray:
    """DCT-II ortho as [n_mels, n_mfcc] float32 (the live columns of the JAX
    tail's padded DCT)."""
    return np.ascontiguousarray(dct_matrix(n_mfcc, n_mels).T, dtype=np.float32)


def eff_pad(n_fft: int, win_length: int | None) -> int:
    """Left pad so frame f's trimmed window support starts at f·hop."""
    win_length = win_length or n_fft
    return n_fft // 2 - (n_fft - win_length) // 2


def hop_rows_geometry(
    n_samples: int, *, n_fft: int = 512, hop: int = 80, win_length: int | None = None,
) -> tuple[int, int]:
    """(rows_total, eff_pad) of the hop-rows input for ``n_samples``: the
    JAX frontend's geometry at its default frame block of 1024,
    rows_total = ceil(nf/1024)·1024 + 16 hop rows, the audio at sample
    offset ``eff_pad`` (centered framing, shifted by the trimmed window
    support)."""
    nf = 1 + n_samples // hop
    return -(-nf // ROWS_BLKF) * ROWS_BLKF + _TAIL_ROWS, eff_pad(n_fft, win_length)


def pack_hop_rows(audio, *, n_fft: int = 512, hop: int = 80, win_length: int | None = None):
    """[B, T] (or [T]) samples → [B, rows_total, hop] zero-padded hop rows,
    the frontends' rows input (dtype-preserving: int16 rows stay int16).
    numpy in → numpy out (the corpus batch assembler's case); a tensor in →
    a tensor on its device."""
    if audio.ndim == 1:
        audio = audio[None, :]
    b, t = audio.shape
    rows_total, pad = hop_rows_geometry(t, n_fft=n_fft, hop=hop, win_length=win_length)
    if isinstance(audio, np.ndarray):
        out = np.zeros((b, rows_total * hop), dtype=audio.dtype)
        out[:, pad : pad + t] = audio
        return out.reshape(b, rows_total, hop)
    return tnf.pad(audio, (pad, rows_total * hop - t - pad)).reshape(b, rows_total, hop)


def _geometry(audio: torch.Tensor, hop: int, n_fft: int, win_length: int | None,
              n_samples: int | None) -> tuple[int, int, int]:
    """(n_samples, buffer length per utterance, offset of frame 0's first
    sample in that buffer) of a flat [B, T] or hop-rows [B, rows, hop] batch;
    raises on what the frontends do not take."""
    if audio.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"fused_mel_frontend: audio must be float32 or int16, got {audio.dtype}")
    pad = eff_pad(n_fft, win_length)
    if audio.ndim == 2:
        return audio.shape[1], audio.shape[1], -pad
    if audio.ndim != 3:
        raise ValueError(f"fused_mel_frontend: audio must be [B, T] or [B, rows, hop], got {tuple(audio.shape)}")
    if n_samples is None:
        raise ValueError("rows input [B, rows, hop] requires n_samples")
    rows_total, _ = hop_rows_geometry(int(n_samples), n_fft=n_fft, hop=hop, win_length=win_length)
    if audio.shape[1:] != (rows_total, hop):
        raise ValueError(
            f"rows input {tuple(audio.shape)} does not match the geometry [B, {rows_total}, {hop}] "
            f"of n_samples={n_samples}; build it with pack_hop_rows"
        )
    return int(n_samples), rows_total * hop, 0


# ---------------------------------------------------------------------------
# Per-utterance scales of the fixed-point modes (device side)
# ---------------------------------------------------------------------------


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as float32, built from the exponent bits (exact; k in [-126, 127])."""
    return ((k.to(torch.int32) + 127).clamp(1, 254) << 23).view(torch.float32)


def quant_scales(audio: torch.Tensor, algorithm: str, sw: torch.Tensor) -> torch.Tensor:
    """sc [B, 2] float32 = (s, 1/(s·Sw)) per utterance, from the samples as
    the kernel sees them (dequantized; rows include their zero pad, which
    moves no bound): for 'i24' s = (127·65536 − 33000) / max|x|; for 'i16'
    the largest power of two with max(x)·s ≤ 32767 and −min(x)·s ≤ 32768
    (frexp, then halved where f32 rounding overshot), at most 2⁶⁰."""
    af = dequantize_samples(audio).reshape(audio.shape[0], -1)
    if algorithm == "i24":
        amax = torch.clamp(af.abs().amax(dim=1), min=1e-20)
        s = torch.tensor(_I24_FULL, dtype=torch.float32, device=af.device) / amax
    else:
        pmax = af.amax(dim=1)
        nmax = -af.amin(dim=1)
        ratio = torch.tensor(32768.0, dtype=torch.float32, device=af.device) / torch.clamp(
            torch.maximum(pmax, nmax), min=1e-30)
        s = _pow2(torch.frexp(ratio)[1] - 1)
        over = (pmax * s > 32767.0) | (nmax * s > 32768.0)
        s = torch.clamp(torch.where(over, s * 0.5, s), max=2.0**60)
    return torch.stack([s, 1.0 / (s * sw.to(torch.float32))], dim=1)


# ---------------------------------------------------------------------------
# Kernel binding
# ---------------------------------------------------------------------------


class _TcPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in TcPlan._fields]


class _FoldPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in FoldPlan._fields]


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from modulation_mfcc_tpu_torch.kernels._build import load_library

    lib = load_library()
    p, i, plan = ctypes.c_void_p, ctypes.c_int, _TcPlan
    for alg in ("f32", "bf16", "x3"):
        fn = getattr(lib, f"fused_mel_{alg}")
        fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, plan, p]
        fn.restype = i
    lib.fused_mel_i16.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, plan, p]
    lib.fused_mel_i16.restype = i
    lib.fused_mel_i24.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, plan, p]
    lib.fused_mel_i24.restype = i
    lib.fused_mel_fold_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.fused_mel_fold_bf16.restype = i
    for alg in TC_FOLD_ALGORITHMS:
        fn = getattr(lib, f"fused_mel_fold_{alg}")
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, _FoldPlan, p]
        fn.restype = i
    lib.mfcc_tail_f32.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
    lib.mfcc_tail_f32.restype = i
    return lib


# ---------------------------------------------------------------------------
# The frontend kernels
# ---------------------------------------------------------------------------


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _stepped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w [K, C] in the f32 kernels' order: the contraction in steps of
    16 rows, each step's product summed on its own and then added to the
    running sum, step by step. Against one K-term sum this cuts the f32
    rounding of the DFT's long sums (the MFCC's distance from float64 on
    16 × 30 s of noise at 16 kHz: 2.5e-4 as one sum, 8.5e-5 in steps;
    tests/test_torch_frontend_accuracy.py). The f32 plain versions' DFT."""
    out = x[..., :_KC] @ w[:_KC]
    for k0 in range(_KC, w.shape[-2], _KC):
        out.add_(x[..., k0 : k0 + _KC] @ w[k0 : k0 + _KC])
    return out


def _split3_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in fused_mel_f32's tensor-core arithmetic, mirrored in float32
    matmuls: x split into three bf16 planes as the kernel splits its
    operands (:func:`_split3`), ``w`` [3, K, C] the planes of the other
    operand; the hi·hi products summed per 16-row step and the step sums
    added to the running sum one by one (:func:`_stepped_matmul`), the five
    smaller products (hi·mid, mid·hi, hi·lo, mid·mid, lo·hi) summed apart
    and added at the end. Each product of two bf16 values is exact in
    float32. A CPU proof of the split's accuracy: no path calls it."""
    xh, xm, xl = _split3(x)
    wh, wm, wl = w
    return _stepped_matmul(xh, wh) + ((((xh @ wm + xm @ wh) + xh @ wl) + xm @ wm) + xl @ wh)


def _x3_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """hi·Whi + hi·Wlo + lo·Whi in the JAX order, w = [2, K, C] (hi, lo)."""
    hi = _bf16r(x)
    lo = _bf16r(x - hi)
    return (hi @ w[0] + hi @ w[1]) + lo @ w[0]


def _fixed_point_reim(frames: torch.Tensor, planes: torch.Tensor, sc: torch.Tensor,
                      algorithm: str, corr: torch.Tensor | None) -> torch.Tensor:
    """The i16/i24 windowed DFT: digits of round(x·s), exact digit × plane
    products (each an integer below 2²⁴, so an f32 matmul is exact; summed
    as int32), recombined in f32 in the JAX order, times 1/(s·Sw)."""
    s, inv = sc[:, 0, None, None], sc[:, 1, None, None]
    x = torch.round(frames * s)  # half to even, as jnp.round
    if algorithm == "i16":
        x = torch.clamp(x, -32768.0, 32767.0)
        x1 = torch.floor(x * (1.0 / 256.0))
        digits = (x1, x - 256.0 * x1 - 128.0)
    else:
        q1 = torch.floor((x + 128.0) * (1.0 / 256.0))
        q2 = torch.floor((q1 + 128.0) * (1.0 / 256.0))
        digits = (q2, q1 - 256.0 * q2, x - 256.0 * q1)
    w2, w1, w0 = planes.to(torch.float32)

    def dot(a, w):
        return (a @ w).to(torch.int32)

    if algorithm == "i16":
        x1, x0 = digits
        d1 = dot(x1, w2)
        d2 = dot(x1, w1) + dot(x0, w2)
        d3 = dot(x1, w0) + dot(x0, w1)
        return (d1.float() * 16777216.0 + d2.float() * 65536.0 + d3.float() * 256.0 + corr) * inv
    x2, x1, x0 = digits
    d1 = dot(x2, w2)
    d2 = dot(x2, w1) + dot(x1, w2)
    d3 = dot(x2, w0) + dot(x1, w1) + dot(x0, w2)
    return (d1.float() * 4294967296.0 + d2.float() * 16777216.0 + d3.float() * 65536.0) * inv


def fused_mel_frontend_reference(
    audio: torch.Tensor, wri: torch.Tensor, melw: torch.Tensor, *, hop: int, eff_pad: int,
    algorithm: str = "f32", n_samples: int | None = None, sw: torch.Tensor | None = None,
    corr: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the frontend kernels: frame matrix, then
    matmuls in the mode's arithmetic ('f32': true FP32 GEMMs, the DFT summed
    in 16-row steps, :func:`_stepped_matmul`, the steps the kernel adds its
    hi·hi products in). ``wri``/``melw``/``sw``/``corr`` are
    the mode's :func:`mode_weights` (``wri`` = ``planes`` for i16/i24).
    Audio as for :func:`fused_mel_frontend`."""
    bins_pad = melw.shape[-2]
    frames = _frames(audio, wri.shape[-2], hop, eff_pad, n_samples)
    if algorithm == "f32":
        reim = _stepped_matmul(frames, wri)
    elif algorithm == "bf16":
        reim = _bf16r(frames) @ wri
    elif algorithm == "x3":
        reim = _x3_matmul(frames, wri)
    else:
        reim = _fixed_point_reim(frames, wri, quant_scales(audio, algorithm, sw), algorithm, corr)
    re, im = reim[..., :bins_pad], reim[..., bins_pad:]
    return _mel_of_power(re * re + im * im, melw, algorithm)


def _frames(audio: torch.Tensor, k: int, hop: int, eff_pad: int, n_samples: int | None) -> torch.Tensor:
    """[B, nf, k] frames of the frontends' input (flat [B, T] with the left
    pad ``eff_pad``, or hop rows with ``n_samples``), dequantized, zero
    past the buffer."""
    bsz = audio.shape[0]
    if audio.ndim == 3:
        t, flat, left = int(n_samples), dequantize_samples(audio).reshape(bsz, -1), 0
    else:
        t, flat, left = audio.shape[1], dequantize_samples(audio), eff_pad
    nf = 1 + t // hop
    right = max(0, (nf - 1) * hop + k - left - flat.shape[1])
    return frame_by_slices(tnf.pad(flat, (left, right)), 0, nf, k, hop)


def split3_frontend_mirror(
    audio: torch.Tensor, wri: torch.Tensor, melw: torch.Tensor, *, hop: int, eff_pad: int,
    n_samples: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel, block maxima) of ``fused_mel_f32``'s arithmetic mirrored in
    float32 matmuls (:func:`_split3_matmul`): the DFT of the split frames
    against the split basis, power = re² + im² in float32, and the split
    power against the split mel weights (16-bin steps). ``wri``/``melw``
    are the f32 :func:`mode_weights`; audio as for
    :func:`fused_mel_frontend`. It shows on the CPU, and beside the kernel
    on the card, how far the split lands from float64; no path calls it."""
    bins_pad = melw.shape[-2]
    reim = _split3_matmul(_frames(audio, wri.shape[-2], hop, eff_pad, n_samples), _split3(wri))
    re, im = reim[..., :bins_pad], reim[..., bins_pad:]
    return _with_block_max(_split3_matmul(re * re + im * im, _split3(melw)))


def _with_block_max(mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel, the max of each 64-frame block of it [B, ceil(nf/64)])."""
    bsz, nf = mel.shape[:2]
    n_blocks = -(-nf // BLOCK_FRAMES)
    fmax = tnf.pad(torch.amax(mel, dim=-1), (0, n_blocks * BLOCK_FRAMES - nf))
    return mel, torch.amax(fmax.reshape(bsz, n_blocks, BLOCK_FRAMES), dim=-1)


def _mel_of_power(p: torch.Tensor, melw: torch.Tensor, algorithm: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel, block maxima) of the power [B, nf, bins_pad] in the mode's
    arithmetic, as every frontend kernel ends."""
    if algorithm == "f32":
        mel = p @ melw
    elif algorithm == "bf16":
        mel = _bf16r(p) @ melw
    else:
        mel = _x3_matmul(p, melw)
    mel, bmax = _with_block_max(mel)
    return (mel.to(torch.bfloat16) if algorithm == "bf16" else mel), bmax


def fold_operands(audio: torch.Tensor, k: int, *, hop: int, eff_pad: int,
                  algorithm: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """The folded operands (s, d) [B, nf, k] float32 of the plain fold, before
    the mode's rounding of the products' operands: frames of sup + 1 = 2k − 1
    samples of the audio (rounded to bf16 first for 'bf16') padded by
    ``eff_pad`` on the left, s[u] = z[a+u] + z[a+sup−u], d[u] = z[a+u] −
    z[a+sup−u]."""
    t = audio.shape[1]
    sup = 2 * (k - 1)
    nf = 1 + t // hop
    x = _bf16r(audio) if algorithm == "bf16" else audio
    right = max(0, (nf - 1) * hop + sup + 1 - eff_pad - t)
    frames = frame_by_slices(tnf.pad(x, (eff_pad, right)), 0, nf, sup + 1, hop)
    fwd = frames[..., :k]
    rev = torch.flip(frames[..., sup // 2 :], dims=(-1,))  # rev[u] = frame[sup − u]
    return fwd + rev, fwd - rev


def fused_mel_fold_reference(
    audio: torch.Tensor, wc: torch.Tensor, ws: torch.Tensor, melw: torch.Tensor, *, hop: int, eff_pad: int,
    algorithm: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fold kernels, in the JAX order: frames
    of sup + 1 samples of the audio padded by ``eff_pad`` on the left,
    s[u] = z[a+u] + z[a+sup−u] and d[u] = z[a+u] − z[a+sup−u] for
    u ∈ [0, sup/2], then re = s·wc and im = d·ws in the mode's arithmetic
    ('f32' in the kernel's 16-row steps; 'bf16' rounds the audio to bf16 before the fold and s, d again at the
    products), power and mel as the unfolded frontend. ``wc``/``ws``/``melw``
    are the mode's :func:`fold_weights`; audio float32 [B, T]."""
    s, d = fold_operands(audio, wc.shape[-2], hop=hop, eff_pad=eff_pad, algorithm=algorithm)
    if algorithm == "f32":
        re, im = _stepped_matmul(s, wc), _stepped_matmul(d, ws)
    elif algorithm == "bf16":
        re, im = _bf16r(s) @ wc, _bf16r(d) @ ws
    else:
        re, im = _x3_matmul(s, wc), _x3_matmul(d, ws)
    im = tnf.pad(im, (0, re.shape[-1] - im.shape[-1]))
    return _mel_of_power(re * re + im * im, melw, algorithm)


def split3_fold_mirror(
    audio: torch.Tensor, wc: torch.Tensor, ws: torch.Tensor, melw: torch.Tensor, *, hop: int, eff_pad: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel, block maxima) of ``fused_mel_fold_f32``'s arithmetic mirrored
    in float32 matmuls (:func:`_split3_matmul`): s and d as the plain fold
    forms them, against the split cosine and sine bases, power = re² + im²
    in float32, and the split power against the split mel weights.
    ``wc``/``ws``/``melw`` are the f32 :func:`fold_weights`; audio float32
    [B, T]. The fold's counterpart of :func:`split3_frontend_mirror`: it
    shows on the CPU, and beside the kernel on the card, how far the split
    lands from float64; no path calls it."""
    s, d = fold_operands(audio, wc.shape[-2], hop=hop, eff_pad=eff_pad)
    re, im = _split3_matmul(s, _split3(wc)), _split3_matmul(d, _split3(ws))
    im = tnf.pad(im, (0, re.shape[-1] - im.shape[-1]))
    return _with_block_max(_split3_matmul(re * re + im * im, _split3(melw)))


def fused_mel_frontend(
    audio: torch.Tensor,
    *,
    sr: float,
    n_fft: int = 512,
    hop: int = 80,
    win_length: int | None = None,
    n_mels: int = 128,
    fmin: float = 100.0,
    fmax: float | None = None,
    algorithm: str = "f32",
    n_samples: int | None = None,
    weights: dict[str, torch.Tensor] | None = None,
    fold: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel [B, nf, n_mels], block_maxes [B, ceil(nf/64)]), nf = 1 + T // hop
    (librosa centered framing, zero pad), in the arithmetic of
    ``algorithm`` ∈ :data:`ALGORITHMS`; mel is bf16 for 'bf16', float32
    otherwise.

    ``audio`` is float32 or int16 (dequantized as v·2⁻¹⁵): flat [B, T], or
    hop rows [B, rows, hop] from :func:`pack_hop_rows` with ``n_samples`` =
    T. ``block_maxes[b, j]`` is the max of the float32 mel over frames
    [64j, 64j+64) ∩ [0, nf); their max over j is the utterance's peak mel
    power. ``weights`` = the mode's :func:`mode_tensors` (:func:`fold_tensors`
    with ``fold``) on the audio's device (a module's buffers); designed
    from the other arguments when None.

    ``fold=True`` takes the folded real DFT (``fused_mel_fold_*``): float32
    flat audio, :data:`FOLD_ALGORITHMS`, and a geometry :func:`fold_ok`
    accepts; anything else raises.
    """
    t, buf_len, off = _geometry(audio, hop, n_fft, win_length, n_samples)
    if algorithm not in ALGORITHMS:
        raise ValueError(f"Unknown algorithm {algorithm!r}; one of {', '.join(ALGORITHMS)}")
    if fold:
        return _fused_mel_fold(audio, sr=sr, n_fft=n_fft, hop=hop, win_length=win_length, n_mels=n_mels,
                               fmin=fmin, fmax=fmax, algorithm=algorithm, weights=weights)
    if weights is None:
        weights = mode_tensors(algorithm, audio.device, sr, n_fft, win_length, n_mels, fmin, fmax)
    fixed = algorithm in ("i16", "i24")
    wri, melw = weights["planes" if fixed else "wri"], weights["melw"]
    pad = eff_pad(n_fft, win_length)
    if not route(audio, "fused_mel_frontend"):
        return fused_mel_frontend_reference(
            audio, wri, melw, hop=hop, eff_pad=pad, algorithm=algorithm, n_samples=t,
            sw=weights.get("sw"), corr=weights.get("corr"),
        )
    name = f"fused_mel_{algorithm}"
    if not audio.is_contiguous():
        raise ValueError(f"{name}: audio must be contiguous")
    check_cuda(name, melw, *([] if fixed else [wri]))
    k, two_bins = wri.shape[-2:]
    bins_pad, n_mels = melw.shape[-2:]
    if two_bins != 2 * bins_pad or bins_pad % _BIN_TILE or not 1 <= n_mels <= MEL_LIMIT:
        raise ValueError(
            f"{name}: weights {tuple(wri.shape)} / melw {tuple(melw.shape)} need "
            f"2·bins_pad columns, bins_pad a multiple of {_BIN_TILE}, n_mels in 1..{MEL_LIMIT}"
        )
    bsz = audio.shape[0]
    nf = 1 + t // hop
    mel_dtype = torch.bfloat16 if algorithm == "bf16" else torch.float32
    mel = torch.empty((bsz, nf, n_mels), dtype=mel_dtype, device=audio.device)
    rc, bmax = _launch_tc(name, audio, int(audio.dtype == torch.int16), weights, mel, buf_len, k, hop, off, nf,
                          bins_pad, n_mels)
    raise_on(rc, name)
    LAUNCHES[name] += 1
    return mel, bmax


def _launch_tc(name: str, audio: torch.Tensor, is_i16: int, weights: dict[str, torch.Tensor], mel: torch.Tensor,
               buf_len: int, k: int, hop: int, off: int, nf: int, bins_pad: int,
               n_mels: int, plan: TcPlan | None = None) -> tuple[int, torch.Tensor]:
    """Launch ``fused_mel_f32``, ``fused_mel_bf16``, ``fused_mel_x3``,
    ``fused_mel_i16`` or ``fused_mel_i24`` on the weights' tensor-core
    layouts (:func:`tc_layouts`, which :func:`mode_tensors` includes) under
    its :func:`tc_plan`, or under ``plan`` (another rung of the ladder,
    which the launcher checks; chip_smoke.py compares the rungs); the
    launcher's code and the block maxima [B, ceil(nf/64)], zeroed first
    where the plan merges them (the compact plan, or more than one mel
    group)."""
    algorithm = name.removeprefix("fused_mel_")
    basis_key = "wri_tc" if algorithm in _TC_BF16 else "planes_tc"
    if basis_key not in weights or "melw_tc" not in weights:
        raise ValueError(f"{name}: weights lack the tensor-core layouts {basis_key!r}/'melw_tc'; "
                         "pass mode_tensors(...) or add tc_layouts(...)")
    basis, mtc = weights[basis_key], weights["melw_tc"]
    step = _TC_STEP[algorithm]
    kp = basis.shape[1] * step
    _, basis_planes, mel_planes = _TC_PLANES[algorithm]
    want = (2 * bins_pad // _TC_COLS, kp // step, basis_planes, _TC_COLS, step)
    for t, dtype in ((basis, torch.bfloat16 if algorithm in _TC_BF16 else torch.int8), (mtc, torch.bfloat16)):
        if t.device != audio.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: tensor-core weights must be contiguous {dtype} on {audio.device}, "
                             f"got {t.dtype} on {t.device}")
    plan = tc_plan(algorithm, hop, kp, n_mels) if plan is None else plan
    if obs.recording():
        obs.annotate(tc_plan="streamed" if plan.streamed else "compact" if plan.shifted else "full")
    want_mel = (plan.mel_groups * bins_pad // _MEL_STEP, mel_planes, _MEL_MAX, _MEL_STEP)
    if tuple(basis.shape) != want or kp < k or kp % _TC_CHUNK or tuple(mtc.shape) != want_mel:
        raise ValueError(f"{name}: tensor-core weights {tuple(basis.shape)} / {tuple(mtc.shape)} do not match "
                         f"K={k}, bins_pad={bins_pad}, n_mels={n_mels} (pack_tc_basis, pack_tc_mel)")
    bsz = audio.shape[0]
    merged = plan.frames != BLOCK_FRAMES or plan.mel_groups > 1
    bmax = (torch.zeros if merged else torch.empty)((bsz, -(-nf // BLOCK_FRAMES)), dtype=torch.float32,
                                                    device=audio.device)
    lib, cplan = _lib(), _TcPlan(*plan)
    if algorithm in _TC_BF16:
        return getattr(lib, name)(
            audio.data_ptr(), is_i16, basis.data_ptr(), mtc.data_ptr(), mel.data_ptr(), bmax.data_ptr(),
            bsz, buf_len, kp, hop, off, nf, bins_pad, n_mels, cplan, stream_of(audio),
        ), bmax
    sc = quant_scales(audio, algorithm, weights["sw"])
    check_cuda(name, sc)
    if algorithm == "i16":
        corr = weights["corr"]
        check_cuda(name, corr)
        if corr.shape != (2 * bins_pad,):
            raise ValueError(f"{name}: corr {tuple(corr.shape)} != ({2 * bins_pad},)")
        return lib.fused_mel_i16(
            audio.data_ptr(), is_i16, basis.data_ptr(), sc.data_ptr(), corr.data_ptr(), mtc.data_ptr(),
            mel.data_ptr(), bmax.data_ptr(), bsz, buf_len, kp, hop, off, nf, bins_pad, n_mels, cplan,
            stream_of(audio),
        ), bmax
    return lib.fused_mel_i24(
        audio.data_ptr(), is_i16, basis.data_ptr(), sc.data_ptr(), mtc.data_ptr(), mel.data_ptr(),
        bmax.data_ptr(), bsz, buf_len, kp, hop, off, nf, bins_pad, n_mels, cplan, stream_of(audio),
    ), bmax


def _fused_mel_fold(audio: torch.Tensor, *, sr, n_fft, hop, win_length, n_mels, fmin, fmax, algorithm,
                    weights) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_mel_frontend(fold=True)``: the JAX fold's guards, then the
    fold kernel of ``algorithm`` (its plain version for a CPU tensor)."""
    if audio.ndim == 3:
        raise ValueError("fold=True unsupported with rows input")
    if audio.dtype != torch.float32:
        raise ValueError(f"fold=True takes float32 audio, got {audio.dtype}")
    if algorithm not in FOLD_ALGORITHMS or not fold_ok(n_fft, hop, win_length):
        raise ValueError("fold=True unsupported for this geometry/algorithm")
    if weights is None:
        weights = fold_tensors(algorithm, audio.device, sr, n_fft, win_length, n_mels, fmin, fmax)
    wc, ws, melw = weights["wc"], weights["ws"], weights["melw"]
    pad = eff_pad(n_fft, win_length)
    if not route(audio, "fused_mel_frontend"):
        return fused_mel_fold_reference(audio, wc, ws, melw, hop=hop, eff_pad=pad, algorithm=algorithm)
    name = f"fused_mel_fold_{algorithm}"
    if not audio.is_contiguous():
        raise ValueError(f"{name}: audio must be contiguous")
    check_cuda(name, wc, ws, melw)
    sup = win_length or n_fft
    k, bins_pad = wc.shape[-2:]
    im_cols = ws.shape[-1]
    n_mels = melw.shape[-1]
    if (k != sup // 2 + 1 or ws.shape[-2] != k or melw.shape[-2] != bins_pad or bins_pad % _BIN_TILE
            or im_cols % _BIN_TILE or im_cols > bins_pad or not 1 <= n_mels <= MEL_LIMIT):
        raise ValueError(
            f"{name}: wc {tuple(wc.shape)} / ws {tuple(ws.shape)} / melw {tuple(melw.shape)} need "
            f"sup/2 + 1 = {sup // 2 + 1} rows, column counts multiples of {_BIN_TILE}, n_mels in 1..{MEL_LIMIT}"
        )
    bsz, t = audio.shape
    nf = 1 + t // hop
    mel_dtype = torch.bfloat16 if algorithm == "bf16" else torch.float32
    mel = torch.empty((bsz, nf, n_mels), dtype=mel_dtype, device=audio.device)
    if algorithm in TC_FOLD_ALGORITHMS:
        rc, bmax = _launch_fold_tc(name, audio, weights, mel, k, sup, hop, -pad, nf, bins_pad)
    else:
        # more than one group of 128 mel columns merges its block maxima by atomicMax
        bmax = (torch.zeros if n_mels > _MEL_MAX else torch.empty)((bsz, -(-nf // BLOCK_FRAMES)),
                                                                    dtype=torch.float32, device=audio.device)
        rc = getattr(_lib(), name)(
            audio.data_ptr(), wc.data_ptr(), ws.data_ptr(), melw.data_ptr(), mel.data_ptr(), bmax.data_ptr(),
            bsz, t, k, sup, hop, -pad, nf, bins_pad, im_cols, n_mels,
            stream_of(audio),
        )
    raise_on(rc, name)
    LAUNCHES[name] += 1
    return mel, bmax


def _launch_fold_tc(name: str, audio: torch.Tensor, weights: dict[str, torch.Tensor], mel: torch.Tensor, k: int,
                    sup: int, hop: int, off: int, nf: int, bins_pad: int) -> tuple[int, torch.Tensor]:
    """Launch ``fused_mel_fold_f32`` or ``fused_mel_fold_x3`` on the weights'
    tensor-core layouts (:func:`fold_layouts`, which :func:`fold_tensors`
    includes) under its :func:`fold_plan`; the launcher's code and the block
    maxima [B, ceil(nf/64)], zeroed first where the plan merges them (32
    frames a block, or more than one mel group)."""
    algorithm = name.removeprefix("fused_mel_fold_")
    if "wcs_tc" not in weights or "melw_tc" not in weights:
        raise ValueError(f"{name}: weights lack the tensor-core layouts 'wcs_tc'/'melw_tc'; "
                         "pass fold_tensors(...) or add fold_layouts(...)")
    basis, mtc = weights["wcs_tc"], weights["melw_tc"]
    n_mels = mel.shape[-1]
    planes = _TC_PLANES[algorithm][1]
    plan = fold_plan(algorithm, hop, sup, n_mels)
    kp = round_up_to_multiple(k, _TC_CHUNK)
    want = (bins_pad // (_TC_COLS // 2), kp // _KC, planes, _TC_COLS, _KC)
    want_mel = (plan.mel_groups * bins_pad // _MEL_STEP, planes, _MEL_MAX, _MEL_STEP)
    for x in (basis, mtc):
        if x.device != audio.device or x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError(f"{name}: tensor-core weights must be contiguous bfloat16 on {audio.device}, "
                             f"got {x.dtype} on {x.device}")
    if tuple(basis.shape) != want or tuple(mtc.shape) != want_mel:
        raise ValueError(f"{name}: tensor-core weights {tuple(basis.shape)} / {tuple(mtc.shape)} do not match "
                         f"K={k}, bins_pad={bins_pad}, n_mels={n_mels} (pack_fold_basis, pack_tc_mel)")
    bsz, t = audio.shape
    merged = plan.frames != BLOCK_FRAMES or plan.mel_groups > 1
    bmax = (torch.zeros if merged else torch.empty)((bsz, -(-nf // BLOCK_FRAMES)), dtype=torch.float32,
                                                    device=audio.device)
    return getattr(_lib(), name)(
        audio.data_ptr(), basis.data_ptr(), mtc.data_ptr(), mel.data_ptr(), bmax.data_ptr(),
        bsz, t, k, kp, sup, hop, off, nf, bins_pad, n_mels, _FoldPlan(*plan), stream_of(audio),
    ), bmax


# ---------------------------------------------------------------------------
# mfcc_tail_f32
# ---------------------------------------------------------------------------


def mfcc_tail_reference(
    mel: torch.Tensor, peak: torch.Tensor, dct: torch.Tensor, *, transposed: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of ``mfcc_tail_f32``."""
    db = 10.0 * torch.log10(torch.clamp(mel.float(), min=1e-10))
    db = torch.maximum(db, (peak - 80.0)[:, None, None])
    out = db @ dct
    return out.transpose(-1, -2).contiguous() if transposed else out


def mfcc_tail(
    mel: torch.Tensor,
    peak: torch.Tensor,
    n_mfcc: int,
    *,
    transposed: bool = False,
    dct: torch.Tensor | None = None,
) -> torch.Tensor:
    """dB/clip/DCT over mel [B, nf, n_mels] (float32 or bf16) with
    per-utterance dB peaks [B] (librosa power_to_db top_db=80 + DCT-II
    ortho): [B, nf, n_mfcc], or coef-major [B, n_mfcc, nf] with
    ``transposed=True``. ``dct`` is the [n_mels, n_mfcc] matrix on mel's
    device (designed when None). The kernel takes n_mfcc ≤ n_mels ≤ 512."""
    bsz, nf, n_mels = mel.shape
    if dct is None:
        dct = torch.as_tensor(tail_dct(n_mfcc, n_mels), dtype=torch.float32, device=mel.device)
    if dct.shape != (n_mels, n_mfcc):
        raise ValueError(f"mfcc_tail: dct {tuple(dct.shape)} != {(n_mels, n_mfcc)}")
    if not route(mel, "mfcc_tail"):
        return mfcc_tail_reference(mel, peak, dct, transposed=transposed)
    if mel.dtype not in (torch.float32, torch.bfloat16) or not mel.is_contiguous():
        raise ValueError(f"mfcc_tail: mel must be a contiguous float32 or bf16 tensor, got {mel.dtype}")
    check_cuda("mfcc_tail", peak, dct)
    if peak.shape != (bsz,) or not 1 <= n_mfcc <= n_mels <= MEL_LIMIT:
        raise ValueError(f"mfcc_tail: peak {tuple(peak.shape)} != ({bsz},), or not 1 ≤ n_mfcc ({n_mfcc}) ≤ "
                         f"n_mels ({n_mels}) ≤ {MEL_LIMIT}")
    shape = (bsz, n_mfcc, nf) if transposed else (bsz, nf, n_mfcc)
    out = torch.empty(shape, dtype=torch.float32, device=mel.device)
    rc = _lib().mfcc_tail_f32(
        mel.data_ptr(), int(mel.dtype == torch.bfloat16), peak.data_ptr(), dct.data_ptr(), out.data_ptr(),
        bsz, nf, n_mels, n_mfcc, int(transposed),
        stream_of(mel),
    )
    raise_on(rc, "mfcc_tail_f32")
    LAUNCHES["mfcc_tail_f32"] += 1
    return out


# ---------------------------------------------------------------------------
# Frontend and tail together
# ---------------------------------------------------------------------------


def fused_mfcc(
    audio: torch.Tensor,
    *,
    sr: float,
    n_fft: int = 512,
    hop: int = 80,
    win_length: int | None = None,
    n_mfcc: int = 13,
    n_mels: int = 128,
    fmin: float = 100.0,
    fmax: float | None = None,
    frame_mask: torch.Tensor | None = None,
    transposed: bool = False,
    algorithm: str = "f32",
    n_samples: int | None = None,
    weights: dict[str, torch.Tensor] | None = None,
    dct: torch.Tensor | None = None,
) -> torch.Tensor:
    """MFCC [B, nf, n_mfcc] of audio [B, T] (or [T], or hop rows with
    ``n_samples``, float32 or int16) via the fused kernels, or coef-major
    [B, n_mfcc, nf] with ``transposed=True``.

    librosa semantics (power=2, power_to_db top_db=80, DCT-II ortho), the
    contract of ops/spectral.mfcc_from_frames. The top_db peak comes from
    the kernel's block maxes, or, with ``frame_mask`` [B, nf] (1 = valid),
    from one masked reduction over mel. ``weights`` (the mode's
    :func:`mode_tensors`) and ``dct`` on the audio's device; designed from
    the other arguments when None.
    """
    single = audio.ndim == 1
    if single:
        audio = audio[None, :]
    if weights is None:
        weights = mode_tensors(algorithm, audio.device, sr, n_fft, win_length, n_mels, fmin, fmax)
    if dct is None:
        dct = torch.as_tensor(tail_dct(n_mfcc, n_mels), dtype=torch.float32, device=audio.device)
    with obs.span("frontend.mel"):
        mel, bmax = fused_mel_frontend(
            audio, sr=sr, n_fft=n_fft, hop=hop, win_length=win_length, algorithm=algorithm,
            n_samples=n_samples, weights=weights,
        )
    with obs.span("frontend.peak"):
        if frame_mask is not None:
            valid = frame_mask[..., : mel.shape[1], None] > 0
            pmax = torch.amax(torch.where(valid, mel.float(), 0.0), dim=(1, 2))
        else:
            pmax = torch.amax(bmax, dim=1)
        peak = 10.0 * torch.log10(torch.clamp(pmax, min=1e-10))
    with obs.span("frontend.tail"):
        out = mfcc_tail(mel, peak, dct.shape[1], transposed=transposed, dct=dct)
    return out[0] if single else out
