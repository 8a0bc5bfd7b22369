#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``modulation_mfcc_tpu_torch/csrc``
(nvcc, sm_90a), checks each against its plain PyTorch version on the card,
drives the flagship ``mfcc_change`` at full size (128 × 30 s at 16 kHz)
through the kernels and checks it against the plain path, runs both
``extract_mfcc_change`` routes against the CPU path, and times the kernels
and the pipeline with CUDA events. Phases:

  0  card, power limit, versions, TF32 flags (exits 2 without CUDA)
  1  kernel build
  2  kernel vs plain version on the card, both configurations
  3  main path at full size, with launch counts and checks
  4  single utterances (masked-FIR route, host-tail route)
  5  times: one warm-up, median of 5, kernels beside their plain versions

Every check raises on failure, so the script exits 0 only when all phases
passed. The second-to-last line is the card's name and power limit; the
last line is the device JSON. Imports no JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import modulation_mfcc_tpu_torch as mt  # noqa: E402
from modulation_mfcc_tpu_torch.kernels import _build  # noqa: E402
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff  # noqa: E402

FLAGSHIP = mt.MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0)
DEFAULT_10K = mt.MfccConfig()
BATCH, SECONDS = 128, 30
SOURCE = "modulation_mfcc_tpu_torch/csrc/fused_frontend.cu"
REPLACES = {
    "fused_mel_f32": "modulation_mfcc_tpu/pallas/fused_frontend.py:990",
    "mfcc_tail_f32": "modulation_mfcc_tpu/pallas/fused_frontend.py:1190",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up."""
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


def frontend_args(cfg: mt.MfccConfig, dev) -> dict:
    wri, melw = ff.frontend_weights(
        cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq, cfg.maxFreq
    )
    return dict(
        wri=torch.tensor(wri, device=dev), melw=torch.tensor(melw, device=dev),
        dct=torch.tensor(ff.tail_dct(cfg.n_mfcc, cfg.n_mels), device=dev),
        eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length),
    )


def frontend_kernel(audio, cfg, a):
    return ff.fused_mel_frontend(
        audio, sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=cfg.hop_length,
        win_length=cfg.win_length, weights=(a["wri"], a["melw"]),
    )


def frontend_plain(audio, cfg, a):
    return ff.fused_mel_frontend_reference(
        audio, a["wri"], a["melw"], hop=cfg.hop_length, eff_pad=a["eff_pad"]
    )


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

    # -- 1: build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.load_library()
    print(f"[1] built {lib_path.name} from {SOURCE} (nvcc {' '.join(_build.NVCC_FLAGS)}) "
          f"in {time.perf_counter() - t0:.3f} s")

    # -- 2: kernels vs plain versions on the card (4 x 30 s) -----------------
    for name, cfg in (("10k default (packed Nyquist)", DEFAULT_10K), ("16k fmax 8k", FLAGSHIP)):
        sr = cfg.signal_sample_rate
        audio = torch.tensor(speechlike(4, SECONDS * sr, sr, seed=1), device=dev)
        a = frontend_args(cfg, dev)
        mel_k, bmax_k = frontend_kernel(audio, cfg, a)
        mel_p, bmax_p = frontend_plain(audio, cfg, a)
        torch.cuda.synchronize()
        mel_rel, peak_rel, _ = mel_errors(mel_k, bmax_k, mel_p, bmax_p)
        print(f"[2] {name}: fused_mel_f32 vs plain: mel rel err {mel_rel:.3e} (bar 1e-4), "
              f"peak rel err {peak_rel:.3e} (bar 1e-5)")
        check(mel_rel <= 1e-4 and peak_rel <= 1e-5, f"fused_mel_f32 {name}")
        pk = peak_db(bmax_p)
        for transposed in (True, False):
            out_k = ff.mfcc_tail(mel_p, pk, cfg.n_mfcc, transposed=transposed, dct=a["dct"])
            out_p = ff.mfcc_tail_reference(mel_p, pk, a["dct"], transposed=transposed)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            print(f"[2] {name}: mfcc_tail_f32 ({'coef' if transposed else 'frame'}-major) "
                  f"vs plain: max-abs {err:.3e} (bar 1e-4)")
            check(out_k.shape == out_p.shape and err <= 1e-4, f"mfcc_tail_f32 {name}")
        del audio, mel_k, mel_p

    # -- 3: main path at full size -----------------------------------------
    cfg = FLAGSHIP
    sr = cfg.signal_sample_rate
    y_np = speechlike(BATCH, SECONDS * sr, sr, seed=0)
    y = torch.tensor(y_np, device=dev)
    print(f"[3] mfcc_change on [{BATCH}, {SECONDS * sr}] float32 "
          f"({y.numel() * 4 / 1e6:.1f} MB of audio), sr {sr}, fmax {cfg.maxFreq}")
    for k in ff.LAUNCHES:
        ff.LAUNCHES[k] = 0
    tot = mt.mfcc_change(y, cfg)
    torch.cuda.synchronize()
    launches = dict(ff.LAUNCHES)
    print(f"[3] launches in the main path: {launches}")
    check(all(v > 0 for v in launches.values()), "every kernel launched in the main path")
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

    # -- 4: single utterances ----------------------------------------------
    sig = speechlike(1, SECONDS * DEFAULT_10K.signal_sample_rate, DEFAULT_10K.signal_sample_rate, 2)[0]
    for label, cfg1, x in (
        ("30 s at 10 kHz (masked-FIR route)", DEFAULT_10K, sig),
        ("utterance_16k.wav (host-tail route)", FLAGSHIP, read_fixture()),
    ):
        got, t_gpu = mt.extract_mfcc_change(x, cfg1, device=dev)
        torch.cuda.synchronize()
        want, t_cpu = mt.extract_mfcc_change(x, cfg1, device="cpu")
        err = float((got.cpu() - want).abs().max())
        print(f"[4] extract_mfcc_change {label}: {tuple(got.shape)} frames, vs CPU max-abs "
              f"{err:.3e} (bar 1e-5)")
        check(got.shape == want.shape == t_gpu.shape and np.array_equal(t_gpu, t_cpu), label)
        check(bool(torch.isfinite(got).all()) and err <= 1e-5, label)

    # -- 5: times at the main path's shapes -------------------------------
    a = frontend_args(cfg, dev)
    mel_p, bmax_p = frontend_plain(y, cfg, a)
    mel_k, bmax_k = frontend_kernel(y, cfg, a)
    mel_rel, peak_rel, mel_abs = mel_errors(mel_k, bmax_k, mel_p, bmax_p)
    pk = peak_db(bmax_k)
    tail_k = ff.mfcc_tail(mel_k, pk, cfg.n_mfcc, transposed=True, dct=a["dct"])
    tail_p = ff.mfcc_tail_reference(mel_k, pk, a["dct"], transposed=True)
    tail_abs = float((tail_k - tail_p).abs().max())
    check(mel_rel <= 1e-4 and peak_rel <= 1e-5 and tail_abs <= 1e-4, "full-size kernels vs plain")
    del mel_p, tail_p
    ms = {
        "fused_mel_f32": (
            cuda_ms(lambda: frontend_kernel(y, cfg, a)),
            cuda_ms(lambda: frontend_plain(y, cfg, a)),
        ),
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
        print(f"[5] {k}: {t_k:.3f} ms, plain {t_p:.3f} ms at [{BATCH}, {SECONDS * sr}] ({card})")
    print(f"[5] mfcc_change end to end: {e2e:.3f} ms = {hours / (e2e / 1e3):.3f} audio-h/s; "
          f"plain spectrum {e2e_plain:.3f} ms = {hours / (e2e_plain / 1e3):.3f} audio-h/s ({card})")
    print(f"[5] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    errs = {"fused_mel_f32": mel_abs, "mfcc_tail_f32": tail_abs}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": errs[k], "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k in ff.LAUNCHES
    ]}))
    print(card_line())
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
    sys.exit(main())
