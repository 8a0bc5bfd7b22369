"""Plain float64 reference of the modulation cepstrum (the rate of MFCC
change), written from the published definitions and imported by nothing
of the program under test.

    librosa.feature.mfcc: centred frames (zero pad n_fft/2), a periodic Hann
      window of win_length centred in n_fft, |rfft|^2, Slaney mel bank
      (Slaney norm), 10*log10(max(1e-10, .)), clipped at the utterance's
      peak less 80 dB, DCT-II ortho, the first n_mfcc;
    then (script/mfcc.py:393-425 of the reference GUI) drop C0, a
      Butterworth low-pass of each coefficient (scipy sosfiltfilt), the
      gradient over frames, sqrt(sum of squares) / n_coef, and the final
      Butterworth low-pass.

The spectral part runs in torch float64 on the samples' device, ``block``
utterances at a time; the filter part in scipy on the host. Each utterance
is taken at its own length, so a padded batch's rows compare with their
single-file results.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.signal import butter, sosfiltfilt


def hz_to_mel(f):
    """Slaney's mel scale: linear to 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-300) / 1000.0) / (math.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((math.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_bank(sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """[n_mels, 1 + n_fft/2] triangles on the Slaney scale, each scaled by
    2 / (its upper edge less its lower edge) (librosa.filters.mel)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    w = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        rise = (freqs - edges[i]) / (edges[i + 1] - edges[i])
        fall = (edges[i + 2] - freqs) / (edges[i + 2] - edges[i + 1])
        w[i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (edges[i + 2] - edges[i])
    return w


def dct_ortho(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in]: row k is DCT-II with orthonormal scaling."""
    n = np.arange(n_in)
    c = np.cos(np.pi * np.arange(n_out)[:, None] * (2 * n[None, :] + 1) / (2 * n_in)) * math.sqrt(2.0 / n_in)
    c[0] /= math.sqrt(2.0)
    return c


def hann_in_fft(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of ``win_length`` zero-padded to ``n_fft``, centred."""
    k = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / win_length)
    out = np.zeros(n_fft)
    lo = (n_fft - win_length) // 2
    out[lo : lo + win_length] = w
    return out


def geometry(cfg: dict) -> tuple[int, int, int]:
    """(n_fft, hop, win_length) in samples."""
    sr = cfg["signal_sample_rate"]
    return cfg["n_fft"], int(cfg["tStep"] * sr), int(cfg["winLen"] * sr)


def mfcc_rows(x: torch.Tensor, lengths: np.ndarray, cfg: dict) -> list[np.ndarray]:
    """Each utterance's MFCC [n_mfcc, nf_i] (nf_i = 1 + len_i // hop), in
    float64, from rows ``x`` [b, T] (any real dtype; the samples past each
    length are zero)."""
    n_fft, hop, win = geometry(cfg)
    dev = x.device
    x = x.to(torch.float64)
    w = torch.as_tensor(hann_in_fft(win, n_fft), device=dev)
    mel_w = torch.as_tensor(mel_bank(cfg["signal_sample_rate"], n_fft, cfg["n_mels"], cfg["minFreq"], cfg["maxFreq"]),
                            device=dev)
    dct = torch.as_tensor(dct_ortho(cfg["n_mfcc"], cfg["n_mels"]), device=dev)
    nf_max = 1 + int(lengths.max()) // hop
    pad = n_fft // 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    frames = xp.unfold(-1, n_fft, hop)[:, :nf_max] * w  # [b, nf, n_fft]
    spec = torch.fft.rfft(frames, dim=-1)
    del frames
    power = spec.real.square() + spec.imag.square()
    del spec
    db = 10.0 * torch.log10(torch.clamp(power @ mel_w.T, min=1e-10))  # [b, nf, n_mels]
    out = []
    for r, n in enumerate(lengths):
        nf = 1 + int(n) // hop
        d = db[r, :nf]
        d = torch.maximum(d, d.max() - 80.0)
        out.append((dct @ d.T).cpu().numpy())
    return out


def trajectory_tail(mfcc: np.ndarray, cfg: dict) -> np.ndarray:
    """tot_change [..., nf] of MFCCs [..., n_mfcc, nf] (scipy, float64)."""
    if cfg["diffMethod"] != "grad":
        raise NotImplementedError(f"diffMethod {cfg['diffMethod']!r}")
    fs = 1.0 / cfg["tStep"]
    m = mfcc[..., 1:, :] if cfg["removeFirst"] else mfcc
    sos = butter(cfg["filtOrd"], cfg["filtCutoff"] / (fs / 2.0), btype="low", output="sos")
    diff = np.gradient(sosfiltfilt(sos, m, axis=-1), axis=-1)
    tot = np.sqrt(np.sum(diff * diff, axis=-2)) / m.shape[-2]
    if cfg["outFilter"] is None:
        return sosfiltfilt(sos, tot, axis=-1)
    if cfg["outFilter"] == "iir" and cfg["outFiltType"] in ("low", "lowpass") and len(cfg["outFiltCutOff"]) == 1:
        sos2 = butter(cfg["outFiltLen"], cfg["outFiltCutOff"][0] / (fs / 2.0), btype="low", output="sos")
        return sosfiltfilt(sos2, tot, axis=-1)
    raise NotImplementedError(f"outFilter {cfg['outFilter']!r} / {cfg['outFiltType']!r}")


def tot_change(samples: torch.Tensor, lengths: np.ndarray, cfg: dict, device, *, block: int = 16) -> list[np.ndarray]:
    """Each utterance's tot_change over its valid frames, float64, from the
    batch's samples [B, T] as generated: float32, or int16 PCM read as
    v * 2**-15. Rows go to ``device`` ``block`` at a time."""
    scale = 2.0**-15 if samples.dtype == torch.int16 else 1.0
    out: dict[int, np.ndarray] = {}
    for i in range(0, samples.shape[0], block):
        rows = samples[i : i + block].to(device=device, dtype=torch.float64) * scale
        m = mfcc_rows(rows, lengths[i : i + block], cfg)
        del rows
        for n in {x.shape[-1] for x in m}:  # rows of one length filter together
            idx = [j for j, x in enumerate(m) if x.shape[-1] == n]
            tails = trajectory_tail(np.stack([m[j] for j in idx]), cfg)
            out.update((i + j, tails[k]) for k, j in enumerate(idx))
    return [out[r] for r in range(samples.shape[0])]
