"""Speech-like batches made on the device from a seed.

Each utterance is the harmonics of a gliding f0 under a slow amplitude
envelope, plus noise, silent at its edges and zero past its length (the
padding), peak-normalised to a level drawn per utterance. Every parameter
comes from the traffic file's ``signal`` block; lengths from its ``lengths``
block:

* ``{"kind": "fixed", "seconds": s}``: every utterance ``s`` seconds;
* ``{"kind": "bucket", "keys": [k, ...]}``: the corpus sweep's batches,
  which hold only files of one length bucket (``CorpusSweep`` groups files
  by the key round_up(length, ``bucket_multiple``) and pads a batch to its
  key). Pool batch ``i`` is bucket ``keys[i % len(keys)]``: its lengths are
  the midpoints of ``batch`` equal strata of ((k - 1) m, k m] samples
  (m = ``bucket_multiple``), in a seeded order. Every seed then holds the
  same set of lengths in each batch, so the work of a run does not depend
  on its seed.

The batch is padded to its longest utterance, rounded up to
``bucket_multiple`` samples where the file gives one (a bucket's key). ``dtype`` "int16"
quantises to 16-bit PCM (v = round(x * 32767)); "float32" keeps floats.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _streams(seed: int, index: int) -> tuple[np.random.Generator, int]:
    """A host generator and a torch seed for batch ``index`` of ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), index])
    return np.random.default_rng(ss), int(ss.generate_state(1, np.uint64)[0])


def lengths_of(traffic: dict, sr: int, rng: np.random.Generator, index: int) -> np.ndarray:
    spec, b = traffic["lengths"], traffic["batch"]
    if spec["kind"] == "fixed":
        return np.full(b, round(spec["seconds"] * sr), dtype=np.int64)
    if spec["kind"] == "bucket":
        m = traffic["bucket_multiple"]
        key = spec["keys"][index % len(spec["keys"])]
        mids = (key - 1 + (np.arange(b) + 0.5) / b) * m
        return np.round(mids).astype(np.int64)[rng.permutation(b)]
    raise ValueError(f"unknown lengths kind {spec['kind']!r}")


def padded_length(traffic: dict, lengths: np.ndarray) -> int:
    m = traffic.get("bucket_multiple")
    longest = int(lengths.max())
    return longest if not m else -(-longest // m) * m


def make_batch(traffic: dict, sr: int, seed: int, index: int, device) -> dict:
    """{"samples": [B, T_pad] float32 or int16 on ``device``, "lengths":
    int64 ndarray [B]} for pool batch ``index``."""
    rng, tseed = _streams(seed, index)
    lengths = lengths_of(traffic, sr, rng, index)
    b, t_pad = len(lengths), padded_length(traffic, lengths)
    sig_spec = traffic["signal"]
    g = torch.Generator(device=device).manual_seed(tseed)

    def draw(lo_hi) -> torch.Tensor:  # [B, 1] uniform in [lo, hi]
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand((b, 1), generator=g, device=device, dtype=torch.float64)

    f0, glide, env_hz, noise, peak = (draw(sig_spec[k]) for k in ("f0_hz", "glide_hz", "envelope_hz", "noise", "peak"))
    t = torch.arange(t_pad, device=device, dtype=torch.float64) / sr
    inst = f0 + sig_spec["glide_depth_hz"] * torch.sin(2 * math.pi * glide * t)
    phase = torch.cumsum(inst, dim=1).mul_(2 * math.pi / sr)
    del inst
    x = torch.zeros((b, t_pad), device=device, dtype=torch.float64)
    for k in range(1, sig_spec["harmonics"] + 1):
        x.add_(torch.sin(phase * k), alpha=0.6 / k)
    del phase
    x.mul_(0.5 * (1 + torch.sin(2 * math.pi * env_hz * t - math.pi / 2)))
    x.add_(noise * torch.randn((b, t_pad), generator=g, device=device, dtype=torch.float64))
    edge = round(sig_spec["silent_edge_s"] * sr)
    n = torch.as_tensor(lengths, device=device)[:, None]
    i = torch.arange(t_pad, device=device)[None, :]
    x.mul_(((i >= edge) & (i < n - edge)).to(torch.float64))
    x.mul_(peak / x.abs().amax(dim=1, keepdim=True).clamp_min(1e-30))
    if traffic["dtype"] == "int16":
        samples = torch.round(x * 32767.0).clamp_(-32768, 32767).to(torch.int16)
    elif traffic["dtype"] == "float32":
        samples = x.to(torch.float32)
    else:
        raise ValueError(f"unknown dtype {traffic['dtype']!r}")
    return {"samples": samples, "lengths": lengths}


def make_pool(traffic: dict, sr: int, seed: int, device) -> list[dict]:
    """The ``pool`` distinct batches a run cycles through."""
    return [make_batch(traffic, sr, seed, i, device) for i in range(traffic["pool"])]
