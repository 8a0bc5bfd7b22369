"""Whether the window's outputs are right: the kept calls' outputs against
the configuration's plain reference, after the window has closed.

Two numbers, each held to its limit in the configuration's ``limits``:

* ``tot_err``: the widest gap, over the kept calls' every utterance and
  valid frame, between the program's tot_change and the reference's, as a
  share of the largest |tot_change| of that utterance in the reference; a
  wrong shape or a value that is not finite reads infinite;
* ``mask_err``: the frame-mask entries that differ from 1 on the
  utterance's valid frames (1 + length // hop) and 0 past them.
"""
from __future__ import annotations

import math

import numpy as np


def expected_mask(lengths: np.ndarray, n_frames: int, hop: int) -> np.ndarray:
    return (np.arange(n_frames)[None, :] < (1 + lengths // hop)[:, None]).astype(np.float32)


def call_errors(tot: np.ndarray, mask: np.ndarray, want: list[np.ndarray], lengths: np.ndarray, t_pad: int,
                hop: int) -> tuple[float, int]:
    """(tot_err, mask_err) of one call's outputs."""
    nf = 1 + t_pad // hop
    b = len(lengths)
    if tot.shape != (b, nf) or mask.shape != (b, nf):
        return math.inf, b * nf
    mask_err = int(np.count_nonzero(mask != expected_mask(lengths, nf, hop)))
    worst = 0.0
    for r, w in enumerate(want):
        gap = np.abs(tot[r, : w.shape[-1]].astype(np.float64) - w)
        if not np.all(np.isfinite(gap)):
            return math.inf, mask_err
        worst = max(worst, float(gap.max() / max(np.abs(w).max(), 1e-300)))
    return worst, mask_err


def compare(kept: list, batches: list[dict], config: dict, reference, device) -> dict:
    """{"tot_err", "mask_err", "failed_calls", "calls", "rows"} over the kept
    calls; each pool batch's reference is computed once, on ``device``."""
    hop = int(config["tStep"] * config["signal_sample_rate"])
    limits = config["limits"]
    refs: dict[int, list[np.ndarray]] = {}
    tot_err, mask_err, failed, rows = 0.0, 0, 0, 0
    for k in sorted({c.pool for c in kept}):
        b = batches[k]
        refs[k] = reference.tot_change(b["samples"], b["lengths"], config, device)
    for c in kept:
        b = batches[c.pool]
        e, m = call_errors(c.outputs[0], c.outputs[1], refs[c.pool], b["lengths"], b["samples"].shape[-1], hop)
        tot_err, mask_err, rows = max(tot_err, e), mask_err + m, rows + len(b["lengths"])
        failed += not (e <= limits["tot_err"] and m <= limits["mask_err"])
    return {"tot_err": tot_err, "mask_err": mask_err, "failed_calls": failed, "calls": len(kept), "rows": rows}
