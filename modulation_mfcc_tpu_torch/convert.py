"""Constants carried across from the JAX package.

The pipeline has no learned weights: its parameters are host-designed
constants. :func:`params_from_jax` maps them, as numpy arrays produced by the
JAX package's own host code, onto :class:`MfccChange` buffers, so both
packages can be run from identical constants:

    model = MfccChange(cfg)
    model.load_state_dict(params_from_jax(arrays))

Keys of ``arrays``:

* ``wri`` [K, 2·bins_pad], ``melw`` [bins_pad, n_mels]: the packed DFT bases
  and mel matrix the JAX frontend hands its kernel (f32 algorithm);
* ``dct`` [n_mfcc, n_mels]: ``ops.spectral.dct_matrix(n_mfcc, n_mels)``;
* ``traj_kernel``, ``traj_left``, ``traj_right`` and ``out_kernel``,
  ``out_left``, ``out_right``: the FIR operators
  (``ops.filters.design_filtfilt_operator``) of the trajectory low-pass and
  the final low-pass. Their K, E, W and min_len follow from the shapes.

:func:`frontend_modes_from_jax` maps the constants of the JAX frontend's
other arithmetic modes (bf16, x3, i16, i24) onto the port's
``kernels.fused_frontend.mode_weights``, and :func:`fold_weights_from_jax`
those of its folded frontend onto ``kernels.fused_frontend.fold_weights``.

:func:`pitch_params_from_jax`, :func:`pyin_params_from_jax` and
:func:`formant_params_from_jax` do the same for :class:`PitchTracker`,
:class:`PyinTracker` and :class:`FormantTracker`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "frontend_modes_from_jax", "fold_weights_from_jax", "pitch_params_from_jax",
           "pyin_params_from_jax", "formant_params_from_jax"]


def params_from_jax(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """State dict of :class:`MfccChange` from the JAX package's constants."""
    params = {
        "wri": torch.tensor(np.asarray(arrays["wri"], dtype=np.float32)),
        "melw": torch.tensor(np.asarray(arrays["melw"], dtype=np.float32)),
        "dct": torch.tensor(np.ascontiguousarray(np.asarray(arrays["dct"]).T, dtype=np.float32)),
    }
    for prefix in ("traj", "out"):
        for name in ("kernel", "left", "right"):
            params[f"{prefix}_filter.{name}"] = torch.tensor(
                np.asarray(arrays[f"{prefix}_{name}"], dtype=np.float64)
            )
    return params


def frontend_modes_from_jax(arrays: dict[str, np.ndarray]) -> dict[str, dict[str, np.ndarray]]:
    """``mode_weights`` of 'bf16', 'x3', 'i16' and 'i24' from the JAX
    frontend's constants, keyed as the JAX host code names them:

    * ``wri_bf16``, ``melw_bf16``: ``_stack_weights(·, 'bf16')[0]`` (bf16);
    * ``wri_x3``, ``melw_x3``: ``_stack_weights(·, 'x3')`` ([2, ...] bf16);
    * ``w2``, ``w1``, ``w0``, ``sw``: ``_int8_weight_planes(wri)``;
    * ``corr`` [8, 2·bins_pad] float32: the i16 offset correction (row 0
      live), as the i16 kernel receives it.
    """
    def f32(a):
        return np.asarray(a, dtype=np.float32)

    planes = np.stack([np.asarray(arrays[k], dtype=np.int8) for k in ("w2", "w1", "w0")])
    sw = np.asarray(arrays["sw"], dtype=np.float32)
    melw_x3 = f32(arrays["melw_x3"])
    return {
        "bf16": {"wri": f32(arrays["wri_bf16"]), "melw": f32(arrays["melw_bf16"])},
        "x3": {"wri": f32(arrays["wri_x3"]), "melw": melw_x3},
        "i16": {"planes": planes, "sw": sw, "melw": melw_x3, "corr": f32(arrays["corr"])[0]},
        "i24": {"planes": planes, "sw": sw, "melw": melw_x3},
    }


def fold_weights_from_jax(arrays: dict[str, dict[str, np.ndarray]]) -> dict[str, dict[str, np.ndarray]]:
    """``fold_weights`` of each algorithm from the operands the JAX folded
    frontend hands its kernel, keyed ``{algorithm: {"wc_in", "ws_in",
    "mel_in"}}``: ``_stack_weights(C | S | mel, algorithm)``, [1, ...]
    float32 or bf16 planes, or the [2, ...] (hi, lo) bf16 stacks of 'x3'."""
    out = {}
    for alg, ops in arrays.items():
        w = {name: np.asarray(ops[f"{jax_name}_in"], dtype=np.float32)
             for name, jax_name in (("wc", "wc"), ("ws", "ws"), ("melw", "mel"))}
        out[alg] = w if alg == "x3" else {k: v[0] for k, v in w.items()}
    return out


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def pitch_params_from_jax(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """State dict of :class:`PitchTracker` from the JAX package's constants:

    * ``sinc_weights`` [S, 17]: ``ops.pitch._sinc_weights(linspace(-1, 1,
      17), depth)``, the columns of ``_sinc_band_matrix``;
    * 'ac' only: ``window`` [nw], the AC_HANNING taper the tracker builds
      (or ``ops.windows.praat_gauss(nw)`` with veryAccurate), and ``wac``
      [lag_hi+1], its autocorrelation as the tracker's host code computes it.
    """
    params = {"sinc_w": _f32(arrays["sinc_weights"])}
    if "window" in arrays:
        wac = np.asarray(arrays["wac"], dtype=np.float64)
        params["window"] = _f32(arrays["window"])
        params["rw"] = _f32(wac / (wac[0] + 1e-30))
    return params


def pyin_params_from_jax(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """State dict of :class:`PyinTracker` from the JAX package's host arrays
    (float64, as ``ops/yin._pyin_f0_jit`` builds them):

    * ``transition`` [n, n]: ``ops.yin._transition_local(n_bins, width)``;
    * ``beta_probs`` [T]: ``ops.yin._beta_threshold_probs(T, a, b)``;
    * ``thresholds`` [T]: ``linspace(0, 1, T + 1)[1:]``;
    * ``p_init`` [2n]: zeros, then 1/n on the unvoiced states.

    The logs take float32's ``tiny``, as the JAX package's float32 decode
    adds it (``log(tri + tiny)``, ``log(p_init + tiny)``)."""
    tiny = float(np.finfo(np.float32).tiny)
    return {
        "log_tri": _f32(np.log(np.asarray(arrays["transition"], dtype=np.float64) + tiny)),
        "beta_probs": _f32(arrays["beta_probs"]),
        "thresholds": _f32(arrays["thresholds"]),
        "log_p_init": _f32(np.log(np.asarray(arrays["p_init"], dtype=np.float64) + tiny)),
    }


def formant_params_from_jax(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """State dict of :class:`FormantTracker` from the JAX package's constants:
    ``window`` [nw] (``ops.windows.praat_gauss``), ``kaiser`` [2·hws+1]
    (``ops.intensity._kaiser20``, unnormalized) and ``taps``
    (``io.wav.design_hq_taps(up, down)``, empty without resampling)."""
    kaiser = np.asarray(arrays["kaiser"], dtype=np.float64)
    return {
        "window": _f32(arrays["window"]),
        "kaiser": _f32(kaiser / np.sum(kaiser)),
        "taps": torch.tensor(np.asarray(arrays["taps"], dtype=np.float64)),
    }
