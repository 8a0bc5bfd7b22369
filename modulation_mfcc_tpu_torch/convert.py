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
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


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
