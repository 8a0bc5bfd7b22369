"""PyTorch port: the folded frontend (fused_mel_frontend(fold=True)) against
the JAX package's folded Pallas frontend, run as its own tests run it on the
CPU (interpret mode). The fold's host design is compared bit for bit with
the operands the JAX fold hands its kernel (its pallas_call is
intercepted); the plain version (what the wrapper takes on the CPU) is held
to the bars of the JAX frontend tests. The CUDA kernels themselves are
checked on the card by chip_smoke.py (phases 18-19)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import modulation_mfcc_tpu.pallas.fused_frontend as jax_ff
from modulation_mfcc_tpu_torch import convert
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from tests.test_torch_frontend import CONFIGS, frontend_kwargs
from tests.test_torch_frontend_modes import assert_mel_matches, bf16_ulps

torch.set_num_threads(1)


class _Captured(Exception):
    pass


def jax_fold_operands(monkeypatch, cfg: MfccConfig, algorithm: str) -> dict[str, np.ndarray]:
    """wc_in, ws_in and mel_in as the JAX fold hands them to its kernel."""
    seen = {}

    def pallas_call(kern, **kw):
        def launch(*ops):
            seen.update(zip(("wc_in", "ws_in", "mel_in"), (np.asarray(op) for op in ops[4:7])))
            raise _Captured
        return launch

    monkeypatch.setattr(jax_ff.pl, "pallas_call", pallas_call)
    with pytest.raises(_Captured):
        jax_ff.fused_mel_frontend(jnp.zeros((1, 4000), jnp.float32), algorithm=algorithm, fold=True,
                                  **frontend_kwargs(cfg))
    monkeypatch.undo()
    return seen


def design(cfg: MfccConfig) -> tuple:
    return (cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq, cfg.maxFreq)


def noise(cfg: MfccConfig) -> np.ndarray:
    return np.random.default_rng(20260816).standard_normal((2, 24_000)).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ff.FOLD_ALGORITHMS)
def test_fold_weights_bit_identical(monkeypatch, algorithm, name):
    """The folded bases (taper, half weight at sup/2, zero sine row there),
    the zero-mel-bin trim, the Nyquist cosine in the DC slot at 10 kHz and
    the mode stacks equal the JAX fold's kernel operands bit for bit."""
    cfg = MfccConfig(**CONFIGS[name])
    w = ff.fold_weights(*design(cfg), algorithm)
    ops = jax_fold_operands(monkeypatch, cfg, algorithm)
    k = cfg.win_length // 2 + 1
    for key, jax_key in (("wc", "wc_in"), ("ws", "ws_in"), ("melw", "mel_in")):
        want = ops[jax_key].astype(np.float32)
        if algorithm != "x3":
            want = want[0]
        assert w[key].dtype == np.float32 and np.array_equal(w[key], want), key
    assert w["wc"].shape[-2:] == (k, 256) and w["ws"].shape[-2:] == (k, 256)
    assert not w["wc"][..., 0, :].any() and not w["ws"][..., k - 1, :].any()


@pytest.mark.parametrize("name", CONFIGS)
def test_fold_weights_from_jax(monkeypatch, name):
    """convert.fold_weights_from_jax maps the JAX fold's operands onto the
    port's fold_weights exactly, for every algorithm."""
    cfg = MfccConfig(**CONFIGS[name])
    arrays = {alg: jax_fold_operands(monkeypatch, cfg, alg) for alg in ff.FOLD_ALGORITHMS}
    got = convert.fold_weights_from_jax(arrays)
    for alg in ff.FOLD_ALGORITHMS:
        own = ff.fold_weights(*design(cfg), alg)
        assert got[alg].keys() == own.keys()
        for k in own:
            assert got[alg][k].dtype == own[k].dtype and np.array_equal(got[alg][k], own[k]), (alg, k)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ff.FOLD_ALGORITHMS)
def test_fold_plain_matches_jax(algorithm, name):
    """Against JAX's fold in interpret mode on 2 × 24,000 samples of noise:
    f32 within 1e-5 of the largest mel (test_pallas_frontend.py's fold bar)
    and x3 within 1e-4 relative above the top_db floor, with the peaks to
    1e-6 (the f32 summation order is all that differs); bf16 (JAX asked to
    store bf16 mel, as the port does) within one bf16 ulp, the bar of the
    unfolded bf16 mode."""
    cfg = MfccConfig(**CONFIGS[name])
    a = noise(cfg)
    kw = frontend_kwargs(cfg)
    out = {"out_dtype": jnp.bfloat16} if algorithm == "bf16" else {}
    with pltpu.force_tpu_interpret_mode():
        jmel, jbmax = jax_ff.fused_mel_frontend(jnp.asarray(a), algorithm=algorithm, fold=True, **out, **kw)
    mel, bmax = ff.fused_mel_frontend(torch.tensor(a), algorithm=algorithm, fold=True, **kw)
    nf = 1 + a.shape[1] // cfg.hop_length
    assert mel.shape == (2, nf, cfg.n_mels) and bmax.shape == (2, -(-nf // ff.BLOCK_FRAMES))
    jmel = np.asarray(jmel)[:, :nf].astype(np.float32)
    if algorithm == "bf16":
        assert mel.dtype == torch.bfloat16
        assert bf16_ulps(mel.float().numpy(), jmel).max() <= 1.0
        np.testing.assert_allclose(bmax.numpy().max(axis=1), np.asarray(jbmax).max(axis=(1, 2, 3)), rtol=1e-6)
        return
    assert mel.dtype == torch.float32
    if algorithm == "f32":
        assert_mel_matches(mel.numpy(), jmel, np.asarray(jbmax), bmax.numpy())
        return
    # x3 splits the power into bf16 (hi, lo) before the mel projection: a
    # one-ulp f32 difference in a bin's power moves the split, and the peak
    # by up to 2^-16 (measured 2.4e-6 at 16 kHz), chip_smoke.py's x3 bar
    jpeak = np.asarray(jbmax).max(axis=(1, 2, 3))
    live = jmel > 1e-8 * jpeak[:, None, None]
    np.testing.assert_allclose(mel.numpy()[live], jmel[live], rtol=1e-4, atol=0)
    np.testing.assert_allclose(bmax.numpy().max(axis=1), jpeak, rtol=2.0**-16, atol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_fold_plain_matches_unfolded(name):
    """The plain fold equals the port's unfolded plain frontend within 1e-5
    of the largest mel, on noise and on a sine that ends one sample before
    the buffer (the last frame's u = 0 term reads past its support)."""
    cfg = MfccConfig(**CONFIGS[name])
    kw = frontend_kwargs(cfg)
    n = 24_000 - 1
    tone = np.sin(2 * np.pi * 440.0 * np.arange(n) / cfg.signal_sample_rate).astype(np.float32)
    for a in (noise(cfg), tone[None, :]):
        mel_f, bmax_f = ff.fused_mel_frontend(torch.tensor(a), fold=True, **kw)
        mel_u, bmax_u = ff.fused_mel_frontend(torch.tensor(a), **kw)
        scale = float(mel_u.abs().max())
        np.testing.assert_allclose(mel_f.numpy(), mel_u.numpy(), rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(bmax_f.numpy(), bmax_u.numpy(), rtol=1e-5)


def test_fold_guards():
    """The JAX fold's guards (test_pallas_frontend.py::test_fold_geometry_guard
    and fused_mel_frontend's own): hop rows, a window that is not a whole
    number of hops, the fixed-point algorithms and non-float32 audio raise
    ValueError naming the fold; nothing falls back to the unfolded path."""
    cfg = MfccConfig(**CONFIGS["16k"])
    kw = frontend_kwargs(cfg)
    x = torch.zeros((1, 8000))
    with pytest.raises(ValueError, match="fold"):
        ff.fused_mel_frontend(x, **{**kw, "win_length": 444}, fold=True)
    for alg in ("i16", "i24"):
        with pytest.raises(ValueError, match="fold"):
            ff.fused_mel_frontend(x, algorithm=alg, fold=True, **kw)
    with pytest.raises(ValueError, match="fold"):
        ff.fused_mel_frontend(x.to(torch.int16), fold=True, **kw)
    rows = torch.tensor(ff.pack_hop_rows(np.zeros((1, 8000), np.float32), n_fft=cfg.n_fft, hop=cfg.hop_length,
                                         win_length=cfg.win_length))
    with pytest.raises(ValueError, match="fold"):
        ff.fused_mel_frontend(rows, n_samples=8000, fold=True, **kw)
    assert ff.fold_ok(512, 80, 400) and ff.fold_ok(512, 50, 250)
    assert not ff.fold_ok(512, 80, 444) and not ff.fold_ok(512, 5, 250)
    with pytest.raises(ValueError, match="fold"):
        ff.fold_weights(*design(cfg), "i24")


def test_fold_kernel_constants_match_wrapper():
    """The block and tile sizes the wrapper assumes are the fold kernel's."""
    csrc = Path(ff.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "fused_frontend_fold.cu").read_text()
    assert '#include "fused_frontend_common.cuh"' in src
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", (csrc / "fused_frontend_common.cuh").read_text()))
    assert int(consts["kBF"]) == ff.BLOCK_FRAMES
    assert int(consts["kBT"]) == ff._BIN_TILE
    assert int(consts["kMelMax"]) == ff._MEL_MAX
    for alg in ff.FOLD_ALGORITHMS:
        assert f'extern "C" int fused_mel_fold_{alg}(' in src
