"""PyTorch port: the f32 MFCC's distance from the float64 MFCC at the
flagship shape (16 kHz, fmax 8 kHz, 30 s utterances), where a long float32
DFT sum shows. The f32 frontend kernels and their plain versions (what the
wrappers take on the CPU, checked here) sum the windowed DFT in steps of 16
contraction rows, each step's product summed on its own and then added to
the running sum; the bar is BASELINE.md's max-abs ≤ 1e-4 at the MFCC
against the float64 'fft' path, and no further from it than the JAX
package's own f32 Pallas frontend (run as its tests run it, in interpret
mode). fused_mel_f32 itself runs an exact three-plane bf16 split on the
tensor cores, and fused_mel_fold_f32 the same split over the folded
operands; their arithmetic, mirrored in float32 matmuls
(split3_frontend_mirror, split3_fold_mirror), is held to the same bars here,
which is the proof that the split keeps the f32 mode's accuracy; so is the
FFT kernel fused_mel_fft_f32's (fft_frontend_mirror, which the kernel equals
bit for bit on the card), the 'f32' mode's route at these geometries. The kernels themselves are
held to their plain versions on the card by chip_smoke.py, which also
prints these distances at 128 × 30 s and holds fused_mel_f32 there to its
plain version's distance."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import modulation_mfcc_tpu.pallas.fused_frontend as jax_ff
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import MfccChange

torch.set_num_threads(1)

CFG = MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0)
KW = dict(sr=16_000.0, n_fft=512, hop=80, win_length=400, fmax=8000.0)
SECONDS = 30


def noise(n_utt: int) -> torch.Tensor:
    """0.3·randn of a seeded CPU generator, [n_utt, 30 s at 16 kHz] float32."""
    return 0.3 * torch.randn((n_utt, SECONDS * 16_000), generator=torch.Generator().manual_seed(191))


def port_mfcc(x: torch.Tensor, route: str, dct: torch.Tensor) -> torch.Tensor:
    """Coef-major f32 MFCC [B, 13, nf] through the plain version of the
    unfolded ('fused') or the folded frontend ('fold'), through
    fused_mel_f32's or fused_mel_fold_f32's split mirrored ('split', 'fold
    split'), or through fused_mel_fft_f32's FFT mirrored ('fft'), the peak
    from its block maxima."""
    if route == "fused":
        return ff.fused_mfcc(x, transposed=True, **KW)
    if route == "fft":
        w = ff.fft_weights(16_000.0, 512, KW["win_length"], 128, 100.0, KW["fmax"])
        mel, bmax = ff.fft_frontend_mirror(x, *(torch.tensor(w[k]) for k in ff.FFT_KEYS), hop=KW["hop"],
                                           eff_pad=ff.eff_pad(512, KW["win_length"]))
    elif route == "split":
        wri, melw = (torch.tensor(a) for a in ff.frontend_weights(
            16_000.0, 512, KW["win_length"], 128, 100.0, KW["fmax"]))
        mel, bmax = ff.split3_frontend_mirror(x, wri, melw, hop=KW["hop"], eff_pad=ff.eff_pad(512, KW["win_length"]))
    elif route == "fold split":
        w = {k: torch.tensor(v) for k, v in ff.fold_weights(16_000.0, 512, KW["win_length"], 128, 100.0,
                                                             KW["fmax"]).items()}
        mel, bmax = ff.split3_fold_mirror(x, w["wc"], w["ws"], w["melw"], hop=KW["hop"],
                                          eff_pad=ff.eff_pad(512, KW["win_length"]))
    else:
        mel, bmax = ff.fused_mel_frontend(x, fold=True, **KW)
    peak = 10.0 * torch.log10(torch.clamp(bmax.amax(dim=1), min=1e-10))
    return ff.mfcc_tail(mel, peak, 13, transposed=True, dct=dct)


def max_abs(got, want: torch.Tensor) -> float:
    return float((torch.as_tensor(np.array(got)).double() - want).abs().max())


@pytest.fixture(scope="module")
def model() -> MfccChange:
    return MfccChange(CFG)


@pytest.fixture(scope="module")
def batch16(model):
    """16 × 30 s of noise and its float64 'fft' MFCC."""
    x = noise(16)
    return x, model.trajectories(x.double(), spectrum="fft", coef_major=True)


@pytest.fixture(scope="module")
def routes16(batch16, model):
    """The batch's coef-major MFCC by route, each computed once."""
    cache = {}

    def mfcc(route: str) -> torch.Tensor:
        if route not in cache:
            cache[route] = port_mfcc(batch16[0], route, model.dct)
        return cache[route]

    return mfcc


@pytest.mark.parametrize("route", ["fused", "fold", "split", "fold split", "fft"])
def test_f32_mfcc_within_bar_at_16x30s(batch16, routes16, route):
    """≤ 1e-4 against the float64 'fft' MFCC over 16 × 30 s (96,016 frames)
    of noise. Summed as one K-term product, the unfolded frontend's plain
    version misses (2.5e-4 on this input); in 16-row steps both FP32 routes
    meet it (measured 8.5e-5 unfolded, 7.0e-5 folded), and so do the
    tensor-core kernels' splits, unfolded and folded, and the FFT kernel's
    mirror (its float32 rounding grows as log N). The bar is a max over the frames, so it
    binds harder as they grow: PERF.md §6 has the distances at 128 × 30 s on
    the card, where of the float32 routes only the split meets it on noise."""
    want = batch16[1]
    got = routes16(route)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert max_abs(got, want) <= 1e-4


@pytest.mark.parametrize("route", ["fused", "fold", "split", "fold split", "fft"])
def test_f32_mfcc_no_further_than_jax_pallas(model, route):
    """On 2 × 30 s of noise, each f32 route's plain version, and the
    kernels' splits mirrored, is no further from the float64 'fft' MFCC than
    the JAX package's f32 Pallas frontend (measured 6.0e-5 unfolded and
    5.3e-5 folded, against JAX's 1.04e-4); the fold's split than the JAX
    package's f32 Pallas fold."""
    x = noise(2)
    want = model.trajectories(x.double(), spectrum="fft", coef_major=True)
    with pltpu.force_tpu_interpret_mode():
        if route == "fold split":  # the JAX fold, through the JAX tail as fused_mfcc runs it
            mel, bmax = jax_ff.fused_mel_frontend(jnp.asarray(x.numpy()), fold=True, **KW)
            peak = 10.0 * jnp.log10(jnp.maximum(jnp.max(bmax, axis=(1, 2, 3)), 1e-10))
            jax_mfcc = np.asarray(jax_ff.mfcc_tail(mel, peak, 13, transposed=True))[..., : want.shape[-1]]
        else:
            jax_mfcc = np.asarray(jax_ff.fused_mfcc(jnp.asarray(x.numpy()), transposed=True, **KW))
    got = port_mfcc(x, route, model.dct)
    assert got.shape == jax_mfcc.shape == tuple(want.shape)
    assert max_abs(got, want) <= max_abs(jax_mfcc, want)


@pytest.mark.parametrize("k", [16, 201, 400])
def test_stepped_matmul_sums_in_16_row_steps(k):
    """_stepped_matmul is the kernels' order: per 16-row step a product of
    its own, added to the running sum step by step (the last step short
    when K is not a multiple of 16), bit for bit."""
    rng = np.random.default_rng(k)
    x = torch.tensor(rng.standard_normal((3, 5, k)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((k, 24)), dtype=torch.float32)
    want = torch.zeros(3, 5, 24)
    for k0 in range(0, k, 16):
        want = want + x[..., k0 : k0 + 16] @ w[k0 : k0 + 16]
    assert torch.equal(ff._stepped_matmul(x, w), want)
    assert torch.allclose(ff._stepped_matmul(x, w).double(), x.double() @ w.double(), rtol=0, atol=1e-4)


def test_split_no_further_than_the_fp32_route(batch16, routes16):
    """On the 16 × 30 s noise batch the split's MFCC is no further from the
    float64 'fft' MFCC than the unfolded plain version's FP32 GEMM in 16-row
    steps: the split's products are exact and its hi·hi step sums round
    less, so on the card fused_mel_f32 can be held to its plain version's
    distance (chip_smoke.py phase 23)."""
    split, plain = (max_abs(routes16(route), batch16[1]) for route in ("split", "fused"))
    assert split <= plain
