"""PyTorch port: the host side of the tensor-core frontend kernels
fused_mel_x3 and fused_mel_i24 (csrc/fused_frontend_tc.cu). Their weights
travel in layouts of their own (kernels/fused_frontend.tc_layouts), built
once per set of weights; here each layout unpacks to the mode's weights
exactly, the kernel's address arithmetic (mirrored in Python) reads the
frames from its staged span copies and the weights from those layouts, and
the wrapper's constants are the source's. The kernels themselves run only
on the card: chip_smoke.py holds them against their plain versions (phases
14, 15, 17)."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import MfccChange
from tests.test_torch_frontend import CONFIGS

CSRC = Path(ff.__file__).resolve().parent.parent / "csrc"
BASIS = {"x3": "wri", "i24": "planes"}


def tensors(algorithm: str, name: str) -> tuple[MfccConfig, dict[str, torch.Tensor]]:
    cfg = MfccConfig(**CONFIGS[name])
    return cfg, ff.mode_tensors(algorithm, "cpu", cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels,
                                cfg.minFreq, cfg.maxFreq)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ff.TC_ALGORITHMS)
def test_tc_layouts_round_trip(algorithm, name):
    """pack_tc_basis and pack_tc_mel, then their inverses, give the mode's
    weights (mode_weights) bit for bit: bf16 holds the x3 planes exactly;
    the padded rows and mel columns are zero; mode_tensors and the
    MfccChange module carry the same layouts."""
    cfg, w = tensors(algorithm, name)
    mw = ff.mode_weights(algorithm, cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq,
                         cfg.maxFreq)
    basis = BASIS[algorithm]
    packed, mel = w[f"{basis}_tc"], w["melw_tc"]
    k = mw[basis].shape[1]
    assert packed.dtype == (torch.bfloat16 if algorithm == "x3" else torch.int8) and mel.dtype == torch.bfloat16
    back = ff.unpack_tc_basis(algorithm, packed, k)
    assert back.dtype == torch.from_numpy(mw[basis]).dtype and torch.equal(back, torch.from_numpy(mw[basis]))
    assert torch.equal(ff.unpack_tc_mel(mel, cfg.n_mels), torch.from_numpy(mw["melw"]))
    kp = packed.shape[1] * packed.shape[-1]
    assert kp % 32 == 0 and kp - k < 32
    assert not ff.unpack_tc_basis(algorithm, packed, kp)[:, k:].float().any()
    module = MfccChange(cfg).frontend_weights(algorithm)
    assert torch.equal(module[f"{basis}_tc"], packed) and torch.equal(module["melw_tc"], mel)


def kernel_constants() -> dict[str, int]:
    src = (CSRC / "tensor_core.cuh").read_text() + (CSRC / "fused_frontend_tc.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    for mode, body in re.findall(r"struct Mode<(kX3|kI24)> \{(.*?)\};", src, re.S):
        for k, v in re.findall(r"static constexpr int (k\w+) = (\d+);", body):
            consts[f"{mode}.{k}"] = int(v)
    consts["kCols"] = 32 * consts["kWN"]  # constexpr int kCols = 32 * kWN
    return consts


def test_tc_wrapper_constants_match_cuda_source():
    """The layouts' tile widths, MMA depths, chunk and mel step are the
    kernel's own constants."""
    c = kernel_constants()
    assert c["kBF"] == ff.BLOCK_FRAMES and c["kMelCols"] == ff._MEL_MAX and c["kMelStep"] == ff._MEL_STEP
    assert c["kChunkRows"] == ff._TC_CHUNK and c["kCols"] == ff._TC_COLS
    assert c["kMT"] * 16 * (c["kThreads"] // 32 // c["kWN"]) == ff.BLOCK_FRAMES
    for alg, mode in (("x3", "kX3"), ("i24", "kI24")):
        assert c[f"{mode}.kStep"] == ff._TC_STEP[alg]
        assert c[f"{mode}.kPlanes"] == (2 if alg == "x3" else 3)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ff.TC_ALGORITHMS)
def test_tc_kernel_addressing_reads_frames_and_weights(algorithm, name):
    """The kernel's address arithmetic, mirrored: a thread's 8-byte A
    fragment of frame row f at contraction k is element f·hop + k of the
    staged span, read from the copy shifted so that the load is aligned (the
    10 kHz default's hop of 50 needs 2 copies for bf16, 4 for int8); its B
    fragment of column n is the interleaved basis column n at rows k..k+7 of
    the pre-arranged chunk; a mel step's B fragment is the mel weight of bin
    16j + 4t + i. Every element of every frame, basis row and mel bin is
    read, and read right."""
    cfg, w = tensors(algorithm, name)
    hop = cfg.hop_length
    al = 4 if algorithm == "x3" else 8  # elements per 8-byte load (kAl)
    step, cols = ff._TC_STEP[algorithm], ff._TC_COLS
    packed = w[f"{BASIS[algorithm]}_tc"]
    tiles, ks, n_planes = packed.shape[:3]
    kp = ks * step
    # A: the span of a block, staged in n_copies copies, copy c shifted by c·gcd
    gcd = math.gcd(hop, al)
    n_copies = al // gcd
    span_pad = -(-(63 * hop + kp) // 16) * 16
    signal = np.random.default_rng(hop).standard_normal(span_pad + al)
    copies = np.stack([signal[c * gcd : c * gcd + span_pad] for c in range(n_copies)]).reshape(-1)
    f = np.arange(64)[:, None, None]
    t, i = np.arange(4)[None, :, None], np.arange(al)[None, None, :]
    for k0 in range(0, kp, step):
        e = f * hop
        r = e % al
        assert (r % gcd == 0).all()
        got = copies[(r // gcd) * span_pad + e - r + al * t + k0 + i]
        np.testing.assert_array_equal(got, signal[e + k0 + al * t + i])
    # B: the basis as the kernel reads each chunk's stage
    flat = packed.reshape(-1)
    inter = ff._interleave(torch.as_tensor(w[BASIS[algorithm]]))
    want = torch.nn.functional.pad(inter, (0, 0, 0, kp - inter.shape[1]))
    got = torch.empty_like(want)
    kk = np.arange(kp)
    chunk, within = kk // ff._TC_CHUNK, kk % ff._TC_CHUNK
    j, rest = within // step, within % step
    for tt in range(tiles):
        for p in range(n_planes):
            base = (tt * kp + chunk * ff._TC_CHUNK) * cols * n_planes
            off = base[:, None] + ((j[:, None] * n_planes + p) * cols + np.arange(cols)[None, :]) * step + rest[:, None]
            got[p, :, tt * cols : (tt + 1) * cols] = flat[torch.as_tensor(off)]
    assert torch.equal(got, want)
    # the mel weights, a tile's steps at a time
    mel = w["melw_tc"].reshape(-1)
    bins = np.arange(w["melw"].shape[1])
    jm, rm = bins // ff._MEL_STEP, bins % ff._MEL_STEP
    for p in range(2):
        off = ((2 * jm[:, None] + p) * ff._MEL_MAX + np.arange(ff._MEL_MAX)[None, :]) * ff._MEL_STEP + rm[:, None]
        got_m = mel[torch.as_tensor(off)].float()
        assert torch.equal(got_m[:, : cfg.n_mels], w["melw"][p]) and not got_m[:, cfg.n_mels :].any()


def test_tc_modes_raise_off_the_card():
    """A CUDA-only layout never reaches a CPU path: on the CPU the x3 and
    i24 wrappers take their plain versions (equal to the plain versions
    with or without the layouts in ``weights``), and on another device they
    raise."""
    kw = dict(sr=16_000, hop=80, win_length=400, fmax=8000.0)
    x = torch.tensor(np.random.default_rng(1).standard_normal((1, 4000)), dtype=torch.float32)
    for alg in ff.TC_ALGORITHMS:
        _, w = tensors(alg, "16k")
        bare = {k: v for k, v in w.items() if not k.endswith("_tc")}
        a = ff.fused_mel_frontend(x, algorithm=alg, weights=w, **kw)
        b = ff.fused_mel_frontend(x, algorithm=alg, weights=bare, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        with pytest.raises(ValueError, match="no kernel"):
            ff.fused_mel_frontend(x.to("meta"), algorithm=alg, **kw)


@pytest.mark.parametrize("algorithm", ff.TC_ALGORITHMS)
def test_tc_launch_needs_the_layouts(algorithm, monkeypatch):
    """The launcher never repacks the weights: on the kernel's route, weights
    without their tensor-core layouts raise before anything is launched,
    naming the layouts and mode_tensors."""
    monkeypatch.setattr(ff, "route", lambda t, name: True)
    _, w = tensors(algorithm, "16k")
    bare = {k: v for k, v in w.items() if not k.endswith("_tc")}
    x = torch.zeros((1, 4000), dtype=torch.float32)
    before = dict(ff.LAUNCHES)
    with pytest.raises(ValueError, match="tensor-core layouts.*mode_tensors"):
        ff.fused_mel_frontend(x, sr=16_000, hop=80, win_length=400, fmax=8000.0, algorithm=algorithm, weights=bare)
    assert dict(ff.LAUNCHES) == before
