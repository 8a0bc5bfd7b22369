"""The roofline functions against counts made by hand."""
import math

import numpy as np
import pytest

from benchlib.catalog import BENCH_DIR, plugin, read_json

FR, TAIL = plugin("roofline", "frontend"), plugin("roofline", "tail")
PEAKS = read_json(BENCH_DIR / "roofline" / "peaks.json")
CFG16 = read_json(BENCH_DIR / "configs" / "modcep16k.json")
CFG10 = read_json(BENCH_DIR / "configs" / "modcep10k.json")


def test_mel_weights():
    """Each bin feeds at most two triangles; the bins some filter weights
    lie between minFreq and the top filter's upper edge (8 kHz, weight 0
    there; at 10 kHz every bin past 100 Hz up to Nyquist)."""
    for cfg in (CFG16, CFG10):
        bins, nonzero = FR.mel_weights(cfg)
        assert bins < nonzero <= 2 * bins <= 2 * 257
    assert FR.mel_weights(CFG16) == (252, 499)
    assert FR.mel_weights(CFG10) == (251, 501)


def test_flagship_counts():
    lengths = np.full(128, 480_000)
    frames = 128 * 6001
    per_frame = 400 + 2.5 * 512 * 9 + 3 * 252 + 2 * 499
    assert FR.frames(CFG16, lengths) == frames
    assert FR.operations(CFG16, lengths) == pytest.approx(frames * per_frame, rel=1e-12)
    assert per_frame == pytest.approx(13_674)
    byt = 128 * 480_000 * 4 + frames * 128 * 4
    assert FR.bytes_moved(CFG16, lengths, 4) == byt
    # the bytes set the bound: 639 MB at 3.35 TB/s
    assert FR.least_seconds(CFG16, lengths, 4, PEAKS) == pytest.approx(byt / 3.35e12)
    assert FR.least_seconds(CFG16, lengths, 4, PEAKS) * 1e3 == pytest.approx(0.1908, abs=1e-4)
    assert FR.operations(CFG16, lengths) / 989e12 < 0.1 * FR.least_seconds(CFG16, lengths, 4, PEAKS)
    # int16 rows read half the audio bytes
    assert FR.least_seconds(CFG16, lengths, 2, PEAKS) * 1e3 == pytest.approx(0.1541, abs=1e-4)
    assert TAIL.least_seconds(CFG16, lengths, PEAKS) == pytest.approx(frames * (128 + 13) * 4 / 3.35e12)


def test_ragged_counts_valid_frames_only():
    lengths = np.array([64_000, 64_079, 64_080, 560_000])
    frames = (1 + 800) + (1 + 800) + (1 + 801) + (1 + 7000)
    assert FR.frames(CFG16, lengths) == frames
    assert FR.operations(CFG16, lengths) == pytest.approx(frames * 13_674, rel=1e-12)
    assert FR.bytes_moved(CFG16, lengths, 2) == lengths.sum() * 2 + frames * 128 * 4


def test_10k_geometry():
    lengths = np.full(128, 300_000)
    frames = 128 * 6001
    per_frame = 250 + 2.5 * 512 * math.log2(512) + 3 * 251 + 2 * 501
    assert FR.operations(CFG10, lengths) == pytest.approx(frames * per_frame, rel=1e-12)
    assert FR.bytes_moved(CFG10, lengths, 4) == 128 * 300_000 * 4 + frames * 128 * 4
