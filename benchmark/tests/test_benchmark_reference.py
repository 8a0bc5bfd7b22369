"""The plain reference against the program's CPU path at a tiny size, for
each traffic mix and configuration, and its designs against the
definitions they follow."""
import numpy as np
import pytest
import scipy.fft
import torch
from conftest import tiny_cell

from benchlib.catalog import plugin

REF = plugin("reference", "modcep")
CELLS = ["modcep16k.uniform30s", "modcep16k.ragged", "modcep16k.i16rows", "modcep10k.uniform30s"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_meets_the_program_on_the_cpu(workload):
    cell = tiny_cell(workload, batch=3, pool=1)
    batch = plugin("gen", "speechlike").make_batch(cell.traffic, cell.config["signal_sample_rate"], 2**31 + 99, 0, "cpu")
    entry = plugin("entries", cell.config["entry"]).build(cell.config, cell.traffic, "cpu")
    tot, mask = entry(entry.prepare(batch))
    want = REF.tot_change(batch["samples"], batch["lengths"], cell.config, "cpu")
    hop = int(cell.config["tStep"] * cell.config["signal_sample_rate"])
    for r, w in enumerate(want):
        assert w.shape == (1 + batch["lengths"][r] // hop,)
        got = tot[r, : w.shape[0]].double().numpy()
        assert np.abs(got - w).max() <= 2e-6 * np.abs(w).max()
        assert torch.equal(mask[r] > 0, torch.arange(mask.shape[1]) < w.shape[0])


def test_designs():
    from modulation_mfcc_tpu_torch.ops.spectral import mel_filterbank

    for sr, fmax in ((16000, 8000.0), (10000, 10000.0)):
        ours = REF.mel_bank(sr, 512, 128, 100.0, fmax)
        assert np.allclose(ours, mel_filterbank(sr, 512, 128, 100.0, fmax), rtol=1e-9, atol=1e-15)
    x = np.random.default_rng(0).standard_normal((5, 128))
    assert np.allclose(x @ REF.dct_ortho(13, 128).T, scipy.fft.dct(x, type=2, norm="ortho")[:, :13])
    w = REF.hann_in_fft(400, 512)
    assert w[:56].sum() == 0 and w[456:].sum() == 0 and w[56] == 0.0 and w[256] == 1.0
