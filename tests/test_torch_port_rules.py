"""PyTorch port: the rules it keeps. No JAX, no silent CPU fallback, no build
at import, and only hand-written kernels on the kernel path."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import modulation_mfcc_tpu_torch as mt
from modulation_mfcc_tpu_torch.kernels import _build, burg, masked_scan, sinc_refine, viterbi
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.ops import filters

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "modulation_mfcc_tpu_torch"


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), **env},
    )


def test_port_runs_without_jax():
    """With jax made unimportable, the port imports and runs mfcc_change
    (also with diffMethod='sg'), pitch_ac, pyin_f0, lpc_formants,
    batched_mfcc_change ('fused_i16' on int16 hop rows), the folded
    frontend, resample_device, chunked_mfcc_change and modulation_spectrum."""
    proc = _run(
        "import sys, importlib.abc\n"
        "class NoJax(importlib.abc.MetaPathFinder):  # jax and the JAX package are not installed\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name in ('jax', 'jaxlib', 'modulation_mfcc_tpu') or name.startswith(('jax.', 'jaxlib.',\n"
        "                                                                             'modulation_mfcc_tpu.')):\n"
        "            raise ImportError(f'no module named {name}')\n"
        "sys.meta_path.insert(0, NoJax())\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import modulation_mfcc_tpu_torch as mt\n"
        "from modulation_mfcc_tpu_torch.ops.pitch import pitch_ac\n"
        "from modulation_mfcc_tpu_torch.ops.lpc import lpc_formants\n"
        "y = torch.tensor(np.random.default_rng(0).standard_normal((1, 40000)), dtype=torch.float32)\n"
        "tot = mt.mfcc_change(y, mt.MfccConfig())\n"
        "assert tot.shape == (1, 801) and bool(torch.isfinite(tot).all())\n"
        "f0 = pitch_ac(y, sr=10000.0)\n"
        "assert f0.shape == (1, 397) and bool(torch.isfinite(f0).all())\n"
        "f0 = mt.pyin_f0(y[:, :15000], sr=10000.0)\n"
        "assert f0.shape == (1, 151) and bool(torch.isfinite(f0).all())\n"
        "freqs, bw = lpc_formants(y[:, :11000], sr=11000.0)\n"
        "assert freqs.shape == (1, 191, 5)\n"
        "from modulation_mfcc_tpu_torch.kernels.fused_frontend import pack_hop_rows\n"
        "from modulation_mfcc_tpu_torch.parallel.batch import batched_mfcc_change\n"
        "pcm = (y * 3000).to(torch.int16).repeat(2, 1)\n"
        "rows = torch.tensor(pack_hop_rows(pcm.numpy(), hop=50, win_length=250))\n"
        "tot, mask = batched_mfcc_change(mt.AudioBatch(rows, torch.tensor([40000, 30000])), mt.MfccConfig(),\n"
        "                                spectrum='fused_i16', n_samples=40000)\n"
        "assert tot.shape == (2, 801) and bool(torch.isfinite(tot).all()) and not bool(tot[1, 601:].any())\n"
        "from modulation_mfcc_tpu_torch.kernels.fused_frontend import fused_mel_frontend\n"
        "mel, bmax = fused_mel_frontend(y, sr=10000, hop=50, win_length=250, fold=True)\n"
        "assert mel.shape == (1, 801, 128) and bool(torch.isfinite(mel).all())\n"
        "tot = mt.mfcc_change(y, mt.MfccConfig(diffMethod='sg'))\n"
        "assert tot.shape == (1, 801) and bool(torch.isfinite(tot).all())\n"
        "y2 = mt.resample_device(y[0, :20000], 10000, 8000)\n"
        "assert y2.shape == (16000,)\n"
        "tot = mt.chunked_mfcc_change(y[0], mt.MfccConfig(), frames_per_chunk=256)\n"
        "assert tot.shape == (801,) and bool(torch.isfinite(tot).all())\n"
        "spec = mt.modulation_spectrum(y, mt.MfccConfig())\n"
        "assert spec.shape == (1, 12, 51, 65) and bool(torch.isfinite(spec).all())\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'modulation_mfcc_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_envelopes_oracle_and_verify_run_without_jax():
    """With jax and the JAX package made unimportable, the envelopes
    (extract_envelope in all three methods, batched_envelope) run, the
    float64 oracle imports, and the verify harness passes on the CPU: the
    card's machine, which has no jax, runs them as they are."""
    proc = _run(
        "import sys, importlib.abc\n"
        "class NoJax(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name in ('jax', 'jaxlib', 'modulation_mfcc_tpu') or name.startswith(('jax.', 'jaxlib.',\n"
        "                                                                             'modulation_mfcc_tpu.')):\n"
        "            raise ImportError(f'no module named {name}')\n"
        "sys.meta_path.insert(0, NoJax())\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import modulation_mfcc_tpu_torch as mt\n"
        "from modulation_mfcc_tpu_torch import oracle\n"
        "from modulation_mfcc_tpu_torch.cli import main\n"
        "y = np.random.default_rng(0).standard_normal(12000).astype(np.float32) * 0.3\n"
        "for method in ('RMS', 'Hilb', 'RMSpraat'):\n"
        "    amp, t = mt.extract_envelope(y, 10000, mt.AmplitudeConfig(method=method), device='cpu')\n"
        "    assert amp.shape[-1] == len(t) and bool(torch.isfinite(amp).all())\n"
        "amp, valid = mt.batched_envelope(mt.pad_batch([y, y[:9000]], device='cpu'), 10000)\n"
        "assert amp.shape == valid.shape == (2, 123) and int(valid[1].sum()) == 91\n"
        "assert main(['verify', '--seconds', '1.2', '--device', 'cpu']) == 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'modulation_mfcc_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0 and proc.stdout.strip().splitlines()[-1] == "ok", proc.stderr


def test_analysis_workflow_runs_without_jax(tmp_path):
    """With jax and the JAX package made unimportable, the analysis
    workflow imports (models.pipeline, models.workbench, models.features,
    ops.peaks, io.ag50x) and runs: extract_feature on the CPU, mfcc39 on a
    masked batch, peaks, an EMA file, a session's CSV and the CLI's extract."""
    proc = _run(
        "import sys, importlib.abc\n"
        "class NoJax(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name in ('jax', 'jaxlib', 'modulation_mfcc_tpu') or name.startswith(('jax.', 'jaxlib.',\n"
        "                                                                             'modulation_mfcc_tpu.')):\n"
        "            raise ImportError(f'no module named {name}')\n"
        "sys.meta_path.insert(0, NoJax())\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import modulation_mfcc_tpu_torch as mt\n"
        "from modulation_mfcc_tpu_torch.models import pipeline, workbench, features\n"
        "from modulation_mfcc_tpu_torch.ops import peaks\n"
        "from modulation_mfcc_tpu_torch.io import ag50x\n"
        "from modulation_mfcc_tpu_torch.io.wav import write_wav\n"
        "from modulation_mfcc_tpu_torch.cli import main\n"
        f"d = {str(tmp_path)!r}\n"
        "rng = np.random.default_rng(0)\n"
        "t = np.arange(12000) / 10000\n"
        "write_wav(d + '/a.wav', 0.6 * np.sin(2 * np.pi * 140 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)), 10000)\n"
        "for feat in ('mod_cepstr', 'f0', 'formant2', 'envelope', 'mfcc'):\n"
        "    tt, v = mt.extract_feature(d + '/a.wav', feat, derivation=1, device='cpu')\n"
        "    assert v.shape[0] == len(tt) and bool(torch.isfinite(v).all()), feat\n"
        "cfg = mt.MfccConfig()\n"
        "batch = mt.pad_batch([rng.standard_normal(9000), rng.standard_normal(6000)], device='cpu')\n"
        "mask = mt.frame_validity_mask(batch.lengths, batch.samples.shape[-1], cfg)\n"
        "m39 = mt.mfcc_with_deltas(mt.mfcc_trajectories(batch.samples, cfg, frame_mask=mask), frame_mask=mask,\n"
        "                          normalize=True)\n"
        "assert m39.shape == (2, 205, 39) and not bool(m39[1, 121:].any())\n"
        "pm = peaks.peak_mask(torch.tensor([[0.0, 1, 0, 2, 2, 0]]))\n"
        "assert pm.tolist() == [[False, True, False, True, False, False]]\n"
        "ag50x.write_ag50x(d + '/r.pos', rng.standard_normal((250, 8, 7)).astype(np.float32), 250)\n"
        "s = mt.AnalysisSession(d + '/a.wav', device='cpu')\n"
        "s.load_pos(d + '/r.pos')\n"
        "s.add_curve('mod_cepstr'); s.add_ema_curve(1, derivation=2)\n"
        "s.set_region(0.1, 1.1); s.analyze_max_peaks()\n"
        "s.export_csv(d + '/s.csv')\n"
        "assert main(['extract', d + '/a.wav', '--features', 'mod_cepstr,f0', '--out', d + '/e.csv',\n"
        "             '--device', 'cpu']) == 0\n"
        "assert len(open(d + '/e.csv').read().splitlines()) > 300\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'modulation_mfcc_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_sweep_and_distributed_paths_run_without_jax(tmp_path):
    """With jax and the JAX package made unimportable, the native loader
    (io.native), the meshes (parallel.mesh, parallel.multislice) and the dry
    run (dryrun) import, and run: the sweep with every extra through the
    native loader, the CLI's sweep on one manifest shard, and a gloo world
    of one (init_distributed with an init_method) through
    sharded_mfcc_change and sharded_longform_mfcc_change."""
    proc = _run(
        "import sys, importlib.abc\n"
        "class NoJax(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name in ('jax', 'jaxlib', 'modulation_mfcc_tpu') or name.startswith(('jax.', 'jaxlib.',\n"
        "                                                                             'modulation_mfcc_tpu.')):\n"
        "            raise ImportError(f'no module named {name}')\n"
        "sys.meta_path.insert(0, NoJax())\n"
        "import os, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import modulation_mfcc_tpu_torch as mt\n"
        "from modulation_mfcc_tpu_torch import dryrun\n"
        "from modulation_mfcc_tpu_torch.io import native\n"
        "from modulation_mfcc_tpu_torch.io.wav import write_wav\n"
        "from modulation_mfcc_tpu_torch.parallel import batch, corpus, mesh, multislice, streaming\n"
        "from modulation_mfcc_tpu_torch.cli import main\n"
        f"d = {str(tmp_path)!r}\n"
        "t = np.arange(15000) / 10000\n"
        "paths = []\n"
        "for i in range(3):\n"
        "    paths.append(f'{d}/u{i}.wav')\n"
        "    write_wav(paths[-1], 0.6 * np.sin(2 * np.pi * (130 + 20 * i) * t) * (0.5 + 0.5 * np.sin(6 * t)), 10000)\n"
        "assert native.native_available()\n"
        "rep = corpus.sweep_mfcc_change(paths, corpus.CorpusSweep(d + '/feats', device='cpu', spectrum='fft',\n"
        "    features=('mod_cepstr', 'mfcc39', 'f0', 'envelope', 'formants')))\n"
        "rec = np.load(d + '/feats/u1.npz')\n"
        "assert rep['items'] == 3 and rec['mfcc39'].shape[1] == 39 and abs(np.median(rec['f0'][rec['f0'] > 0]) - 150) < 5\n"
        "assert main(['sweep', d, '--out', d + '/s1', '--num-shards', '2', '--shard-id', '1', '--device', 'cpu',\n"
        "             '--spectrum', 'fft']) == 0\n"
        "assert sorted(os.listdir(d + '/s1')) == ['_done.txt', 'u1.npz']\n"
        "assert multislice.init_distributed() is False\n"
        "assert multislice.init_distributed(f'file://{d}/store', 1, 0, backend='gloo')\n"
        "m = mesh.make_mesh(1, 1, device_type='cpu')\n"
        "b = mt.pad_batch([np.sin(t * 700), np.sin(t[:9000] * 900)], device='cpu')\n"
        "tot, mask, mean = batch.sharded_mfcc_change(b, mt.MfccConfig(), m)\n"
        "ref, _ = batch.batched_mfcc_change(b, mt.MfccConfig())\n"
        "assert torch.equal(tot, ref) and bool(torch.isfinite(mean))\n"
        "y = torch.tensor(np.sin(np.arange(30000) / 7.0), dtype=torch.float32)\n"
        "got = streaming.sharded_longform_mfcc_change(y, mt.MfccConfig(), m)\n"
        "assert float((got - mt.mfcc_change(y, mt.MfccConfig())).abs().max()) < 1e-5\n"
        "assert callable(dryrun.spawn) and set(dryrun.PROGRAMS) == {'certify', 'mesh_sweep'}\n"
        "torch.distributed.destroy_process_group()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'modulation_mfcc_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0 and proc.stdout.strip().splitlines()[-1] == "ok", proc.stderr


def test_kernel_module_imports_without_nvcc_or_triton():
    """Importing the kernel modules, the native loader's binding and the dry
    run builds nothing and needs no toolchain."""
    proc = _run(
        "import sys; sys.modules['triton'] = None\n"
        "from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff, _build, burg, masked_scan, sinc_refine,"
        " viterbi\n"
        "import modulation_mfcc_tpu_torch\n"
        "from modulation_mfcc_tpu_torch import dryrun\n"
        "from modulation_mfcc_tpu_torch.io import native\n"
        "assert _build.load_library.cache_info().currsize == 0 and native.load_library.cache_info().currsize == 0\n"
        "assert all(m._lib.cache_info().currsize == 0 for m in (ff, burg, masked_scan, sinc_refine, viterbi))\n"
        "print('ok')\n",
        PATH="/nonexistent",
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cuda_request_without_cuda_raises(tmp_path):
    """CUDA is the default device of every entry point given non-tensor
    input: asking for it, or leaving the default, raises where CUDA is
    missing; only device="cpu" (or a CPU tensor) computes on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule concerns machines without it")
    from modulation_mfcc_tpu_torch.models.pitch_adaptive import praat_style_intensity
    from modulation_mfcc_tpu_torch.parallel.corpus import CorpusSweep, sweep_mfcc_change
    from modulation_mfcc_tpu_torch.parallel.prefetch import prefetch_to_device

    y = np.zeros(16_000, np.float32)
    calls = {
        "extract_mfcc_change": lambda **kw: mt.extract_mfcc_change(y, **kw),
        "extract_mfcc_matrix": lambda **kw: mt.models.modulation.extract_mfcc_matrix(y, **kw),
        "extract_mfcc": lambda **kw: mt.extract_mfcc(y, **kw),
        "extract_modulation": lambda **kw: mt.extract_modulation(y, **kw),
        "extract_f0": lambda **kw: mt.extract_f0(y, 16_000, **kw),
        "extract_f0 pyin": lambda **kw: mt.extract_f0(y, 16_000, mt.F0Config(method="pyin"), **kw),
        "batched_f0 pyin": lambda **kw: mt.batched_f0(mt.pad_batch([y], **kw), 16_000, mt.F0Config(method="pyin")),
        "extract_formants": lambda **kw: mt.extract_formants(y, 16_000, **kw),
        "formants_with_gating": lambda **kw: mt.formants_with_gating(y, 16_000, **kw),
        "pad_batch": lambda **kw: mt.pad_batch([y], **kw),
        "extract_mfcc_change fused_i16": lambda **kw: mt.extract_mfcc_change(y, spectrum="fused_i16", **kw),
        "sweep_mfcc_change": lambda **kw: sweep_mfcc_change([], CorpusSweep(str(tmp_path), **kw)),
        "prefetch_to_device": lambda **kw: list(prefetch_to_device(iter([{"a": y}]), **kw)),
        "resample_device": lambda **kw: mt.resample_device(y, 16_000, 10_000, **kw),
        "modulation_spectrum": lambda **kw: mt.modulation_spectrum(y, mt.MfccConfig(), **kw),
        "extract_envelope": lambda **kw: mt.extract_envelope(y, 16_000, **kw),
        "extract_envelope RMSpraat": lambda **kw: mt.extract_envelope(y, 16_000, mt.AmplitudeConfig(method="RMSpraat"),
                                                                      **kw),
        "praat_style_intensity": lambda **kw: praat_style_intensity(y, 16_000, **kw),
        "batched_envelope": lambda **kw: mt.batched_envelope(mt.pad_batch([y], **kw), 16_000),
    }
    for call in calls.values():
        for kw in ({"device": "cuda"}, {}):
            with pytest.raises(RuntimeError, match="CUDA"):
                call(**kw)
        call(device="cpu")  # the CPU on request
    tot, _ = mt.extract_mfcc_change(torch.tensor(y))  # a CPU tensor keeps its device
    assert tot.device.type == "cpu"


def test_analysis_workflow_cuda_request_without_cuda_raises(tmp_path):
    """extract_feature, AnalysisSession, the CLI's extract and plot, the EMA
    reader, the spectrogram and the peak finders on host arrays default to
    CUDA and raise without it; mfcc_with_deltas, peak_mask and
    apply_derivation compute on their tensor's own device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule concerns machines without it")
    from modulation_mfcc_tpu_torch.cli import main
    from modulation_mfcc_tpu_torch.io.ag50x import read_ag50x, write_ag50x
    from modulation_mfcc_tpu_torch.io.wav import write_wav
    from modulation_mfcc_tpu_torch.models.pipeline import apply_derivation
    from modulation_mfcc_tpu_torch.models.sound import praat_spectrogram
    from modulation_mfcc_tpu_torch.ops.peaks import find_peaks_host, peaks_in_interval

    wav, pos = str(tmp_path / "a.wav"), str(tmp_path / "a.pos")
    y = np.sin(np.arange(12_000) / 10.0) * 0.5
    write_wav(wav, y, 10_000)
    write_ag50x(pos, np.zeros((100, 8, 7), np.float32), 250)
    calls = {
        "extract_feature": lambda **kw: mt.extract_feature(wav, "mod_cepstr", **kw),
        "extract_feature soundwave": lambda **kw: mt.extract_feature(wav, "soundwave", **kw),
        "AnalysisSession": lambda **kw: mt.AnalysisSession(wav, **kw),
        "read_ag50x": lambda **kw: read_ag50x(pos, **kw),
        "praat_spectrogram": lambda **kw: praat_spectrogram(y, 10_000, **kw),
        "find_peaks_host": lambda **kw: find_peaks_host(y[:50], **kw),
        "peaks_in_interval": lambda **kw: peaks_in_interval(np.arange(50.0), y[:50], (0.0, 49.0), **kw),
    }
    for call in calls.values():
        for kw in ({"device": "cuda"}, {}):
            with pytest.raises(RuntimeError, match="CUDA"):
                call(**kw)
        call(device="cpu")
    for cmd in (["extract", wav, "--out", str(tmp_path / "e.csv")], ["plot", wav, "--out", str(tmp_path / "p.png")],
                ["sweep", wav, "--out", str(tmp_path / "feats")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(cmd)
    m = torch.zeros((1, 20, 13))
    assert mt.mfcc_with_deltas(m).device.type == "cpu" and mt.peak_mask(m).device.type == "cpu"
    assert apply_derivation(np.arange(9.0), torch.arange(9.0), 1)[1].device.type == "cpu"


def test_wrappers_raise_on_devices_without_a_kernel():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (a meta tensor stands in for a non-CPU device)."""
    audio = torch.empty((1, 4000), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ff.fused_mel_frontend(audio, sr=16_000, hop=80, win_length=400, fmax=8000.0)
    mel = torch.empty((1, 51, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ff.mfcc_tail(mel, torch.empty(1, device="meta"), 13)
    with pytest.raises(ValueError, match="float32"):
        ff.fused_mel_frontend(torch.zeros((1, 4000), dtype=torch.float64), sr=16_000)
    r_ext = torch.empty((4, 300), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sinc_refine.refine_sinc_band(r_ext, 37, 16, 134, 35)
    frames = torch.empty((4, 550), device="meta")
    for fn in (burg.burg_lpc, burg.burg_reflections):
        with pytest.raises(ValueError, match="no kernel"):
            fn(frames, 10)
    log_obs, delta0 = torch.empty((2, 30, 722), device="meta"), torch.empty((2, 722), device="meta")
    log_tri = torch.empty((361, 361), device="meta")
    for fn in (viterbi.viterbi_forward, viterbi.viterbi_decode):
        with pytest.raises(ValueError, match="no kernel"):
            fn(log_obs, delta0, log_tri, -0.01, -4.6)
    with pytest.raises(ValueError, match="no kernel"):
        viterbi.viterbi_backtrace(log_obs[:, 1:], delta0, log_tri, -0.01, -4.6)
    with pytest.raises(ValueError, match="no kernel"):
        mt.pyin_f0(torch.empty((1, 4000), device="meta"), sr=10_000.0)
    rows = torch.empty((1, 1040, 80), dtype=torch.int16, device="meta")
    for alg in ("f32", "bf16", "x3", "i16", "i24"):
        for x, n in ((audio, None), (audio.to(torch.int16), None), (rows, 4000)):
            with pytest.raises(ValueError, match="no kernel"):
                ff.fused_mel_frontend(x, sr=16_000, hop=80, win_length=400, fmax=8000.0, algorithm=alg, n_samples=n)
    with pytest.raises(ValueError, match="no kernel"):
        ff.mfcc_tail(mel.to(torch.bfloat16), torch.empty(1, device="meta"), 13)
    with pytest.raises(ValueError, match="no kernel"):
        mt.mfcc_change(rows, mt.MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0), spectrum="fused_i16",
                       n_samples=4000)
    for alg in ff.FOLD_ALGORITHMS:
        with pytest.raises(ValueError, match="no kernel"):
            ff.fused_mel_frontend(audio, sr=16_000, hop=80, win_length=400, fmax=8000.0, algorithm=alg, fold=True)
    with pytest.raises(ValueError, match="no kernel"):
        mt.modulation_spectrum(audio, mt.MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0))
    sos, zi, padlen = filters.design_butter_sos(6, (0.12,), "lowpass")
    with pytest.raises(ValueError, match="no kernel"):
        masked_scan.masked_sosfiltfilt_f64(sos, zi, padlen, torch.empty((2, 12, 400), device="meta"),
                                           torch.empty(2, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        masked_scan.masked_grad_norm(torch.empty((2, 12, 400), device="meta"),
                                     torch.empty(2, dtype=torch.int64, device="meta"))


def test_build_is_true_fp32_for_sm90a():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "burg.cu", "fused_frontend.cu", "fused_frontend_fft.cu", "fused_frontend_fold.cu", "fused_frontend_fold_tc.cu",
        "fused_frontend_tc.cu", "masked_scan.cu", "sinc_refine.cu", "viterbi.cu"]
    assert _build.library_path().parent == _build.BUILD_DIR
    assert "modulation_mfcc_tpu_torch/_build/" in (REPO / ".gitignore").read_text()


def test_package_source_rules():
    """No jax, no library kernels on the kernel path, and no try/except that
    could turn a failed build or launch into the plain version."""
    banned = re.compile(r"^\s*(import jax|from jax)|torch\.compile|scaled_dot_product_attention|"
                        r"torch\.backends\.cudnn|conv1d|conv_general", re.M)
    for path in PKG.rglob("*.py"):
        if "_build" in path.relative_to(PKG).parts:
            continue
        src = path.read_text()
        assert not banned.search(src), path
    for path in (PKG / "kernels").glob("*.py"):
        assert not re.search(r"^\s*(try|except)\b", path.read_text(), re.M), path
