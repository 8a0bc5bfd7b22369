"""PyTorch port: the reference's config schema (models/config.py), the
named features with their derivations (models/pipeline.py) and the CLI's
``extract`` and ``plot`` against the JAX package, on the CPU.

Bars: the schema and the saved files equal; each feature at its tracker's
port bar on tests/fixtures/utterance_16k.wav (mod_cepstr 1e-5, f0 and
formants 0.05 Hz, envelope 1e-5 relative, the MFCC matrix 2e-6 relative
to its largest magnitude, the float32 rounding of two sum orders; the
waveform exact), and a derived curve at that bar times the derivation
operator's largest column L1 norm, which bounds how far a max-abs error
can grow through it."""
import csv
import dataclasses
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from modulation_mfcc_tpu import runner as jax_runner
from modulation_mfcc_tpu.models import config as jax_config
from modulation_mfcc_tpu.models import pipeline as jax_pipeline
from modulation_mfcc_tpu_torch import cli
from modulation_mfcc_tpu_torch.models import config
from modulation_mfcc_tpu_torch.models import pipeline
from modulation_mfcc_tpu_torch.ops.derivatives import velocity

torch.set_num_threads(1)

WAV = str(Path(__file__).resolve().parent / "fixtures" / "utterance_16k.wav")
CLASSES = ["MfccConfig", "AmplitudeConfig", "FormantConfig", "F0Config", "EmaConfig", "DerivationConfig",
           "SectionMeta", "PipelineConfig"]


def _fields(cls) -> list[tuple]:
    out = []
    for f in dataclasses.fields(cls):
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        out.append((f.name, str(f.type), dataclasses.asdict(default) if dataclasses.is_dataclass(default) else default))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_dataclasses_have_the_jax_fields(name):
    """Same fields, types and defaults, so the schema maps the same keys."""
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert _fields(ours) == _fields(theirs)
    assert ours.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen


def _filled_reference_json() -> dict:
    """A saved dialog with a non-default value in every section, the
    derivation keys set, list-valued cutoffs and keys the schema skips."""
    return {
        "mfcc": {"signal_sample_rate": 16000, "maxFreq": 8000.0, "n_mfcc": 20, "n_mels": 64, "tStep": 0.01,
                 "outFiltCutOff": [8.0], "diffMethod": "sg", "enabled": False, "name": "modulation", "panel": 1,
                 "derivation_type": 1, "derivative_method": "finDiff", "fin_diff_acc_order": 4, "unknown_key": 3},
        "amplitude": {"method": "Hilb", "winLen": 0.05, "outFilter": "iir", "outFiltCutOff": [2.0, 20.0],
                      "outFiltType": "band", "derivation_type": 2, "derivative_method": "sg", "sg_width": 5},
        "formant1": {"max_formant": 5000.0, "energy_threshold": 30.0, "panel": 3},
        "formant2": {"max_num_formants": 4, "name": "F2"},
        "formant3": {"window_length": 0.03, "enabled": False},
        "f0": {"method": "pyin", "minPitch": 60.0, "maxPitch": 400.0, "minMaxQuant": [0.1, 0.9],
               "beta_parameters": [1, 10], "pyinfill_na": 0.0, "derivation_type": 1, "sg_poly_order": 3},
        "ema": {"target_sample_rate": 250, "derivative_method": "sg", "sg_width": 7},
    }


@pytest.mark.parametrize("case", ["default", "filled"])
def test_reference_json_schema_matches_jax(tmp_path, case):
    """config_from_reference_json → equal dataclass dicts;
    config_to_reference_json → equal dicts; save_config → the same file,
    which load_config reads back to an equal config."""
    src = {} if case == "default" else _filled_reference_json()
    ours = config.config_from_reference_json(json.dumps(src))
    theirs = jax_config.config_from_reference_json(json.dumps(src))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert config.config_to_reference_json(ours) == jax_config.config_to_reference_json(theirs)
    if case == "default":
        assert ours == config.PipelineConfig()
    else:
        assert ours.f0.minMaxQuant == (0.1, 0.9) and ours.meta_for("mfcc").derivation.derivative_method == "finDiff"
    mine, jaxs = tmp_path / "port.json", tmp_path / "jax.json"
    config.save_config(ours, str(mine))
    jax_config.save_config(theirs, str(jaxs))
    assert mine.read_text() == jaxs.read_text()
    assert config.load_config(str(jaxs)) == ours
    with pytest.raises(ValueError, match="section"):
        ours.meta_for("nope")


def test_resolve_derivation_matches_jax():
    cfg = config.config_from_reference_json(_filled_reference_json())
    jcfg = jax_config.config_from_reference_json(_filled_reference_json())
    for feature in list(pipeline.SECTION_OF_FEATURE):
        for derivation, dcfg in ((None, None), (0, None), (2, config.DerivationConfig(derivative_method="sg"))):
            jd = None if dcfg is None else jax_config.DerivationConfig(**dataclasses.asdict(dcfg))
            got = pipeline.resolve_derivation(feature, cfg, derivation, dcfg)
            want = jax_pipeline.resolve_derivation(feature, jcfg, derivation, jd)
            assert got[0] == want[0] and dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    assert pipeline.SECTION_OF_FEATURE == jax_pipeline.SECTION_OF_FEATURE
    assert sorted(pipeline.FEATURES) == sorted(jax_pipeline.FEATURES)


def _bar(feature: str, v: np.ndarray) -> float:
    """Each feature's port bar, max-abs."""
    if feature == "mod_cepstr":
        return 1e-5
    if feature in ("f0", "formant1", "formant2", "formant3"):
        return 0.05  # Hz
    if feature == "envelope":
        return 1e-5 * np.abs(v).max()
    if feature == "mfcc":
        return 2e-6 * np.abs(v).max()
    return 0.0


def _growth(n: int, derivation: int, dcfg: config.DerivationConfig) -> float:
    """Largest column L1 norm of the derivation operator on n samples: a
    max-abs error e in the input moves the output by at most e times this.
    The stencils are at most 7 wide, so 64 samples show every column kind."""
    if derivation == 0:
        return 1.0
    op = velocity(torch.eye(min(n, 64), dtype=torch.float64), 1.0, difference=derivation, method=dcfg.derivative_method,
                  width=dcfg.sg_width, acc_order=dcfg.fin_diff_acc_order, poly_order=dcfg.sg_poly_order)
    return float(op.abs().sum(dim=-1).max())


DERIVATIONS = [(0, "gradient"), (1, "gradient"), (1, "sg"), (1, "finDiff"), (2, "gradient"), (2, "sg"),
               (2, "finDiff")]


@pytest.mark.parametrize("feature", ["mod_cepstr", "mfcc", "envelope", "f0", "formant1", "formant2", "formant3",
                                     "soundwave"])
def test_extract_feature_matches_jax(feature):
    """Every feature at derivation 0, 1 and 2 with each derivative method,
    on the speech fixture: times equal, values at the feature's bar."""
    cfg, jcfg = config.PipelineConfig(), jax_config.PipelineConfig()
    for derivation, method in DERIVATIONS:
        dcfg = config.DerivationConfig(derivative_method=method)
        jd = jax_config.DerivationConfig(derivative_method=method)
        t, v = pipeline.extract_feature(WAV, feature, cfg, derivation=derivation, dcfg=dcfg, device="cpu")
        jt, jv = jax_pipeline.extract_feature(WAV, feature, jcfg, derivation=derivation, dcfg=jd)
        jv = np.asarray(jv)
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(t), np.asarray(jt))
        assert v.shape == jv.shape and np.isfinite(v.numpy()).all()
        if derivation == 0:
            bar0 = _bar(feature, jv)
        tol = bar0 * _growth(jv.shape[-1], derivation, dcfg)
        err = float(np.max(np.abs(v.double().numpy() - jv)))
        assert err <= tol, (feature, derivation, method, err, tol)
        if feature == "soundwave" and derivation == 0:
            assert np.array_equal(v.numpy(), jv)


def test_extract_feature_follows_the_saved_derivation():
    """With no derivation arguments the feature's section decides: a saved
    'amplitude velocity, sg width 5' gives that curve."""
    src = {"amplitude": {"derivation_type": 1, "derivative_method": "sg", "sg_width": 5}}
    cfg = config.config_from_reference_json(src)
    t, auto = pipeline.extract_feature(WAV, "envelope", cfg, device="cpu")
    _, explicit = pipeline.extract_feature(WAV, "envelope", config.PipelineConfig(), derivation=1,
                                           dcfg=config.DerivationConfig(derivative_method="sg", sg_width=5),
                                           device="cpu")
    assert torch.equal(auto, explicit)
    _, jv = jax_pipeline.extract_feature(WAV, "envelope", jax_config.config_from_reference_json(src))
    np.testing.assert_allclose(auto.numpy(), np.asarray(jv), rtol=0, atol=1e-5 * np.abs(np.asarray(jv)).max() * 4)
    with pytest.raises(ValueError, match="Unknown feature 'pitch'"):
        pipeline.extract_feature(WAV, "pitch", device="cpu")


def _csv_rows(text: str) -> list[list[str]]:
    return list(csv.reader(io.StringIO(text)))


@pytest.mark.parametrize("derivation", [0, 1])
def test_cli_extract_matches_jax_run_extract(tmp_path, derivation):
    """`modmfcc-torch extract` writes JAX run_extract's CSV: the same header
    and rows, file, feature and time columns equal as text, each value at
    its feature's bar (times the velocity's growth); a missing file is
    skipped with a warning, as JAX does."""
    import argparse

    feats = "mod_cepstr,envelope,f0,mfcc"
    out = tmp_path / "port.csv"
    missing = str(tmp_path / "missing.wav")
    rc = cli.main(["extract", WAV, missing, "--features", feats, "--out", str(out), "--derivation",
                   str(derivation), "--device", "cpu"])
    assert rc == 0
    ref = tmp_path / "jax.csv"
    jax_runner.run_extract(argparse.Namespace(inputs=[WAV, missing], config=None, features=feats, out=str(ref),
                                              derivation=derivation))
    got, want = _csv_rows(out.read_text()), _csv_rows(ref.read_text())
    assert got[0] == want[0] == ["file", "feature", "time", "value"]
    assert len(got) == len(want) > 1000
    assert [r[:3] for r in got] == [r[:3] for r in want]
    by_feature: dict[str, list] = {}
    for g, w in zip(got[1:], want[1:]):
        base = "mfcc" if g[1].startswith("mfcc") and g[1] != "mfcc" else g[1]
        by_feature.setdefault(base, []).append((float(g[3]), float(w[3])))
    growth = 1.0 if derivation == 0 else 2.0  # np.gradient's one-sided edges
    for feature, pairs in by_feature.items():
        g, w = np.array(pairs).T
        assert np.max(np.abs(g - w)) <= _bar(feature, w) * growth, feature


def test_cli_plot_writes_a_png(tmp_path, capsys):
    """`modmfcc-torch plot` renders the session's figure (matplotlib is
    present here), peaks in the region included."""
    out = tmp_path / "fig.png"
    rc = cli.main(["plot", WAV, "--out", str(out), "--features", "mod_cepstr,envelope,f0", "--region", "0.3",
                   "1.8", "--device", "cpu"])
    assert rc == 0 and capsys.readouterr().out.strip() == str(out)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and out.stat().st_size > 10_000
