"""Typed configuration of the pipelines and the reference's JSON schema.

The reference's config surface is the nested dict its config dialog
produces (script/config_dialog.py:604-725: sections ``mfcc``,
``amplitude``, ``formant1..3``, ``f0``, ``ema``) and persists as JSON
(config_dialog.py:574-590). These frozen dataclasses take and emit that
schema with the same field names and defaults (``tStep``, ``winLen``,
``outFiltCutOff``, ...) as the JAX package's ``models/config.py``. Frozen,
so a config can key the host design caches.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

__all__ = [
    "MfccConfig",
    "AmplitudeConfig",
    "FormantConfig",
    "F0Config",
    "EmaConfig",
    "DerivationConfig",
    "SectionMeta",
    "PipelineConfig",
    "config_from_reference_json",
    "config_to_reference_json",
    "save_config",
    "load_config",
]


@dataclass(frozen=True)
class DerivationConfig:
    """Velocity/acceleration derivation settings shared by every feature row
    (reference: script/main.py:946-956 CurveGenerator defaults, and the
    ``derivative_method``/``sg_width``/... keys of each config section)."""

    derivation_type: int = 0  # 0 trajectory, 1 velocity, 2 acceleration
    derivative_method: str = "gradient"  # gradient | sg | finDiff
    sg_width: int = 3
    fin_diff_acc_order: int = 2
    sg_poly_order: int = 2


@dataclass(frozen=True)
class SectionMeta:
    """Dialog-row metadata of one config section: the ``enabled``/``name``/
    ``panel`` keys plus the per-section derivation settings every section of
    the reference JSON carries (config_dialog.py:604-725). Kept separate from
    the DSP configs so those stay minimal cache keys."""

    enabled: bool = True
    name: str = ""
    panel: int = 0
    derivation: DerivationConfig = field(default_factory=DerivationConfig)


@dataclass(frozen=True)
class MfccConfig:
    """Parameters of get_MFCCS_change (reference script/mfcc.py:291-310 defaults,
    overridden by the GUI to the values of script/main.py:732-748)."""

    signal_sample_rate: int = 10_000
    channelN: int = 0  # multichannel selection (script/mfcc.py:295, :377-380)
    tStep: float = 0.005
    winLen: float = 0.025
    n_mfcc: int = 13
    n_fft: int = 512
    minFreq: float = 100.0
    maxFreq: float = 10_000.0
    removeFirst: int = 1
    filtCutoff: float = 12.0
    filtOrd: int = 6
    diffMethod: str = "grad"
    outFilter: str | None = "iir"
    outFiltType: str = "low"
    outFiltCutOff: tuple = (12.0,)
    outFiltLen: int = 6
    outFiltPolyOrd: int = 3
    n_mels: int = 128

    @property
    def win_length(self) -> int:
        return int(self.winLen * self.signal_sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.tStep * self.signal_sample_rate)


@dataclass(frozen=True)
class AmplitudeConfig:
    """Parameters of get_amplitude / calculate_amplitude_envelope
    (reference script/mfcc.py:137-150)."""

    method: str = "RMS"  # RMS | RMSpraat | Hilb
    winLen: float = 0.1
    hopLen: float = 0.01
    center: bool = True
    outFilter: str | None = None
    outFiltType: str = "low"
    outFiltCutOff: tuple = (12.0,)
    outFiltLen: int = 6
    outFiltPolyOrd: int = 3


@dataclass(frozen=True)
class FormantConfig:
    """Parameters of calc_formants (reference script/calc.py:131-141)."""

    energy_threshold: float = 20.0
    time_step: float = 0.005
    max_num_formants: int = 5
    max_formant: float = 5500.0
    window_length: float = 0.025
    pre_emphasis_from: float = 50.0


@dataclass(frozen=True)
class F0Config:
    """Parameters of get_f0 (reference script/calc.py:386-420)."""

    method: str = "praatac"  # praatac | praatcc | pyin
    hopSize: float = 0.01
    minPitch: float = 75.0
    maxPitch: float = 600.0
    interpUnvoiced: str | None = "linear"
    outFilter: str | None = "iir"
    outFiltType: str = "low"
    outFiltCutOff: tuple = (12.0,)
    outFiltLen: int = 6
    outFiltPolyOrd: int = 3
    # Praat-specific cost parameters (script/calc.py:400-406)
    minMaxQuant: tuple | None = None
    maxCandNum: int = 15
    veryAccurate: bool = False
    silenceThresh: float = 0.03
    voicingThresh: float = 0.45
    octaveCost: float = 0.01
    octaveJumpCost: float = 0.35
    voicedUnvoicedCost: float = 0.14
    # pyin-specific (script/calc.py:408-419)
    pyinframe_length: int = 2048
    pyinwin_length: int | None = None
    n_thresholds: int = 100
    beta_parameters: tuple = (2, 18)
    boltzmann_parameter: int = 2
    resolution: float = 0.1
    max_transition_rate: float = 35.92
    switch_prob: float = 0.01
    no_trough_prob: float = 0.01
    # (script/calc.py:417-419) — fill value for unvoiced frames (None = NaN;
    # NaN itself would break dataclass equality and hashing),
    # centered framing flag, and pad mode for the centered frames
    pyinfill_na: float | None = None
    pyincenter: bool = True
    pyinpad_mode: str = "constant"


@dataclass(frozen=True)
class EmaConfig:
    """EMA (.pos) resampling parameters (reference config_dialog.py 'ema')."""

    target_sample_rate: int = 200


#: sections carrying SectionMeta (the reference's ema section has only the
#: derivative keys — no enabled/name/panel/derivation_type).
_META_SECTIONS = ("mfcc", "amplitude", "formant1", "formant2", "formant3", "f0", "ema")


@dataclass(frozen=True)
class PipelineConfig:
    """A full analysis configuration = one saved config-dialog JSON."""

    mfcc: MfccConfig = field(default_factory=MfccConfig)
    amplitude: AmplitudeConfig = field(default_factory=AmplitudeConfig)
    formant1: FormantConfig = field(default_factory=FormantConfig)
    formant2: FormantConfig = field(default_factory=FormantConfig)
    formant3: FormantConfig = field(default_factory=FormantConfig)
    f0: F0Config = field(default_factory=F0Config)
    ema: EmaConfig = field(default_factory=EmaConfig)
    mfcc_meta: SectionMeta = field(default_factory=SectionMeta)
    amplitude_meta: SectionMeta = field(default_factory=SectionMeta)
    formant1_meta: SectionMeta = field(default_factory=SectionMeta)
    formant2_meta: SectionMeta = field(default_factory=SectionMeta)
    formant3_meta: SectionMeta = field(default_factory=SectionMeta)
    f0_meta: SectionMeta = field(default_factory=SectionMeta)
    ema_meta: SectionMeta = field(default_factory=SectionMeta)

    def meta_for(self, section: str) -> SectionMeta:
        """SectionMeta of a config section ('mfcc', 'amplitude', ...)."""
        if section not in _META_SECTIONS:
            raise ValueError(f"Unknown config section {section!r}")
        return getattr(self, f"{section}_meta")


_DERIV_KEYS = {"derivative_method", "sg_width", "fin_diff_acc_order", "sg_poly_order"}
_SKIP_KEYS = {"enabled", "name", "panel", "derivation_type"} | _DERIV_KEYS


def _section_to_meta(section: dict) -> SectionMeta:
    """Per-section derivation/dialog keys → SectionMeta (the keys the DSP
    dataclasses skip; dropping them used to lose the saved derivation)."""
    dkw = {k: section[k] for k in _DERIV_KEYS if k in section}
    if "derivation_type" in section:
        dkw["derivation_type"] = int(section["derivation_type"])
    return SectionMeta(
        enabled=bool(section.get("enabled", True)),
        name=str(section.get("name", "")),
        panel=int(section.get("panel", 0)),
        derivation=DerivationConfig(**dkw),
    )


def _section_to_config(cls, section: dict, extra_map: dict[str, str] | None = None):
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in section.items():
        if k in _SKIP_KEYS:
            continue
        key = (extra_map or {}).get(k, k)
        if key not in known:
            continue
        if isinstance(v, list):
            v = tuple(v)
        kwargs[key] = v
    return cls(**kwargs)


def config_from_reference_json(data: str | dict) -> PipelineConfig:
    """Load a reference config-dialog JSON (config_dialog.py:574-590 format)."""
    if isinstance(data, str):
        data = json.loads(data)
    return PipelineConfig(
        mfcc=_section_to_config(MfccConfig, data.get("mfcc", {})),
        amplitude=_section_to_config(AmplitudeConfig, data.get("amplitude", {})),
        formant1=_section_to_config(FormantConfig, data.get("formant1", {})),
        formant2=_section_to_config(FormantConfig, data.get("formant2", {})),
        formant3=_section_to_config(FormantConfig, data.get("formant3", {})),
        f0=_section_to_config(F0Config, data.get("f0", {})),
        ema=_section_to_config(EmaConfig, data.get("ema", {})),
        **{
            f"{s}_meta": _section_to_meta(data.get(s, {})) for s in _META_SECTIONS
        },
    )


def save_config(cfg: PipelineConfig, path: str) -> str:
    """Persist in the reference dialog's JSON format (config_dialog.py:574-583
    save_parameters equivalent)."""
    with open(path, "w") as f:
        json.dump(config_to_reference_json(cfg), f, indent=2)
    return path


def load_config(path: str) -> PipelineConfig:
    """Load a saved analysis config (config_dialog.py:584-590 equivalent)."""
    with open(path) as f:
        return config_from_reference_json(json.load(f))


def config_to_reference_json(cfg: PipelineConfig) -> dict:
    """Emit the reference's nested-dict schema (lists for cutoff tuples),
    including each section's enabled/name/panel + derivation keys
    (config_dialog.py:604-725). The ema section carries only the derivative
    keys, matching the reference's dialog output."""

    def conv(obj):
        d = dataclasses.asdict(obj)
        return {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}

    def meta_keys(meta: SectionMeta, *, ema: bool = False) -> dict:
        d = dataclasses.asdict(meta.derivation)
        if ema:
            d.pop("derivation_type")
            return d
        return {"enabled": meta.enabled, "name": meta.name, "panel": meta.panel, **d}

    out = {}
    for s in _META_SECTIONS:
        out[s] = {
            **conv(getattr(cfg, s)),
            **meta_keys(cfg.meta_for(s), ema=(s == "ema")),
        }
    return out
