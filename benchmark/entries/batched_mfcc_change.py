"""The system under test: ``modulation_mfcc_tpu_torch.parallel.batch.
batched_mfcc_change``, as the corpus sweep calls it.

``prepare`` turns a generated batch into the program's inputs once, in
set-up: the samples on the device as an ``AudioBatch`` (int16 hop rows packed
with the program's own ``pack_hop_rows`` where the traffic's layout is
"hop_rows"), and the route the sweep would pick (``masked_fir`` where every
utterance has at least ``min_frames_for_fir`` frames). A call returns the
device tensors (tot_change [B, NF], frame mask [B, NF]) without waiting.
"""
from __future__ import annotations

import dataclasses

import torch

from modulation_mfcc_tpu_torch.kernels.fused_frontend import pack_hop_rows
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import min_frames_for_fir
from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch, batched_mfcc_change


def mfcc_config(config: dict) -> MfccConfig:
    kw = {f.name: config[f.name] for f in dataclasses.fields(MfccConfig)}
    kw["outFiltCutOff"] = tuple(kw["outFiltCutOff"])
    return MfccConfig(**kw)


@dataclasses.dataclass
class Prepared:
    batch: AudioBatch
    kwargs: dict


class Entry:
    def __init__(self, config: dict, traffic: dict, device, spectrum: str):
        self.cfg = mfcc_config(config)
        self.traffic = traffic
        self.device = torch.device(device)
        self.spectrum = spectrum
        self.min_frames = min_frames_for_fir(self.cfg)

    def prepare(self, batch: dict) -> Prepared:
        cfg, traffic = self.cfg, self.traffic
        samples = batch["samples"].to(self.device)
        lengths = torch.as_tensor(batch["lengths"], device=self.device)
        kwargs = {"spectrum": self.spectrum, "uniform_lengths": bool(traffic["uniform_lengths"])}
        if traffic["layout"] == "hop_rows":
            kwargs["n_samples"] = samples.shape[-1]
            samples = pack_hop_rows(samples, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length)
        elif traffic["layout"] != "flat":
            raise ValueError(f"unknown layout {traffic['layout']!r}")
        if not kwargs["uniform_lengths"]:
            shortest = 1 + int(batch["lengths"].min()) // cfg.hop_length
            kwargs["masked_fir"] = self.min_frames is not None and shortest >= self.min_frames
        return Prepared(AudioBatch(samples.contiguous(), lengths), kwargs)

    def inputs(self, p: Prepared) -> list[torch.Tensor]:
        return [p.batch.samples, p.batch.lengths]

    def __call__(self, p: Prepared) -> tuple[torch.Tensor, torch.Tensor]:
        return batched_mfcc_change(p.batch, self.cfg, **p.kwargs)


def build(config: dict, traffic: dict, device, *, control: bool = False) -> Entry:
    """The entry at the configuration's spectrum, or with ``control`` at its
    lower-precision route (the control of the comparison)."""
    return Entry(config, traffic, device, config["control_spectrum" if control else "spectrum"])
