"""The system under test on its scan route: ``batched_mfcc_change`` as the
corpus sweep calls it for batches with an utterance shorter than
``min_frames_for_fir`` frames (entries/batched_mfcc_change.py, unchanged),
held to that route.

``build`` first imports the program's scan kernel
(``kernels/masked_scan``): a program without it runs the route as a
per-sample loop of ~10^5 launches a call, which the tracer cannot hold,
so the run stops there. ``prepare`` holds every batch to the scan route
(``masked_fir=False``, which takes any length), so that the cell measures
the route it names whatever lengths a batch has.

On CUDA a call runs on a compute stream of the adapter's own, and the
caller's stream waits for it before it copies the outputs to the host: a
call's result copy then overlaps the next call's compute, as a sweep that
keeps two batches in flight lets it, and the card's compute paces the cell.
At 1,024 utterances a call the results are 3.4-6.7 MB, whose copy took
0.11-0.14 ms of the caller's stream a call at a rate that differed between
processes (NVIDIA H100 80GB HBM3), enough to move a run's rate by 1 %.
"""
from __future__ import annotations

import importlib

import torch

from benchlib.catalog import plugin

SCAN_KERNEL = "modulation_mfcc_tpu_torch.kernels.masked_scan"


class ScanEntry:
    def __init__(self, entry, device):
        self.entry = entry
        device = torch.device(device)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def prepare(self, batch: dict):
        p = self.entry.prepare(batch)
        p.kwargs["masked_fir"] = False
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))  # the inputs are made
        return p

    def inputs(self, p):
        return self.entry.inputs(p)

    def __call__(self, p):
        if self.stream is None:
            return self.entry(p)
        caller = torch.cuda.current_stream(self.stream.device)
        with torch.cuda.stream(self.stream):
            outs = self.entry(p)
        caller.wait_stream(self.stream)
        for o in outs:
            o.record_stream(caller)  # kept from reuse until the caller's copy of it is done
        return outs


def build(config: dict, traffic: dict, device, *, control: bool = False) -> ScanEntry:
    try:
        importlib.import_module(SCAN_KERNEL)
    except ModuleNotFoundError as e:
        if e.name != SCAN_KERNEL:
            raise
        raise RuntimeError(f"this program has no {SCAN_KERNEL}: its scan route is a per-sample loop of ~10^5 "
                           "launches a call, which a traced run cannot hold; no result") from e
    return ScanEntry(plugin("entries", "batched_mfcc_change").build(config, traffic, device, control=control), device)
