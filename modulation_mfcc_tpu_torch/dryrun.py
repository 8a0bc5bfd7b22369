"""Dry run of the distributed paths over a world of ranks.

    python -m modulation_mfcc_tpu_torch.dryrun --world 4 --device cpu    # gloo, 4 processes
    python -m modulation_mfcc_tpu_torch.dryrun --world 2 --device cuda   # NCCL, one GPU a rank

:func:`spawn` starts ``world`` processes (the ``spawn`` start method), joins
them into one process group (gloo on the CPU, NCCL with rank r on
``cuda:r``; a file rendezvous in a temporary directory) and runs the named
rank programs of :data:`PROGRAMS` in each, in order; every rank's results
come back to the caller. :func:`certify` runs the data-sharded
(``sharded_mfcc_change``, also on a batch the axis does not divide), extras
(the sweep's tracker extras on each rank's rows, all-gathered), time-sharded
(``sharded_longform_mfcc_change``) and, at four ranks or more, multislice
paths, and holds each against the unsharded result computed in the same
rank (the checks of the JAX package's ``dryrun_multichip``); :func:`mesh_sweep`
runs the corpus sweep over a ("data", "time") mesh. The programs live here,
importable by name, so the spawned children find them.
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from modulation_mfcc_tpu_torch.models.config import AmplitudeConfig, F0Config, FormantConfig, MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import mfcc_change
from modulation_mfcc_tpu_torch.parallel import corpus
from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch, batched_mfcc_change, sharded_mfcc_change
from modulation_mfcc_tpu_torch.parallel.mesh import axis_index, axis_size, gather_rows, make_mesh, shard_rows
from modulation_mfcc_tpu_torch.parallel.multislice import make_multislice_mesh, multislice_sharded_mfcc_change
from modulation_mfcc_tpu_torch.parallel.streaming import sharded_longform_mfcc_change

__all__ = ["spawn", "certify", "mesh_sweep", "dryrun_inputs", "dryrun_multichip", "PROGRAMS"]

EXTRA_FEATURES = ("f0", "envelope", "formants", "mfcc39")
# the extras' bars against the unsharded batch: formants and bandwidths (Hz,
# float32 Burg at another batch width) to the trackers' 0.05 Hz
EXTRA_BARS = {"formants": 0.05, "formant_bw": 0.05}


def dryrun_inputs(world: int) -> dict:
    """The dry run's own inputs (JAX ``dryrun_multichip``'s shapes): a
    ragged batch of 2·world + 1 noise utterances of 4,000-5,000 samples and
    a 68,321-sample signal, at MfccConfig(n_fft=256, n_mels=40)."""
    rng = np.random.default_rng(0)
    sigs = [rng.standard_normal(4000 + 500 * (i % 3)).astype(np.float32) for i in range(2 * world + 1)]
    samples = np.zeros((len(sigs), 5120), np.float32)
    for i, s in enumerate(sigs):
        samples[i, : len(s)] = s
    return dict(cfg=MfccConfig(n_fft=256, n_mels=40), samples=samples,
                lengths=np.array([len(s) for s in sigs], np.int64),
                long=[rng.standard_normal(64_000 + 4321).astype(np.float32)], spectrum="fused")


def _close(what: str, got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not err <= atol:
        raise AssertionError(f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}, max-abs {err:.3e} (bar {atol:g})")
    return err


def certify(world: int, device: torch.device, *, cfg: MfccConfig, samples: np.ndarray, lengths: np.ndarray,
            long: list[np.ndarray], spectrum: str = "fused", long_cfg: MfccConfig | None = None) -> dict:
    """Every distributed path on this world against the unsharded result of
    the same rank; raises on the first disagreement. Returns the sharded
    results (numpy) and each check's max-abs error."""
    out, errs = {}, {}
    full = AudioBatch(torch.as_tensor(samples, device=device), torch.as_tensor(lengths, device=device))

    def unsharded(b: AudioBatch):
        tot, mask = batched_mfcc_change(b, cfg, spectrum=spectrum)
        return tot, mask, (tot.double() * mask).sum() / torch.clamp(mask.double().sum(), min=1.0)

    mesh = make_mesh(world, 1, device_type=device.type)
    for label, b in (("data", full), ("data_uneven", AudioBatch(full.samples[:-1], full.lengths[:-1]))):
        tot, mask, mean = sharded_mfcc_change(b, cfg, mesh, spectrum=spectrum)
        ref_tot, ref_mask, ref_mean = unsharded(b)
        errs[label] = _close(f"{label}-sharded extraction vs unsharded", tot * mask, ref_tot * ref_mask, 1e-5)
        _close(f"{label}-sharded frame mask", mask, ref_mask, 0.0)
        _close(f"{label}-sharded corpus mean", mean.reshape(1), ref_mean.reshape(1), 1e-5 * abs(float(ref_mean)))
        out[label] = (tot.cpu().numpy(), mask.cpu().numpy(), float(mean))

    # the sweep's tracker extras on this rank's rows, all-gathered
    dims = ("data",)
    n_blocks, block = axis_size(mesh, dims), axis_index(mesh, dims)
    feats, f0cfg, acfg, fmcfg = EXTRA_FEATURES, F0Config(), AmplitudeConfig(), FormantConfig()
    local = corpus._extras(shard_rows(full.samples, n_blocks, block), shard_rows(full.lengths, n_blocks, block),
                           cfg, spectrum, feats, f0cfg, acfg, fmcfg)
    ref = corpus._extras(full.samples, full.lengths, cfg, spectrum, feats, f0cfg, acfg, fmcfg)
    n = full.batch_size
    for key, (vals, valid) in local.items():
        vals, valid = gather_rows(vals, mesh, dims)[:n], gather_rows(valid, mesh, dims)[:n]
        _close(f"sharded extra {key!r} valid mask", valid.float(), ref[key][1].float(), 0.0)
        fin = torch.isfinite(ref[key][0])
        _close(f"sharded extra {key!r} NaN pattern", torch.isfinite(vals).float(), fin.float(), 0.0)
        errs[f"extra_{key}"] = _close(f"sharded extra {key!r} vs unsharded", torch.where(fin, vals, 0.0),
                                      torch.where(fin, ref[key][0], 0.0), EXTRA_BARS.get(key, 1e-4))
        out[f"extra_{key}"] = (vals.cpu().numpy(), valid.cpu().numpy())

    # the time-sharded long form
    long_cfg = long_cfg or cfg
    tmesh = make_mesh(1, world, device_type=device.type)
    out["long"] = []
    for i, y in enumerate(long):
        yt = torch.as_tensor(y, device=device)
        got = sharded_longform_mfcc_change(yt, long_cfg, tmesh)
        errs[f"long_{i}"] = _close(f"time-sharded long-form ({len(y)} samples) vs whole-file", got,
                                   mfcc_change(yt, long_cfg), 1e-5)
        out["long"].append(got.cpu().numpy())

    # the ('slice', 'data', 'time') layout
    if world >= 4 and world % 2 == 0:
        msmesh = make_multislice_mesh(2, world // 2, 1, device_type=device.type)
        tot, mask, mean = multislice_sharded_mfcc_change(full, cfg, msmesh, spectrum=spectrum)
        ref_tot, ref_mask, ref_mean = unsharded(full)
        errs["multislice"] = _close("multislice-sharded extraction vs unsharded", tot * mask, ref_tot * ref_mask,
                                    1e-5)
        _close("multislice corpus mean", mean.reshape(1), ref_mean.reshape(1), 1e-5 * abs(float(ref_mean)))
        out["multislice"] = (tot.cpu().numpy(), mask.cpu().numpy(), float(mean))
    out["errors"] = errs
    return out


def mesh_sweep(world: int, device: torch.device, *, paths: list[str], out_dir: str, **sweep_kw) -> dict:
    """The corpus sweep over a (world, 1) ("data", "time") mesh into
    ``out_dir``; this rank's report."""
    mesh = make_mesh(world, 1, device_type=device.type)
    return corpus.sweep_mfcc_change(paths, corpus.CorpusSweep(out_dir, mesh=mesh, device=device, **sweep_kw))


PROGRAMS = {"certify": certify, "mesh_sweep": mesh_sweep}


def _rank_main(rank: int, world: int, device_type: str, store: str, programs: list, result_dir: str) -> None:
    torch.set_num_threads(1)
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    try:
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=timedelta(seconds=60))
        try:
            results = [PROGRAMS[name](world, device, **kw) for name, kw in programs]
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(result_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(result_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def spawn(world: int, programs: list[tuple[str, dict]], *, device: str = "cpu", timeout_s: float = 300.0) -> list:
    """Run ``programs`` [(name in PROGRAMS, keyword arguments)] in order in
    each rank of a new world of ``world`` processes; returns each rank's
    list of results. Raises when a rank fails (with its traceback) or the
    world is not done within ``timeout_s`` (its processes are then killed)."""
    if device == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"a world of {world} NCCL ranks needs {world} GPUs, have {torch.cuda.device_count()}")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="modmfcc_dryrun_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world, device, store, programs, tmp), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = {r: open(os.path.join(tmp, f"rank{r}.err")).read() for r in range(world)
                  if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
        if errors:
            raise RuntimeError("dry-run rank(s) failed:\n" + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
        if hung:
            raise TimeoutError(f"dry-run ranks {hung} of {world} still running after {timeout_s:g} s")
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad:
            raise RuntimeError(f"dry-run ranks exited with codes {bad}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:  # written by this run's ranks
                results.append(pickle.load(f))
    return results


def dryrun_multichip(world: int, device: str = "cpu", *, timeout_s: float = 300.0) -> dict:
    """:func:`certify` on :func:`dryrun_inputs` over a world of ``world``
    ranks; rank 0's per-check max-abs errors."""
    return spawn(world, [("certify", dryrun_inputs(world))], device=device, timeout_s=timeout_s)[0][0]["errors"]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m modulation_mfcc_tpu_torch.dryrun", description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=2, help="ranks (processes) to spawn")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"), help="gloo on the CPU or NCCL on GPUs")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    errs = dryrun_multichip(args.world, args.device)
    print({"world": args.world, "device": args.device, "seconds": round(time.perf_counter() - t0, 3), "max_abs": errs})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
