"""Command-line interface of the PyTorch/CUDA port: extract / plot / sweep / verify / info.

    modmfcc-torch extract a.wav b.wav --features mod_cepstr,f0 [--derivation 1] [--config cfg.json] [--out feats.csv]
    modmfcc-torch plot a.wav --out fig.png [--features mod_cepstr,envelope,f0] [--textgrid a.TextGrid]
                       [--region 0.5 1.5]
    modmfcc-torch sweep corpus/ --out feats/ [--features mod_cepstr,mfcc39,f0,envelope,formants]
                        [--spectrum fused_i16] [--batch-size 32] [--no-resume] [--num-shards 4 --shard-id 0]
    modmfcc-torch verify [--sr 16000] [--seconds 2] [--wav FILE] [--device cuda|cpu]
    modmfcc-torch info

Every command but info computes on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="modmfcc-torch", description="modulation-MFCC toolkit, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "device to compute on (default cuda; cpu for the CPU)"

    ex = sub.add_parser("extract", help="extract features from WAV file(s)")
    ex.add_argument("inputs", nargs="+", help="WAV files")
    ex.add_argument("--config", help="reference-schema JSON config file")
    ex.add_argument("--features", default="mod_cepstr",
                    help="comma list: mod_cepstr, mfcc, envelope, f0, formant1, formant2, formant3, soundwave")
    ex.add_argument("--out", default="-", help="output CSV path or - for stdout")
    ex.add_argument("--derivation", type=int, default=0, choices=(0, 1, 2),
                    help="0 trajectory, 1 velocity, 2 acceleration")
    ex.add_argument("--device", default="cuda", help=device_help)

    ver = sub.add_parser("verify", help="parity harness vs the float64 oracle")
    ver.add_argument("--wav", help="optional WAV to verify on (default: synthetic)")
    ver.add_argument("--seconds", type=float, default=2.0, help="synthetic signal length (default 2.0)")
    ver.add_argument("--sr", type=int, default=10_000,
                     help="sample rate of the harness (default 10000, the reference's; the flagship is 16000)")
    ver.add_argument("--device", default="cuda", help=device_help)

    sub.add_parser("info", help="print the torch/CUDA versions, the cards and the kernel build")

    sw = sub.add_parser("sweep", help="corpus sweep: many WAVs → npz feature store")
    sw.add_argument("inputs", nargs="+", help="WAV files or directories")
    sw.add_argument("--out", required=True, help="output directory")
    sw.add_argument("--config", help="reference-schema JSON config file")
    sw.add_argument("--batch-size", type=int, default=32)
    sw.add_argument("--spectrum", default="auto",
                    choices=("auto", "fft", "matmul", "fused", "fused_bf16", "fused_x3", "fused_i16", "fused_i24"),
                    help="'auto' = fused")
    sw.add_argument("--features", default="mod_cepstr", help="comma list: mod_cepstr, mfcc39, f0, envelope, formants")
    sw.add_argument("--no-resume", action="store_true")
    sw.add_argument("--num-shards", type=int, default=1, help="multi-process scale-out: total manifest shards")
    sw.add_argument("--shard-id", type=int, default=0, help="this process's shard index (0-based)")
    sw.add_argument("--device", default="cuda", help=device_help)

    pv = sub.add_parser("plot", help="render an analysis figure for a WAV")
    pv.add_argument("wav")
    pv.add_argument("--out", required=True, help="output PNG path")
    pv.add_argument("--features", default="mod_cepstr,envelope,f0", help="comma list of curves")
    pv.add_argument("--textgrid", help="optional TextGrid overlay")
    pv.add_argument("--config", help="reference-schema JSON config file")
    pv.add_argument("--region", nargs=2, type=float, metavar=("START", "END"),
                    help="selection region; peaks are analyzed inside it")
    pv.add_argument("--device", default="cuda", help=device_help)
    args = p.parse_args(argv)

    from modulation_mfcc_tpu_torch import runner

    commands = {"extract": runner.run_extract, "plot": runner.run_plot, "sweep": runner.run_sweep,
                "verify": runner.run_verify}
    return commands[args.cmd](args) if args.cmd in commands else runner.run_info()


if __name__ == "__main__":
    raise SystemExit(main())
