"""Command-line interface of the PyTorch/CUDA port: verify / info.

    modmfcc-torch verify [--sr 16000] [--seconds 2] [--wav FILE] [--device cuda|cpu]
    modmfcc-torch info
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="modmfcc-torch", description="modulation-MFCC toolkit, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)
    ver = sub.add_parser("verify", help="parity harness vs the float64 oracle")
    ver.add_argument("--wav", help="optional WAV to verify on (default: synthetic)")
    ver.add_argument("--seconds", type=float, default=2.0, help="synthetic signal length (default 2.0)")
    ver.add_argument("--sr", type=int, default=10_000,
                     help="sample rate of the harness (default 10000, the reference's; the flagship is 16000)")
    ver.add_argument("--device", default="cuda", help="device to compute on (default cuda; cpu for the CPU)")
    sub.add_parser("info", help="print the torch/CUDA versions, the cards and the kernel build")
    args = p.parse_args(argv)

    from modulation_mfcc_tpu_torch.runner import run_info, run_verify

    return run_verify(args) if args.cmd == "verify" else run_info()


if __name__ == "__main__":
    raise SystemExit(main())
