"""PyTorch port: the ``modmfcc-torch verify`` parity harness (runner.py,
cli.py) is a shipped surface. On the CPU (``--device cpu``) all eleven
surfaces of the JAX package's harness pass against the port's float64
oracles, each printed as its own JSON line, then the verdict; ``info``
prints the versions and the kernel build. chip_smoke.py runs the harness on
the card at 10 and 16 kHz."""
import json

import pytest

from modulation_mfcc_tpu_torch.cli import main

SURFACES = {
    "mod_cepstr", "intensity", "pitch_ac", "pitch_cc", "minmax_quant",
    "pyin", "envelope_rms", "envelope_hilbert", "envelope_rmspraat",
    "formants", "padded_batch",
}


def json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.strip().splitlines() if line.startswith("{")]


@pytest.mark.parametrize("sr", [10_000, 16_000])
def test_verify_all_surfaces_pass_on_the_cpu(capsys, sr):
    """Exit 0, the eleven surface names of the JAX harness each passing in
    its own line, and overall_pass last; at the reference's 10 kHz and the
    flagship's 16 kHz."""
    rc = main(["verify", "--seconds", "1.2", "--device", "cpu", "--sr", str(sr)])
    lines = json_lines(capsys.readouterr().out)
    assert rc == 0, lines
    assert [line["surface"] for line in lines[:-1]] and {line["surface"] for line in lines[:-1]} == SURFACES
    assert len(lines) == len(SURFACES) + 1 and all(line["pass"] for line in lines[:-1])
    assert lines[-1] == {"overall_pass": True}


def test_info_reports_versions_and_build(capsys):
    assert main(["info"]) == 0
    (info,) = json_lines(capsys.readouterr().out)
    assert {"torch", "cuda", "cuda_available", "device_count", "devices", "kernels_built", "kernel_library"} <= set(info)
    assert info["kernel_library"].endswith(".so")
