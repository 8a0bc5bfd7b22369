"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` (with the ``*.cuh`` headers it includes) compiles with
its own nvcc process, all started together, and the objects link into one shared library with a plain C interface, at
first use, into ``modulation_mfcc_tpu_torch/_build/`` (listed in
.gitignore). The file name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached library.
Nothing here runs at import: the CPU-only test machine has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

from modulation_mfcc_tpu_torch.utils import obs

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math: it would turn log10f and division into approximations.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmodmfcc_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; their stderr, or raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}{err}")
    return [err for _, err in outs]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    ``verbose`` prints nvcc's ptxas report (registers, shared memory, spills),
    kept beside the library, so a cached build prints it too."""
    out = library_path()
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        if verbose and report.exists():
            print(report.read_text(), end="")
        return out
    with obs.setup_span("setup.library.build"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        sources = sorted(CSRC.glob("*.cu"))
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        reports = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources, objs)])
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
        for o in objs:
            o.unlink()
        report.write_text("".join(reports))
        if verbose:
            print("".join(reports), end="")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    with obs.setup_span("setup.library"):
        return ctypes.CDLL(str(build()))
