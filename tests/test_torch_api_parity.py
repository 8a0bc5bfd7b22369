"""PyTorch port: its public surface against the JAX package's, module by
module.

For every module of ``modulation_mfcc_tpu`` (``pallas/*`` aside: its
counterparts are ``kernels/*``, held by the kernel tests, and
``pallas/knobs.py`` holds TPU switches), the module of the same path in
``modulation_mfcc_tpu_torch`` must define every public callable the JAX
module defines, and each class every public method; each must take every
parameter of the JAX signature, with the same default. The allow-lists
below are the record of what the port leaves out and why: ``NOT_PORTED``
(names), ``DROPPED`` (parameters) and ``DEFAULTS_DIFFER`` (defaults), each
entry with its reason. Every entry must still describe a real difference,
so the lists cannot go stale. The package's top-level names and the CLI's
subcommands and options are held the same way."""
import argparse
import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import modulation_mfcc_tpu as jax_pkg
import modulation_mfcc_tpu_torch as mt

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "modulation_mfcc_tpu"


def jax_modules() -> list[str]:
    """The JAX package's modules, relative to it ('' for the package),
    found on disk so that collection imports nothing."""
    names = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = path.relative_to(JAX_ROOT).with_suffix("").parts
        if parts[0] == "pallas":
            continue
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


MODULES = jax_modules()

USE_FFT = ("JAX's switch from before `spectrum`, read only when spectrum is None "
           "(modulation_mfcc_tpu/models/modulation.py:87-88); the port names spectrum='fft' or 'matmul'")
BUCKET = ("one jit compile per bucket of padded lengths (modulation_mfcc_tpu/models/modulation.py:380-384); "
          "eager PyTorch compiles nothing, so the port runs each utterance at its exact length")
PRECISION = ("a jax.lax.Precision for the filter matmuls, DEFAULT only in JAX's bf16 corpus mode; the port "
             "filters in float32 at 'highest' in every mode (ROADMAP, Not to port)")
MXU_ENGINE = ("selects JAX's 'mxu' engines, TPU matrix-unit forms of the same function (ROADMAP, Not to "
              "port); the port computes with its plain form or its CUDA kernel")
KW_FORWARDED = ("JAX forwards **kw to its jitted body; the port names each of that body's keywords "
                "(test_forwarded_keywords_are_named)")
DEVICES = "a list of JAX devices; the port's meshes span the ranks of torch.distributed and take device_type"
FIR_A = ("the denominator of JAX's transversal filtfilt, which it only ever passes as [1] "
         "(modulation_mfcc_tpu/ops/filters.py:414, models/modulation.py:271); the port's FIR form is that case")
SPECTRUM_DEFAULT = ("JAX's None means 'fft' (through use_fft); the port's default is its hand-written CUDA "
                    "frontend, 'fused', the counterpart of JAX's 'pallas' f32 mode (README)")

NOT_PORTED = {
    "ops.interp.jax_cummax": "a running max written for XLA; torch has torch.cummax",
    "ops.savgol.savgol_filter_jax": "the same function is the port's ops.savgol.savgol_filter",
    "parallel.mesh.data_sharding": ("a JAX NamedSharding over a device mesh; the port shards rows over "
                                    "torch.distributed ranks (parallel.batch.shard_rows)"),
    "parallel.batch.AudioBatch.tree_flatten": "JAX pytree registration; torch passes an AudioBatch as it is",
    "parallel.batch.AudioBatch.tree_unflatten": "JAX pytree registration; torch passes an AudioBatch as it is",
}

DROPPED = {
    "models.modulation.mfcc_trajectories": {"use_fft": USE_FFT},
    "models.modulation.mfcc_change": {"use_fft": USE_FFT},
    "models.modulation.extract_mfcc_change": {"use_fft": USE_FFT, "bucket": BUCKET},
    "models.modulation.extract_mfcc_matrix": {"bucket": BUCKET},
    "models.modulation.modulation_spectrum": {"use_fft": USE_FFT},
    "parallel.batch.batched_mfcc_change": {"use_fft": USE_FFT},
    "parallel.batch.sharded_mfcc_change": {"use_fft": USE_FFT},
    "ops.filters.sosfiltfilt": {"precision": PRECISION},
    "ops.filters.sosfiltfilt_fir": {"precision": PRECISION},
    "ops.filters.filtfilt": {"a": FIR_A},
    "ops.masked.masked_filtfilt": {"a": FIR_A},
    "ops.pitch.pitch_ac": {"kw": KW_FORWARDED},
    "ops.yin.pyin_f0": {"cmndf_engine": MXU_ENGINE, "kw": KW_FORWARDED},
    "ops.resample.resample_poly_device": {
        "block_rows": ("the rows of JAX's blocked conv, a TPU staging choice that changes no result "
                       "(test_block_rows_changes_no_result); the port blocks by block_threshold alone"),
    },
    "parallel.mesh.make_mesh": {"devices": DEVICES},
    "parallel.multislice.make_multislice_mesh": {"devices": DEVICES},
    "parallel.multislice.init_distributed": {
        name: ("jax.distributed's coordinator arguments; the port takes torch.distributed's "
               "init_method, world_size and rank")
        for name in ("coordinator_address", "num_processes", "process_id")
    },
}

DEFAULTS_DIFFER = {
    f"{module}.{fn}": {"spectrum": SPECTRUM_DEFAULT}
    for module, fns in {
        "models.modulation": ("mfcc_trajectories", "mfcc_change", "extract_mfcc_change", "extract_mfcc_matrix",
                              "modulation_spectrum"),
        "parallel.batch": ("batched_mfcc_change", "sharded_mfcc_change"),
        "parallel.multislice": ("multislice_sharded_mfcc_change",),
    }.items()
    for fn in fns
}

# the JAX CLI's subcommands the port's CLI does not have
CLI_NOT_PORTED = {"bench": "runs bench.py, the JAX package's TPU benchmark; the port's own is ROADMAP A.17"}
# JAX functions that forward **kw to a jitted body: (JAX module, body) whose keywords the port must name
FORWARDED = {"ops.pitch.pitch_ac": ("ops.pitch", "_pitch_ac_jit"), "ops.yin.pyin_f0": ("ops.yin", "_pyin_f0_jit")}


def modules(rel: str):
    """(the JAX module, the port's module of the same path)."""
    suffix = f".{rel}" if rel else ""
    return (importlib.import_module(f"modulation_mfcc_tpu{suffix}"),
            importlib.import_module(f"modulation_mfcc_tpu_torch{suffix}"))


def qualified(rel: str, name: str) -> str:
    return f"{rel}.{name}" if rel else name


def public_callables(module) -> dict:
    """Every public callable the module itself defines."""
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and callable(v) and not inspect.ismodule(v)
            and getattr(v, "__module__", None) == module.__name__}


def public_methods(cls) -> dict:
    """The class's own public methods and properties."""
    return {k: v for k, v in vars(cls).items()
            if not k.startswith("_") and (callable(v) or isinstance(v, (staticmethod, classmethod, property)))}


def same_default(a, b) -> bool:
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return type(a).__name__ == type(b).__name__ and dataclasses.asdict(a) == dataclasses.asdict(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    try:
        return bool(a == b)
    except Exception:
        return a is b


def signature_gaps(name: str, jax_fn, port_fn) -> list[str]:
    """The parameters and defaults of ``jax_fn`` that ``port_fn`` lacks and
    no allow-list names."""
    js, ps = inspect.signature(jax_fn).parameters, inspect.signature(port_fn).parameters
    dropped, differ = DROPPED.get(name, {}), DEFAULTS_DIFFER.get(name, {})
    gaps = []
    for p in js.values():
        if p.name in dropped:
            continue
        if p.name not in ps:
            gaps.append(f"{name}: parameter {p.name!r}")
        elif p.name not in differ and not same_default(p.default, ps[p.name].default):
            gaps.append(f"{name}: default of {p.name!r} is {ps[p.name].default!r}, JAX's {p.default!r}")
    return gaps


@pytest.mark.parametrize("rel", MODULES, ids=[m or "__init__" for m in MODULES])
def test_module_surface_matches_jax(rel):
    """Every public callable of the JAX module (and every public method of
    its classes) is in the port's module with every parameter and default,
    or is in an allow-list."""
    jm, pm = modules(rel)
    gaps = []
    for name, obj in public_callables(jm).items():
        q = qualified(rel, name)
        if q in NOT_PORTED:
            continue
        port = getattr(pm, name, None)
        if port is None:
            gaps.append(f"{q}: missing")
            continue
        gaps += signature_gaps(q, obj, port)
        if inspect.isclass(obj):
            for mname, member in public_methods(obj).items():
                mq = f"{q}.{mname}"
                if mq in NOT_PORTED:
                    continue
                if not hasattr(port, mname):
                    gaps.append(f"{mq}: missing")
                elif callable(member) and callable(getattr(port, mname)):
                    gaps += signature_gaps(mq, getattr(obj, mname), getattr(port, mname))
    assert not gaps, "the port lacks:\n" + "\n".join(gaps)


def resolve(q: str):
    """The JAX object and the port's object (None where absent) of a
    qualified name from an allow-list."""
    rel = next(m for m in sorted(MODULES, key=len, reverse=True) if q.startswith(f"{m}."))
    jm, pm = modules(rel)
    jax_obj, port_obj = jm, pm
    for part in q[len(rel) + 1:].split("."):
        jax_obj, port_obj = getattr(jax_obj, part), getattr(port_obj, part, None)
    return jax_obj, port_obj


def test_allow_lists_are_exact():
    """Each entry has a written reason and still names a real difference:
    a NOT_PORTED name the JAX package defines and the port does not, a
    DROPPED parameter JAX's signature has and the port's lacks, a
    DEFAULTS_DIFFER default that differs."""
    for q, reason in NOT_PORTED.items():
        jax_obj, port_obj = resolve(q)
        assert reason.strip() and callable(jax_obj) and port_obj is None, q
    for q, params in DROPPED.items():
        jax_obj, port_obj = resolve(q)
        js, ps = inspect.signature(jax_obj).parameters, inspect.signature(port_obj).parameters
        for p, reason in params.items():
            assert reason.strip() and p in js and p not in ps, f"{q}: {p}"
    for q, params in DEFAULTS_DIFFER.items():
        jax_obj, port_obj = resolve(q)
        js, ps = inspect.signature(jax_obj).parameters, inspect.signature(port_obj).parameters
        for p, reason in params.items():
            assert reason.strip() and not same_default(js[p].default, ps[p].default), f"{q}: {p}"
    for sub, reason in CLI_NOT_PORTED.items():
        assert reason.strip() and sub in cli_options(jax_pkg_cli()) and sub not in cli_options(mt_cli()), sub


def test_forwarded_keywords_are_named():
    """Where JAX's signature ends in **kw passed to its jitted body, the
    port's signature names every keyword of that body (DROPPED aside)."""
    for q, (rel, body) in FORWARDED.items():
        jax_obj, port_obj = resolve(q)
        inner = getattr(modules(rel)[0], body)
        inner = getattr(inner, "__wrapped__", inner)
        ps = inspect.signature(port_obj).parameters
        missing = [p for p in inspect.signature(inner).parameters
                   if p not in ps and p not in DROPPED.get(q, {})]
        assert not missing, f"{q} lacks {missing} of {body}"


def test_top_level_names_match_jax():
    """Every public name at the JAX package's top level (its modules aside)
    is at the port's, and so is its version."""
    names = [k for k, v in vars(jax_pkg).items() if not k.startswith("_") and not inspect.ismodule(v)]
    assert {"extract_mfcc", "extract_modulation", "MfccConfig", "mfcc_change"} <= set(names)
    missing = [k for k in names if not hasattr(mt, k)]
    assert not missing, f"the port's top level lacks {missing}"
    assert mt.__version__ == jax_pkg.__version__
    assert mt.extract_modulation is mt.extract_mfcc_change
    assert {"extract_mfcc", "extract_modulation"} <= set(mt.__all__)


class _Parsed(Exception):
    pass


def jax_pkg_cli():
    from modulation_mfcc_tpu import cli

    return cli.main


def mt_cli():
    from modulation_mfcc_tpu_torch import cli

    return cli.main


def cli_options(main) -> dict[str, set[str]]:
    """{subcommand: its option strings and positional names} of the parser
    ``main`` builds, taken when it parses."""
    seen = {}

    def grab(self, *args, **kw):
        seen["parser"] = self
        raise _Parsed

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in seen["parser"]._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {s for act in p._actions for s in (act.option_strings or [act.dest])}
            for name, p in sub.choices.items()}


def test_cli_subcommands_match_jax():
    """Every subcommand of the JAX CLI (``bench`` aside) is one of
    modmfcc-torch's, with every option and positional argument."""
    want, got = cli_options(jax_pkg_cli()), cli_options(mt_cli())
    for sub, opts in want.items():
        if sub in CLI_NOT_PORTED:
            continue
        assert sub in got, f"modmfcc-torch lacks the subcommand {sub!r}"
        assert opts <= got[sub], f"modmfcc-torch {sub} lacks {sorted(opts - got[sub])}"


@pytest.mark.parametrize("block_rows", [1, 64, 8192])
def test_block_rows_changes_no_result(rng, block_rows):
    """JAX's blocked resampler at any ``block_rows`` equals the port's
    blocked form (float64, 1e-10, the bar of test_torch_longform.py's
    resampler parity), which has no such parameter."""
    import jax.numpy as jnp

    from modulation_mfcc_tpu.ops.resample import resample_poly_device as jax_resample
    from modulation_mfcc_tpu_torch.ops.resample import resample_poly_device

    x = rng.standard_normal((2, 3, 8_011))
    want = np.asarray(jax_resample(jnp.asarray(x), 3, 2, block_rows=block_rows, block_threshold=0))
    got = resample_poly_device(torch.tensor(x), 3, 2, block_threshold=0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
