"""What the benchmark imports and where it writes."""
import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "modulation_mfcc_tpu"}


def loaded_after(code: str) -> set[str]:
    """Top-level names of every module loaded after ``code`` runs in a
    fresh interpreter that has the benchmark's paths."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_imports_no_jax():
    names = loaded_after(
        "import runpy; runpy.run_path('benchmark/run.py', run_name='benchmark_run')\n"
        "from benchlib import catalog, check, loop, run_cell, trace\n"
        "[catalog.plugin(k, p.stem) for k in catalog.PLUGIN_KINDS for p in (catalog.BENCH_DIR / k).glob('*.py')]"
    )
    assert "modulation_mfcc_tpu_torch" in names  # the port itself is loaded
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    names = loaded_after("from benchlib.catalog import BENCH_DIR, plugin\n"
                         "[plugin('reference', p.stem) for p in (BENCH_DIR / 'reference').glob('*.py')]")
    assert not names & (FORBIDDEN | {"modulation_mfcc_tpu_torch"})
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".", 1)[0] not in FORBIDDEN | {"modulation_mfcc_tpu_torch", "benchlib"}, (path, m)


def test_no_fixed_scratch_paths():
    for path in BENCH_DIR.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, path
