"""Nothing of the benchmark imports JAX or the JAX package, and nothing of
the plain reference imports the program under test; module names are
compared by their top-level part, whole (the port's name begins with the
JAX package's)."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from h100_bench.bench.context import BENCH, FORBIDDEN, PROGRAM, ROOT, forbidden_loaded

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path) -> set:
    """Top-level names of the modules a file imports (relative imports stay
    inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    text = path.read_text()
    assert PROGRAM not in text
    assert _imports(path) <= {"__future__", "contextlib", "math", "torch", "numpy"}


def test_the_names_are_compared_whole():
    assert forbidden_loaded([PROGRAM, f"{PROGRAM}.ops", "jaxtyping", "flaxen"]) == []
    assert forbidden_loaded(["jax.numpy", f"{PROGRAM[:-len('_torch')]}.models"]) == [
        "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu", "jax"]


def test_a_process_that_loads_every_benchmark_module_holds_no_jax():
    code = (
        "import sys, importlib, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from h100_bench.bench.context import BENCH, forbidden_loaded\n"
        "from h100_bench.bench import harness\n"
        "for p in sorted(BENCH.rglob('*.py')):\n"
        "    rel = p.relative_to(BENCH.parent)\n"
        "    if 'tests' in rel.parts or p.name in ('run.py', 'probe_limits.py') or '.' in p.stem:\n"
        "        continue\n"
        "    importlib.import_module('.'.join(rel.with_suffix('').parts))\n"
        "for p in sorted((BENCH / 'metrics').glob('*.py')):\n"
        "    harness.reader(p.stem)\n"
        "print(forbidden_loaded(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
