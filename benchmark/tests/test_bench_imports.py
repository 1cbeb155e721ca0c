"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Modules are compared by their
top-level name, whole: ``passt_tpu_torch`` is not ``passt_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.lib import harness

BENCH = harness.HERE
JAX = {"jax", "jaxlib", "flax", "optax", "passt_tpu"}
#: the reference and what it imports: nothing of the program either
REFERENCE = ["lib/reference.py", "lib/draws.py", "lib/flops.py", "lib/weights.py", "lib/control.py"]


def _top_imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py")))
def test_no_file_imports_jax(path):
    assert not _top_imports(BENCH / path) & JAX


@pytest.mark.parametrize("path", REFERENCE)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "passt_tpu_torch" not in _top_imports(BENCH / path)


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=str(harness.ROOT), capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("from benchmark.lib import reference, draws, flops, control")
    assert not loaded & (JAX | {"passt_tpu_torch"})


def test_a_run_loads_no_jax():
    code = ("import time, torch\nfrom benchmark.lib import harness\nfrom benchmark.tests._tiny import tiny_cell\n"
            "for name in ('passt_s.train.b12', 'passt_s.serve.b20'):\n"
            "    harness.run_rank(tiny_cell(name), harness.Env(seed=1, seconds=0.2, trace=False, "
            "device=torch.device('cpu'), t_start=time.time()))\n"
            "assert not harness.forbidden_modules()")
    loaded = _modules_after(code)
    assert "passt_tpu_torch" in loaded and not loaded & JAX


def test_without_a_card_no_result(tmp_path):
    """No CUDA card: a code other than 0 and no result line."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "passt_s.train.b12", "--seed",
                          str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"], cwd=str(harness.ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_without_the_program_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder
    fails and prints no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "passt_s.train.b12", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
