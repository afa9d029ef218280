"""Nothing under ``bench/`` imports JAX or the JAX package (``repro``),
compared by whole top-level name (the port, ``repro_torch``, begins with
``repro``), and nothing reads the JAX package's ``benchmarks/``; the entry
point refuses to run without a card."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from bench import harness

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    for path in sorted(BENCH.rglob("*.py")):
        for name in _imports(path):
            if name.split(".")[0] in harness.BARRED:
                found.append((path.name, name))
    assert found == []


def test_nothing_reads_the_jax_benchmarks():
    for path in sorted(BENCH.rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] != "benchmarks", (path, name)
        if path.name != Path(__file__).name:   # this file names it
            assert "benchmarks/" not in path.read_text(), path


def test_barred_names_compare_whole_top_level_names():
    names = ["repro", "repro.models", "jax", "jaxlib.xla_client",
             "flax.linen", "repro_torch", "repro_torch.models", "jaxtyping",
             "reprox"]
    assert harness.barred_modules(names) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repro", "repro.models"]


def _run(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_it_prints_no_result_and_fails():
    out = _run(ROOT, "--workload", "mamba2-370m.docqa", "--seed", "1",
               "--seconds", "1")
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path, "--workload", "mamba2-370m.unshared", "--seed",
               "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
