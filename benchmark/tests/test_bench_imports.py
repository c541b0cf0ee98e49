"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, compared by whole top-level names (sings_tpu_torch, the
program, begins with sings_tpu), and nothing of the program in the
reference. A run without a card, or without the program beside the
benchmark, fails and prints no result."""
import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

from bench_tiny import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sings_tpu"}


def imported_tops(path: str) -> set:
    """Top-level names of a file's absolute imports."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(sub: str = "") -> list:
    return sorted(glob.glob(os.path.join(HERE, sub, "**", "*.py"),
                            recursive=True))


def test_the_check_compares_whole_top_level_names():
    from common import forbidden_loaded

    assert forbidden_loaded(["sings_tpu_torch", "sings_tpu_torch.ops.knn",
                             "jaxtyping", "flaxen", "torch"]) == []
    assert forbidden_loaded(["sings_tpu", "sings_tpu.ops", "jax.numpy",
                             "jaxlib", "flax.core"]) == [
        "flax.core", "jax.numpy", "jaxlib", "sings_tpu", "sings_tpu.ops"]


def test_no_file_of_the_benchmark_imports_jax():
    for path in sources():
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    files = sources("reference")
    assert len(files) > 30
    for path in files:
        assert not imported_tops(path) & (FORBIDDEN | {"sings_tpu_torch"}), \
            path


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {!r}); import reference.build, "
            "reference.train, reference.anim; print(sorted({{m.split('.')[0] "
            "for m in sys.modules}}))").format(HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/").stdout
    tops = set(eval(out))
    assert not tops & (FORBIDDEN | {"sings_tpu_torch"})


def _run(cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "complex-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run(ROOT)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "only on a card" in res.stderr


def test_a_run_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: the run
    fails (on the CPU here, with the card's check skipped) and prints
    no result."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys, torch; sys.path.insert(0, 'benchmark'); import run;"
            " sys.exit(run.main(['--workload', 'complex-train', '--seed', "
            "'1', '--seconds', '1'], device=torch.device('cpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "sings_tpu_torch" in res.stderr


def test_a_traced_run_needs_a_card(capsys, one_thread):
    """The per-layer path reads the card's trace: on the CPU it fails
    instead of writing a CPU number under a device metric's name."""
    import torch

    from bench_tiny import run_cell

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        run_cell("complex-anim", 1, capsys, trace=1)
