"""What the benchmark loads: never jax, jaxlib, flax or the JAX package
(top-level names compared whole), and in the plain reference nothing of
the program; and the command refuses to measure without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def loaded_after(code: str, cwd=REPO) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    running `code` from `cwd`."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_cpu_run_loads_no_jax():
    names = loaded_after(
        "from benchmark import harness\n"
        "from benchmark.conftest import small_config\n"
        "harness.run_cell('crowd144_1080.animated', 5, 0.2, False, 'cpu',"
        " config=small_config('crowd144_1080.animated', 64))")
    assert "trident_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "trident_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    names = loaded_after(
        "import benchmark.reference.sphere_field, "
        "benchmark.reference.tube_crowd, benchmark.work, benchmark.check")
    assert not names & {"trident_tpu_torch", "trident_tpu", "jax"}


def test_forbidden_names_are_compared_whole():
    from benchmark import run

    assert run.forbidden_modules(["trident_tpu_torch.ops.raster",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["trident_tpu.ops", "jax._src.core",
                                  "flax"]) == ["flax", "jax", "trident_tpu"]


def run_cmd(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "field1m_1080.dynamic", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=600)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks a machine without one")
    out = run_cmd(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = run_cmd(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
