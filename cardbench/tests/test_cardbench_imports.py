"""The import check: modules of JAX or of the JAX package are named by
their whole top-level name, and a run loads none of them."""
import subprocess
import sys

from cardbench import harness


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_loaded(["bumpcosmology_torch", "bumpcosmology_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.forbidden_loaded(["bumpcosmology_tpu.models", "flax.linen", "jaxlib"]) == [
        "bumpcosmology_tpu", "flax", "jaxlib"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from cardbench import harness; import cardbench.reference.bump_joint; "
            "import bumpcosmology_torch.inference.sampler, bumpcosmology_torch.inference.calibration; "
            "print(harness.forbidden_loaded())") % str(harness.REPO_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_the_port_exits_without_a_result(tmp_path):
    import shutil

    shutil.copy(harness.REPO_DIR / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "cardbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload", "flagship_bump.nuts", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
