"""The import check: modules of JAX or of the JAX package are named by
their whole top-level name, and a run loads none of them."""
import ast
import subprocess
import sys

from cardbench import harness


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_loaded(["bumpcosmology_torch", "bumpcosmology_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.forbidden_loaded(["bumpcosmology_tpu.models", "flax.linen", "jaxlib"]) == [
        "bumpcosmology_tpu", "flax", "jaxlib"]


def reference_modules():
    return sorted(p for p in (harness.BENCH_DIR / "reference").glob("*.py"))


def test_the_harness_and_the_port_load_no_jax():
    refs = "; ".join(["import cardbench.reference"] + [f"import cardbench.reference.{p.stem}"
                                                       for p in reference_modules() if p.stem != "__init__"])
    code = ("import sys; sys.path.insert(0, %r); from cardbench import harness; %s; "
            "import bumpcosmology_torch.inference.sampler, bumpcosmology_torch.inference.calibration; "
            "print(harness.forbidden_loaded())") % (str(harness.REPO_DIR), refs)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_references_import_only_torch_numpy_and_the_standard_library():
    """Every module under ``reference/``, the families' to come with the
    bump's, imports ``torch``, ``numpy``, ``math``, ``typing`` and
    ``__future__`` alone: nothing of the port, of JAX or of the harness."""
    allowed = {"torch", "numpy", "math", "typing", "__future__"}
    assert {"__init__", "bump_joint"} <= {p.stem for p in reference_modules()}
    for path in reference_modules():
        imported = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                imported.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                imported.add("." if node.level else node.module.split(".")[0])
        assert imported <= allowed, f"{path.name} imports {sorted(imported - allowed)}"


def test_a_run_without_the_port_exits_without_a_result(tmp_path):
    import shutil

    shutil.copy(harness.REPO_DIR / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "cardbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload", "flagship_bump.nuts", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
