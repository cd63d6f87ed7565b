"""A new configuration, traffic mix or per-layer metric is found by its
name: a later change adds files and BENCHMARK.json entries and edits none."""
import json
import shutil

from cardbench import harness


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("data", ".cache", "__pycache__"))
    (bench / "configs" / "flagship_small.json").write_text(json.dumps({"name": "flagship_small", "source": "x"}))
    (bench / "traffic" / "chees.json").write_text(json.dumps({"entry": "fit", "sampler": "nuts+chees"}))
    (bench / "metrics" / "chees_leapfrogs.py").write_text("def read(run):\n    return None if run is None else 3.0\n")
    manifest = json.loads((harness.REPO_DIR / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "flagship_small", "source": "x", "file": "bench/configs/flagship_small.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "flagship_small.chees", "config": "flagship_small", "traffic": "chees",
                                  "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "chees_leapfrogs", "unit": "n", "better": "lower", "source": "host_clock",
                                  "layer": "sampler", "moves": "leapfrog_ms", "workloads": ["flagship_small.chees"]})
    cell, entry = harness.cell_of(manifest, "flagship_small.chees")
    assert harness.load_config(entry, root=tmp_path)["name"] == "flagship_small"
    assert harness.load_traffic(cell["traffic"], bench)["sampler"] == "nuts+chees"
    names = [m["name"] for m in harness.per_layer_metrics(manifest, "flagship_small.chees")]
    assert names == ["chees_leapfrogs"]
    assert harness.load_reader("chees_leapfrogs", bench)(object()) == 3.0
    # the cells already there keep their own metrics, and no reader of theirs changed
    assert "chees_leapfrogs" not in [m["name"] for m in harness.per_layer_metrics(manifest, "flagship_bump.nuts")]
    for m in harness.per_layer_metrics(manifest, "flagship_bump.nuts"):
        assert callable(harness.load_reader(m["name"], bench))
