"""BENCHMARK.json against the benchmark's contract: names, units, keys and
the files each entry is found by."""
import json
import re

from cardbench.harness import BENCH_DIR, REPO_DIR

MANIFEST = json.loads((REPO_DIR / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["cardbench"] and MANIFEST["command"] == ["python3", "cardbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)


def test_names_units_and_lines():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in MANIFEST["configs"]] + \
        [w["name"] for w in MANIFEST["workloads"]] + [w["traffic"] for w in MANIFEST["workloads"]]
    for n in names + [k for c in MANIFEST["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [c["why"] for c in MANIFEST["configs"]] + [w["why"] for w in MANIFEST["workloads"]] + \
            [m["layer"] for m in MANIFEST["per_layer"]] + [c["source"] for c in MANIFEST["configs"]]:
        assert LINE.match(text), text
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entries_have_just_their_keys_and_sound_bounds():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    ends = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in ends


def test_every_entry_is_found_by_its_name():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert (REPO_DIR / c["file"]).is_file() and c["file"].startswith("cardbench/")
        assert json.loads((REPO_DIR / c["file"]).read_text())["source"] == c["source"]
    for w in MANIFEST["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    for m in MANIFEST["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(MANIFEST)) < 64 * 1024
