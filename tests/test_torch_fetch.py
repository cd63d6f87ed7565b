"""The port's fetch stage (``bumpcosmology_torch.data.fetch``) against the JAX
package's, offline: ``_download`` raises in every test but one, and that one
gives ``urllib.request.urlopen`` a local stand-in, so no test reaches the
network."""
import hashlib
import json

import numpy as np
import pytest

from bumpcosmology_tpu.data import fetch as JF
from bumpcosmology_torch.data import fetch as TF

_DOWNLOAD = TF._download  # the port's own, run below on a local stand-in for urlopen


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Any download not replaced by a test fails at once."""
    def refuse(url, dest, timeout):
        raise OSError("no network in the tests")

    monkeypatch.setattr(JF, "_download", refuse)
    monkeypatch.setattr(TF, "_download", refuse)


def _layout(tmp_path, n_present=2, seed=0):
    pe_dir = tmp_path / "pe-samples-raw"
    pe_dir.mkdir()
    inj = tmp_path / TF.INJECTION_FILE[1]
    rng = np.random.default_rng(seed)
    for _, name in TF.ZENODO_FILES[:n_present]:
        (pe_dir / name).write_bytes(rng.bytes(64))
    inj.write_bytes(rng.bytes(64))
    return pe_dir, inj


def test_inventory_and_urls_equal_jax():
    assert TF.ZENODO_FILES == JF.ZENODO_FILES
    assert TF.INJECTION_FILE == JF.INJECTION_FILE
    assert len(TF.ZENODO_FILES) == 56 and len({n for _, n in TF.ZENODO_FILES}) == 56
    for rec, name in TF.ZENODO_FILES + [TF.INJECTION_FILE]:
        assert TF.zenodo_url(rec, name) == JF.zenodo_url(rec, name)


def test_present_files_are_skipped_and_counted_as_jax(tmp_path):
    """Two PE files and the injection file on disk, every download failing:
    the same counts and manifest entries as the JAX package, and after three
    failures in a row the rest are not attempted."""
    pe_dir, inj = _layout(tmp_path)
    counts, manifests = [], []
    for pkg, name in ((JF, "jax.json"), (TF, "torch.json")):
        counts.append(pkg.fetch_inputs(pe_dir, inj, manifest_out=str(tmp_path / name)))
        manifests.append(json.loads((tmp_path / name).read_text()))
    assert counts[1] == counts[0] == {"present": 3, "downloaded": 0, "failed": 54}
    assert manifests[1] == manifests[0]
    statuses = [e["status"] for e in manifests[1]["files"]]
    assert statuses.count("failed: OSError") == 3
    assert statuses.count("failed: skipped (network unreachable)") == 51


class _Response:
    """What ``urllib.request.urlopen`` returns, serving ``body`` in blocks and
    raising after the first block when ``fail`` is set."""

    def __init__(self, body: bytes, fail: bool):
        self.blocks, self.fail = [body[:40], body[40:]], fail

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read(self, n):
        if not self.blocks:
            return b""
        if self.fail and len(self.blocks) == 1:
            raise OSError("connection reset")
        return self.blocks.pop(0)


def test_part_file_is_renamed_on_success_only(tmp_path, monkeypatch):
    """The port's ``_download`` streams into ``<name>.part`` and renames it
    only when the stream ends; a stream that breaks leaves the ``.part`` file
    and nothing under the final name.  Through ``fetch_inputs``, every second
    file's stream breaks."""
    import urllib.request

    calls = []

    def urlopen(req, timeout):
        calls.append(req.full_url)
        return _Response(req.full_url.encode() * 3, fail=len(calls) % 2 == 0)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(TF, "_download", _DOWNLOAD)
    pe_dir, inj = _layout(tmp_path, n_present=0)
    inj.unlink()
    counts = TF.fetch_inputs(pe_dir, inj, manifest_out=str(tmp_path / "m.json"))
    assert len(calls) == 57 and counts == {"present": 0, "downloaded": 29, "failed": 28}
    entries = json.loads((tmp_path / "m.json").read_text())["files"]
    for i, e in enumerate(entries):
        dest = pe_dir / e["file"] if i < 56 else inj
        part = dest.with_suffix(dest.suffix + ".part")
        if i % 2 == 0:
            assert e["status"] == "downloaded" and not part.exists()
            assert dest.read_bytes() == TF.zenodo_url(e["record"], e["file"]).encode() * 3
            assert e["sha256"] == hashlib.sha256(dest.read_bytes()).hexdigest()
        else:
            assert e["status"] == "failed: OSError" and not dest.exists()
            assert part.read_bytes() == TF.zenodo_url(e["record"], e["file"]).encode()[:40]


def test_manifest_sha256_and_a_torn_file_as_jax(tmp_path):
    """The manifest holds each present file's SHA-256; on the next run a file
    whose checksum changed is set aside as ``.corrupt`` and fetched again
    (failing here), in both packages alike."""
    results = []
    for pkg in (JF, TF):
        root = tmp_path / pkg.__name__.split(".")[0]
        root.mkdir()
        pe_dir, inj = _layout(root, seed=1)
        manifest = root / "input_manifest.json"
        pkg.fetch_inputs(pe_dir, inj, manifest_out=str(manifest))
        entries = {e["file"]: e for e in json.loads(manifest.read_text())["files"]}
        for _, name in TF.ZENODO_FILES[:2]:
            assert entries[name]["sha256"] == hashlib.sha256((pe_dir / name).read_bytes()).hexdigest()
        assert pkg.fetch_inputs(pe_dir, inj, manifest_out=str(manifest))["present"] == 3
        torn = pe_dir / TF.ZENODO_FILES[0][1]
        torn.write_bytes(b"torn")
        counts = pkg.fetch_inputs(pe_dir, inj, manifest_out=str(manifest))
        results.append((counts, torn.with_suffix(".h5.corrupt").read_bytes(), torn.exists()))
    assert results[1] == results[0]
    assert results[1][0] == {"present": 2, "downloaded": 0, "failed": 55}


def test_offline_attempts_no_download(tmp_path, monkeypatch):
    """``offline=True`` (the pipeline's rehearsal) never calls ``_download``."""
    pe_dir, inj = _layout(tmp_path)

    def called(url, dest, timeout):
        raise AssertionError("a download was attempted offline")

    monkeypatch.setattr(TF, "_download", called)
    counts = TF.fetch_inputs(pe_dir, inj, manifest_out=str(tmp_path / "m.json"), offline=True)
    assert counts == {"present": 3, "downloaded": 0, "failed": 54}
    statuses = {e["status"] for e in json.loads((tmp_path / "m.json").read_text())["files"]}
    assert statuses == {"present", "failed: offline (no download attempted)"}
