"""Input acquisition: the GWTC PE releases and the O3 injection file from
Zenodo; counterpart of the JAX package's ``data/fetch.py`` (the reference's
showyourwork dataset stanza, ``showyourwork.yml:27-94``): the 33 GWTC-2.1 +
23 GWTC-3 posterior-sample releases and the ``endo3`` sensitivity-injection
file, fetched as a resumable pipeline stage.

* Files already present (non-empty) are never downloaded again.
* Each download goes to a ``.part`` file and is renamed only on success, so
  an interrupted fetch never leaves a truncated file behind.
* A SHA-256 manifest is written after every run; when one exists from an
  earlier run, present files are checked against it, and a mismatch is
  renamed ``.corrupt`` and downloaded again.
* Network failures are counted, not fatal (ingestion skips missing events);
  after three in a row the remaining downloads are not attempted.
* ``offline=True`` attempts no download at all: absent files are counted
  as failed.  The pipeline's rehearsal (``--rehearsal``) runs so.

``urllib`` is imported by the download itself.  Without network, place the
files of :data:`ZENODO_FILES` under ``pe_raw_dir`` and the injection file at
``injection_file`` by other means, or write format-faithful fixtures with
:mod:`bumpcosmology_torch.data.rehearsal`.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional

__all__ = ["ZENODO_FILES", "INJECTION_FILE", "fetch_inputs", "zenodo_url"]

# Zenodo record ids from the reference's DOIs (``showyourwork.yml:28,62,89``):
# 10.5281/zenodo.6513631 (GWTC-2.1), 10.5281/zenodo.5546663 (GWTC-3),
# 10.5281/zenodo.7890437 (O3 BBH sensitivity injections).
_GWTC2P1_RECORD = "6513631"
_GWTC3_RECORD = "5546663"
_INJ_RECORD = "7890437"

_GWTC2P1_EVENTS = [
    "GW190408_181802", "GW190412_053044", "GW190413_052954", "GW190413_134308",
    "GW190421_213856", "GW190503_185404", "GW190512_180714", "GW190513_205428",
    "GW190517_055101", "GW190519_153544", "GW190521_030229", "GW190521_074359",
    "GW190527_092055", "GW190602_175927", "GW190620_030421", "GW190630_185205",
    "GW190701_203306", "GW190706_222641", "GW190707_093326", "GW190708_232457",
    "GW190719_215514", "GW190720_000836", "GW190727_060333", "GW190728_064510",
    "GW190731_140936", "GW190803_022701", "GW190828_063405", "GW190828_065509",
    "GW190910_112807", "GW190915_235702", "GW190924_021846", "GW190929_012149",
    "GW190930_133541",
]

_GWTC3_EVENTS = [
    "GW191103_012549", "GW191105_143521", "GW191109_010717", "GW191127_050227",
    "GW191129_134029", "GW191204_171526", "GW191215_223052", "GW191216_213338",
    "GW191222_033537", "GW191230_180458", "GW200112_155838", "GW200128_022011",
    "GW200129_065458", "GW200202_154313", "GW200208_130117", "GW200209_085452",
    "GW200216_220804", "GW200219_094415", "GW200224_222234", "GW200225_060421",
    "GW200302_015811", "GW200311_115853", "GW200316_215756",
]

#: (record_id, filename) for the 56 PE releases (``showyourwork.yml:29-87``).
ZENODO_FILES = [
    (_GWTC2P1_RECORD, f"IGWN-GWTC2p1-v2-{evt}_PEDataRelease_mixed_nocosmo.h5")
    for evt in _GWTC2P1_EVENTS
] + [
    (_GWTC3_RECORD, f"IGWN-GWTC3p0-v1-{evt}_PEDataRelease_mixed_nocosmo.h5")
    for evt in _GWTC3_EVENTS
]

#: (record_id, filename) of the sensitivity-injection set (``showyourwork.yml:88-94``).
INJECTION_FILE = (_INJ_RECORD, "endo3_bbhpop-LIGO-T2100113-v12.hdf5")


def zenodo_url(record: str, filename: str) -> str:
    return f"https://zenodo.org/record/{record}/files/{filename}?download=1"


def _sha256(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _download(url: str, dest: Path, timeout: float) -> None:
    """Stream ``url`` to ``dest`` via a ``.part`` temp, rename on success."""
    import urllib.request

    part = dest.with_suffix(dest.suffix + ".part")
    part.parent.mkdir(parents=True, exist_ok=True)
    req = urllib.request.Request(url, headers={"User-Agent": "bumpcosmology-torch/fetch"})
    with urllib.request.urlopen(req, timeout=timeout) as r, open(part, "wb") as out:
        while True:
            block = r.read(1 << 20)
            if not block:
                break
            out.write(block)
    os.replace(part, dest)


def fetch_inputs(
    pe_raw_dir,
    injection_file,
    manifest_out: Optional[str] = None,
    timeout: float = 120.0,
    offline: bool = False,
) -> dict:
    """Fetch (or verify) all pipeline inputs; returns status counts.

    Parameters
    ----------
    pe_raw_dir:
        Directory receiving the 56 GWTC posterior files.
    injection_file:
        Full path of the ``endo3`` injection file.
    manifest_out:
        Where to write the JSON status/checksum manifest (also read back on
        later runs to verify files that were already present).
    offline:
        Attempt no download: absent files are counted as failed.

    Returns
    -------
    dict with keys ``present`` (already on disk, checksum-consistent),
    ``downloaded`` (fetched this run), ``failed`` (unreachable/mismatched).
    """
    pe_raw_dir = Path(pe_raw_dir)
    injection_file = Path(injection_file)

    prior_sums: dict = {}
    if manifest_out and Path(manifest_out).exists():
        try:
            with open(manifest_out) as f:
                prior_sums = {
                    e["file"]: e.get("sha256")
                    for e in json.load(f).get("files", [])
                    if e.get("sha256")
                }
        except (json.JSONDecodeError, KeyError, TypeError):
            prior_sums = {}

    targets = [(rec, name, pe_raw_dir / name) for rec, name in ZENODO_FILES]
    targets.append((INJECTION_FILE[0], INJECTION_FILE[1], injection_file))

    counts = {"present": 0, "downloaded": 0, "failed": 0}
    entries = []
    net_failures = 0
    for record, name, dest in targets:
        status, sha = None, None
        if dest.exists() and dest.stat().st_size > 0:
            sha = _sha256(dest)
            if name in prior_sums and prior_sums[name] != sha:
                # torn/partial from an interrupted run — keep the evidence
                # (the refetch writes to a .part temp and os.replace()s
                # atomically, so the mismatched file need not be destroyed)
                dest.rename(dest.with_suffix(dest.suffix + ".corrupt"))
            else:
                status = "present"
                counts["present"] += 1
        if status is None:
            if offline:
                status = "failed: offline (no download attempted)"
                sha = None
                counts["failed"] += 1
            elif net_failures >= 3:
                # three consecutive hard failures: the network is down, not
                # flaky — skip the remaining attempts instead of burning one
                # timeout per file (up to ~2 min x 57 files offline)
                status = "failed: skipped (network unreachable)"
                sha = None
                counts["failed"] += 1
            else:
                try:
                    _download(zenodo_url(record, name), dest, timeout=timeout)
                    sha = _sha256(dest)
                    status = "downloaded"
                    counts["downloaded"] += 1
                    net_failures = 0
                except Exception as err:  # no egress / transient — not fatal
                    status = f"failed: {type(err).__name__}"
                    sha = None
                    counts["failed"] += 1
                    net_failures += 1
        entries.append(
            {"file": name, "record": record, "path": str(dest), "status": status, "sha256": sha}
        )

    if manifest_out:
        Path(manifest_out).parent.mkdir(parents=True, exist_ok=True)
        with open(manifest_out, "w") as f:
            json.dump({"files": entries, "counts": counts}, f, indent=1)

    return counts
