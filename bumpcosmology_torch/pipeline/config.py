"""Run configuration (L6); a copy of the fit's part of the JAX package's
``pipeline/config.py``: :class:`PathsConfig` and :class:`FitConfig` with
the same fields and defaults, held by a :class:`PipelineConfig`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["PathsConfig", "FitConfig", "PipelineConfig"]


@dataclass
class PathsConfig:
    """Artifact locations (cf. reference ``paths.py``)."""

    data_dir: str = "data"
    pe_raw_dir: str = "data/pe-samples-raw"
    injection_file: str = "data/endo3_bbhpop-LIGO-T2100113-v12.hdf5"

    def path(self, name: str) -> Path:
        """Artifact path under ``data_dir`` (created on first use)."""
        d = Path(self.data_dir)
        d.mkdir(parents=True, exist_ok=True)
        return d / name


@dataclass
class FitConfig:
    """Sampler configuration (``run_fit.py:11-14``, ``run_cosmo_fit.py:17-19``)."""

    num_warmup: int = 1000
    num_samples: int = 1000
    num_chains: int = 4
    seed: int = 3281922803
    cosmo_seed: int = 1652819403
    max_depth: int = 10
    target_accept: float = 0.8
    n_grid: int = 256
    n_z: int = 1024
    n_chain_shards: int = 1  # mesh rows for the chains axis (not ported: one card)
    shared_mass: bool = False  # pool mass-matrix adaptation across chains
    mass_family: str = "bump"  # only the PISN-bump family is ported
    # "nuts" (reference parity), "chees", or "nuts+chees" (NUTS warmup +
    # fixed-length jittered sampling — the ragged-tree-free TPU config)
    sampler: str = "nuts"


@dataclass
class PipelineConfig:
    paths: PathsConfig = field(default_factory=PathsConfig)
    fit: FitConfig = field(default_factory=FitConfig)
