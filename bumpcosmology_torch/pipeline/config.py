"""Run configuration (L6); a copy of the JAX package's ``pipeline/config.py``
with every section of the JAX package's: :class:`PathsConfig`,
:class:`IngestConfig`, :class:`FitConfig`, :class:`MockConfig`,
:class:`SBCConfig`, :class:`ScoreCheckConfig`, :class:`LooConfig`,
:class:`CompareConfig` and :class:`PpcConfig` with the same fields and
defaults, held by a :class:`PipelineConfig` that loads a JSON file and
``section.key=value`` overrides.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

__all__ = ["PathsConfig", "IngestConfig", "FitConfig", "MockConfig", "SBCConfig", "ScoreCheckConfig",
           "LooConfig", "CompareConfig", "PpcConfig", "PipelineConfig"]


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
class IngestConfig:
    """PE/selection extraction (``draw_pe_samples.py:11-14``,
    ``draw_selection_samples.py:8-11``); the mock fit inputs draw their
    selection rows with ``sel_seed``."""

    nsamp_pe: int = 128
    nsamp_sel: int = 1024
    pe_seed: int = 232970088
    sel_seed: int = 727228188
    far_threshold: float = 1.0
    # offline fallback of the fetch stage (CLI --rehearsal): format-faithful
    # rehearsal fixtures from the mock universe, written with no download attempted
    rehearsal_fallback: bool = False
    rehearsal_events: int = 8
    rehearsal_campaign_ndraw: int = 200_000
    rehearsal_seed: int = 11


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
    n_chain_shards: int = 1  # mesh rows for the chains axis (no stage reads it, as in the JAX package)
    shared_mass: bool = False  # pool mass-matrix adaptation across chains
    # mass-model family: "bump" (the reference's physical PISN-bump model),
    # "plpeak" (the GWTC-3 fiducial POWER-LAW+PEAK, models/plpeak.py) or
    # "brokenpl" (the LVK BROKEN POWER LAW, models/brokenpl.py) — selects the
    # registry row (likelihoods.MASS_FAMILIES) in the fit stages; traces
    # record the family so `pipeline compare` can rank them on one catalog
    mass_family: str = "bump"
    # "nuts" (reference parity), "chees", or "nuts+chees" (NUTS warmup +
    # fixed-length jittered sampling — the ragged-tree-free TPU config)
    sampler: str = "nuts"


@dataclass
class MockConfig:
    """Mock-universe campaign (``mock_injections.py:28-29,137-140``,
    ``mock_observations.py:12,30``, ``mock_one_year_samples.py:11``)."""

    ndraw: int = 10_000_000
    injection_seed: int = 333165393
    observation_seed: int = 181286134
    catalog_seed: int = 177043409
    nsamp: int = 128
    z_horizon: float = 3.5
    chirp_dist_min: float = 1.5
    detection_snr: float = 10.0
    snr_chunk: int = 65536
    # optional {detector: path} of tabulated physical PSD files (2 columns:
    # f [Hz], S_n [1/Hz]; .txt/.csv/.npz with arrays "f","psd") replacing the
    # analytic design curves for real sensitivity studies
    psd_files: Optional[Dict[str, str]] = None


@dataclass
class SBCConfig:
    """Simulation-based calibration suite (BASELINE.md scale-out config)."""

    model: str = "pop"  # "pop", "pop_cosmo" (joint), "plpeak_cosmo" or "brokenpl_cosmo"
    n_sims: int = 20
    nobs: int = 12
    nsamp: int = 64
    nsel: int = 512  # raised automatically to >=2048 for the joint model
    campaign_ndraw: int = 200_000
    num_warmup: int = 200
    num_samples: int = 256
    thin: int = 4
    threshold: float = 20.0
    # cap on the detected-injection pool backing events/banks (uniform
    # thinning with Ndraw rescaled — bounds the host-side bank building at
    # low detection thresholds)
    pool_max: Optional[int] = None
    pe_bank_size: int = 4096  # Gaussian draws per per-injection PE bank
    # per-simulation fresh observation noise + banks (exact SBC law; the
    # shared-bank fast path leaves a common-mode tilt in weakly identified
    # directions) — applies to the pop_cosmo model
    fresh_noise: bool = True
    # fleet bounds: NUTS transitions between two progress reports, and the
    # NUTS depth cap (a wide fleet in early warmup builds deep lockstep trees)
    fleet_chunk: int = 5
    max_depth: int = 8
    seed: int = 424242


@dataclass
class ScoreCheckConfig:
    """Score-identity diagnostic (``pipeline score_check``): E[∇ log L̂] = 0
    at the default parameters over fresh simulated catalogs — the fit-free
    generative/model-mismatch instrument (docs/DESIGN.md §9.5)."""

    model: str = "pop_cosmo"  # "pop_cosmo", "plpeak_cosmo" or "brokenpl_cosmo"
    n_catalogs: int = 200
    nobs: int = 16
    nsamp: int = 256
    nsel: int = 3584
    campaign_ndraw: int = 6_500_000
    pe_bank_size: int = 16384
    threshold: float = 20.0
    n_grid: int = 128
    n_z: int = 256
    z_bar: float = 4.0  # per-site |z| pass bar on the TOTAL score
    seed: int = 616161


@dataclass
class LooConfig:
    """Leave-one-out event-influence fleet (``pipeline loo``)."""

    model: str = "pop_cosmo"  # which fit to diagnose ("pop" or "pop_cosmo")
    num_warmup: int = 400
    num_samples: int = 256
    fleet_chunk: int = 5
    max_depth: int = 8
    seed: int = 515151


@dataclass
class CompareConfig:
    """Predictive model comparison (``pipeline compare``): PSIS-LOO + WAIC
    of pop vs pop_cosmo on their saved traces."""

    max_draws: int = 1024  # posterior draws retained for the pointwise matrix
    batch: int = 64  # likelihood evaluations per device batch (the chain axis)


@dataclass
class PpcConfig:
    """Posterior predictive checks (``pipeline ppc``): observed catalog vs
    injection-reweighted predicted detections, per observable, per trace."""

    n_draws: int = 256  # posterior draws used for the check
    batch: int = 32  # log-weight evaluations per device batch (the chain axis)
    seed: int = 271828


@dataclass
class PipelineConfig:
    paths: PathsConfig = field(default_factory=PathsConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    fit: FitConfig = field(default_factory=FitConfig)
    mock: MockConfig = field(default_factory=MockConfig)
    sbc: SBCConfig = field(default_factory=SBCConfig)
    score: ScoreCheckConfig = field(default_factory=ScoreCheckConfig)
    loo: LooConfig = field(default_factory=LooConfig)
    compare: CompareConfig = field(default_factory=CompareConfig)
    ppc: PpcConfig = field(default_factory=PpcConfig)

    @classmethod
    def load(cls, json_path: Optional[str] = None, overrides: Optional[list] = None):
        """Build from defaults, then a JSON file, then ``section.key=value``
        overrides (e.g. ``fit.num_chains=16 mock.ndraw=100000``); an unknown
        key raises ``KeyError``."""
        cfg = cls()
        if json_path:
            with open(json_path) as f:
                data = json.load(f)
            for section, vals in data.items():
                sub = getattr(cfg, section)
                for k, v in vals.items():
                    if not hasattr(sub, k):
                        raise KeyError(f"unknown config key {section}.{k}")
                    setattr(sub, k, v)
        for ov in overrides or []:
            key, _, val = ov.partition("=")
            section, _, name = key.partition(".")
            sub = getattr(cfg, section)
            if not hasattr(sub, name):
                raise KeyError(f"unknown config key {key}")
            current = getattr(sub, name)
            setattr(sub, name, type(current)(json.loads(val)) if not isinstance(current, str) else val)
        return cfg

    def to_dict(self):
        return dataclasses.asdict(self)
