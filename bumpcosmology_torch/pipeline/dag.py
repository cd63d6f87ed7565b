"""Artifact-cached pipeline DAG (L6); counterpart of the JAX package's
``pipeline/dag.py``.

The reference's orchestration is a showyourwork/Snakemake DAG with Zenodo
rule caching (``Snakefile:1-126``, ``showyourwork.yml:2,139``).  Here a
dependency-free stage runner plays that role: each stage declares inputs and
outputs, and runs only when an output is missing or older than an input
(make-style freshness), so a failed pipeline resumes from its last valid
artifact.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Sequence

__all__ = ["Stage", "Pipeline"]


@dataclass
class Stage:
    name: str
    run: Callable[[], None]
    inputs: Sequence[Path] = field(default_factory=list)
    outputs: Sequence[Path] = field(default_factory=list)
    after: Sequence[str] = field(default_factory=list)  # stage-name dependencies

    def fresh(self) -> bool:
        outs = [Path(o) for o in self.outputs]
        if not outs or not all(o.exists() for o in outs):
            return False
        ins = [Path(i) for i in self.inputs if Path(i).exists()]
        if not ins:
            return True
        newest_in = max(i.stat().st_mtime for i in ins)
        oldest_out = min(o.stat().st_mtime for o in outs)
        return oldest_out >= newest_in


class Pipeline:
    def __init__(self, stages: Sequence[Stage]):
        self.stages: Dict[str, Stage] = {s.name: s for s in stages}

    def _resolve(self, targets: Sequence[str]) -> List[str]:
        order: List[str] = []
        seen = set()

        def visit(name: str, chain=()):
            if name in chain:
                raise ValueError(f"stage cycle: {' -> '.join(chain + (name,))}")
            if name in seen:
                return
            stage = self.stages.get(name)
            if stage is None:
                raise KeyError(f"unknown stage {name!r}; known: {sorted(self.stages)}")
            for dep in stage.after:
                visit(dep, chain + (name,))
            seen.add(name)
            order.append(name)

        for t in targets:
            visit(t)
        return order

    def run(self, targets: Sequence[str], force: bool = False, verbose: bool = True):
        for name in self._resolve(targets):
            stage = self.stages[name]
            if not force and stage.fresh():
                if verbose:
                    print(f"[pipeline] {name}: up to date")
                continue
            t0 = time.perf_counter()
            if verbose:
                print(f"[pipeline] {name}: running...")
            stage.run()
            missing = [str(o) for o in stage.outputs if not Path(o).exists()]
            if missing:
                raise RuntimeError(f"stage {name} did not produce outputs: {missing}")
            if verbose:
                print(f"[pipeline] {name}: done in {time.perf_counter() - t0:.1f}s")
