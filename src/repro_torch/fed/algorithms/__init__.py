"""Algorithm-strategy layer of the port: one strategy class per (algorithm
family, engine), driven by ``fed.driver.RoundDriver``.  The clustered-KD
strategies (fedsikd and the random ablation) and the FedAvg/FedProx
baselines run on both engines, FL+HC on the loop engine.

``make_algorithm(cfg)`` is the one dispatch point: ``FedConfig`` validates
the engine x algorithm matrix at construction, so dispatch here is total.
"""
from __future__ import annotations

from repro_torch.fed.algorithms.base import Algorithm
from repro_torch.fed.algorithms.baselines import LoopBaseline, PackedBaseline
from repro_torch.fed.algorithms.clustered_kd import (LoopClusteredKD,
                                                     ShardedClusteredKD)
from repro_torch.fed.algorithms.flhc import FLHC

__all__ = ["Algorithm", "make_algorithm", "LoopClusteredKD",
           "ShardedClusteredKD", "LoopBaseline", "PackedBaseline", "FLHC"]


def make_algorithm(cfg) -> Algorithm:
    """Strategy for a validated ``FedConfig`` (see rounds.ALGORITHMS)."""
    sharded = cfg.engine == "sharded"
    if cfg.algorithm in ("fedsikd", "random"):
        return ShardedClusteredKD() if sharded else LoopClusteredKD()
    if cfg.algorithm in ("fedavg", "fedprox"):
        return PackedBaseline() if sharded else LoopBaseline()
    if cfg.algorithm == "flhc":
        return FLHC()
    raise ValueError(f"unknown algorithm {cfg.algorithm!r}")
