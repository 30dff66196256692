"""Algorithm-strategy layer of the port: one strategy class per (algorithm
family, engine), driven by ``fed.driver.RoundDriver``.  The clustered-KD
strategies (fedsikd and the random ablation) run on both engines;
``run_federated`` refuses the other algorithms first.
"""
from __future__ import annotations

from repro_torch.fed.algorithms.base import Algorithm
from repro_torch.fed.algorithms.clustered_kd import (LoopClusteredKD,
                                                     ShardedClusteredKD)

__all__ = ["Algorithm", "LoopClusteredKD", "ShardedClusteredKD",
           "make_algorithm"]


def make_algorithm(cfg) -> Algorithm:
    """Strategy for a validated ``FedConfig`` the port runs."""
    if cfg.algorithm in ("fedsikd", "random"):
        return LoopClusteredKD() if cfg.engine == "loop" else \
            ShardedClusteredKD()
    raise NotImplementedError(
        f"algorithm={cfg.algorithm!r} on engine={cfg.engine!r} is not ported "
        "to repro_torch yet (ROADMAP Queue 1 item 8)")
