"""Algorithm-strategy layer of the port: one strategy class per (algorithm
family, engine), driven by ``fed.driver.RoundDriver``.  This slice ports
the loop engine's clustered-KD strategy (fedsikd and the random ablation);
``run_federated`` refuses the other algorithms and engines first.
"""
from __future__ import annotations

from repro_torch.fed.algorithms.base import Algorithm
from repro_torch.fed.algorithms.clustered_kd import LoopClusteredKD

__all__ = ["Algorithm", "LoopClusteredKD", "make_algorithm"]


def make_algorithm(cfg) -> Algorithm:
    """Strategy for a validated ``FedConfig`` the port runs."""
    if cfg.engine == "loop" and cfg.algorithm in ("fedsikd", "random"):
        return LoopClusteredKD()
    raise NotImplementedError(
        f"algorithm={cfg.algorithm!r} on engine={cfg.engine!r} is not ported "
        "to repro_torch yet (ROADMAP Queue 1 items 7-8)")
