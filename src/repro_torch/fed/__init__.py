from repro_torch.fed.rounds import FedConfig, run_federated
from repro_torch.fed.schedule import RoundPlan, RoundScheduler

__all__ = ["FedConfig", "run_federated", "RoundPlan", "RoundScheduler"]
