from repro_torch.data import dirichlet, pipeline, synthetic

__all__ = ["dirichlet", "pipeline", "synthetic"]
