from repro_torch.core import aggregation, distill, kmeans, stats

__all__ = ["aggregation", "distill", "kmeans", "stats"]
