from repro_torch.models.cnn import HarCNN, MnistCNN, make_model

__all__ = ["HarCNN", "MnistCNN", "make_model"]
