"""Checkpoint format of the port: flat npz files of tensor trees, in the
JAX package's key paths (``ckpt.py``)."""
from repro_torch.checkpoint.ckpt import load_meta, restore, save

__all__ = ["save", "restore", "load_meta"]
