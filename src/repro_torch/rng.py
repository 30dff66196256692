"""Explicit random streams for the port.

The JAX package threads ``jax.random`` keys and derives child keys with
``fold_in``.  Torch cannot reproduce those bits, so the port keeps the same
derivation tree with integer seeds instead: ``fold_seed(seed, a, b, ...)``
is the child seed for the path ``(a, b, ...)`` below ``seed`` (a
``numpy.random.SeedSequence`` hash, so distinct paths give independent
streams), and ``generator`` turns a seed into a ``torch.Generator``.  The
parity tests therefore hand both packages the same initial parameters and
cluster labels instead of expecting equal random draws.
"""
from __future__ import annotations

import numpy as np
import torch


def fold_seed(seed: int, *path: int) -> int:
    """The 63-bit seed of the stream at ``path`` below ``seed``."""
    entropy = [int(seed) & 0xFFFFFFFF] + [int(p) & 0xFFFFFFFF for p in path]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, *path: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded with ``fold_seed``."""
    return torch.Generator().manual_seed(fold_seed(seed, *path))
