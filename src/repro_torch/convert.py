"""Weights across: JAX param pytrees (of numpy arrays, or anything
``np.asarray`` takes) to the port's dicts of tensors, and back.

- Keys: the JAX tree path joined by dots (``conv.0.w``, ``head.b``,
  ``conv1.w``), which are the ``state_dict`` keys of the port's modules; a
  numeric path component is a list index.
- Conv weights: HWIO -> OIHW (4-D) and WIO -> OIW (3-D).
- Dense weights stay ``(in, out)``: the port applies them as ``h @ w``.
- The MNIST head needs no row permutation: the port flattens channels-last
  activations, in the JAX (NHWC) order.
- Adam states: the moments convert like the params, the count becomes an
  int32 scalar tensor.

The round trip is exact: only transposes and copies, no arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import AdamState


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:                  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 3:                  # WIO -> OIW
        return a.transpose(2, 1, 0)
    return a


def _to_jax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:                  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 3:                  # OIW -> WIO
        return a.transpose(2, 1, 0)
    return a


def params_from_jax(tree, *, device="cpu") -> dict:
    """JAX param pytree -> ``{dotted key: tensor}`` in the port's layout."""
    return {k: torch.from_numpy(np.array(_to_torch_layout(a), order="C"))
            .to(device)
            for k, a in _flatten(tree)}


def params_to_jax(params: dict):
    """The inverse of ``params_from_jax``: a nested dict/list pytree of
    numpy arrays in the JAX layout."""
    root: dict = {}
    for key, t in params.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(
            _to_jax_layout(t.detach().cpu().numpy()))
    return _lists(root)


def _lists(node):
    """Turn dicts whose keys are 0..n-1 back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def adam_from_jax(state, *, device="cpu") -> AdamState:
    """A JAX ``AdamState`` (or any ``(mu, nu, count)``) -> the port's."""
    mu, nu, count = state
    return AdamState(params_from_jax(mu, device=device),
                     params_from_jax(nu, device=device),
                     torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                                  device=device))


def adam_to_jax(state: AdamState) -> tuple:
    """The port's ``AdamState`` -> ``(mu, nu, count)`` in the JAX layout
    (``repro.optim.optimizers.AdamState(*result)`` rebuilds the JAX one)."""
    return (params_to_jax(state.mu), params_to_jax(state.nu),
            np.int32(int(state.count)))
