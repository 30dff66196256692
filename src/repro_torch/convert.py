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
- Stacks of models (``stacked=True``: the packed engine's (K, ...) teacher
  stacks and their Adam states) keep their leading axis; the layout change
  applies to the axes after it.

The round trip is exact: only transposes and copies, no arithmetic.

Language models (``lm_params_from_jax`` / ``lm_params_to_jax``) keep the
nested dict of the JAX params (``p["layers"]["attn"]["wq"]``) and permute
nothing: every LM weight is ``(in, out)``, its layers stacked on a leading
L axis, so the conv rule above, which reads any 3-D leaf as WIO, must not
touch them.  A bfloat16 leaf, which ``np.asarray`` gives as
``ml_dtypes.bfloat16``, crosses as float32 (every bf16 value is a float32),
so that direction is exact too.  Their Adam states
(``lm_adam_from_jax`` / ``lm_adam_to_jax``) hold the moments as the LM
steps' optimizers do, flat with dotted keys (``layers.attn.wq``); a
stacked state (the distillation step's students) keeps its leading D axis
on every moment and its (D,) count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import AdamState
from repro_torch.tree import flatten, unflatten


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _permute(a, lead: int, order: tuple):
    """Permute the axes after the ``lead`` leading (stack) axes (a numpy
    array, or a tensor as a view)."""
    axes = (*range(lead), *(lead + i for i in order))
    if isinstance(a, torch.Tensor):
        return a.permute(*axes)
    return a.transpose(*axes)


def _to_torch_layout(a: np.ndarray, lead: int = 0) -> np.ndarray:
    if a.ndim - lead == 4:           # HWIO -> OIHW
        return _permute(a, lead, (3, 2, 0, 1))
    if a.ndim - lead == 3:           # WIO -> OIW
        return _permute(a, lead, (2, 1, 0))
    return a


def _to_jax_layout(a: torch.Tensor, lead: int = 0) -> torch.Tensor:
    if a.ndim - lead == 4:           # OIHW -> HWIO
        return _permute(a, lead, (2, 3, 1, 0))
    if a.ndim - lead == 3:           # OIW -> WIO
        return _permute(a, lead, (2, 1, 0))
    return a


def params_from_jax(tree, *, device="cpu", stacked: bool = False) -> dict:
    """JAX param pytree -> ``{dotted key: tensor}`` in the port's layout.
    ``stacked=True`` takes a stack of models (every leaf with a leading
    (K,) axis, as the packed engine's teacher stack) and keeps that axis."""
    lead = int(stacked)
    return {k: torch.from_numpy(np.array(_to_torch_layout(a, lead),
                                         order="C")).to(device)
            for k, a in _flatten(tree)}


def params_to_jax(params: dict, *, stacked: bool = False):
    """The inverse of ``params_from_jax``: a nested dict/list pytree in the
    JAX layout whose leaves are the tensors where they lie, as permuted
    views (nothing is copied; ``np.asarray`` or the checkpoint writer reads
    them to the host)."""
    lead = int(stacked)
    root: dict = {}
    for key, t in params.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_jax_layout(t.detach(), lead)
    return _lists(root)


def _lists(node):
    """Turn dicts whose keys are 0..n-1 back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def adam_from_jax(state, *, device="cpu", stacked: bool = False) -> AdamState:
    """A JAX ``AdamState`` (or any ``(mu, nu, count)``) -> the port's.  With
    ``stacked=True`` the moments carry a leading (K,) axis and the count is
    (K,), one per stacked model."""
    mu, nu, count = state
    return AdamState(params_from_jax(mu, device=device, stacked=stacked),
                     params_from_jax(nu, device=device, stacked=stacked),
                     torch.from_numpy(np.array(count, dtype=np.int32))
                     .to(device))


def adam_to_jax(state: AdamState, *, stacked: bool = False) -> AdamState:
    """The port's ``AdamState`` -> ``(mu, nu, count)`` in the JAX layout, as
    an ``AdamState`` (a NamedTuple with the JAX one's fields, so
    ``repro.optim.optimizers.AdamState(*result)`` rebuilds the JAX one and
    a checkpoint names its leaves ``.mu``, ``.nu``, ``.count`` as JAX's
    does).  Leaves are tensor views, as in ``params_to_jax``."""
    return AdamState(params_to_jax(state.mu, stacked=stacked),
                     params_to_jax(state.nu, stacked=stacked),
                     state.count.detach())


def _bf16_as_f32(a: np.ndarray) -> tuple[np.ndarray, bool]:
    """``a`` as an array torch takes; bfloat16 (which numpy knows only
    through ``ml_dtypes``) as float32, flagged to be cast back."""
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32), True
    return a, False


def lm_params_from_jax(tree, *, device="cpu"):
    """A JAX LM param pytree (nested dicts of arrays) -> the same nested
    dicts of tensors on ``device``, layouts and dtypes kept."""
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, device=device)
                for k, v in tree.items()}
    a, bf16 = _bf16_as_f32(np.asarray(tree))
    t = torch.from_numpy(np.array(a, order="C")).to(device)
    return t.to(torch.bfloat16) if bf16 else t


def lm_params_to_jax(params):
    """The inverse of ``lm_params_from_jax``: nested dicts of numpy arrays,
    bfloat16 leaves as ``ml_dtypes.bfloat16`` (imported here, for the
    tests' JAX side; the port itself never needs it)."""
    if isinstance(params, dict):
        return {k: lm_params_to_jax(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy().copy()


def lm_adam_from_jax(state, *, device="cpu") -> AdamState:
    """A JAX ``AdamState`` over LM params (nested moments; under ``vmap``
    each with a leading D axis and a (D,) count) -> the port's, with flat
    dotted-key moments."""
    mu, nu, count = state
    return AdamState(flatten(lm_params_from_jax(mu, device=device)),
                     flatten(lm_params_from_jax(nu, device=device)),
                     torch.from_numpy(np.array(count, dtype=np.int32))
                     .to(device))


def lm_adam_to_jax(state: AdamState) -> AdamState:
    """The inverse of ``lm_adam_from_jax``: nested numpy moments and a
    numpy count, as an ``AdamState``."""
    return AdamState(lm_params_to_jax(unflatten(state.mu)),
                     lm_params_to_jax(unflatten(state.nu)),
                     state.count.detach().cpu().numpy().copy())
