"""Flat-npz checkpoints of tensor trees with round metadata: the port of
``repro.checkpoint.ckpt``, in the same file format.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
torch tensors (on any device) or numpy arrays.  Each leaf is stored under
the key path the JAX package writes for the same structure: dict keys and
list or tuple indices joined by ``/``, a NamedTuple field as ``.name``
(``t_opts/0/.mu/conv/0/w``).  bfloat16 leaves are stored as their uint16
bits under ``key + "__bf16__"`` (npz has no bf16), so every dtype
round-trips bit for bit.  ``save`` publishes meta first and npz last, each
through a temporary name and ``os.replace``, so a visible npz always has
its meta and a kill mid-save never leaves a truncated npz behind.
``restore`` checks the file against a template tree and raises
``ValueError`` naming every missing, unexpected or mis-shaped leaf.

The conversion between the port's layouts and the JAX package's (conv
kernels OIHW against HWIO) is the caller's, through ``repro_torch.convert``;
this module moves bytes only.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

_BF16_TAG = "__bf16__"


def _children(node):
    """(path element, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_path(tree, path=()):
    kids = _children(tree)
    if kids is None:
        yield "/".join(path), tree
        return
    for name, child in kids:
        yield from _flatten_with_path(child, path + (name,))


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.dtype(leaf.dtype).name


def _to_host(key: str, leaf) -> tuple[str, np.ndarray]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return key + _BF16_TAG, t.view(torch.int16).numpy().view(np.uint16)
        return key, t.numpy()
    return key, np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return dict(_to_host(k, leaf) for k, leaf in _flatten_with_path(tree))


def _npz_path(path) -> Path:
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(".npz")


def save(path, tree, *, step: int = 0, extra: dict | None = None) -> None:
    """Atomically publish ``tree`` and its meta JSON ``{"step": step,
    **extra}``: meta first, npz last, each through a temporary name, so the
    npz's appearance is the commit point."""
    npz_path = _npz_path(path)
    npz_path.parent.mkdir(parents=True, exist_ok=True)
    meta_path = npz_path.with_suffix(".meta.json")
    tmp_meta = meta_path.with_name(meta_path.name + ".tmp")
    tmp_meta.write_text(json.dumps({"step": step, **(extra or {})}))
    os.replace(tmp_meta, meta_path)
    tmp_npz = npz_path.with_name(npz_path.name + ".tmp")
    with open(tmp_npz, "wb") as f:
        np.savez(f, **_flatten(tree))
    os.replace(tmp_npz, npz_path)


def _unflatten(like, leaves: dict, path=()):
    kids = _children(like)
    if kids is None:
        return leaves["/".join(path)]
    vals = [_unflatten(child, leaves, path + (name,)) for name, child in kids]
    if isinstance(like, dict):
        return dict(zip((k for k, _ in kids), vals))
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def restore(path, like):
    """The checkpoint at ``path`` in the structure of ``like`` (leaves with
    ``shape`` and ``dtype``: tensors or numpy arrays), as CPU tensors.

    Every leaf of ``like`` must be in the file with the same shape and
    dtype, and every array of the file must be taken by a leaf of ``like``;
    otherwise ``ValueError`` names every offending key path."""
    npz_path = _npz_path(path)
    with np.load(npz_path) as z:
        flat = dict(z.items())
    leaves, used, errors = {}, set(), []
    for key, leaf in _flatten_with_path(like):
        want_shape, want_dtype = tuple(leaf.shape), _dtype_name(leaf)
        if key + _BF16_TAG in flat:
            bits = flat[key + _BF16_TAG]
            used.add(key + _BF16_TAG)
            arr = torch.from_numpy(bits.view(np.int16).copy()).view(
                torch.bfloat16)
            shape, dtype = tuple(bits.shape), "bfloat16"
        elif key in flat:
            used.add(key)
            arr = torch.from_numpy(flat[key].copy())
            shape, dtype = flat[key].shape, flat[key].dtype.name
        else:
            errors.append(f"missing leaf '{key}' (wanted {want_shape} "
                          f"{want_dtype})")
            continue
        if shape != want_shape:
            errors.append(f"shape mismatch at '{key}': checkpoint has "
                          f"{shape}, target wants {want_shape}")
        elif dtype != want_dtype:
            errors.append(f"dtype mismatch at '{key}': checkpoint has "
                          f"{dtype}, target wants {want_dtype}")
        leaves[key] = arr
    unexpected = sorted(set(flat) - used)
    if unexpected:
        errors.append("checkpoint leaves absent from the restore target: "
                      + ", ".join(f"'{k.removesuffix(_BF16_TAG)}'"
                                  for k in unexpected))
    if errors:
        raise ValueError(f"cannot restore {npz_path}:\n  "
                         + "\n  ".join(errors))
    return _unflatten(like, leaves)


def load_meta(path) -> dict:
    return json.loads(_npz_path(path).with_suffix(".meta.json").read_text())
