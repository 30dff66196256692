"""Offline dataset twins for MNIST and HAR (paper §V-A).

Real MNIST/HAR are not shipped with the repo,
so we generate *structured* synthetic twins with the same shapes, class
counts and a class-conditional signal a CNN can learn:

- MNIST twin : 28x28 grayscale; each class has a smooth random prototype
  (low-frequency pattern) + per-example elastic jitter + pixel noise.
- HAR twin   : 561-dim feature vectors, 6 classes; class prototypes with
  block-correlated sensor-channel noise, mimicking accelerometer/gyro stats.

``load_dataset()`` auto-detects real files under $REPRO_DATA_DIR (idx or .npz)
and falls back to the twins, so the same code path runs against real data
when available.  Generators are deterministic in ``seed``.

A copy of ``repro.data.synthetic`` (the port imports nothing of
the JAX package) with one difference: real data is looked up only when
``$REPRO_DATA_DIR`` is set — there is no built-in default directory.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def input_shape(self) -> tuple[int, ...]:
        return self.x_train.shape[1:]


def _smooth_prototype(rng: np.random.Generator, side: int, cutoff: int = 6) -> np.ndarray:
    """Low-frequency random image prototype via truncated DCT-like basis."""
    coef = rng.normal(size=(cutoff, cutoff))
    u = np.cos(np.pi * np.outer(np.arange(side) + 0.5, np.arange(cutoff)) / side)
    img = u @ coef @ u.T
    img = (img - img.min()) / (np.ptp(img) + 1e-9)
    return img.astype(np.float32)


def make_mnist_twin(
    *, n_train: int = 12000, n_test: int = 2000, seed: int = 0,
    noise: float = 0.35, modes_per_class: int = 3
) -> Dataset:
    """Each class is a MIXTURE of ``modes_per_class`` smooth prototypes
    (real digits are intra-class multimodal — writing styles); this is what
    makes single-class clients drift hard under FedAvg."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_smooth_prototype(rng, 28)
                       for _ in range(10 * modes_per_class)]
                      ).reshape(10, modes_per_class, 28, 28)

    def sample(n):
        y = rng.integers(0, 10, size=n)
        mode = rng.integers(0, modes_per_class, size=n)
        base = protos[y, mode]
        # per-example brightness/contrast jitter + translation by roll
        gain = rng.uniform(0.7, 1.3, size=(n, 1, 1)).astype(np.float32)
        x = base * gain + noise * rng.normal(size=base.shape).astype(np.float32)
        shift = rng.integers(-2, 3, size=(n, 2))
        for i in range(n):  # cheap integer translate
            x[i] = np.roll(x[i], shift[i], axis=(0, 1))
        return np.clip(x, 0.0, 1.5)[..., None].astype(np.float32), y.astype(np.int32)

    xt, yt = sample(n_train)
    xv, yv = sample(n_test)
    return Dataset("mnist", xt, yt, xv, yv, 10)


def make_har_twin(
    *, n_train: int = 7352, n_test: int = 2947, seed: int = 1,
    noise: float = 2.2, modes_per_class: int = 3
) -> Dataset:
    """Class signal is a weak mixture-of-modes prototype buried in strong
    block-correlated sensor noise — calibrated so a central CNN lands around
    the real-HAR ~90% regime instead of saturating instantly."""
    rng = np.random.default_rng(seed)
    f = 561
    protos = rng.normal(size=(6, modes_per_class, f)).astype(np.float32)
    # class signal lives in a sparse ~10% feature support (real HAR features
    # are highly redundant/correlated); the rest is pure sensor noise
    support = rng.random((6, modes_per_class, f)) < 0.10
    protos = (protos * support).astype(np.float32)
    # block-correlated channel noise: 33 blocks of 17 features share a factor
    blocks = np.repeat(np.arange(33), 17)[:f]

    def sample(n):
        y = rng.integers(0, 6, size=n)
        mode = rng.integers(0, modes_per_class, size=n)
        factors = rng.normal(size=(n, 33)).astype(np.float32)
        x = protos[y, mode] + noise * factors[:, blocks] + 0.8 * rng.normal(
            size=(n, f)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    xt, yt = sample(n_train)
    xv, yv = sample(n_test)
    return Dataset("har", xt[..., None], yt, xv[..., None], yv, 6)  # (N,561,1) for Conv1D


def _try_real(name: str) -> Dataset | None:
    root = os.environ.get("REPRO_DATA_DIR")
    if not root:
        return None
    npz = Path(root) / f"{name}.npz"
    if npz.exists():
        z = np.load(npz)
        return Dataset(name, z["x_train"], z["y_train"], z["x_test"], z["y_test"],
                       int(z["y_train"].max()) + 1)
    return None


def load_dataset(name: str, *, seed: int = 0, small: bool = False) -> Dataset:
    """Real data if present under $REPRO_DATA_DIR, else the synthetic twin.

    ``small=True`` shrinks the twin for unit tests."""
    real = _try_real(name)
    if real is not None:
        return real
    if name == "mnist":
        return make_mnist_twin(n_train=1500 if small else 12000,
                               n_test=400 if small else 2000, seed=seed)
    if name == "har":
        return make_har_twin(n_train=1200 if small else 7352,
                             n_test=400 if small else 2947, seed=seed)
    raise ValueError(f"unknown dataset {name!r}")
