"""The paper's CNN teacher/student models (Tables III and IV) as
``nn.Module``s: the port of ``repro.models.cnn``.

MNIST (Table III):
  Teacher: Conv2D 32-64-64-64, all 3x3 stride 2 'same', Flatten, Dense 10.
  Student: Conv2D 32-16-16-64 (same geometry), Flatten, Dense 10.
HAR (Table IV):
  Teacher: Conv1D 128 k3 s2 'same' + LeakyReLU(0.2) + MaxPool1D(2, s1 'same')
           + Dropout 0.25, Conv1D 256 k3 s2 'same', Flatten, Dense 128 relu,
           Dense 6.
  Student: first Conv1D has 64 filters instead of 128; rest identical.

Layout (``repro_torch.convert`` maps JAX params onto it):

- ``state_dict`` keys mirror the JAX tree paths: ``conv.0.w`` ...
  ``head.b`` for MNIST, ``conv1.w`` ... ``fc2.b`` for HAR;
- conv weights are OIHW / OIW (JAX: HWIO / WIO); dense weights stay
  ``(in, out)`` and are applied as ``h @ w + b``, as in JAX;
- inputs keep the JAX layout (NHWC images, NWC sequences), and activations
  go back to channels-last before the flatten, so the head's rows are in the
  JAX order and need no permutation.

XLA's 'SAME' padding at stride 2 is asymmetric (low 0, high 1 for even
inputs), so convolutions pad explicitly with ``F.pad`` instead of torch's
symmetric ``padding=``.  Dropout (HAR only, ``train=True`` with a ``key``)
draws from a ``torch.Generator`` seeded with the integer ``key``, or takes a
ready ``keep`` mask (the packed engine's per-lane masks,
``make_lane_dropout``); it cannot match ``jax.random``'s bits.

``make_model`` returns ``(init, fwd)`` like the JAX function: ``init(seed,
device)`` gives a dict of parameter tensors, ``fwd(params, x, train, key)``
runs the module over that dict with ``torch.func.functional_call``, which
is how the loop engine copies, steps and merges plain tensor dicts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch import rng


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA 'SAME' (low, high) padding for an input of length ``n``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv2d_same(h, w, b, stride):
    k = w.shape[-1]
    ph = _same_pads(h.shape[-2], k, stride)
    pw = _same_pads(h.shape[-1], k, stride)
    h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(h, w, b, stride=stride)


def _conv1d_same(h, w, b, stride):
    p = _same_pads(h.shape[-1], w.shape[-1], stride)
    return F.conv1d(F.pad(h, p), w, b, stride=stride)


def _maxpool1d_same(h, pool=2, stride=1):
    p = _same_pads(h.shape[-1], pool, stride)
    return F.max_pool1d(F.pad(h, p, value=-math.inf), pool, stride)


class _Layer(nn.Module):
    """One weight/bias pair, named ``w``/``b`` like the JAX leaves."""

    def __init__(self, w_shape, b_shape):
        super().__init__()
        self.w = nn.Parameter(torch.empty(w_shape))
        self.b = nn.Parameter(torch.zeros(b_shape))


class MnistCNN(nn.Module):
    def __init__(self, *, student: bool, num_classes: int = 10,
                 input_hw: tuple[int, int] = (28, 28)):
        super().__init__()
        filters = [32, 16, 16, 64] if student else [32, 64, 64, 64]
        self.conv = nn.ModuleList()
        cin, hw = 1, input_hw[0]
        for f in filters:
            self.conv.append(_Layer((f, cin, 3, 3), (f,)))
            cin = f
            hw = (hw + 1) // 2                       # stride-2 'same'
        self.head = _Layer((hw * hw * filters[-1], num_classes),
                           (num_classes,))

    def forward(self, x, *, train: bool = False, key=None, keep=None):
        del train, key, keep                         # no dropout in Table III
        h = x.float().permute(0, 3, 1, 2)            # NHWC -> NCHW
        for c in self.conv:
            h = F.relu(_conv2d_same(h, c.w, c.b, 2))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
        return h @ self.head.w + self.head.b


class HarCNN(nn.Module):
    def __init__(self, *, student: bool, num_classes: int = 6,
                 input_len: int = 561):
        super().__init__()
        f1 = 64 if student else 128
        l1 = (input_len + 1) // 2          # after the stride-2 conv and pool
        l2 = (l1 + 1) // 2
        self.drop_site = (f1, l1)          # (channels, length) at the dropout
        self.conv1 = _Layer((f1, 1, 3), (f1,))
        self.conv2 = _Layer((256, f1, 3), (256,))
        self.fc1 = _Layer((l2 * 256, 128), (128,))
        self.fc2 = _Layer((128, num_classes), (num_classes,))

    def dropout_shape(self, batch: int) -> tuple:
        """Shape of the Dropout keep mask of a forward on ``batch`` rows."""
        return (batch,) + self.drop_site

    def forward(self, x, *, train: bool = False, key=None, keep=None):
        h = x.float().permute(0, 2, 1)               # NWC -> NCW
        h = _conv1d_same(h, self.conv1.w, self.conv1.b, 2)
        h = F.leaky_relu(h, 0.2)
        h = _maxpool1d_same(h, 2, 1)
        if train and keep is None and key is not None:
            keep = dropout_keep(self.dropout_shape(h.shape[0]), key, h.device)
        if train and keep is not None:               # Dropout 0.25
            h = torch.where(keep, h / 0.75, torch.zeros_like(h))
        h = F.relu(_conv1d_same(h, self.conv2.w, self.conv2.b, 2))
        h = h.permute(0, 2, 1).reshape(h.shape[0], -1)      # NWC flatten
        h = F.relu(h @ self.fc1.w + self.fc1.b)
        return h @ self.fc2.w + self.fc2.b


def dropout_keep(shape, key: int, device) -> torch.Tensor:
    """The Dropout(0.25) keep mask of one forward: a ``torch.Generator``
    seeded with the integer ``key`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(key))
    return torch.rand(shape, generator=gen, device=device) < 0.75


def init_params(module: nn.Module, seed: int, device="cpu") -> dict:
    """He-normal weights (std sqrt(2 / fan_in), fan_in as in the JAX init)
    and zero biases, drawn on the CPU from ``seed`` so every device gets the
    same values, then moved to ``device``."""
    out = {}
    for i, (name, p) in enumerate(module.named_parameters()):
        if name.endswith(".b"):
            out[name] = torch.zeros(p.shape)
            continue
        # conv OI[HW] -> fan_in = I * prod(kernel); dense (in, out) -> in
        fan_in = p.shape[0] if p.dim() == 2 else math.prod(p.shape[1:])
        gen = rng.generator(seed, i)
        out[name] = math.sqrt(2.0 / fan_in) * torch.randn(p.shape,
                                                          generator=gen)
    return {k: v.to(device) for k, v in out.items()}


def _module(dataset: str, *, student: bool) -> nn.Module:
    if dataset == "mnist":
        return MnistCNN(student=student)
    if dataset == "har":
        return HarCNN(student=student)
    raise ValueError(dataset)


def make_model(dataset: str, *, student: bool):
    """(init(seed, device) -> params, fwd(params, x, train, key) -> logits)
    for the paper's models."""
    module = _module(dataset, student=student)

    def init(seed: int, device="cpu"):
        return init_params(module, seed, device)

    def fwd(params, x, *, train: bool = False, key=None, keep=None):
        return functional_call(module, params, (x,),
                               {"train": train, "key": key, "keep": keep})

    return init, fwd


def make_lane_dropout(dataset: str, *, student: bool):
    """None for a model without dropout, else ``keep(seeds, batch, device)
    -> (S, ...) bool``: one Dropout keep mask per client lane, each from its
    own generator (``dropout_keep`` of that lane's integer seed) and of the
    module's ``dropout_shape``.  The packed engine draws them outside its
    vmapped forward and passes lane ``i``'s mask as
    ``fwd(..., keep=masks[i])``."""
    module = _module(dataset, student=student)
    if not hasattr(module, "dropout_shape"):
        return None

    def keep(seeds, batch: int, device):
        shape = module.dropout_shape(batch)
        return torch.stack([dropout_keep(shape, int(s), device)
                            for s in seeds])

    return keep
