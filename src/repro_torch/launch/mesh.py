"""The federated client mesh of the port: the port of the client half of
``repro.launch.mesh`` (``CLIENT_AXIS``, ``fed_mesh_layout``,
``fed_wave_layout``, ``make_fed_client_mesh``) over ``torch.distributed``.

The JAX package places the packed engine's slots on ``n_devices`` devices
of one process.  The port runs one process per rank instead: the caller
sets up the process group (``torchrun`` and NCCL on cards, gloo on the
CPU), and the client mesh is a 1-D ``DeviceMesh`` named ``("clients",)``
over the whole world.  The slot layout does not depend on the world:
``S = n_devices x pack`` slots keep their numbering, and rank ``r`` of a
world of ``W`` holds the contiguous block ``[r S / W, (r + 1) S / W)``
(``launch.shardings.rank_slots``).  ``n_devices`` stays the layout knob.

Besides the mesh, the helpers every rank of a run calls: ``distributed``
(is there a process group), ``is_rank0``, ``from_rank0`` (a value that
rank 0 computes from device results and every rank receives, so ranks
never split on a result that is not bit-stable on the card) and
``max_over_ranks``.  Importing this module touches no process group.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

CLIENT_AXIS = "clients"               # the federated engines' 1-D mesh axis


def fed_mesh_layout(n_participants: int, *, pack: int = 1,
                    n_devices: int | None = None) -> tuple[int, int]:
    """Client-packed layout: ``(n_devices, n_slots)`` hosting
    ``n_participants`` clients with ``pack`` lanes a device, ``n_slots =
    n_devices * pack``; slot ``s`` is lane ``s % pack`` of device
    ``s // pack``."""
    if pack < 1:
        raise ValueError(f"pack must be >= 1, got {pack}")
    if n_devices is None:
        n_devices = math.ceil(n_participants / pack)
    if n_devices * pack < n_participants:
        raise ValueError(
            f"{n_devices} devices x pack={pack} = {n_devices * pack} slots "
            f"cannot host {n_participants} participants")
    return n_devices, n_devices * pack


def fed_wave_layout(n_participants: int, *, pack: int = 1,
                    n_devices: int | None = None,
                    waves: int | None = None) -> tuple[int, int, int]:
    """Wave-scheduled layout: ``(n_devices, wave_slots, n_waves)`` hosting
    ``n_participants`` clients by streaming them through a FIXED mesh of
    ``wave_slots = n_devices * pack`` slots in ``n_waves`` passes.

    Defaults reproduce the single-wave layout: with ``n_devices=None`` and
    ``waves=None`` the mesh is sized for the whole cohort, ``n_waves == 1``.
    """
    if pack < 1:
        raise ValueError(f"pack must be >= 1, got {pack}")
    if waves is not None and waves < 1:
        raise ValueError(f"waves must be >= 1, got {waves}")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_devices is None:
        per_wave = (n_participants if waves is None
                    else math.ceil(n_participants / waves))
        n_devices = max(1, math.ceil(per_wave / pack))
    wave_slots = n_devices * pack
    if waves is None:
        waves = max(1, math.ceil(n_participants / wave_slots))
    if wave_slots * waves < n_participants:
        raise ValueError(
            f"{waves} waves x {n_devices} devices x pack={pack} = "
            f"{wave_slots * waves} lanes cannot host {n_participants} "
            "participants")
    return n_devices, wave_slots, waves


def distributed() -> bool:
    """Whether the caller has set up a ``torch.distributed`` process group.
    A launch that names a world of several ranks (``WORLD_SIZE``, as
    ``torchrun`` sets it) without one raises: each rank would otherwise run
    the whole run on its own."""
    if dist.is_available() and dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(
            f"WORLD_SIZE={world} but no torch.distributed process group is "
            "set up: call torch.distributed.init_process_group before the "
            "run")
    return False


def is_rank0() -> bool:
    return not distributed() or dist.get_rank() == 0


def make_fed_client_mesh(n_participants: int, *, pack: int = 1,
                         n_devices: int | None = None,
                         device_type: str = "cuda"):
    """1-D ``(CLIENT_AXIS,)`` ``DeviceMesh`` over the whole world of the
    caller's process group, hosting the ``fed_mesh_layout(...)`` slots:
    each rank holds a contiguous block of ``n_slots / world`` of them.
    Raises without a process group, and ``ValueError`` when the world does
    not divide the slot count."""
    n_devices, n_slots = fed_mesh_layout(n_participants, pack=pack,
                                         n_devices=n_devices)
    if not distributed():
        raise RuntimeError(
            "make_fed_client_mesh needs a torch.distributed process group: "
            "run under torchrun, or call init_process_group first")
    world = dist.get_world_size()
    if n_slots % world:
        raise ValueError(
            f"a world of {world} ranks cannot host {n_devices} devices x "
            f"pack={pack} = {n_slots} slots: each rank holds a contiguous "
            "block of slots, so the world size must divide the slot count")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, list(range(world)),
                      mesh_dim_names=(CLIENT_AXIS,))


def from_rank0(fn):
    """``fn()`` computed on rank 0 and received by every rank (pickled; a
    result of host values), or simply ``fn()`` without a process group.
    If ``fn`` raises on rank 0, every other rank raises too, instead of
    waiting for a value that never comes."""
    if not distributed():
        return fn()
    if dist.get_rank() == 0:
        try:
            box = [(True, fn())]
        except Exception as e:
            dist.broadcast_object_list(
                [(False, f"{type(e).__name__}: {e}")], src=0)
            raise
    else:
        box = [None]
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if not ok:
        raise RuntimeError(f"rank 0 failed: {value}")
    return value


def max_over_ranks(value: float, device) -> float:
    """The largest of every rank's ``value`` (``value`` itself without a
    process group): a round ends when its slowest rank does."""
    if not distributed():
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())
