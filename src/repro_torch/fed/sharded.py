"""Client-packed federated runtime: the port of ``repro.fed.sharded`` (the
FedSiKD round programs, the FedAvg/FedProx round program, the client mesh
and the staging helpers the packed strategies call).

The JAX package hosts ``C = devices x pack`` client lanes on a device mesh
and ``vmap``s each local step over the lanes inside ``shard_map``.  The
port holds a rank's slots in one ``(S / W, ...)`` stack per parameter leaf
(every slot, ``(S, ...)``, with no process group) and the lane axis is a
batch axis written out:

- the forward of all lanes is ``torch.func.vmap(functional_call(...))``
  over the stacked params (the convolutions become grouped convolutions);
- each step sums the per-lane mean losses and calls ONE
  ``torch.autograd.grad``; lanes are independent, so the gradient of the
  sum is each lane's own gradient;
- the KD student loss is ``ops.kd_distillation_loss_lanes``: one forward
  and one backward kernel launch for all lanes of a step (no ``vmap``
  around the ``autograd.Function``);
- Adam runs as ``vmap(opt.update)`` over the stacked params and state (a
  per-lane step count), and lanes past their budget are frozen with
  ``torch.where(live, new, old)`` over params AND optimizer state, as
  ``_masked_scan_steps`` does in JAX;
- ``jax.lax.scan`` is a Python loop that stops at the longest budget of the
  wave (later steps would be frozen on every lane), and the losses stay on
  the device: a wave syncs with the host once, when the caller reads its
  loss scalars.

A round's cohort may span several waves of ``S`` slots (``RoundPlan.wave``);
every wave runs the same fixed-shape program, and ``WaveStager`` stages
wave ``w + 1``'s data while wave ``w`` computes.

The client mesh (``make_client_mesh``: one rank a process of the caller's
``torch.distributed`` group) places slots only: rank ``r`` of ``W`` holds
the contiguous block ``[r S / W, (r + 1) S / W)`` and stages only its
block; the round programs take the plan's full ``(S,)`` budgets, seeds and
operators and cut the rank's block themselves.  Every rank runs the wave's
longest budget over ALL slots (its lanes past budget frozen), so the ranks
stay in step and each launches the KD kernels as one card would; the
teacher sync and the aggregation all-gather the blocks
(``core.cluster_collectives``), and the loss means all-reduce their sums.
With no process group the mesh is ``None`` and every program computes
exactly what it computed before the mesh existed.

Step budgets (``n_steps``) are host numpy arrays, as the strategies build
them; random streams are integer seeds (``repro_torch.rng``) read only by
models with dropout (HAR), whose per-lane keep masks are drawn outside the
vmapped forward (``models.cnn.make_lane_dropout``).  Aggregation is
``core.cluster_collectives``: FedSiKD's round contracts the plan's
two-level row, FedAvg/FedProx's (``make_packed_baseline_round``) the
example-weighted row, each one product a leaf.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.func import vmap

from repro_torch import guards, perf, rng
from repro_torch.core import cluster_collectives as cc
from repro_torch.core.distill import distillation_loss, softmax_cross_entropy
from repro_torch.fed.schedule import RoundPlan
from repro_torch.kernels import ops
from repro_torch.launch.mesh import distributed, make_fed_client_mesh
from repro_torch.launch.shardings import local_block
from repro_torch.optim import Optimizer, apply_updates, fedprox_penalty
from repro_torch.tree import tree_map


# ------------------------------------------------------------ client mesh
def make_client_mesh(n_devices: int, *, pack: int = 1, device):
    """The client mesh that hosts ``n_devices x pack`` slots over the
    process group the caller has set up (``launch.mesh.
    make_fed_client_mesh``: a ``ValueError`` names a world that does not
    divide the slots), or ``None`` without one: the engine then keeps
    every slot in this process."""
    if not distributed():
        return None
    return make_fed_client_mesh(n_devices * pack, pack=pack,
                                n_devices=n_devices,
                                device_type=torch.device(device).type)


# ------------------------------------------------------------ data staging
def stack_client_data(shards, steps_per_round: int, batch_size: int, *,
                      seed: int = 0):
    """(C, steps, B, ...) arrays — every client padded to the same number of
    steps per round (shorter clients repeat batches cyclically; pair with
    ``client_step_counts`` to mask the repeats out).  The packed engine
    stages ALL clients once and row-gathers each round's participants onto
    slots (``RoundPlan.slot_client``)."""
    xs, ys = [], []
    for sh in shards:
        bx, by = [], []
        epoch = 0
        while len(bx) < steps_per_round:
            for x, y in sh.batches(batch_size, epoch=epoch, seed=seed):
                bx.append(x)
                by.append(y)
                if len(bx) == steps_per_round:
                    break
            epoch += 1
        xs.append(np.stack(bx))
        ys.append(np.stack(by))
    return np.stack(xs), np.stack(ys)


def client_step_counts(shards, batch_size: int, epochs: int) -> np.ndarray:
    """Number of REAL optimizer steps per client for ``epochs`` local epochs
    (matches the loop engine's per-client batch count)."""
    return np.asarray([math.ceil(sh.num_examples / batch_size) * epochs
                       for sh in shards], np.int32)


def stage_on_slots(plan: RoundPlan, *arrays, device, row_maps=None,
                   mesh=None):
    """Row-gather this round's participants onto slots and copy the (S, ...)
    stacks to ``device`` (idle slots carry row 0; they run zero steps); on
    a client ``mesh``, this rank's block of slots only.

    The gather stays on the host (``arrays`` are the (C, ...) numpy stacks
    built once by ``stack_client_data``): for a CUDA device it writes
    straight into pinned host memory, and each array is one ``non_blocking``
    copy on the current stream.  ``row_maps`` (one entry per array, ``None``
    = identity) translates the plan's client ids into each array's row space
    (the KD teacher feed maps a slot to its cluster leader's rows)."""
    device = torch.device(device)
    cid = local_block(np.where(plan.active, plan.slot_client, 0), mesh)
    maps = (None,) * len(arrays) if row_maps is None else row_maps
    out = []
    for a, m in zip(arrays, maps):
        a = np.asarray(a)
        idx = cid if m is None else np.asarray(m)[cid]
        if device.type != "cuda":
            out.append(torch.from_numpy(np.ascontiguousarray(a[idx]))
                       .to(device))
            continue
        host = torch.empty((len(idx),) + a.shape[1:],
                           dtype=torch.from_numpy(a[:0]).dtype,
                           pin_memory=True)
        np.take(a, idx, axis=0, out=host.numpy())
        out.append(host.to(device, non_blocking=True))
    return tuple(out)


class WaveStager:
    """Stages wave assignments: an insertion-ordered LRU of staged waves
    plus a dict of in-flight prefetches, so wave ``w+1``'s host gather and
    copy run on a background thread while wave ``w`` computes, and the next
    round's wave-0 prefetch coexists with this round's waves.

    ``stage(plan)`` returns the (S, ...) device tensors of ``plan``'s slot
    assignment: a staged entry (an LRU hit), else an adopted prefetch, else
    a synchronous ``stage_on_slots``.  ``capacity`` bounds both the staged
    LRU and the pending dict; size it ``n_waves + 1`` so a whole round's
    waves and the next round's wave-0 prefetch fit (repeat assignments, as
    ``participation="full"`` gives, then upload once per run).  A
    mispredicted prefetch is never a source of truth: it stays pending
    until evicted by later prefetches, and a ``stage`` of another key
    gathers synchronously.

    On a CUDA device a prefetch's copies run on a side stream and end with
    a recorded event; adopting it makes the current (compute) stream wait
    on that event and marks every tensor with ``record_stream`` on it, so
    the caching allocator keeps a staged entry's memory until the compute
    stream is done with it, even if the LRU evicts the entry first.

    Overlap accounting (``perf``): adopting a prefetch records its
    background gather time that ran hidden (``stage_hidden``) and the
    residual join wait (``stage_wait``); a cold or mispredicted wave records
    its whole synchronous gather as ``stage_wait``.  The ``wave-stage``,
    ``wave-prefetch`` and ``wave-evict`` jitter points let the race harness
    stretch each handoff.  On a client ``mesh`` each rank stages its own
    block of slots, with its own prefetch thread."""

    def __init__(self, *arrays, device, row_maps: Optional[Sequence] = None,
                 capacity: int = 2, mesh=None):
        self.arrays, self.row_maps, self.mesh = arrays, row_maps, mesh
        self.device = torch.device(device)
        self.capacity = max(2, int(capacity))
        self._staged: dict[bytes, tuple] = {}     # insertion-ordered LRU
        self._pending: dict[bytes, tuple] = {}    # key -> (thread, box)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def _gather(self, plan: RoundPlan):
        return stage_on_slots(plan, *self.arrays, device=self.device,
                              row_maps=self.row_maps, mesh=self.mesh)

    def _put(self, key: bytes, staged) -> None:
        self._staged[key] = staged
        while len(self._staged) > self.capacity:
            self._staged.pop(next(iter(self._staged)))

    def stage(self, plan: RoundPlan):
        key = plan.slot_client.tobytes()
        hit = self._staged.pop(key, None)
        if hit is not None:
            self._put(key, hit)                   # LRU refresh
            return hit
        pend = self._pending.pop(key, None)
        if pend is not None:
            th, box = pend
            guards.jitter_point("wave-stage")
            t0 = time.perf_counter()
            th.join()
            wait = time.perf_counter() - t0
            staged = box.get("staged")
            if staged is not None:
                if self._side is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(box["event"])
                    for t in staged:              # allocated on the side
                        t.record_stream(cur)      # stream, read on this one
                perf.add("stage_hidden", max(0.0, box["dt"] - wait))
                perf.add("stage_wait", wait)
                self._put(key, staged)
                return staged
            # the background gather failed: the synchronous one re-raises
        t0 = time.perf_counter()
        staged = self._gather(plan)
        perf.add("stage_wait", time.perf_counter() - t0)
        self._put(key, staged)
        return staged

    def prefetch(self, plan: RoundPlan):
        """Begin staging ``plan``'s slot assignment on a background thread
        (a no-op if it is already staged or in flight)."""
        key = plan.slot_client.tobytes()
        if key in self._staged or key in self._pending:
            return
        box: dict = {}

        def work():
            guards.jitter_point("wave-prefetch")
            t0 = time.perf_counter()
            try:
                if self._side is None:
                    box["staged"] = self._gather(plan)
                else:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(self._side):
                        staged = self._gather(plan)
                        event = torch.cuda.Event()
                        event.record()
                    box["event"], box["staged"] = event, staged
            except Exception as e:  # raised again by the synchronous retry
                box["error"] = e
            box["dt"] = time.perf_counter() - t0

        th = threading.Thread(target=work, daemon=True, name="wave-prefetch")
        th.start()
        self._pending[key] = (th, box)
        # eviction happens on this (the driver's) thread only: an evicted
        # worker finishes into its own box and is never adopted
        guards.jitter_point("wave-evict")
        while len(self._pending) > self.capacity:
            self._pending.pop(next(iter(self._pending)))


# ------------------------------------------------------------ slot streams
def slot_client_keys(base: int, plan: RoundPlan, *,
                     offset: int = 0) -> np.ndarray:
    """One integer seed per slot, folded by ``offset +`` the hosted CLIENT
    id: streams stay stable under slot re-assignment across rounds (idle
    slots fold client 0; they never train)."""
    cid = np.where(plan.active, plan.slot_client, 0)
    return np.asarray([rng.fold_seed(base, offset + int(c)) for c in cid],
                      np.int64)


def slot_cluster_keys(base: int, plan: RoundPlan) -> np.ndarray:
    """One integer seed per slot, folded by the slot's CLUSTER index: all
    slots of a cluster share one stream (identical batches and identical
    dropout masks keep teacher replicas in sync between syncs)."""
    kidx = np.where(plan.active, plan.slot_cluster, 0)
    return np.asarray([rng.fold_seed(base, int(k)) for k in kidx], np.int64)


def take_rows(tree: dict, idx: int, *, mesh=None) -> dict:
    """Lane ``idx`` (a global slot id) of every slot stack as a COPY, on
    every rank: a straggler's update waits in the staleness buffer for
    rounds, and a view would pin the whole slot stack (S times the memory)
    and share storage with it.  On a client ``mesh`` the rank that holds
    the lane sends it (``cluster_collectives.gather_slots``)."""
    rows = cc.gather_slots(tree, [idx], mesh=mesh)
    return {k: v[0].clone() for k, v in rows.items()}


# ------------------------------------------------------------ lane helpers
def stacked_opt_init(opt: Optimizer, params: dict):
    """Optimizer state for an (S, ...) params stack: the moments of the
    stack and one step count per lane ((S,) int32)."""
    state = opt.init(params)
    S = next(iter(params.values())).shape[0]
    return state._replace(count=torch.zeros(S, dtype=torch.int32,
                                            device=state.count.device))


def _where_live(live, new, old):
    """Lane-wise ``torch.where(live, new, old)`` over two state trees."""
    def leaf(n, o):
        return torch.where(live.reshape((-1,) + (1,) * (o.dim() - 1)), n, o)
    return tree_map(leaf, new, old)


def _lane_forward(fwd: Callable, params, x, *, train: bool, keep=None):
    """``fwd`` over S lanes: params leaves (S, ...), x (S, B, ...) and the
    optional (S, ...) dropout masks -> (S, B, V) logits."""
    if keep is None:
        return vmap(lambda p, xb: fwd(p, xb, train=train))(params, x)
    return vmap(lambda p, xb, m: fwd(p, xb, train=train, keep=m))(
        params, x, keep)


def _lane_keep(lane_dropout, seeds, step: int, batch: int, device):
    """This step's per-lane dropout masks (None for a model without)."""
    if lane_dropout is None:
        return None
    return lane_dropout([rng.fold_seed(int(s), step) for s in seeds], batch,
                        device)


def _grad_update(opt: Optimizer, params, opt_state, loss_fn):
    """One optimizer step on every lane: ``loss_fn(params) -> (S,)`` per-lane
    losses; ONE ``autograd.grad`` of their sum gives every lane its own
    gradient."""
    pg = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(pg)
    grads = torch.autograd.grad(loss.sum(), list(pg.values()))
    updates, opt_state = vmap(opt.update)(dict(zip(pg, grads)), opt_state,
                                          params)
    with torch.no_grad():
        return apply_updates(params, updates), opt_state, loss.detach()


def _masked_scan_steps(step_fn, carry, xs, ys, n_steps: np.ndarray,
                       mesh=None):
    """Run ``step_fn(carry, x, y, i) -> (carry, (S,) loss)`` over the step
    axis of ``xs`` (S, T, B, ...), freezing each lane once its budget
    ``n_steps`` (host (S,) ints over the plan's slots) is spent: shorter
    clients stop early and idle slots (``n_steps == 0``) never move,
    exactly as in the sequential loop engine.  On a client ``mesh`` the
    carry and ``xs`` hold this rank's block, and every rank runs the
    longest budget of all slots.  Returns the carry and each lane's mean
    loss over its real steps, both on the device."""
    n_max = int(np.max(n_steps, initial=0))
    if n_max > xs.shape[1]:
        raise ValueError(f"step budget {n_max} exceeds the {xs.shape[1]} "
                         "staged steps")
    n_dev = torch.as_tensor(local_block(np.asarray(n_steps), mesh),
                            device=xs.device)
    total = torch.zeros(xs.shape[0], dtype=torch.float32, device=xs.device)
    for i in range(n_max):
        new_carry, loss = step_fn(carry, xs[:, i], ys[:, i], i)
        live = i < n_dev
        carry = _where_live(live, new_carry, carry)
        total = total + torch.where(live, loss.float(), 0.0)
    return carry, total / torch.clamp(n_dev.float(), min=1.0)


def _make_teacher_step(t_fwd: Callable, t_opt: Optimizer, seeds,
                       lane_dropout):
    """One lane-stacked teacher CE step (Alg. 1 line 12), shared by the
    warm-up phase and the in-round teacher refresh."""

    def t_step(carry, x, y, i):
        p, s = carry
        keep = _lane_keep(lane_dropout, seeds, i, x.shape[1], x.device)
        p, s, loss = _grad_update(t_opt, p, s, lambda pg: vmap(
            softmax_cross_entropy)(_lane_forward(t_fwd, pg, x, train=True,
                                                 keep=keep), y))
        return (p, s), loss

    return t_step


def _active_mean(loss, n_steps: np.ndarray, mesh=None):
    """Mean of per-lane losses over the ACTIVE slots (of the whole mesh:
    the numerator and the denominator are summed over the ranks)."""
    act = torch.as_tensor(local_block(np.asarray(n_steps) > 0, mesh),
                          device=loss.device)
    num, den = torch.where(act, loss, 0.0).sum(), act.sum().float()
    if mesh is not None:
        both = torch.stack([num, den])
        dist.all_reduce(both, group=mesh.get_group())
        num, den = both
    return num / torch.clamp(den, min=1.0)


def _operator(table, device):
    return torch.as_tensor(np.asarray(table), dtype=torch.float32,
                           device=device)


# ----------------------------------------- FedSiKD packed KD round engine
def make_packed_teacher_phase(t_fwd: Callable, t_opt: Optimizer, *,
                              lane_dropout=None, mesh=None):
    """Teacher-only phase over the slot stack: CE steps on every slot's
    teacher feed, then intra-cluster teacher sync with the plan's (S, S)
    operator.  Used for Alg. 1's KD-establishment warm-up.

    Returns phase(tp, ts, xs, ys, n_steps, rng, sync_mat) -> (tp, ts,
    teacher_loss): ``tp``/``ts`` are (S, ...) params and Adam state, ``xs``
    / ``ys`` (S, T, B, ...) device batches, ``n_steps`` and ``rng`` (S,) host
    budgets and integer seeds, ``sync_mat`` the (S, S) operator.  On a
    client ``mesh`` the tensors hold this rank's block of slots, the host
    arrays and the operator the plan's whole ones."""

    def phase(tp, ts, xs, ys, n_steps, rng_seeds, sync_mat):
        step = _make_teacher_step(t_fwd, t_opt, local_block(rng_seeds, mesh),
                                  lane_dropout)
        (tp, ts), loss = _masked_scan_steps(step, (tp, ts), xs, ys, n_steps,
                                            mesh)
        sync = _operator(sync_mat, xs.device)
        tp = cc.packed_teacher_sync(tp, sync, mesh=mesh)
        ts = cc.packed_teacher_sync(ts, sync, mesh=mesh)
        return tp, ts, _active_mean(loss, n_steps, mesh)

    return phase


def make_packed_kd_round(t_fwd: Callable, s_fwd: Callable, t_opt: Optimizer,
                         s_opt: Optimizer, *, kd_temperature: float = 2.0,
                         kd_alpha: float = 0.5, kd_impl: str = "fused",
                         t_dropout=None, s_dropout=None, mesh=None):
    """The full FedSiKD round (Alg. 1 lines 10-18) over the slot stack:

      1. teacher CE steps on each slot's teacher feed             (line 12)
      2. intra-cluster teacher sync with the runtime (S, S) operator
      3. student distillation steps vs the synced teacher — the loss is the
         fused KD kernel for all lanes at once (``kd_impl="fused"``) or the
         plain ``core.distill.distillation_loss`` per lane
         (``kd_impl="reference"``)                              (line 13-14)
      4. aggregation with the plan's (S,) weight row: the unbiased two-level
         mean collapsed into one contraction                    (lines 16-18)

    Returns round_fn(tp, ts, sp, ss, tx, ty, t_n, sx, sy, s_n, t_rng, s_rng,
    sync_mat, agg_row) -> (tp, ts, sp, sp_local, ss, teacher_loss,
    student_loss), the signature of the JAX program: params and Adam state
    carry a leading (S,) slot axis, ``sp_local`` is each slot's student after
    its local steps and before aggregation, the two losses are device
    scalars (means over the active slots).  ``t_n``/``s_n`` and
    ``t_rng``/``s_rng`` are (S,) host budgets and seeds; ``t_dropout`` /
    ``s_dropout`` are the models' ``make_lane_dropout`` (None without
    dropout).  On a client ``mesh`` the params, state and batches hold this
    rank's block of slots, the host arrays and operators the plan's whole
    ones."""
    if kd_impl not in ("fused", "reference"):
        raise ValueError(
            f"kd_impl must be 'fused' or 'reference', got {kd_impl!r}")

    def kd_loss(s_logits, t_logits, y):
        if kd_impl == "fused":
            return ops.kd_distillation_loss_lanes(
                s_logits, t_logits, y, tau=kd_temperature, alpha=kd_alpha)
        return vmap(lambda s, t, yy: distillation_loss(
            s, t, yy, temperature=kd_temperature, alpha=kd_alpha)[0])(
                s_logits, t_logits, y)

    def kd_round(tp, ts, sp, ss, tx, ty, t_n, sx, sy, s_n, t_rng, s_rng,
                 sync_mat, agg_row):
        # ---- 1-2: teacher refresh (per lane) + sync
        t_step = _make_teacher_step(t_fwd, t_opt, local_block(t_rng, mesh),
                                    t_dropout)
        (tp, ts), t_loss = _masked_scan_steps(t_step, (tp, ts), tx, ty, t_n,
                                              mesh)
        sync = _operator(sync_mat, tx.device)
        tp = cc.packed_teacher_sync(tp, sync, mesh=mesh)
        ts = cc.packed_teacher_sync(ts, sync, mesh=mesh)
        s_seeds = local_block(s_rng, mesh)

        # ---- 3: student distillation against the synced cluster teacher
        def s_step(carry, x, y, i):
            p, s = carry
            with torch.no_grad():
                t_logits = _lane_forward(t_fwd, tp, x, train=False)
            keep = _lane_keep(s_dropout, s_seeds, i, x.shape[1], x.device)
            p, s, loss = _grad_update(s_opt, p, s, lambda pg: kd_loss(
                _lane_forward(s_fwd, pg, x, train=True, keep=keep),
                t_logits, y))
            return (p, s), loss

        (sp, ss), s_loss = _masked_scan_steps(s_step, (sp, ss), sx, sy, s_n,
                                              mesh)

        # ---- 4: plan-weighted mean -> every slot
        sp_local = sp
        sp = cc.packed_weighted_mean(sp, _operator(agg_row, sx.device),
                                     mesh=mesh)
        return (tp, ts, sp, sp_local, ss, _active_mean(t_loss, t_n, mesh),
                _active_mean(s_loss, s_n, mesh))

    return kd_round


# -------------------------------------------- FedAvg/FedProx packed engine
def make_packed_baseline_round(fwd: Callable, opt: Optimizer, *,
                               prox_mu: float = 0.0, lane_dropout=None,
                               mesh=None):
    """One FedAvg (``prox_mu=0``) or FedProx round over the slot stack:

      1. plain-CE local steps on every participating slot's batches, with
         FedProx's proximal term ``(mu/2)||w - w_g||^2`` added per lane
         against the ROUND-START global params (one unstacked dict, shared
         by every lane and never differentiated), masked like every other
         step quantity (idle slots never move);
      2. one all-clients aggregation: the runtime (S,) example-weighted row
         (``RoundPlan.example_row``) contracted by
         ``cluster_collectives.packed_weighted_mean``, the stacked form of
         the loop engine's ``aggregation.fedavg(locals, sizes)``.

    Returns round_fn(p, s, xs, ys, n_steps, rng, agg_row, global_p) ->
    (p, p_local, s, train_loss), the signature of the JAX program: params
    and Adam state carry a leading (S,) slot axis, batch stacks are (S,
    steps, B, ...), ``n_steps`` and ``rng`` are (S,) host budgets and
    integer seeds, ``p_local`` is each slot's params after its local steps
    and before aggregation, and ``train_loss`` is a device scalar (the mean
    over the active slots).  After the call every slot holds the aggregate.
    ``lane_dropout`` is the model's ``make_lane_dropout`` (None without
    dropout).  On a client ``mesh`` the params, state and batches hold
    this rank's block of slots, the host arrays and the row the plan's
    whole ones."""
    prox = vmap(lambda q, g: fedprox_penalty(q, g, prox_mu),
                in_dims=(0, None))

    def baseline_round(p, s, xs, ys, n_steps, rng_seeds, agg_row, global_p):
        seeds = local_block(rng_seeds, mesh)

        def step(carry, x, y, i):
            p, s = carry
            keep = _lane_keep(lane_dropout, seeds, i, x.shape[1], x.device)

            def loss_fn(pg):
                loss = vmap(softmax_cross_entropy)(
                    _lane_forward(fwd, pg, x, train=True, keep=keep), y)
                if prox_mu:
                    loss = loss + prox(pg, global_p)
                return loss

            p, s, loss = _grad_update(opt, p, s, loss_fn)
            return (p, s), loss

        (p, s), loss = _masked_scan_steps(step, (p, s), xs, ys, n_steps,
                                          mesh)
        p_local = p
        p = cc.packed_weighted_mean(p, _operator(agg_row, xs.device),
                                    mesh=mesh)
        return p, p_local, s, _active_mean(loss, n_steps, mesh)

    return baseline_round
