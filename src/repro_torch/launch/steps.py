"""Step builders for the decoder-only models: the port of
``repro.launch.steps``.

- ``make_optimizer`` / ``make_train_step``: next-token training with AdamW
  and optional gradient accumulation;
- ``make_prefill_step`` / ``make_decode_step``: serving;
- ``averaging_matrices``, ``chunked_kd_loss`` and
  ``make_fedsikd_distill_step``: the paper's technique at LLM scale, D
  student replicas distilling one frozen teacher, with the intra-cluster
  gradient mean and the end-of-round two-level mean as contractions on the
  replica axis.

PyTorch runs eagerly, so the builders return plain functions; nothing is
compiled.  The training and distillation steps update ``(params,
opt_state)`` in place (``Optimizer.update_``), the port's form of the
JAX steps' ``donate_argnums = (0, 1)``; the teacher is only read.  The
optimizers take flat dicts, so the steps flatten the nested LM params
with dotted keys (``tree.flatten``) at their boundary.  Every step serves
or trains the dense, VLM-prefix and MoE decoders (GQA or MLA attention;
a MoE model's loss carries its load-balance aux); the audio
encoder-decoder's steps raise (ROADMAP Queue 1 item 10.4), and the model
raises for the other unported families.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamState, adamw
from repro_torch.rng import fold_seed
from repro_torch.tree import flatten, unflatten


def _check_decoder(cfg: ModelConfig) -> None:
    if cfg.arch_type == "audio":
        raise NotImplementedError(
            "the audio encoder-decoder's steps are not ported yet (ROADMAP "
            "Queue 1 item 10.4)")


def make_optimizer(cfg: ModelConfig, *, lr: float = 1e-4):
    """AdamW with bfloat16 moments above 8e9 parameters (read from
    ``cfg.param_count()``), float32 below.  Its ``init`` takes the nested
    LM params (or a flat dict) and returns flat moments."""
    big = cfg.param_count() > 8_000_000_000
    base = adamw(lr, state_dtype=torch.bfloat16 if big else torch.float32)
    return dataclasses.replace(base,
                               init=lambda params: base.init(flatten(params)))


def _grad_aliases(flat: dict) -> dict:
    """Leaves that share each parameter's storage and require grad, so a
    step differentiates without changing the caller's tensors' flags."""
    return {k: v.detach().requires_grad_() for k, v in flat.items()}


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-4, accum: int = 1):
    """``(train_step, opt)``.  ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)`` with ``opt_state = opt.init(params)``;
    params, moments and count are updated in place.  With ``accum > 1`` the
    batch is cut into ``accum`` micro-batches along its first axis, their
    gradients summed in float32, divided by ``accum`` and cast to bfloat16
    when ``cfg.dtype`` is, and the loss is the mean of the micro losses."""
    _check_decoder(cfg)
    opt = make_optimizer(cfg, lr=lr)
    grad_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def loss_and_grads(flat_p, batch):
        alias = _grad_aliases(flat_p)
        loss, _ = tf.lm_loss(unflatten(alias), cfg, batch)
        grads = torch.autograd.grad(loss, list(alias.values()))
        return loss.detach(), dict(zip(alias, grads))

    def train_step(params, opt_state, batch):
        flat_p = flatten(params)
        if accum > 1:
            B = batch["tokens"].shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into {accum} "
                                 "micro-batches")
            m = B // accum
            g_sum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in flat_p.items()}
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=batch["tokens"].device)
            for i in range(accum):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                loss, g = loss_and_grads(flat_p, mb)
                for k in g_sum:
                    g_sum[k] += g[k].float()
                l_sum = l_sum + loss
                del g
            grads = {k: (g_sum.pop(k) / accum).to(grad_dtype)
                     for k in list(g_sum)}
            loss = l_sum / accum
        else:
            loss, grads = loss_and_grads(flat_p, batch)
        opt.update_(grads, opt_state, flat_p)
        return params, opt_state, loss

    return train_step, opt


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last-token logits (B, V), cache)``."""
    _check_decoder(cfg)

    def prefill_step(params, batch):
        return tf.prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, tokens (B, 1), pos) -> (logits (B, V),
    cache)``; the cache is updated in place."""
    _check_decoder(cfg)

    def decode_step(params, cache, tokens, pos):
        logits, cache = tf.decode_step(params, cfg, cache, tokens, pos)
        return logits[:, -1, :], cache

    return decode_step


# ------------------------------------------------------- FedSiKD at scale
def averaging_matrices(cluster_of):
    """(A_intra, A_global) on the replica axis, float32 CPU tensors.

    A_intra[d, e] = 1/|C_k| if replicas d and e share cluster k (the
    grouped all-reduce of Alg. 1 line 16); A_global[d, e] =
    1/(K |C_k(e)|) (the two-level FedSiKD mean, Alg. 1 line 18)."""
    cluster_of = np.asarray(cluster_of)
    D = len(cluster_of)
    ks, counts = np.unique(cluster_of, return_counts=True)
    size = {k: c for k, c in zip(ks, counts)}
    K = len(ks)
    intra = np.zeros((D, D), np.float32)
    glob = np.zeros((D, D), np.float32)
    for d in range(D):
        for e in range(D):
            if cluster_of[d] == cluster_of[e]:
                intra[d, e] = 1.0 / size[cluster_of[d]]
            glob[d, e] = 1.0 / (K * size[cluster_of[e]])
    return torch.from_numpy(intra), torch.from_numpy(glob)


def _contract(A: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``einsum("de,e...->d...", A, x)`` in float32, cast back to x's
    dtype: each output replica a sum of float32 terms in replica order, so
    equal rows of A give bit-equal replicas.  Float32 temporaries of one
    replica at a time."""
    out = torch.empty_like(x)
    for d in range(A.shape[0]):
        acc = None
        for e in range(A.shape[1]):
            term = float(A[d, e]) * x[e].float()
            acc = term if acc is None else acc + term
        out[d] = acc.to(x.dtype)
    return out


def _kd_chunk(m_t, l_t, m_s, l_s, m_1, l_1, u, picked, h_s, w_s, h_t, w_t,
              labels, col0: int, tau: float):
    """One vocab chunk of ``chunked_kd_loss``: its (T, chunk) logits and
    the online updates of the eight (T,) accumulators."""
    s = (h_s @ w_s).float()
    t = (h_t @ w_t).float()

    def online(m, l, x):
        m_new = torch.maximum(m, x.amax(-1))
        return m_new, l * torch.exp(m - m_new) + torch.exp(
            x - m_new[:, None]).sum(-1)

    m_t_new = torch.maximum(m_t, (t / tau).amax(-1))
    scale = torch.exp(m_t - m_t_new)
    w_unnorm = torch.exp(t / tau - m_t_new[:, None])
    u = u * scale + (w_unnorm * ((t - s) / tau)).sum(-1)
    l_t = l_t * scale + w_unnorm.sum(-1)
    m_s, l_s = online(m_s, l_s, s / tau)
    m_1, l_1 = online(m_1, l_1, s)
    cols = col0 + torch.arange(s.shape[1], device=s.device)
    hit = cols[None, :] == labels[:, None]
    picked = picked + torch.where(hit, s, torch.zeros((), device=s.device)
                                  ).sum(-1)
    return m_t_new, l_t, m_s, l_s, m_1, l_1, u, picked


def chunked_kd_loss(h_s, w_s, h_t, w_t, labels, *, tau: float, alpha: float,
                    chunk: int = 8192):
    """The distillation loss from final hidden states in vocab chunks, the
    plain-torch port of the JAX package's jnp mirror of the KD kernel:
    each chunk's logits come from ``h @ w[:, chunk]`` inside a
    ``torch.utils.checkpoint`` (recomputed in the backward), with online
    max/sum accumulators, so the (T, V) logits never exist whole.

    h_s, h_t: (T, d); w_s, w_t: (d, V) heads; labels: (T,), -1 = ignore.
    V need not divide by ``chunk``: the last chunk is shorter (JAX pads it
    with masked columns, which add exactly nothing).  Returns the mean of
    (1-alpha) CE + alpha tau^2 KL over the labels >= 0."""
    T = h_s.shape[0]
    V = w_s.shape[1]
    z = torch.zeros((T,), dtype=torch.float32, device=h_s.device)
    neg = torch.full((T,), NEG, dtype=torch.float32, device=h_s.device)
    carry = (neg, z, neg, z, neg, z, z, z)
    for c0 in range(0, V, chunk):
        carry = checkpoint(_kd_chunk, *carry, h_s, w_s[:, c0:c0 + chunk],
                           h_t, w_t[:, c0:c0 + chunk], labels, c0, tau,
                           use_reentrant=False)
    m_t, l_t, m_s, l_s, m_1, l_1, u, picked = carry
    logz_t = m_t + torch.log(l_t)
    logz_s = m_s + torch.log(l_s)
    logz_1 = m_1 + torch.log(l_1)
    kl = u / l_t + logz_s - logz_t
    ce = logz_1 - picked
    mask = (labels >= 0).float()
    per_tok = ((1.0 - alpha) * ce + alpha * tau * tau * kl) * mask
    return per_tok.sum() / torch.clamp(mask.sum(), min=1.0)


def make_fedsikd_distill_step(cfg: ModelConfig, cluster_of, *,
                              lr: float = 1e-4, kd_alpha: float = 0.5,
                              kd_tau: float = 2.0,
                              teacher_in_grad: bool = False,
                              vocab_chunk: int = 0):
    """``(distill_step, sync, init_students, opt, s_cfg)``.

    Students are one nest of params with a leading D axis on every leaf
    (``init_students``), the JAX layout, so ``convert.lm_params_from_jax``
    carries JAX students across; ``opt.init(students)`` gives their Adam
    state (flat moments with the D axis, a (D,) count).  The teacher is a
    full-depth model, only read.  One step: each replica's distillation
    gradient, the intra-cluster mean (``A_intra`` on the replica axis, in
    float32), then each replica's AdamW in place.  ``sync(students)``
    applies the two-level global mean (``A_global``) in place.

    The loss paths, as in JAX:

    - default: the teacher's logits from one forward of the whole batch
      under ``torch.no_grad()`` (on the card the flash kernel), the
      students' logits from their training forwards, and the D replicas'
      loss in one call of ``ops.kd_distillation_loss_lanes`` (the KD
      kernels on the card; its (D,) per-replica means are JAX's
      ``vmap(kd_loss)``);
    - ``teacher_in_grad=True``: each replica's teacher forward inside the
      student's checkpointed closure, so the backward recomputes the
      teacher; the loss as in the default;
    - ``vocab_chunk > 0``: the teacher's final hidden states once, and
      each replica's loss by ``chunked_kd_loss``, no KD kernel.
    """
    _check_decoder(cfg)
    s_cfg = cfg.as_student()
    base = make_optimizer(s_cfg, lr=lr)
    A_intra, A_global = (a.numpy() for a in averaging_matrices(cluster_of))
    D = len(np.asarray(cluster_of))
    P = cfg.prefix_len

    def init_opt(students):
        state = base.init(students)
        count = torch.zeros((D,), dtype=torch.int32,
                            device=state.count.device)
        return AdamState(state.mu, state.nu, count)

    opt = dataclasses.replace(base, init=init_opt)

    def _replica(tree, d):
        return {k: _replica(v, d) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree[d]

    def _merged(batch):
        return {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}

    def _drop_prefix(x):
        return x[:, P:] if P else x

    def _head(params):
        return params["embed"].T if cfg.tie_embeddings else params["lm_head"]

    def _student_logits(student, b):
        s_logits, _ = tf.forward(student, s_cfg, b, train=True)
        return _drop_prefix(s_logits)

    def _naive(student, teacher, b):
        with torch.no_grad():
            t_logits, _ = tf.forward(teacher, cfg, b)
        return _student_logits(student, b), _drop_prefix(t_logits)

    def _lanes_loss(s_logits, t_logits, labels):
        V = s_logits.shape[-1]
        return ops.kd_distillation_loss_lanes(
            s_logits.reshape(D, -1, V), t_logits.reshape(D, -1, V),
            labels.reshape(D, -1), tau=kd_tau, alpha=kd_alpha)

    def losses_of(reps, teacher, batch):
        labels = batch["labels"]
        if teacher_in_grad:
            pairs = [checkpoint(_naive, reps[d], teacher, _replica(batch, d),
                                use_reentrant=False) for d in range(D)]
            return _lanes_loss(torch.stack([s for s, _ in pairs]),
                               torch.stack([t for _, t in pairs]), labels)
        if vocab_chunk:
            with torch.no_grad():
                t_hidden, _ = tf.forward(teacher, cfg, _merged(batch),
                                         return_hidden=True)
                t_hidden = _drop_prefix(t_hidden)
                t_hidden = t_hidden.reshape(D, -1, t_hidden.shape[-1])
            w_t = _head(teacher).detach()
            out = []
            for d in range(D):
                s_hidden, _ = tf.forward(reps[d], s_cfg, _replica(batch, d),
                                         return_hidden=True, train=True)
                s_hidden = _drop_prefix(s_hidden)
                out.append(chunked_kd_loss(
                    s_hidden.reshape(-1, s_hidden.shape[-1]),
                    _head(reps[d]), t_hidden[d], w_t,
                    labels[d].reshape(-1), tau=kd_tau, alpha=kd_alpha,
                    chunk=vocab_chunk))
            return torch.stack(out)
        with torch.no_grad():
            t_logits, _ = tf.forward(teacher, cfg, _merged(batch))
            t_logits = _drop_prefix(t_logits)
        s_logits = torch.stack([_student_logits(reps[d], _replica(batch, d))
                                for d in range(D)])
        return _lanes_loss(s_logits, t_logits, labels)

    def distill_step(students, opt_state, teacher, batch):
        """batch leaves: (D, B/D, ...), one micro-batch a replica.  Returns
        (students, opt_state, mean loss over replicas), the first two
        updated in place."""
        flat_s = flatten(students)
        alias = _grad_aliases(flat_s)
        nested = unflatten(alias)
        reps = [_replica(nested, d) for d in range(D)]
        losses = losses_of(reps, teacher, batch)
        grads = list(torch.autograd.grad(losses.sum(),
                                         list(alias.values())))
        del reps, nested, alias
        for i, g in enumerate(grads):      # one leaf's temporaries at a time
            grads[i] = _contract(A_intra, g)
            del g
        grads = dict(zip(flat_s, grads))
        for d in range(D):
            opt.update_({k: g[d] for k, g in grads.items()},
                        AdamState({k: m[d] for k, m in opt_state.mu.items()},
                                  {k: v[d] for k, v in opt_state.nu.items()},
                                  opt_state.count[d]),
                        {k: p[d] for k, p in flat_s.items()})
        return students, opt_state, losses.detach().mean()

    @torch.no_grad()
    def sync(students):
        """End-of-round two-level FedSiKD mean across replicas, in place."""
        for w in flatten(students).values():
            w.copy_(_contract(A_global, w))
        return students

    def init_students(seed: int, *, device="cuda"):
        """D student replicas stacked on a leading axis, replica d from
        ``init_lm(fold_seed(seed, d), s_cfg)``."""
        flat = None
        for d in range(D):
            one = flatten(tf.init_lm(fold_seed(seed, d), s_cfg,
                                     device=device))
            if flat is None:
                flat = {k: torch.empty((D, *v.shape), dtype=v.dtype,
                                       device=v.device)
                        for k, v in one.items()}
            for k, v in one.items():
                flat[k][d] = v
            del one
        return unflatten(flat)

    return distill_step, sync, init_students, opt, s_cfg
