"""The port's recurrent families against the JAX package on the CPU: the
chunked decay scan (``models/chunked_scan.py``: both conventions, chunks 8
and 32, T not a chunk multiple, chained initial states, decays far below
the floor, the one-step recurrence), the Mamba2 and RWKV6 blocks
(``models/ssm.py``, ``models/rwkv.py``: forward with their carries, then
decode), and the two models built of them at smoke size, rwkv6-3b (``ssm``)
and zamba2-1.2b (``hybrid``: Mamba2 layers and one shared attention block
after every ``attn_every``): configs, init tree, the param converter,
forward, prefill then decode against the full forward, the rotating
sliding-window buffer, the decode cache's layout, ``lm_loss`` and its
gradients, and ``examples/serve_torch.py``.

Both packages get the same inputs: JAX's params carried over by
``lm_params_from_jax`` (for the blocks with every leaf moved off its
init value by numpy noise, so zero-initialised mixes and biases count),
activations and tokens from numpy seeds.  The scan and the blocks are held
at 1e-5 in float32, relative and of their largest output (XLA and torch
sum the products in other orders; near-zero outputs carry the rounding of
the large ones), the models' forward at 1e-5 so too and in bf16 as close
to JAX's float32 forward as JAX's bf16 is (the rule of untied heads),
prefill and decode at 2e-4 (the tolerance of ``tests/test_models.py``),
gradients at GRAD_TOL of each leaf's largest.
"""
import dataclasses
import functools
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import chunked_scan as jcs
from repro.models import rwkv as jrk
from repro.models import ssm as jsm
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.models import chunked_scan as cs
from repro_torch.models import rwkv as rk
from repro_torch.models import ssm as sm
from repro_torch.models import transformer as tf
from repro_torch.tree import flatten, unflatten

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
TOL = 1e-5
DECODE_TOL = 2e-4
# gradients, of each leaf's largest: every leaf comes within 5e-6 but the
# decay's (zamba2's dt_bias, 1.2-1.6e-5), whose gradient sums each
# position's path through the cumulative log-decays, e^L and e^-L up to
# e^64 apart
GRAD_TOL = 5e-5
ARCHS = ["rwkv6-3b", "zamba2-1.2b"]


def _cfgs(arch, **over):
    over = {"dtype": "float32", "remat": False, **over}
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol=TOL):
    """Within ``tol`` relative and ``tol`` of the largest |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _noisy(tree, seed):
    """Every leaf plus 0.1 x standard normal noise from numpy, as numpy."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(
            np.float32), tree)


def _scan_inputs(B, H, T, dk, dv, seed, scalar_decay=False, scale=1.5):
    r = np.random.default_rng(seed)
    q, k = (r.standard_normal((B, H, T, dk), np.float32) for _ in range(2))
    v = r.standard_normal((B, H, T, dv), np.float32)
    la = -np.exp(scale * r.standard_normal(
        (B, H, T, 1 if scalar_decay else dk), np.float32))
    u = r.standard_normal((H, dk), np.float32)
    s0 = r.standard_normal((B, H, dk, dv), np.float32)
    return q, k, v, la, u, s0


# ------------------------------------------------------------ the scan
@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("bonus", [False, True])
def test_chunked_scan_matches_jax_and_the_sequential_oracle(chunk, bonus):
    """T = 45 (not a multiple of either chunk), a carried initial state;
    Mamba's scalar decay per head, RWKV's per channel with its bonus."""
    q, k, v, la, u, s0 = _scan_inputs(2, 3, 45, 16, 8, seed=chunk + bonus,
                                      scalar_decay=not bonus)
    ju = jnp.asarray(u) if bonus else None
    tu = torch.from_numpy(u) if bonus else None
    want_y, want_s = jcs.chunked_decay_scan(
        *map(jnp.asarray, (q, k, v, la)), u=ju, init_state=jnp.asarray(s0),
        chunk=chunk, bonus_mode=bonus)
    args = [torch.from_numpy(a) for a in (q, k, v, la)]
    y, s = cs.chunked_decay_scan(*args, u=tu, init_state=torch.from_numpy(s0),
                                 chunk=chunk, bonus_mode=bonus)
    assert y.shape == (2, 3, 45, 8) and s.dtype == torch.float32
    _close_scaled(y, want_y)
    _close_scaled(s, want_s)
    ry, rs = cs.reference_scan(*args, u=tu, init_state=torch.from_numpy(s0),
                               bonus_mode=bonus)
    # the chunked and the sequential form, at JAX's own tolerance
    _close(y, ry.numpy(), DECODE_TOL)
    _close(s, rs.numpy(), DECODE_TOL)


def test_chunked_scan_chains_initial_states():
    """[0, 24) then [24, 56) with the carried state is the whole scan, as
    in JAX."""
    q, k, v, la, _, _ = _scan_inputs(1, 2, 56, 8, 8, seed=3,
                                     scalar_decay=True, scale=0.5)
    t = [torch.from_numpy(a) for a in (q, k, v, la)]
    y_full, s_full = cs.chunked_decay_scan(*t, chunk=8)
    y1, s1 = cs.chunked_decay_scan(*(a[:, :, :24] for a in t), chunk=8)
    y2, s2 = cs.chunked_decay_scan(*(a[:, :, 24:] for a in t),
                                   init_state=s1, chunk=8)
    _close(torch.cat([y1, y2], dim=2), y_full.numpy())
    _close(s2, s_full.numpy())
    jy, _ = jcs.chunked_decay_scan(*map(jnp.asarray, (q, k, v, la)), chunk=8)
    _close_scaled(y_full, jy)


@pytest.mark.parametrize("bonus", [False, True])
def test_decays_far_below_the_floor(bonus):
    """log decays of -50 (e^-50 a step): both forms clamp at
    LOG_DECAY_FLOOR, agree with each other and with JAX, and stay
    finite."""
    assert cs.LOG_DECAY_FLOOR == jcs.LOG_DECAY_FLOOR == -2.0
    assert cs.DEFAULT_CHUNK == jcs.DEFAULT_CHUNK == 32
    q, k, v, _, u, _ = _scan_inputs(1, 2, 40, 4, 4, seed=4)
    la = np.full((1, 2, 40, 4), -50.0, np.float32)
    ju = jnp.asarray(u) if bonus else None
    tu = torch.from_numpy(u) if bonus else None
    args = [torch.from_numpy(a) for a in (q, k, v, la)]
    y, _ = cs.chunked_decay_scan(*args, u=tu, chunk=8, bonus_mode=bonus)
    ry, _ = cs.reference_scan(*args, u=tu, bonus_mode=bonus)
    jy, _ = jcs.chunked_decay_scan(*map(jnp.asarray, (q, k, v, la)), u=ju,
                                   chunk=8, bonus_mode=bonus)
    assert bool(torch.isfinite(y).all())
    _close(y, ry.numpy())
    _close_scaled(y, jy)
    clamped = cs.clamp_log_decay(torch.tensor([-50.0, -1.0, 0.5]))
    assert clamped.tolist() == [-2.0, -1.0, 0.0]


@pytest.mark.parametrize("bonus", [False, True])
def test_decay_scan_step_matches_jax(bonus):
    q, k, v, la, u, s0 = _scan_inputs(2, 3, 1, 8, 6, seed=5,
                                      scalar_decay=not bonus)
    one = [a[:, :, 0] for a in (q, k, v, la)]
    jy, js = jcs.decay_scan_step(*map(jnp.asarray, one), jnp.asarray(s0),
                                 u=jnp.asarray(u) if bonus else None,
                                 bonus_mode=bonus)
    y, s = cs.decay_scan_step(*(torch.from_numpy(a) for a in one),
                              torch.from_numpy(s0),
                              u=torch.from_numpy(u) if bonus else None,
                              bonus_mode=bonus)
    _close(y, jy)
    _close(s, js)


# ------------------------------------------------------------ the blocks
def _block_params(init, cfg, seed):
    """The port's init of one block (``lead=()``) with every leaf moved by
    numpy noise, as the JAX side's numpy tree, and carried back to the
    port by ``lm_params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    jp = _noisy(lm_params_to_jax(init(gen, cfg)), seed)
    return jp, lm_params_from_jax(jp)


def test_mamba2_block_and_decode_match_jax():
    """``mamba2_fwd`` over 13 tokens (its output and cache), then 3
    ``mamba2_decode`` steps from that cache; the conv tail of a prompt
    shorter than the kernel; the empty cache's layout."""
    jc, tc = _cfgs("zamba2-1.2b")
    jp, tp = _block_params(sm.init_mamba2, tc, 6)
    x = _x((2, 16, jc.d_model), 7)
    want, jcache = jax.jit(functools.partial(jsm.mamba2_fwd, cfg=jc))(
        jp, x=jnp.asarray(x[:, :13]))
    got, cache = sm.mamba2_fwd(tp, tc, torch.from_numpy(x[:, :13]))
    _close_scaled(got, want)
    assert cache.keys() == jcache.keys()
    _close_scaled(cache["conv"], jcache["conv"])
    _close_scaled(cache["ssm"], jcache["ssm"])
    jdec = jax.jit(functools.partial(jsm.mamba2_decode, cfg=jc))
    for t in range(13, 16):
        want, jcache = jdec(jp, x=jnp.asarray(x[:, t:t + 1]), cache=jcache)
        got, cache = sm.mamba2_decode(tp, tc, torch.from_numpy(x[:, t:t + 1]),
                                      cache)
        _close_scaled(got, want)
        _close_scaled(cache["ssm"], jcache["ssm"])
    _close_scaled(cache["conv"], jcache["conv"])
    _, short = sm.mamba2_fwd(tp, tc, torch.from_numpy(x[:, :2]))  # T < K - 1
    assert tuple(short["conv"].shape) == (2, jc.conv_kernel - 1,
                                          cache["conv"].shape[-1])
    assert not bool(short["conv"][:, 0].any())          # left-padded
    _close(short["conv"][:, 1:],
           sm._split(tp, tc, torch.from_numpy(x[:, :2]))[1])
    empty = sm.init_mamba2_cache(tc, 2, torch.float32, device="cpu")
    jempty = jsm.init_mamba2_cache(jc, 2, jnp.float32)
    assert _shapes(empty) == _shapes(jempty)


def test_rwkv6_block_and_decode_match_jax():
    """``rwkv6_block_fwd`` over 11 tokens from non-zero carries and state
    (its output and carries), then 3 ``rwkv6_block_decode`` steps."""
    jc, tc = _cfgs("rwkv6-3b")
    jp, tp = _block_params(rk.init_rwkv6, tc, 8)
    H, hd = jc.num_heads, jc.hd
    x = _x((2, 14, jc.d_model), 9)
    tm, cm = _x((2, 1, jc.d_model), 10), _x((2, 1, jc.d_model), 11)
    s0 = _x((2, H, hd, hd), 12)
    want, jcar = jax.jit(functools.partial(jrk.rwkv6_block_fwd, cfg=jc))(
        jp, x=jnp.asarray(x[:, :11]), tm_prev=jnp.asarray(tm),
        cm_prev=jnp.asarray(cm), state=jnp.asarray(s0))
    got, car = rk.rwkv6_block_fwd(tp, tc, torch.from_numpy(x[:, :11]),
                                  tm_prev=torch.from_numpy(tm),
                                  cm_prev=torch.from_numpy(cm),
                                  state=torch.from_numpy(s0))
    _close_scaled(got, want)
    assert car.keys() == jcar.keys()
    for k in car:
        _close_scaled(car[k], jcar[k])
    jdec = jax.jit(functools.partial(jrk.rwkv6_block_decode, cfg=jc))
    for t in range(11, 14):
        want, jcar = jdec(jp, x=jnp.asarray(x[:, t:t + 1]), cache=jcar)
        got, car = rk.rwkv6_block_decode(tp, tc,
                                         torch.from_numpy(x[:, t:t + 1]), car)
        _close_scaled(got, want)
    for k in car:
        _close_scaled(car[k], jcar[k])
    assert _shapes(rk.init_rwkv6_cache(tc, 2, torch.float32, device="cpu")) \
        == _shapes(jrk.init_rwkv6_cache(jc, 2, jnp.float32))


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_jax_configs(arch, smoke):
    jc, tc = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.hd, tc.param_count()) == (jc.hd, jc.param_count())
    assert dataclasses.asdict(tc.as_student()) == dataclasses.asdict(
        jc.as_student())


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype):
    """The model's params as the JAX side's numpy tree: the port's init at
    seed 0 (the JAX init's distributions; JAX's own init compiles for
    10 s), its values rounded to bf16 so that the float32 and the bf16
    runs share them, in ``dtype`` (the float32 leaves stay float32)."""
    _, tc = _cfgs(arch, dtype="bfloat16")
    tree = lm_params_to_jax(tf.init_lm(0, tc, device="cpu"))
    if dtype == "float32":
        tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _models(arch, **over):
    """(JAX config, port config, JAX params, the port's copy of them by
    ``lm_params_from_jax``)."""
    jc, tc = _cfgs(arch, **over)
    jp = _jax_params(arch, jc.dtype)
    return jc, tc, jp, lm_params_from_jax(jp)


_SEQ = np.random.default_rng(1).integers(0, 512, (2, 41), dtype=np.int32)
TOKS = _SEQ[:, :-1].copy()
LABELS = _SEQ[:, 1:].copy()
LABELS[0, 3] = LABELS[1, -1] = -1


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """JAX's float32 logits of TOKS and its gradients of ``lm_loss`` on
    (TOKS, LABELS), with ``remat``, from one jitted program (one compile,
    the file's largest cost)."""
    jc, _, jp, _ = _models(arch, remat=True)

    def loss_and_logits(p, batch):
        return (jtf.lm_loss(p, jc, batch)[0],
                jtf.forward(p, jc, {"tokens": batch["tokens"]})[0])

    (_, logits), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(
            jp, {"tokens": jnp.asarray(TOKS), "labels": jnp.asarray(LABELS)})
    return np.asarray(logits, np.float32), grads


@functools.lru_cache(maxsize=None)
def _jax_logits(arch, dtype, window=None):
    if dtype == "float32" and window is None:
        return _jax_run(arch)[0]
    jc, _, jp, _ = _models(arch, dtype=dtype)
    if window is not None:
        jc = dataclasses.replace(jc, sliding_window=window)
    return np.asarray(jtf.forward(jp, jc, {"tokens": jnp.asarray(TOKS)})[0],
                      np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_converter_match_jax(arch):
    """bf16: the keys, shapes and dtypes of JAX's ``eval_shape`` of
    ``init_lm`` (the float32 leaves ``w0``, ``u``, ``dt_bias``, ``A_log``
    and ``D`` among them) and the JAX init's constants; the converter
    carries the tree both ways bit for bit, float32 leaves kept
    float32."""
    jc, tc = _cfgs(arch, dtype="bfloat16")
    want = jax.eval_shape(lambda: jtf.init_lm(KEY, jc))
    got = tf.init_lm(3, tc, device="cpu")
    assert _shapes(got) == _shapes(want)
    flat = flatten(got)
    f32 = {k for k, v in flat.items() if v.dtype == torch.float32}
    if arch == "rwkv6-3b":
        assert f32 == {"layers.w0", "layers.u"}
        assert bool((flat["layers.w0"] == -2.0).all())
        assert bool((flat["layers.u"] == 0.5).all())
    else:
        assert f32 == {"layers.dt_bias", "layers.A_log", "layers.D"}
        assert bool((flat["layers.D"] == 1.0).all())
        assert abs(float(flat["layers.conv_w"].float().std()) - 0.5) < 0.02
    jp = _jax_params(arch, "bfloat16")
    back = lm_params_to_jax(lm_params_from_jax(jp))
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """float32 at 1e-5, relative and of the largest logit; the hidden
    states are what the head turns into those logits.  bf16 by the rule of
    untied heads: as close to JAX's float32 forward of the same weights as
    JAX's own bf16 run is (1.25 times its largest and mean gap), both
    packages rounding at every bf16 op but not at the same places."""
    _, tc, _, tp = _models(arch)
    ref = _jax_logits(arch, "float32")
    got, aux = tf.forward(tp, tc, {"tokens": torch.from_numpy(TOKS)})
    assert got.shape == ref.shape and float(aux) == 0.0
    _close_scaled(got, ref)
    hid, _ = tf.forward(tp, tc, {"tokens": torch.from_numpy(TOKS)},
                        return_hidden=True)
    assert torch.equal(hid @ tp["lm_head"], got)
    _, tc, _, tp = _models(arch, dtype="bfloat16")
    got, _ = tf.forward(tp, tc, {"tokens": torch.from_numpy(TOKS)})
    assert got.dtype == torch.bfloat16
    port_gap = np.abs(got.float().numpy() - ref)
    jax_gap = np.abs(_jax_logits(arch, "bfloat16") - ref)
    assert port_gap.max() <= 1.25 * jax_gap.max(), (port_gap.max(),
                                                    jax_gap.max())
    assert port_gap.mean() <= 1.25 * jax_gap.mean(), (port_gap.mean(),
                                                      jax_gap.mean())


def _prefill_decode(arch, T, window=None):
    """Prefill T of TOKS, then decode the rest: each step's logits against
    JAX's full forward of TOKS, at 2e-4, and the prefill's cache in the
    layout of JAX's (``eval_shape``)."""
    over = {} if window is None else {"sliding_window": window}
    jc, tc, jp, tp = _models(arch, **over)
    full = _jax_logits(arch, "float32", window)
    got, cache = tf.prefill(tp, tc, {"tokens": torch.from_numpy(TOKS[:, :T])})
    _close(got, full[:, T - 1], DECODE_TOL)
    want = jax.eval_shape(lambda: jtf.prefill(
        jp, jc, {"tokens": jnp.asarray(TOKS[:, :T])})[1])
    assert _shapes(cache) == _shapes(want)
    for t in range(T, TOKS.shape[1]):
        out, same = tf.decode_step(tp, tc, cache,
                                   torch.from_numpy(TOKS[:, t:t + 1]), t)
        assert same is cache                        # updated in place
        _close(out[:, 0], full[:, t], DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_the_full_forward(arch):
    _prefill_decode(arch, 36)


def test_hybrid_rotating_window_past_its_end():
    """zamba2 with a window of 16: a prefill of 32 keeps the last 16 keys
    (32 % 16 == 0, so slot p % 16 holds position p), and 8 decode steps
    rotate through the buffer past its end.  The prefill's trim is aligned
    with the rotating buffer only when T < window or T % window == 0 (the
    JAX package's behaviour, which the port keeps)."""
    _prefill_decode("zamba2-1.2b", 32, window=16)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout(arch):
    jc, tc = _cfgs(arch)
    want = jax.eval_shape(lambda: jtf.init_cache(jc, 3, 40))
    got = tf.init_cache(tc, 3, 40, device="cpu")
    assert _shapes(got) == _shapes(want)
    assert not any(bool(v.any()) for v in flatten(got).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grads_match_jax(arch):
    """Every leaf's gradient of the loss through the training forward, each
    layer (each group of the hybrid) checkpointed (``remat``), within
    GRAD_TOL of the leaf's largest (the loss itself is held in
    ``tests/test_torch_lm_train.py``)."""
    _, tc, _, tp = _models(arch, remat=True)
    flat = {k: v.requires_grad_() for k, v in flatten(tp).items()}
    loss, aux = tf.lm_loss(unflatten(flat), tc,
                           {"tokens": torch.from_numpy(TOKS),
                            "labels": torch.from_numpy(LABELS)})
    assert float(aux["aux"]) == 0.0
    loss.backward()
    want_g = flatten(lm_params_from_jax(_jax_run(arch)[1]))
    for k, p in flat.items():
        scale = float(np.abs(want_g[k].numpy()).max())
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


# ------------------------------------------------------------ the example
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_example_runs_on_the_cpu(arch, capsys):
    """``examples/serve_torch.py ARCH --device cpu`` at smoke size."""
    example = runpy.run_path(str(ROOT / "examples" / "serve_torch.py"))
    gen = example["main"]([arch, "--device", "cpu"])
    assert tuple(gen.shape) == (4, 16)
    out = capsys.readouterr().out
    assert f"{arch}: prefilled 4x24 tokens" in out
    assert "generated 16 tokens/request greedily" in out
