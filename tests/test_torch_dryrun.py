"""The port's dry run (``repro_torch.launch``: ``inputs``, ``roofline``,
``dryrun``, ``analysis``) against the JAX package's, on the CPU, nothing
allocated at full size.

- (i) every ``ARCH_ID`` x ``INPUT_SHAPES`` entry at full size: the port's
  fake inputs have JAX's ``batch_specs_for`` / ``cache_specs_for`` leaves,
  name for name, shape and dtype (the decode position is a Python int in
  the port, a () int32 in JAX);
- (ii) the dry run's argument bytes are JAX's ``eval_shape`` params +
  ``opt.init`` state + batch (train) or + cache + tokens + the 4-byte
  position (decode), each family at full width (depth cut to 2, experts to
  4: neither is width);
- (iii) a prefill's counted FLOPs at each family's smoke config are 2 x the
  matmul weights each token (a MoE expert each capacity slot) passes
  through, plus the attention formula (4 B H hd a visible pair; MLA's
  widths), plus the recurrent families' chunked scan, counted on its own;
- (iv) the peak of a smoke train step on fake tensors is the peak of the
  same step on real CPU tensors, both by ``MemTracker``;
- (v) the kernels' fake branches give the plain versions' shapes and
  dtypes, add their work to the count and tick no launch counter;
- (vi) ``analysis.extrapolate`` reproduces the full-depth count at 1e-9.

JAX's trees come from ``jax.eval_shape``: nothing is drawn with JAX's init.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.launch import inputs as jinp
from repro.launch import steps as jst
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kd_softmax_kl as kd
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.launch import analysis, dryrun, inputs, roofline
from repro_torch.launch import steps as st
from repro_torch.models import chunked_scan as cs
from repro_torch.models import transformer as tf
from repro_torch.models.rwkv import _heads
from repro_torch.models.ssm import _dims
from repro_torch.tree import flatten

DEV = "cpu"


def _jax_cfg(arch, shape="", **over):
    cfg = jbase.get_config(arch)
    if shape == "long_500k" and dryrun.LONG_OK.get(arch):
        cfg = dataclasses.replace(cfg, sliding_window=dryrun.LONG_OK[arch])
    return dataclasses.replace(cfg, **over)


def _jax_leaves(tree):
    """{dotted name: (shape, dtype name)} of a nest of ShapeDtypeStructs."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path)
        out[name] = (tuple(leaf.shape), str(np.dtype(leaf.dtype)))
    return out


def _port_leaves(tree):
    return {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in flatten(tree).items()}


def _jax_bytes(tree):
    return sum(int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize
               for a in jax.tree_util.tree_leaves(tree))


# --------------------------------------------------------------- (i)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inputs_match_jax_specs(arch):
    for shape, spec in INPUT_SHAPES.items():
        cfg = dryrun.arch_config(arch, shape)
        jcfg = _jax_cfg(arch, shape)
        got = inputs.input_specs(cfg, shape, device=DEV)
        if spec["kind"] in ("train", "prefill"):
            want = _jax_leaves(jinp.batch_specs_for(jcfg, shape))
            assert _port_leaves(got["batch"]) == want, (arch, shape)
            continue
        want = _jax_leaves(jinp.input_specs(jcfg, shape))
        assert want.pop("pos") == ((), "int32")
        assert got["pos"] == spec["seq_len"] - 1
        mine = _port_leaves(got["cache"])
        mine = {f"cache.{k}": v for k, v in mine.items()}
        mine["tokens"] = _port_leaves({"t": got["tokens"]})["t"]
        assert mine == want, (arch, shape)


# --------------------------------------------------------------- (ii)
def _cut(arch):
    full = jbase.get_config(arch)
    over = {"num_layers": 2}
    if full.num_experts:
        over["num_experts"] = 4
    if full.arch_type == "hybrid":
        over["attn_every"] = 2
    if full.num_encoder_layers:
        over["num_encoder_layers"] = 2
    return over


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = _jax_cfg(arch, **_cut(arch))
    init = jed.init_encdec if cfg.arch_type == "audio" else jtf.init_lm
    params = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    return cfg, params


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_jax(arch):
    jcfg, jparams = _jax_params(arch)
    cfg = dataclasses.replace(get_config(arch), **_cut(arch))
    opt_state = jax.eval_shape(jst.make_optimizer(jcfg).init, jparams)
    train = (_jax_bytes(jparams) + _jax_bytes(opt_state)
             + _jax_bytes(jinp.batch_specs_for(jcfg, "train_4k")))
    decode = (_jax_bytes(jparams)
              + _jax_bytes(jinp.input_specs(jcfg, "decode_32k")))
    with FakeTensorMode():
        b = dryrun.build_step(arch, "train_4k", cfg=cfg, device=DEV)
        assert roofline.nbytes(b["args"]) == train
        b = dryrun.build_step(arch, "decode_32k", cfg=cfg, device=DEV)
        # JAX's decode position is a () int32 array, the port's an int
        assert roofline.nbytes(b["args"]) + 4 == decode


def test_dry_run_reports_its_argument_bytes():
    cfg = get_config("qwen2.5-3b", smoke=True)
    spec = {"seq_len": 16, "global_batch": 2, "kind": "train"}
    r = dryrun.lower_one("qwen2.5-3b", spec, cfg=cfg, device=DEV,
                         verbose=False)
    with FakeTensorMode():
        b = dryrun.build_step("qwen2.5-3b", spec, cfg=cfg, device=DEV)
        args = roofline.nbytes(b["args"])
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] == args
    # the updated params and moments, the count and the loss: the inputs
    # but the (2, 16) int32 tokens and labels, and 4 bytes
    assert mem["output_size_in_bytes"] == args - 2 * (2 * 16 * 4) + 4
    assert r["roofline"]["hbm_bytes_per_device"] == args + \
        mem["output_size_in_bytes"]
    assert r["mesh"] == "1" and r["chips"] == 1 and r["fits"]


def test_probes_keep_the_full_models_moment_dtype():
    """glm4-9b's 9.4e9 parameters take bfloat16 Adam moments, its 2-layer
    probe's 1.6e9 float32 ones: a probe (``opt_cfg``) keeps the full
    model's, or its bytes and peak would not extrapolate."""
    full = get_config("glm4-9b")
    cut = dataclasses.replace(full, num_layers=2)
    spec = {"seq_len": 8, "global_batch": 2, "kind": "train"}
    with FakeTensorMode():
        for opt_cfg, dtype in ((full, torch.bfloat16), (None, torch.float32)):
            b = dryrun.build_step("glm4-9b", spec, cfg=cut, opt_cfg=opt_cfg,
                                  device=DEV)
            assert {m.dtype for m in b["args"][1].mu.values()} == {dtype}


# --------------------------------------------------------------- (iii)
def _numel(tree, names):
    return sum(t.numel() for n, t in flatten(tree).items()
               if n.rsplit(".", 1)[-1] in names)


_GQA = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")
_MLA = ("q_a", "q_b", "kv_a", "k_b", "v_b", "wo")
_RWKV = ("mix_lora_a", "mix_lora_b", "w_lora_a", "w_lora_b", "wr", "wk",
         "wv", "wg", "wo", "cm_k", "cm_v", "cm_r")


def _scan_flops(B, H, T, dk, dv, *, bonus):
    """The chunked scan's own FlopCounterMode count at these shapes."""
    z = torch.zeros
    with FlopCounterMode(display=False) as fc:
        cs.chunked_decay_scan(z(B, H, T, dk), z(B, H, T, dk),
                              z(B, H, T, dv),
                              z(B, H, T, dk if bonus else 1),
                              u=z(H, dk) if bonus else None,
                              bonus_mode=bonus)
    return fc.get_total_flops()


def _attn(B, H, width, T, S, *, causal=True, window=0):
    return 2 * B * H * width * roofline.visible_pairs(T, S, causal, window)


def _expected_prefill(cfg, p, B, S):
    """2 x weights x the rows that pass through them, attention and scan
    terms, for a prefill of B sequences of S positions."""
    N = B * S
    head = cfg.vocab_size * cfg.d_model
    L, d, H, hd = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hd
    if cfg.arch_type == "ssm":
        Hr, hdr = _heads(cfg)
        return (2 * N * (_numel(p["layers"], _RWKV) + head)
                + L * _scan_flops(B, Hr, S, hdr, hdr, bonus=True))
    if cfg.arch_type == "hybrid":
        G = L // cfg.attn_every
        d_in, heads, head_p, state = _dims(cfg)
        shared = _numel(p["shared_attn"], _GQA + _MLP)
        return (2 * N * (_numel(p["layers"], ("in_proj", "out_proj"))
                         + G * shared + head)
                + L * _scan_flops(B, heads, S, state, head_p, bonus=False)
                + G * _attn(B, H, 2 * hd, S, S, window=cfg.sliding_window))
    if cfg.arch_type == "audio":
        F_ = S // cfg.frame_ratio
        enc, dec = p["encoder"], p["decoder"]
        return (2 * B * F_ * _numel(enc, _GQA + _MLP)
                + cfg.num_encoder_layers * _attn(B, H, 2 * hd, F_, F_,
                                                 causal=False)
                + 2 * N * (_numel(dec["self_attn"], _GQA)
                           + _numel(dec["cross_attn"], ("wq", "wo"))
                           + _numel(dec["mlp"], _MLP) + head)
                + 2 * B * F_ * _numel(dec["cross_attn"], ("wk", "wv"))
                + L * _attn(B, H, 2 * hd, S, S)
                + L * _attn(B, H, 2 * hd, S, F_, causal=False))
    lay = p["layers"]
    if cfg.use_mla:
        per_tok = _numel(lay["attn"], _MLA)
        attn = _attn(B, H, cfg.qk_nope_dim + cfg.qk_rope_dim
                     + cfg.v_head_dim, S, S)
    else:
        per_tok = _numel(lay["attn"], _GQA)
        attn = _attn(B, H, 2 * hd, S, S, window=cfg.sliding_window)
    if cfg.num_experts:
        moe = lay["moe"]
        E, k = cfg.num_experts, cfg.num_experts_per_tok
        C = max(1, int(N * k / E * cfg.capacity_factor))
        per_tok += _numel(moe, ("router",)) + sum(
            _numel(moe[m], _MLP) for m in ("shared", "dense") if m in moe)
        experts = 2 * C * _numel(moe, ("w_in", "w_out"))
    else:
        per_tok += _numel(lay["mlp"], _MLP)
        experts = 0
    return 2 * N * (per_tok + head) + experts + L * attn


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-2b",
                                  "deepseek-v2-236b", "arctic-480b",
                                  "rwkv6-3b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_prefill_flops_are_weights_attention_and_scan(arch):
    cfg = get_config(arch, smoke=True)
    B, S = 2, 96 + cfg.prefix_len
    r = dryrun.lower_one(arch, {"seq_len": S, "global_batch": B,
                                "kind": "prefill"}, cfg=cfg, device=DEV,
                         verbose=False)
    with FakeTensorMode():
        p = dryrun._init(cfg)(0, cfg, device=DEV)
        want = _expected_prefill(cfg, p, B, S)
    assert r["roofline"]["flops_per_device"] == want


# --------------------------------------------------------------- (iv)
def test_fake_peak_is_the_real_peak():
    arch = "qwen2.5-3b"
    cfg = get_config(arch, smoke=True)
    spec = {"seq_len": 32, "global_batch": 2, "kind": "train"}
    fake = dryrun.lower_one(arch, spec, cfg=cfg, accum=2, device=DEV,
                            verbose=False)["memory_analysis"]
    step, opt = st.make_train_step(cfg, accum=2)
    params = tf.init_lm(0, cfg, device=DEV)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33), dtype=np.int32))
    args = (params, opt.init(params),
            {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()})
    tracker = MemTracker()
    tracker.track_external(*roofline.tensors(args))
    with tracker:
        step(*args)
    peak = sum(s["Total"] for s in
               tracker.get_tracker_snapshot("peak").values())
    assert fake["argument_size_in_bytes"] + fake["temp_size_in_bytes"] == peak


# --------------------------------------------------------------- (v)
def test_kernel_fake_branches_count_and_launch_nothing():
    reset_launches()
    r = np.random.default_rng(0)

    def real(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(r.standard_normal(shape, np.float32)).to(
            dtype)

    q, k, v = real(2, 40, 4, 64), real(2, 40, 2, 64), real(2, 40, 2, 64)
    qd = real(2, 1, 4, 64)
    s, t = real(12, 50), real(12, 50)
    y = torch.from_numpy(r.integers(0, 50, 12))
    stats = torch.zeros(12, 3)
    g = torch.ones(12)
    plain = [fa.flash_attention(q, k, v, window=16),
             fa.flash_attention(qd, k, v),
             *kd.kd_loss_fwd(s, t, y), kd.kd_loss_bwd(s, t, y, stats, g)]

    def calls(q, k, v, qd, s, t, y, stats, g):
        return [fa.flash_attention(q, k, v, window=16),
                fa.flash_attention(qd, k, v),
                *kd.kd_loss_fwd(s, t, y), kd.kd_loss_bwd(s, t, y, stats, g)]

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        args = [mode.from_tensor(x) for x in (q, k, v, qd, s, t, y, stats,
                                              g)]
        counted = roofline.analyze(calls, tuple(args))
        outs = calls(*args)
    assert [(o.shape, o.dtype) for o in outs] == \
        [(o.shape, o.dtype) for o in plain]
    assert counted.kernels == {"flash_attention": 2, "kd_softmax_kl_fwd": 1,
                               "kd_softmax_kl_bwd": 1}
    assert counted.roofline.flops == 4 * 2 * 4 * 64 * (
        roofline.visible_pairs(40, 40, True, 16) + 40)
    assert set(launch_counts().values()) == {0}
    for fn in (fa.flash_attention, kd.kd_loss_fwd, kd.kd_loss_bwd):
        assert set(fn.variant_launches.values()) == {0}


def test_visible_pairs():
    assert roofline.visible_pairs(4, 4) == 10
    assert roofline.visible_pairs(2, 5) == 4 + 5
    assert roofline.visible_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert roofline.visible_pairs(3, 7, False) == 21


# --------------------------------------------------------------- (vi)
@pytest.mark.parametrize("arch,shape,over,kind", [
    ("qwen2.5-3b", {"seq_len": 24, "global_batch": 2, "kind": "train"},
     {"num_layers": 4}, "auto"),
    ("zamba2-1.2b", {"seq_len": 24, "global_batch": 2, "kind": "prefill"},
     {"num_layers": 6, "attn_every": 2}, "auto"),
    ("seamless-m4t-large-v2", {"seq_len": 24, "global_batch": 2,
                               "kind": "prefill"},
     {"num_layers": 4, "num_encoder_layers": 5}, "auto"),
    ("qwen2.5-3b", {"seq_len": 16, "global_batch": 2, "kind": "train"},
     {"num_layers": 6}, "fedsikd"),
])
def test_analysis_fit_reproduces_the_full_depth_count(arch, shape, over,
                                                      kind):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    fit = analysis.extrapolate(arch, shape, base=cfg, step_kind=kind,
                               device=DEV)
    full = dryrun.lower_one(arch, shape, cfg=cfg, step_kind=kind, accum=1,
                            device=DEV, verbose=False)["roofline"]
    for f in analysis.FIELDS[:3]:
        assert fit[f] == pytest.approx(full[f], rel=1e-9, abs=1e-9), f
