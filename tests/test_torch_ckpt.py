"""The port's checkpoints against the JAX package's, on the CPU.

- ``repro_torch.checkpoint`` writes the JAX package's key paths
  (``t_opts/0/.mu/conv/0/w``) for the same state, round-trips every dtype
  bit for bit (bfloat16 as its uint16 bits), reads files the JAX package
  wrote and writes files it reads, and names every missing, unexpected or
  mis-shaped leaf on restore.
- ``fed/fedstate.py``: ``keep_last`` pruning, the fingerprint check on
  resume, and the ``AsyncCheckpointWriter`` (the same files as the
  synchronous save, JSON members copied at submit, a writer error raised
  by ``close``).
- Resume within the port repeats the uninterrupted run bit for bit on the
  CPU: the history (every key but ``round_seconds``, which is host time)
  and every array of the last checkpoint, across a re-clustering boundary
  with updates in the staleness buffer, on both engines and for FL+HC.
- Across packages: a run the JAX package checkpointed (client lifecycle
  and stragglers on) resumes in the port, and a run the port checkpointed
  resumes in the JAX package; each matches the other package's
  uninterrupted run at the bounds of ``test_torch_runtime``.  Neither file
  is edited: the port was handed the JAX run's initial clusters, which the
  fingerprint holds.
"""
import json
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.optim import adamw as jax_adamw
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.fed import fedstate
from repro_torch.optim import adamw
from test_torch_runtime import (SMALL, _capture_jax_init, _inject_into_port,
                                assert_histories_match, jax_run, port_run,
                                run_both)

torch.set_num_threads(1)


def _jax_state(seed=0):
    from repro.models import cnn as jcnn
    init, _ = jcnn.make_model("mnist", student=False)
    t = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))
    return {"student": t, "teachers": [t, t],
            "t_opts": [jax_adamw(1e-3).init(t)] * 2,
            "labels": np.arange(6, dtype=np.int32)}


def _port_state(jstate):
    t = convert.params_from_jax(jstate["student"])
    o = adamw(1e-3).init(t)
    return {"student": convert.params_to_jax(t),
            "teachers": [convert.params_to_jax(t)] * 2,
            "t_opts": [convert.adam_to_jax(o)] * 2,
            "labels": torch.arange(6, dtype=torch.int32)}


def test_key_paths_are_the_jax_packages():
    jstate = _jax_state()
    want = {k: (v.shape, v.dtype.name)
            for k, v in jckpt.ckpt._flatten(jstate).items()}
    got = {k: (v.shape, v.dtype.name)
           for k, v in ckpt.ckpt._flatten(_port_state(jstate)).items()}
    assert got == want
    assert "t_opts/1/.count" in got and "teachers/0/conv/3/w" in got


def test_files_cross_between_the_packages(tmp_path):
    jstate = _jax_state(1)
    jckpt.save(tmp_path / "j", jstate, step=3, extra={"k": 1})
    like = _port_state(jstate)
    back = ckpt.restore(tmp_path / "j", like)
    assert ckpt.load_meta(tmp_path / "j") == {"step": 3, "k": 1}
    got = dict(convert._flatten(back["teachers"][1]))
    for k, v in convert._flatten(jstate["teachers"][1]):
        assert np.array_equal(got[k], v), k
    assert back["t_opts"][0].count.dtype == torch.int32
    ckpt.save(tmp_path / "p", back, step=4)
    again = dict(convert._flatten(jckpt.restore(tmp_path / "p", jstate)))
    for k, v in convert._flatten(jstate):
        assert np.array_equal(again[k], v), k


def test_every_dtype_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "x": [torch.randn(4, generator=g),
                  torch.randn(2, 2, generator=g).double()],
            "n": torch.arange(7, dtype=torch.int64),
            "h": torch.randn(6, generator=g).half()}
    ckpt.save(tmp_path / "r", tree)
    back = ckpt.restore(tmp_path / "r.npz", tree)
    for got, want in ((back["w"], tree["w"]), (back["x"][0], tree["x"][0]),
                      (back["x"][1], tree["x"][1]), (back["n"], tree["n"]),
                      (back["h"], tree["h"])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # bf16 bits in the JAX package's form: a uint16 view under the tag
    with np.load(tmp_path / "r.npz") as z:
        assert z["w__bf16__"].dtype == np.uint16
    jback = jckpt.restore(tmp_path / "r", {
        "w": np.zeros((3, 5), ml_dtypes.bfloat16),
        "x": [np.zeros(4, np.float32), np.zeros((2, 2), np.float64)],
        "n": np.zeros(7, np.int64), "h": np.zeros(6, np.float16)})
    assert np.array_equal(np.asarray(jback["w"]).astype(np.float32),
                          tree["w"].float().numpy())


def test_restore_names_every_bad_leaf(tmp_path):
    ckpt.save(tmp_path / "r", {"a": torch.zeros(2), "b": torch.zeros(3),
                               "c": torch.zeros(1, dtype=torch.int32),
                               "gone": torch.zeros(1)})
    like = {"a": torch.zeros(2), "b": torch.zeros(4),
            "c": torch.zeros(1), "new": torch.zeros(1)}
    with pytest.raises(ValueError) as e:
        ckpt.restore(tmp_path / "r", like)
    msg = str(e.value)
    for part in ("missing leaf 'new'", "shape mismatch at 'b'",
                 "dtype mismatch at 'c'", "'gone'"):
        assert part in msg, msg
    assert not list(tmp_path.glob("*.tmp"))


def _state(rnd, v=0.0):
    return fedstate.FedState(round_index=rnd,
                             arrays={"student": {"w": torch.full((3,),
                                                                 float(v))}},
                             history={"acc": [float(v)]}, meta={"seed": 0})


def test_keep_last_and_the_fingerprint_check(tmp_path):
    for rnd in range(1, 6):
        fedstate.save_round(tmp_path, _state(rnd, rnd), keep_last=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "round_00004.meta.json", "round_00004.npz",
        "round_00005.meta.json", "round_00005.npz"]
    (tmp_path / "round_00009.npz.tmp").write_bytes(b"torn")
    assert fedstate.latest_round(tmp_path) == 5
    like = {"student": {"w": torch.zeros(3)}}
    st = fedstate.restore_run(tmp_path, like, expect_meta={"seed": 0})
    assert st.round_index == 5 and st.history == {"acc": [5.0]}
    assert torch.equal(st.arrays["student"]["w"], torch.full((3,), 5.0))
    with pytest.raises(ValueError, match="seed: checkpoint=0 vs this run=1"):
        fedstate.restore_run(tmp_path, like, expect_meta={"seed": 1})
    assert fedstate.latest_round(tmp_path / "none") is None


def test_async_writer_writes_what_the_sync_save_writes(tmp_path):
    w = fedstate.AsyncCheckpointWriter(tmp_path / "a", keep_last=None)
    st = _state(1, 2.0)
    w.submit(st)
    st.history["acc"].append(99.0)        # after submit: not in the file
    w.submit(_state(2, 3.0))
    w.close()
    w.close()                             # idempotent
    fedstate.save_round(tmp_path / "s", _state(1, 2.0))
    fedstate.save_round(tmp_path / "s", _state(2, 3.0))
    for name in ("round_00001", "round_00002"):
        assert ((tmp_path / "a" / f"{name}.meta.json").read_text()
                == (tmp_path / "s" / f"{name}.meta.json").read_text())
        with np.load(tmp_path / "a" / f"{name}.npz") as a, \
                np.load(tmp_path / "s" / f"{name}.npz") as s:
            assert a.files == s.files
            assert all(np.array_equal(a[k], s[k]) for k in a.files)
    with pytest.raises(RuntimeError, match="after close"):
        w.submit(_state(3))


def test_async_writer_raises_its_error_at_close(tmp_path):
    (tmp_path / "f").write_text("a file where the directory should be")
    w = fedstate.AsyncCheckpointWriter(tmp_path / "f" / "d")
    w.submit(_state(1))
    with pytest.raises(RuntimeError, match="async checkpoint writer failed"):
        w.close()


# ----------------------------------------------------- resume in the port
RESUME = [
    ("fedsikd-loop-lifecycle-async-dp",
     dict(algorithm="fedsikd", rounds=4, dp_noise=0.05,
          join_schedule=((2, 1), (3, 1)), leave_rate=0.1, recluster_every=2,
          async_mode=True, straggler_frac=0.4, max_staleness=2), 2),
    ("fedsikd-loop-async-ckpt",
     dict(algorithm="fedsikd", rounds=3, async_mode=True,
          straggler_frac=0.5, async_ckpt=True, recluster_every=1), 2),
    ("fedavg-loop-lifecycle-async",
     dict(algorithm="fedavg", rounds=4, join_schedule=((3, 1),),
          leave_rate=0.1, async_mode=True, straggler_frac=0.5), 2),
    ("fedsikd-packed-dp",
     dict(algorithm="fedsikd", engine="sharded", pack=6, rounds=3,
          dp_noise=0.05), 1),
    ("fedprox-packed",
     dict(algorithm="fedprox", engine="sharded", pack=6, rounds=3), 2),
    ("flhc-loop", dict(algorithm="flhc", num_clusters=3, rounds=3), 2),
]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kw,split", [r[1:] for r in RESUME],
                         ids=[r[0] for r in RESUME])
def test_resume_in_the_port_is_bit_identical(kw, split, tmp_path):
    kw = {**SMALL, **kw}
    full, cut = tmp_path / "full", tmp_path / "cut"
    h_full = port_run(kw, ckpt_dir=str(full), ckpt_keep=None)
    port_run({**kw, "rounds": split}, ckpt_dir=str(cut), ckpt_keep=None)
    meta = json.loads((cut / f"round_{split:05d}.meta.json").read_text())
    if kw.get("async_mode"):       # the buffer crosses the boundary
        assert any(e["has_params"] for e in meta["buffer"]), meta["buffer"]
    h_res = port_run(kw, ckpt_dir=str(cut), ckpt_keep=None, resume=True)
    assert set(h_res) == set(h_full)
    for key in h_full:
        if key != "round_seconds":
            assert h_res[key] == h_full[key], key
    assert len(h_res["round_seconds"]) == kw["rounds"]
    for rnd in range(split + 1, kw["rounds"] + 1):
        a, b = _npz(full / f"round_{rnd:05d}.npz"), _npz(
            cut / f"round_{rnd:05d}.npz")
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    if "labels_history" in h_full:     # a re-clustering after the cut
        assert any(r > split for r, _ in h_full["labels_history"])


def test_resume_refuses_another_run(tmp_path):
    kw = {**SMALL, "algorithm": "fedavg", "rounds": 1}
    port_run(kw, ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="lr: checkpoint=0.001"):
        port_run({**kw, "rounds": 2, "lr": 2e-3}, ckpt_dir=str(tmp_path),
                 resume=True)


# ------------------------------------------------------- across packages
def test_a_jax_checkpoint_resumes_in_the_port(monkeypatch, tmp_path):
    """JAX checkpoints 2 rounds of a lifecycle + async FedSiKD run; the port
    resumes it to round 3, buffer and evolved labels included."""
    run_both({"algorithm": "fedsikd", "rounds": 3,
              "join_schedule": ((2, 1),), "recluster_every": 1,
              "async_mode": True, "straggler_frac": 0.5, "ckpt_dir": "ckpt",
              "resume": True}, monkeypatch, tmp_path)
    meta = json.loads((tmp_path / "jax" / "round_00002.meta.json"
                       ).read_text())
    assert any(e["has_params"] for e in meta["buffer"])


@pytest.mark.parametrize("algorithm", ["fedsikd", "fedavg"])
def test_a_port_checkpoint_resumes_in_jax(algorithm, monkeypatch, tmp_path):
    kw = {**SMALL, "algorithm": algorithm, "rounds": 3,
          "async_mode": True, "straggler_frac": 0.5}
    seen = {}
    _capture_jax_init(monkeypatch, kw, seen)
    h_jax = jax_run(kw)
    _inject_into_port(monkeypatch, kw, seen)
    port_run({**kw, "rounds": 2}, ckpt_dir=str(tmp_path))
    meta = json.loads((tmp_path / "round_00002.meta.json").read_text())
    assert any(e["has_params"] for e in meta["buffer"])
    h = jax_run(kw, ckpt_dir=str(tmp_path), resume=True)
    assert h["round_seconds"][:2] == meta["history"]["round_seconds"]
    assert_histories_match(h, h_jax)
    shutil.rmtree(tmp_path)
