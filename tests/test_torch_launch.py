"""The port's launcher (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``) on the CPU: ``parse_join_schedule`` on
good and bad specs, the ``fl`` mode's history against ``run_federated``'s,
the ``lm`` mode's checkpoint and resume in the JAX package's ``lm.npz``
format (read back by its ``ckpt.restore``), the flags of both launchers,
and the refusal to run on the CPU unasked."""
import json

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro_torch.data.synthetic import load_dataset
from repro_torch.fed.rounds import FedConfig, run_federated
from repro_torch.launch import train


@pytest.mark.parametrize("spec", [None, "", "3:2", "3:2,6:2", " 1:4 ,2:1"])
def test_parse_join_schedule_equals_jax(spec):
    assert train.parse_join_schedule(spec) == jtrain.parse_join_schedule(spec)


@pytest.mark.parametrize("spec", ["3", "a:2", "3:2,", "3:2:1"])
def test_parse_join_schedule_refuses_as_jax(spec):
    with pytest.raises(SystemExit) as got:
        train.parse_join_schedule(spec)
    with pytest.raises(SystemExit) as want:
        jtrain.parse_join_schedule(spec)
    assert str(got.value) == str(want.value)


def _flags(parser):
    out = {}
    for action in parser._subparsers._group_actions[0].choices.items():
        name, sub = action
        out[name] = {(a.dest, tuple(a.option_strings), a.default)
                     for a in sub._actions if a.dest != "help"}
    return out


def test_flags_are_the_jax_launchers_plus_device(monkeypatch):
    """Every flag of the JAX launcher, with its default, plus --device."""
    captured = {}
    real = jtrain.argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["parser"] = self
        raise SystemExit(0)
    monkeypatch.setattr(jtrain.argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jtrain.main()
    monkeypatch.setattr(jtrain.argparse.ArgumentParser, "parse_args", real)
    want = _flags(captured["parser"])
    got = _flags(train.build_parser())
    assert got.keys() == want.keys() == {"fl", "lm"}
    for mode in got:
        extra = got[mode] - want[mode]
        assert extra == {("device", ("--device",), "cuda")}, mode
        assert want[mode] <= got[mode]


def test_fl_mode_history_equals_run_federated(tmp_path):
    """``fl --device cpu --small`` with 4 clients and 1 round writes the
    history that ``run_federated`` returns for the same config."""
    out = tmp_path / "run"
    h = train.main(["fl", "--device", "cpu", "--small", "--clients", "4",
                    "--rounds", "1", "--local-epochs", "1", "--ckpt",
                    str(out)])
    cfg = FedConfig(num_clients=4, rounds=1, local_epochs=1, ckpt_dir=None)
    want = run_federated(load_dataset("mnist", small=True), cfg,
                         device="cpu")
    written = json.loads((out / "history.json").read_text())
    assert written.keys() == h.keys() == want.keys()
    for k in want:
        if k == "round_seconds":           # host wall time
            assert len(written[k]) == len(want[k])
            continue
        assert written[k] == json.loads(json.dumps(
            train.json_safe(want[k]))), k
    assert sorted(p.name for p in out.glob("round_*.npz")) == [
        "round_00001.npz"]


def test_lm_mode_checkpoints_resumes_and_the_jax_package_reads_it(
        tmp_path, capsys):
    ck = tmp_path / "lm"
    args = ["lm", "--device", "cpu", "--arch", "qwen2.5-3b", "--smoke",
            "--steps", "2", "--batch", "2", "--seq", "16", "--log-every",
            "1", "--ckpt", str(ck)]
    params, losses = train.main(args)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert jax_ckpt.load_meta(ck / "lm.npz")["step"] == 2
    jc = jax_config("qwen2.5-3b", smoke=True)
    like = jax.eval_shape(lambda: jtf.init_lm(jax.random.PRNGKey(0), jc))
    back = jax_ckpt.restore(ck / "lm.npz", like)
    assert str(back["embed"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(back["layers"]["attn"]["wq"], np.float32),
        params["layers"]["attn"]["wq"].float().numpy())
    capsys.readouterr()
    resumed, more = train.main(args)
    assert "resumed from step 2" in capsys.readouterr().out
    assert jax_ckpt.load_meta(ck / "lm.npz")["step"] == 4
    assert len(more) == 2
    assert not torch.equal(resumed["embed"], params["embed"])


def test_vlm_lm_mode_runs(tmp_path):
    """internvl2-2b's smoke config: a zero prefix, the tokens cut to fit."""
    _, losses = train.main(["lm", "--device", "cpu", "--arch",
                            "internvl2-2b", "--smoke", "--steps", "1",
                            "--batch", "2", "--seq", "24"])
    assert np.isfinite(losses[0])


@pytest.mark.parametrize("mode", ["fl", "lm"])
def test_the_launcher_raises_without_a_card_unless_asked(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [mode] + (["--small"] if mode == "fl" else
                     ["--arch", "qwen2.5-3b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(argv)
