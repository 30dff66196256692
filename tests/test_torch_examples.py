"""The port's examples (``examples/*_torch.py``, the twins of the JAX
examples) on the CPU: ``llm_distill_torch.py`` runs whole (3 rounds of 10
distillation steps of a 2-layer smoke model, D = 4 replicas in 2
clusters), its losses finite and its replicas equal after every ``sync``;
``quickstart_torch.py`` (8 clients, 3 rounds) and
``fault_tolerance_torch.py`` (a run killed after 3 of 6 rounds and
resumed, its history asserted bit-identical to an uninterrupted run) run
whole too; every example parses ``--help`` and refuses a card that is not
there (``--device`` defaults to ``cuda``).  ``sharded_collectives_torch.py``
runs as a user runs it, a script spawning a gloo world of 4 CPU ranks:
its four parts (the raw mesh operators, FedSiKD, packed FedSiKD with
sampled participation, packed FedAvg) each print their results.
``chip_smoke.py`` runs the quickstart and ``llm_distill_torch.py`` on the
card."""
import math
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "fedsikd_vs_baselines", "client_churn",
            "async_stragglers", "fault_tolerance", "llm_distill", "serve",
            "sharded_collectives"]


def _main(name):
    return runpy.run_path(str(ROOT / "examples" / f"{name}_torch.py"))["main"]


def test_llm_distill_runs_on_the_cpu(capsys):
    rounds = _main("llm_distill")(["--device", "cpu"])
    assert [r["round"] for r in rounds] == [0, 1, 2]
    for r in rounds:
        assert len(r["losses"]) == 10
        assert all(math.isfinite(x) for x in r["losses"])
        assert r["replicas_equal"]
    out = capsys.readouterr().out
    assert "4 replicas on cpu" in out
    assert out.count("post-sync replicas equal: True") == 3


def test_quickstart_runs_on_the_cpu(capsys):
    h = _main("quickstart")(["--device", "cpu"])
    assert len(h["acc"]) == 3
    assert all(math.isfinite(x) for x in h["loss"])
    assert 1 <= h["num_clusters"] <= 8
    assert "accuracy curve" in capsys.readouterr().out


def test_fault_tolerance_resumes_bit_identically_on_the_cpu(capsys):
    """The example asserts the resumed history equal to the uninterrupted
    one; it returns both."""
    h_full, h_res = _main("fault_tolerance")(["--device", "cpu"])
    assert h_res["acc"] == h_full["acc"] and len(h_full["acc"]) == 6
    assert "bit-identical" in capsys.readouterr().out


def test_sharded_collectives_runs_on_four_cpu_ranks():
    res = subprocess.run(
        [sys.executable, "examples/sharded_collectives_torch.py",
         "--device", "cpu", "--world", "4"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "per-cluster means" in out and "two-level global mean" in out
    assert out.count("accuracy curve") == 3
    assert "on a mesh of 4 ranks" in out
    assert "participants/round: [12, 12, 12]" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_parses_help(name, capsys):
    with pytest.raises(SystemExit) as exc:
        _main(name)(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_a_missing_card(name, monkeypatch):
    """The default device is the card; without one the example raises
    before it trains or serves anything, as ``resolve_device`` says."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _main(name)([])
