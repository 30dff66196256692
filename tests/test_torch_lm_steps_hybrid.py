"""The train and distillation steps of zamba2-1.2b (Mamba2 layers and one
shared attention block after every ``attn_every``, the group loop)
against the JAX package on the CPU: the checks of
``test_torch_lm_steps_families.py``, which says what each holds and at
what tolerance.
"""
import pytest

from test_torch_lm_steps_families import (PATHS, TRAIN_CASES,
                                          check_distill_step,
                                          check_hidden_states,
                                          check_train_step)

ARCH = "zamba2-1.2b"


@pytest.mark.parametrize("accum,remat", TRAIN_CASES)
def test_train_step_matches_jax(accum, remat):
    check_train_step(ARCH, accum, remat)


@pytest.mark.parametrize("path", list(PATHS))
def test_distill_step_matches_jax(path):
    check_distill_step(ARCH, path)


def test_hidden_states_match_jax():
    check_hidden_states(ARCH)
