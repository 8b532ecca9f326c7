"""A run of each cell with its timed path broken underneath: ``correct`` has
to come out false for each fault a training cell can have.  The harness's
look for a chip is skipped and the rest of the run driven on the CPU at a
tiny size, with the cell's own limits; each fault has to break a limit that
the sound run at that size keeps."""

import pytest
import torch

from portbench import run
from portbench.tinycells import tiny_cell

SEED = 2 ** 31 + 202


def _measure(cell, plant=None):
    return run.measure(cell, seed=SEED, seconds=0.2, trace=False,
                       device="cpu", t_start=0.0, plant=plant)


def _unchanged(step_fn):
    """A step that returns its state unchanged (and the real step's loss)."""
    def step(state, batch, t):
        copy = state._replace(
            x=state.x.clone(), h=state.h.clone(),
            g_prev=state.g_prev.clone(),
            res=None if state.res is None else tuple(
                r.clone() for r in state.res))
        _, out = step_fn(copy, batch, t)
        return state, out
    return step


def _half_batch(step_fn):
    """Half of each node's samples left out, the mean over the rest: the
    second half repeats the first."""
    def step(state, batch, t):
        b = next(iter(batch.values())).shape[2]
        out = {}
        for k, v in batch.items():
            v = v.clone()
            if b > 1:
                v[:, :, b // 2:] = v[:, :, :b // 2]
            else:
                R = v.shape[1]
                v[:, R // 2:] = v[:, :R // 2]
            out[k] = v
        return step_fn(state, out, t)
    return step


_SOUND = {}


def _broken(checks) -> set:
    return {k for k, c in checks.items() if not c["value"] <= c["limit"]}


def _token_altered(step_fn):
    """One token of node 0's first micro-batch altered where the oracle
    reads it."""
    def step(state, batch, t):
        tok = batch["tokens"].clone()
        tok[0, 0, 0, 1] = (tok[0, 0, 0, 1] + 1) % (int(tok.max()) + 1)
        return step_fn(state, {**batch, "tokens": tok}, t)
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_mix",
                                   "token_altered"])
def test_a_fault_is_not_correct(cell_name, fault, monkeypatch):
    from repro_torch.dist import collectives

    plant = {"unchanged": _unchanged, "half_batch": _half_batch,
             "token_altered": _token_altered}.get(fault)
    if fault == "no_mix":
        monkeypatch.setattr(collectives, "fused_multi_consensus",
                            lambda ws, mat: mat)
        monkeypatch.setattr(collectives, "fused_quantized_consensus",
                            lambda ws, mat, res, cfg, on: (mat, res))
    line = _measure(tiny_cell(cell_name), plant)
    assert not line["correct"], (fault, line["checks"])
    monkeypatch.undo()
    if cell_name not in _SOUND:
        _SOUND[cell_name] = _measure(tiny_cell(cell_name))["checks"]
    assert _broken(line["checks"]) - _broken(_SOUND[cell_name]), (
        fault, line["checks"], _SOUND[cell_name])


def test_a_non_finite_loss_fails(cell_name):
    def nan_loss(step_fn):
        def step(state, batch, t):
            state, out = step_fn(state, batch, t)
            return state, {**out, "loss": out["loss"] * torch.nan}
        return step

    cell = tiny_cell(cell_name)
    real = _measure(cell, None)
    assert real["failed"] == 0
    # the set-up steps feed the comparison: break only the window's
    from portbench.kinds.decentralized_train import SETUP_STEPS

    calls = {"n": 0}

    def late_nan(step_fn):
        broken = nan_loss(step_fn)

        def step(state, batch, t):
            calls["n"] += 1
            return (broken if calls["n"] > SETUP_STEPS else step_fn)(
                state, batch, t)
        return step

    line = _measure(cell, late_nan)
    assert line["failed"] > 0 and not line["correct"]
