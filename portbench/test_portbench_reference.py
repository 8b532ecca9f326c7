"""The plain reference and the frozen yardstick against the program."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import run, schedule, work
from portbench.reference import decoder, encdec, mcdsgt, precision
from portbench.tinycells import TINY_DECODER, TINY_ENCDEC, tiny_cell

FAMILIES = {"decoder": decoder, "encdec": encdec}


def _program_model(config):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import build

    family = FAMILIES[config["family"]]
    return build(ModelConfig(**family.port_fields(config)))


def test_reference_tree_is_the_programs(cell_name):
    """The reference's leaves are the program's, at the cell's full size."""
    config = run.load_cell(cell_name)["config"]
    spec = FAMILIES[config["family"]].param_spec(config)
    from repro_torch import tree

    shapes = {"/".join(p): tuple(s) for p, s in
              tree.items(_program_model(config).shapes)}
    assert shapes == {p: tuple(s) for p, s, _ in spec}


def test_configuration_is_the_programs_registered_one(cell_name):
    """The file runs the program's registered configuration, its sizes.
    Not its dtype, which the file states, nor its rotary base: the registry
    keeps the default 10,000 where qwen1.5-0.5b publishes 1,000,000, which
    the file runs and the program takes as given."""
    from repro_torch import configs

    config = run.load_cell(cell_name)["config"]
    fields = FAMILIES[config["family"]].port_fields(config)
    registered = configs.get(config["name"])
    for key, value in fields.items():
        if key not in ("dtype", "rope_theta"):
            assert getattr(registered, key) == value, key
    assert fields["rope_theta"] == float(config.get("rope_theta", 0.0))


def test_reference_step_equals_the_programs(cell_name):
    """The harness on the CPU at a tiny size: the program's step (its plain
    mixers) against the reference, every number far under 1e-4."""
    cell = tiny_cell(cell_name)
    cell["limits"] = dict.fromkeys(cell["limits"], 1e-4)
    line = run.measure(cell, seed=2 ** 31 + 101, seconds=0.2, trace=False,
                       device="cpu", t_start=0.0)
    assert line["correct"], line["checks"]
    assert len(line["checks"]) >= 4


def test_frozen_counts_equal_the_formulas_and_the_programs():
    from repro_torch.kernels import cost

    for n, D, R in ((4, 463_987_712, 2), (32, 36_448_768, 2), (7, 999, 3)):
        g = work.gossip_mix(n, D, R, 4)
        assert (g.flops, g.bytes) == (2 * n * n * D + 2 * (R - 1) * n ** 3,
                                      R * n * n * 4 + 2 * n * D * 4)
        q = work.quantized_gossip_mix(n, D, R, 4, 4)
        assert (q.flops, q.bytes) == (2 * R * n * n * D + 8 * R * n * D,
                                      R * n * n * 4 + 2 * n * D * 8)
        assert tuple(g) == tuple(cost.gossip_mix(n, D, R, 4))
        assert tuple(q) == tuple(cost.quantized_gossip_mix(n, D, R, 4, 4))
    assert work.PEAK_FLOPS["float32"] == cost.PEAK_FLOPS_F32
    assert work.HBM_BW == cost.HBM_BW


@pytest.mark.parametrize("config,b,S", [(TINY_DECODER, 2, 12),
                                        (TINY_ENCDEC, 3, 7)])
def test_model_flops_equal_the_counter(config, b, S):
    """The formula equals FlopCounterMode over the reference's forward and
    backward, once the masked half of the causal products is taken off."""
    family = FAMILIES[config["family"]]
    from portbench import traffic, weights

    params = weights.draw(family.param_spec(config), 3, "cpu")
    tr = {"nodes": 1, "R": 1, "batch": b, "seq": S, "pool": 1}
    batch = {k: v[0, 0] for k, v in
             traffic.make_pool(family, config, tr, 3, "cpu")[0].items()}
    leaves = {}
    for path, l in mcdsgt.leaf_views(family.param_spec(config)):
        t = params[path] if l is None else params[path][l]
        leaves[(path, l)] = t.detach().requires_grad_()
    with FlopCounterMode(display=False) as fc:
        family.loss(lambda p, l: leaves[(p, l)], config, batch).backward()
    assert (fc.get_total_flops() - family.masked_flops(config, b, S)
            == family.model_flops(config, b, S))


@pytest.mark.parametrize("n,beta", [(4, 0.75), (32, 1 - 1 / 32), (10, 0.6),
                                    (5, 0.0)])
def test_schedule_is_the_programs_theorem3(n, beta):
    from repro_torch.core import gossip

    ref = gossip.theorem3_weight_schedule(n, beta)
    mats = schedule.theorem3(n, beta)
    assert mats.shape[0] == ref.period
    np.testing.assert_allclose(mats, ref.stacked(0, ref.period,
                                                 np.float64), atol=1e-15)
    w = schedule.windows(n, beta, 2 ** 31 + 5)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(w.sum(axis=2), 1.0, atol=1e-6)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12), 3.0])
    r = precision._tf32_round(x)
    assert r.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -1.0, 3.0]


def test_control_fails_the_cells_limits(cell_name):
    """The control, the reference in TF32 put in the program's place, at a
    tiny size on the CPU (operands rounded to TF32 forward): its numbers
    break the cell's limits."""
    from portbench import compare, control

    cell = tiny_cell(cell_name)
    limits = run.load_cell(cell_name)["limits"]
    for _, gaps, _ in control.readings(cell, 2 ** 31 + 77, ["tf32"],
                                         "cpu"):
        assert not compare.verdict(gaps, limits)[0], gaps


@pytest.mark.cuda
def test_control_on_the_card(cell_name):
    """The control with the card's own TF32, at a small size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import compare, control

    cell = tiny_cell(cell_name)
    limits = run.load_cell(cell_name)["limits"]
    for _, gaps, _ in control.readings(cell, 2 ** 31 + 78, ["tf32"],
                                         "cuda"):
        assert not compare.verdict(gaps, limits)[0], gaps
