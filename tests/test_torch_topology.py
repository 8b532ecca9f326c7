"""The port's verbatim copies (``core/topology.py``, ``core/gossip.py``,
configs, ``exp/manifest.py``), and its topology registry, against the JAX package's: weight stacks must be
bit-identical."""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import gossip as jgossip  # noqa: E402
from repro.exp import registry as jregistry  # noqa: E402
from repro.exp import spec as jspec  # noqa: E402
from repro_torch.core import gossip as tgossip  # noqa: E402
from repro_torch.exp import registry as tregistry  # noqa: E402
from repro_torch.exp import spec as tspec  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("module", ["core/topology.py", "core/gossip.py",
                                    "configs/base.py",
                                    "configs/qwen1_5_0_5b.py",
                                    "configs/logreg_paper.py",
                                    "exp/manifest.py"])
def test_copies_are_verbatim(module):
    assert (SRC / "repro_torch" / module).read_text() == \
        (SRC / "repro" / module).read_text()


@pytest.mark.parametrize("n,beta", [(2, 0.5), (4, 0.75), (5, 0.8), (8, 0.875),
                                    (16, 0.6), (7, 0.3)])
def test_theorem3_stacks_bit_identical(n, beta):
    a = jgossip.theorem3_weight_schedule(n, beta)
    b = tgossip.theorem3_weight_schedule(n, beta)
    assert a.period == b.period
    sa, sb = a.stacked(0, a.period), b.stacked(0, b.period)
    assert sa.dtype == sb.dtype and np.array_equal(sa, sb)
    # a window that wraps the period, as the driver gathers it
    assert np.array_equal(a.stacked(3, 2 * a.period + 1),
                          b.stacked(3, 2 * b.period + 1))


def test_registry_vocabulary_is_the_references():
    assert list(tregistry.TOPOLOGIES) == list(jregistry.TOPOLOGIES)
    assert tregistry.ALGORITHMS == jregistry.ALGORITHMS
    assert tregistry.GOSSIP_IMPLS == jregistry.GOSSIP_IMPLS
    assert list(tregistry.LOCAL_OPTS) == list(jregistry.LOCAL_OPTS)
    assert tregistry.COMPRESSIONS == jregistry.COMPRESSIONS
    assert tregistry.CHANNELS == tuple(jregistry.CHANNELS)
    assert tregistry.MODEL_KINDS == jregistry.MODEL_KINDS
    assert tregistry.ROUTING_POLICIES == jregistry.ROUTING_POLICIES
    assert tregistry.SERVE_DTYPES == jregistry.SERVE_DTYPES
    assert tregistry.OBS_METRICS == tuple(jregistry.OBS_METRICS)
    assert tregistry.SINKS == tuple(jregistry.SINKS)
    assert tregistry.OBS_BOUNDS == tuple(jregistry.OBS_BOUNDS)


PORTED = [k for k in jregistry.TOPOLOGIES
          if k not in tregistry.MOBILITY_TOPOLOGIES
          and k not in tregistry.SPARSE_TOPOLOGIES]


@pytest.mark.parametrize("kind", PORTED)
def test_registry_schedules_bit_identical(kind):
    kw = dict(kind=kind, pods=2) if kind == "hierarchical" else dict(kind=kind)
    a = jregistry.build_topology(jspec.TopologySpec(**kw), 8, horizon=40,
                                 seed=3)
    b = tregistry.build_topology(tspec.TopologySpec(**kw), 8, horizon=40,
                                 seed=3)
    assert a.period == b.period
    assert np.array_equal(a.stacked(0, a.period), b.stacked(0, b.period))


@pytest.mark.parametrize("kind", ["geometric-mobility", "waypoint-mobility"])
def test_unported_topologies_raise(kind):
    """(Named when the mobility topologies still raised.)  Each builds the
    reference's schedule: the same matrices over the horizon, bit for bit
    (tests/test_torch_mobility.py holds them at length)."""
    a = jregistry.build_topology(jspec.TopologySpec(kind=kind), 8, horizon=8)
    b = tregistry.build_topology(tspec.TopologySpec(kind=kind), 8, horizon=8)
    assert a.period == b.period == 8
    assert np.array_equal(a.stacked(0, 8), b.stacked(0, 8))
