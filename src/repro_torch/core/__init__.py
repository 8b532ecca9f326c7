"""Core of the paper in the port: time-varying topologies and gossip
weight schedules and their gossip plans (numpy copies of the JAX package's
modules), the update-rule engine, the mixers with the plan dispatcher, and
the training driver."""

from . import algorithms, driver, engine, gossip, topology  # noqa: F401
from .engine import ALGORITHMS, EngineOps, EngineState, UpdateRule, make_rule  # noqa: F401
from .gossip import WeightSchedule, theorem3_weight_schedule  # noqa: F401
