from .optimizers import Optimizer, adam, momentum, sgd  # noqa: F401
