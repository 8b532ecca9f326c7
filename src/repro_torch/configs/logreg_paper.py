"""The paper's own experiment (Section 6): logistic regression with the
non-convex regularizer r(x) = sum_k x_k^2 / (1 + x_k^2) on heterogeneously
partitioned binary datasets.  Not an LM config — consumed by
benchmarks/figure2.py and examples/paper_figure2.py."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LogRegConfig:
    name: str
    n_nodes: int
    center_size: int          # |C| of the sun-shaped schedule
    rho: float                # regularization weight
    R: int                    # MC-DSGT consensus/accumulation rounds
    d: int                    # feature dim
    m: int                    # samples per node
    batch: int = 32


MNIST = LogRegConfig(name="mnist-24", n_nodes=16, center_size=1, rho=0.2,
                     R=2, d=784, m=512)
COVTYPE = LogRegConfig(name="covtype-binary", n_nodes=32, center_size=4,
                       rho=0.015, R=4, d=54, m=512)
