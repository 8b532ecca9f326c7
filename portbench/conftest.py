import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips (with its "
        "reason) where torch finds no CUDA device.")


CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param


@pytest.fixture(autouse=True)
def _one_thread():
    """The harness at a tiny size, in workers that share the machine."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
