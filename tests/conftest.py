def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips (with its "
        "reason) where torch finds no CUDA device. Run these on the card "
        "with `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`.")
