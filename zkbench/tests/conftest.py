"""Markers of the harness's tests: ``gpu`` (needs a CUDA card; each such
test asks the ``cuda`` fixture, which skips without one) and ``slow``
(a CPU rehearsal of a whole run: minutes)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")
    config.addinivalue_line("markers", "slow: a whole run rehearsed on the CPU (minutes)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
