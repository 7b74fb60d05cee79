"""The harness's tests. A test that needs the card takes the ``card``
fixture, which skips without one; the decision is made when the test
runs, never at import."""

import pytest
import torch

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (CUDA)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
