"""Card gate for the kernel-against-plain tests: the decision is taken in a
fixture, when a test runs, never while a module is imported."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("cuda marker: the CUDA kernels need a card")
