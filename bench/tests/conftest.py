import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of the "
        "PyTorch port); skips where torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, never
    while a module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda", 0)
