"""The one-thread fixture that the CPU-heavy port test modules share.

Each of those modules imports `_one_thread` into its namespace, where
pytest collects it as an autouse fixture of that module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while a module runs: the suite runs six
    xdist workers on a shared CPU, and PyTorch's default of one thread per
    core in each of them oversubscribes it (test_torch_session.py's tests
    ran fifty times slower in the full suite than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_fixture_sets_one_thread():
    assert torch.get_num_threads() == 1
