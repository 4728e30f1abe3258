"""The module-scoped autouse fixture that pins torch to one intra-op
thread. A test module takes it with

    from _torch_threads import one_thread  # noqa: F401

and pytest registers the imported fixture as the module's own."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, restored after the module: these smoke-size
    ops gain nothing from more, and under several test workers torch's
    thread pools oversubscribe the cores they share (the cluster's
    mixshift replay runs ≈ 35× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
