"""A fixture the port's MoE test modules share: import it into a module
(``from torch_threads import one_torch_thread``) to pin that module's
torch work to one intra-op thread."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the importing module's torch work.  The
    suite runs in several worker processes at once, and OpenMP's parallel
    regions slow down by orders of magnitude on oversubscribed cores: six
    processes training the reduced MoE at once took 145 s a step with 8
    threads each, 0.6 s with one.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
