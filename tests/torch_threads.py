"""One torch thread for the port's CPU-heavy test modules.

Import the fixture into a test module (``from torch_threads import
one_torch_thread  # noqa: F401``) and it applies to every test there. The
tier-1 run shares the CPU among several worker processes, and torch's own
thread pool then spins against theirs: a detection file ran its CLI cases
40-80× slower than alone.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
