"""One intra-op thread for the port's CPU tests that run the models.

The tier-1 run puts six xdist workers on the host's cores. With torch's
default of one OpenMP thread a core in each, the pools spin against each
other: a 16px train step ran about 250 times slower in six such processes
at once than in six processes of one thread each. A module that imports
``one_torch_thread`` runs its tests at one thread and restores the count
after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
