"""One torch thread for the port's CPU runs in a test module.

The suite runs six pytest workers on the host's cores. A port run in a
test process takes a thread a core by default, and the gloo ranks that
some modules spawn take more, so the cores are oversubscribed: under the
suite, files that train the port took 10-17 times their time alone. A
test module that imports ``one_torch_thread`` runs its tests and its
module fixtures on one torch thread, and restores the count after.
"""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
