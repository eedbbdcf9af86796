"""One torch intra-op thread for a test module.

A module imports the fixture (``from torch_threads import
one_torch_thread``), and pytest then applies it to every test there: under
the test runner's parallel workers, every process spinning up all the
cores' threads for ops of a few hundred elements costs far more than it
gives. The count in use before is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
