"""An autouse fixture that runs a test module's PyTorch CPU work on one
thread; a port test module takes it with
``from torch_threads import one_torch_thread  # noqa: F401``.

The tier-1 run puts six pytest workers on the machine's cores. PyTorch's
CPU ops default to one thread per core, and beside five other busy
processes those threads spend most of their time waiting for each other
at the end of every op, while taking cores from the other workers: the
``profile_train`` tool test takes 6.5 s alone, 123 s beside six busy
processes at the default and 12.5 s there on one thread. The JAX
references in the same modules keep their own thread pool.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
