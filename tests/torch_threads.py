"""One intra-op torch thread for a test module's tiny tensors.

Import the fixture into a test module to apply it there::

    from torch_threads import one_torch_thread  # noqa: E402,F401

Under the suite's xdist workers, a pool of threads per worker
oversubscribes the cores: a tiny engine's or UNet's hundreds of small ops
each pay for the spin-waits (seconds a forward instead of milliseconds).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
