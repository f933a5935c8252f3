"""The port's test files run their CPU work on one intra-op thread: the
suite's parallel workers each take a thread per core by default, and the
small ops of these tests then wait on oversubscribed cores (six workers
running the bit-equality cases of ``test_torch_batched.py``: 623 s each,
against 6 s with one thread).  A file pulls the fixture in with

    from _torch_threads import _one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
