"""The thread policy of the port's CPU tests: one intra-op thread.

A port test file takes it with one line among its imports,

    from _torch_threads import one_torch_thread  # noqa: F401

which puts the autouse, module-scoped fixture below into the file's
namespace, where pytest applies it to every test of that file. The port's
CPU paths run many small ops: beside the suite's other workers (and JAX's
own thread pool) more intra-op threads only contend. Files that test
thread counts themselves, or run on the card, do not take it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
