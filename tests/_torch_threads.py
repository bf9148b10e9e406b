"""One torch thread per test module of the port (imports neither ``jax``
nor ``deepspeed_tpu``, so a pure-port module stays free of them)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one CPU: one torch
    thread per module (its module-scoped engines included) keeps a torch op
    from spreading over every core beside the other workers' compiles. The
    port's CPU test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
