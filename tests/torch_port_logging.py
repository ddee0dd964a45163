"""An autouse fixture for the port's tests that start a DistributedRuntime.

A DistributedRuntime initialises the port's logging: its own handler and
no propagation to the root logger. A later test in the same process would
then see none of the port's records in caplog. Import the fixture by name
into such a test module to put the logging back as it was after each test.
"""

import logging

import pytest

from dynamo_tpu_torch.runtime import logging as tlogging


@pytest.fixture(autouse=True)
def port_logging_restored():
    root = logging.getLogger(tlogging.ROOT)
    saved = (tlogging._initialized, root.propagate, root.level, list(root.handlers))
    yield
    tlogging._initialized = saved[0]
    root.propagate, root.level, root.handlers[:] = saved[1], saved[2], saved[3]
