"""An autouse fixture for the port's tests that start a DistributedRuntime,
or that read the port's log records through caplog.

A DistributedRuntime initialises the port's logging: its own handler and
no propagation to the root logger. A later test in the same process would
then see none of the port's records in caplog. Import the fixture by name
into such a test module: it puts the port's logging into its pristine
state (as no ``init_logging`` call left it) before and after each test.
The state is an explicit one, not a snapshot: a snapshot taken when this
helper is first imported would take in a runtime that an earlier test
module in the same process started and never cleaned up.
"""

import logging

import pytest

from dynamo_tpu_torch.runtime import logging as tlogging

_ROOT = logging.getLogger(tlogging.ROOT)


def _pristine() -> None:
    tlogging._initialized = False
    _ROOT.propagate = True
    _ROOT.setLevel(logging.NOTSET)
    for h in list(_ROOT.handlers):
        _ROOT.removeHandler(h)


@pytest.fixture(autouse=True)
def port_logging_restored():
    _pristine()
    yield
    _pristine()
