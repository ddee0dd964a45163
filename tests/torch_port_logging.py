"""An autouse fixture for the port's tests that start a DistributedRuntime.

A DistributedRuntime initialises the port's logging: its own handler and
no propagation to the root logger. A later test in the same process would
then see none of the port's records in caplog. Import the fixture by name
into such a test module to put the logging back after each test as it was
when this helper was imported (before any test ran), so that a runtime a
module-scoped fixture started before the test does not leak either.
"""

import logging

import pytest

from dynamo_tpu_torch.runtime import logging as tlogging

_ROOT = logging.getLogger(tlogging.ROOT)
_PRISTINE = (tlogging._initialized, _ROOT.propagate, _ROOT.level, list(_ROOT.handlers))


@pytest.fixture(autouse=True)
def port_logging_restored():
    yield
    tlogging._initialized = _PRISTINE[0]
    _ROOT.propagate, _ROOT.level, _ROOT.handlers[:] = _PRISTINE[1], _PRISTINE[2], _PRISTINE[3]
