"""The port's lock-order sanitizer fixture (``KFT_LOCKCHECK=1``).

The twin of the JAX package's ``_lockcheck`` fixture in
tests/conftest.py, for the port's threaded suites: the serving front and
engine, the fleet tier, the cluster scheduler and the supervised
trainer.  A test module takes it with

    from torch_lockcheck import lockcheck_order  # noqa: F401

The sanitizer (``kubeflow_tpu_torch/testing/lockcheck.py``) installs once
and its acquisition graph accumulates across tests, so an inconsistent
nesting order between two tests still closes a cycle, and the test that
closed it fails at teardown with both paths spelled out.  Off unless
``KFT_LOCKCHECK`` is set: instrumentation taxes every acquire.

    KFT_LOCKCHECK=1 JAX_PLATFORMS=cpu python -m pytest \\
        tests/test_torch_serving.py tests/test_torch_fleet.py
"""

import pytest

from kubeflow_tpu_torch.testing import lockcheck


@pytest.fixture(autouse=True)
def lockcheck_order():
    if not lockcheck.enabled_in_env():
        yield
        return
    sanitizer = lockcheck.install()  # idempotent; the graph persists
    before = len(sanitizer.violations())
    yield
    new = sanitizer.violations()[before:]
    assert not new, (
        "lock-order inversions recorded (KFT_LOCKCHECK):\n"
        + "\n".join(repr(v) for v in new))
