"""The port's lock-order sanitizer (kubeflow_tpu_torch/testing/lockcheck.py).

Each test installs the sanitizer around locks of its own and uninstalls
it after, so nothing leaks into another test: two sites nested both ways
give one violation naming both paths, nesting within one site is
ignored, and a lock made before ``install`` is left as it is.  The
checked lock is a whole lock: a Condition built on it works.
"""

import threading

import pytest
import torch

from kubeflow_tpu_torch.testing import lockcheck

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)


@pytest.fixture()
def sanitizer():
    assert lockcheck.active() is None
    san = lockcheck.install()
    try:
        yield san
    finally:
        lockcheck.uninstall()
    assert threading.Lock is lockcheck._real_lock


def _lock_a():
    return threading.Lock()


def _lock_b():
    return threading.Lock()


def test_enabled_only_by_the_env_var():
    assert not lockcheck.enabled_in_env({})
    assert not lockcheck.enabled_in_env({"KFT_LOCKCHECK": "0"})
    assert not lockcheck.enabled_in_env({"KFT_LOCKCHECK": "false"})
    assert lockcheck.enabled_in_env({"KFT_LOCKCHECK": "1"})


def test_install_is_idempotent(sanitizer):
    assert lockcheck.install() is sanitizer
    assert lockcheck.active() is sanitizer


def test_two_sites_nested_both_ways_give_one_violation(sanitizer):
    a, b = _lock_a(), _lock_b()
    with a:
        with b:
            pass
    assert sanitizer.violations() == []

    def other_order():
        with b:
            with a:
                pass

    t = threading.Thread(target=other_order, name="inverter")
    t.start()
    t.join(timeout=30)
    (v,) = sanitizer.violations()
    site_a, site_b = a._site, b._site
    assert site_a != site_b
    assert {site_a, site_b} <= sanitizer.sites()
    assert site_a.startswith("test_torch_lockcheck.py:")
    assert v.edge == (site_b, site_a)
    assert v.cycle == [site_a, site_b, site_a]
    assert v.thread == "inverter"
    text = repr(v)
    assert site_a in text and site_b in text and "inverter" in text
    # The edge is recorded once: the same inversion again adds nothing.
    other_order()
    assert len(sanitizer.violations()) == 1
    sanitizer.reset()
    assert sanitizer.violations() == []


def test_nesting_within_one_site_is_ignored(sanitizer):
    first, second = _lock_a(), _lock_a()
    assert first._site == second._site
    with first:
        with second:
            pass
    with second:
        with first:
            pass
    assert sanitizer.violations() == []


def test_a_lock_made_before_install_is_untouched():
    before = threading.Lock()
    san = lockcheck.install()
    try:
        after = threading.Lock()
        assert isinstance(after, lockcheck._CheckedLock)
        assert not isinstance(before, lockcheck._CheckedLock)
        with after:
            with before:
                pass
        with before:
            with after:
                pass
        assert san.violations() == []
    finally:
        lockcheck.uninstall()
    assert not isinstance(threading.Lock(), lockcheck._CheckedLock)


def test_a_checked_lock_backs_a_condition(sanitizer):
    lock = _lock_a()
    cond = threading.Condition(lock)
    box = []

    def waiter():
        with cond:
            cond.wait_for(lambda: box, timeout=30)

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        box.append(1)
        cond.notify_all()
    t.join(timeout=30)
    assert not t.is_alive()
    assert not lock.locked()
    assert lock.acquire(timeout=1)
    lock.release()
