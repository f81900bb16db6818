"""The port's cluster scheduler (quotas, weighted-fair order, priority
classes, backfill, preemption with resume, fused gangs, train/serve
colocation) against the JAX package's: every test of
``tests/test_scheduler.py`` runs on both packages with its own
assertions, and the two runs must plan, place, evict, requeue, stamp
statuses and events, and count metrics alike (``torch_control_parity``
says how the runs are recorded and compared)."""

import pytest
import torch

from torch_control_parity import (
    SLICE_MAP,
    assert_same,
    differential,
    load_variants,
    jax_test_names,
)
from torch_lockcheck import lockcheck_order  # noqa: F401

# One intra-op thread a process: the suite runs as several processes on
# shared cores (the checkpoint case saves tensors).
torch.set_num_threads(1)

# The resume case saves the trainer's state through each package's own
# CheckpointManager: numpy arrays under JAX's, tensors under the port's
# (which has no save interval: the trainer decides when to save).
PORT_REWRITES = [
    ('''        base = np.arange(4, dtype=np.float32)
        with CheckpointManager(tmp_path / "ckpt",
                               save_interval_steps=1) as mgr:''',
     '''        import torch

        base = torch.arange(4, dtype=torch.float32)
        with CheckpointManager(tmp_path / "ckpt") as mgr:'''),
    ('''                mgr.save(step, {"step": np.full((), step, np.int32),''',
     '''                mgr.save(step, {"step": torch.tensor(step,
                                                     dtype=torch.int32),'''),
    ('''        fresh = {"step": np.zeros((), np.int32),
                 "w": np.zeros(4, dtype=np.float32)}''',
     '''        fresh = {"step": torch.zeros((), dtype=torch.int32),
                 "w": torch.zeros(4)}'''),
]

VARIANTS = load_variants("test_scheduler.py", PORT_REWRITES)
CASES = jax_test_names(VARIANTS["jax"])


def test_every_jax_scheduler_test_is_a_case():
    assert len(CASES) == 48
    assert CASES == jax_test_names(VARIANTS["port"])
    assert SLICE_MAP["v5e-8"] == "h100-8" and SLICE_MAP["v5p-32"] == "h100-32"


@pytest.mark.parametrize("case", CASES)
def test_port_schedules_as_jax(case, tmp_path, monkeypatch):
    assert_same(differential(VARIANTS, case, tmp_path, monkeypatch))
