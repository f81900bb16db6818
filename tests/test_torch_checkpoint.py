"""The port's verified checkpoints (runtime/checkpoint.py), held to the
JAX package's contract and read by the JAX package's own verifier.

A tiny LM trains on the CPU in float32.  Resumed runs are held to
uninterrupted ones exactly (the same ops on the same values, restored
bit for bit).  The JAX package's ``verify_step`` and ``kubeflow-tpu
checkpoints verify`` judge a port checkpoint directory unchanged.
"""

import json
import os

import numpy as np
import pytest
import torch

from kubeflow_tpu.runtime import checkpoint as jax_checkpoint
from kubeflow_tpu.tools import cli as jax_cli
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.runtime import checkpoint, optim
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.runtime.supervisor import TrainSupervisor
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.testing import faults
from kubeflow_tpu_torch.tools import cli as port_cli
from torch_lockcheck import lockcheck_order  # noqa: F401

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

SMALL = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=32, head_dim=8, max_seq_len=16, attention="flash")


def _batches(n=8):
    rng = np.random.RandomState(5)
    return [{"tokens": rng.randint(0, 64, size=(2, 16)).astype(np.int32)}
            for _ in range(n)]


def _data():
    return iter(_batches())


def _trainer(ckpt_dir=None, tx=None, every=2, keep=3):
    init_fn, loss_fn = lm_task(TransformerConfig(dtype=torch.float32,
                                                 **SMALL), device="cpu")
    return Trainer(
        init_fn=init_fn, loss_fn=loss_fn,
        tx=tx or optim.adafactor(1e-2), device="cpu",
        checkpoints=(None if ckpt_dir is None else
                     checkpoint.CheckpointManager(ckpt_dir,
                                                  max_to_keep=keep)),
        checkpoint_every=every,
        metrics=MetricsLogger(stream=open(os.devnull, "w")))


def _params(state):
    return {k: v.detach().clone() for k, v in
            state.params.state_dict().items()}


def _assert_same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _counter(name):
    return REGISTRY.counter(name).value()


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_round_trip_restores_every_part_of_the_state(tmp_path, opt):
    tx = optim.adamw(1e-2) if opt == "adamw" else optim.adafactor(1e-2)
    trainer = _trainer(tx=tx)
    state = trainer.fit(_data(), 3, state=trainer.create_state(1),
                        log_every=0)
    state.rng.manual_seed(99)
    state.mutable = {"seen": 3}
    saves = _counter("kft_checkpoint_saves_total")
    with checkpoint.CheckpointManager(tmp_path) as mgr:
        assert mgr.save(2, state)
        assert not mgr.save(2, state)  # already saved: a no-op
    assert _counter("kft_checkpoint_saves_total") == saves + 1
    fresh = _trainer(tx=tx).create_state(7)
    restored, start = checkpoint.CheckpointManager(tmp_path).restore_or_init(
        fresh)
    assert start == 3 and restored.step == 3
    _assert_same_params(_params(restored), _params(state))
    assert restored.params is fresh.params  # restored in place
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    assert restored.mutable == {"seen": 3}
    assert restored.opt_state.count == state.opt_state.count == 3
    ours, want = (checkpoint._encode(s.opt_state) for s in (restored,
                                                              state))
    for key in want:
        if key != "count":
            for a, b in zip(*(v.values() if isinstance(v, dict) else v
                              for v in (ours[key], want[key]))):
                assert torch.equal(a, b)
    manifest = json.loads(checkpoint.manifest_path(tmp_path, 2).read_text())
    assert manifest["format"] == 1 and manifest["step"] == 2
    assert set(manifest["files"]) == {checkpoint.STATE_FILE}
    leaves = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    assert leaves["['params']['embed']"]["shape"] == [64, 16]
    assert leaves["['step']"]["dtype"] == "int"


def test_resume_two_plus_two_equals_four(tmp_path):
    control = _trainer()
    want = control.fit(_data(), 4, log_every=0)
    first = _trainer(tmp_path, every=1)
    first.fit(_data(), 2, log_every=0)
    assert first.checkpoints.all_steps() == [0, 1]
    second = _trainer(tmp_path, every=1)
    seen = []
    got = second.fit(_data(), 4, log_every=0, on_step=seen.append)
    assert seen == [3, 4]  # resumed at step 2
    assert got.step == want.step == 4
    _assert_same_params(_params(got), _params(want))
    # A rerun past the end trains nothing.
    assert _trainer(tmp_path).fit(_data(), 4, log_every=0).step == 4


@pytest.mark.parametrize("damage", ["missing_manifest", "truncated",
                                    "flipped_byte"])
def test_restore_walks_back_over_a_corrupt_newest_step(tmp_path, damage):
    trainer = _trainer(tmp_path)
    trainer.fit(_data(), 4, log_every=0)
    assert trainer.checkpoints.all_steps() == [1, 3]
    state_file = tmp_path / "3" / checkpoint.STATE_FILE
    if damage == "missing_manifest":
        checkpoint.manifest_path(tmp_path, 3).unlink()
    elif damage == "truncated":
        state_file.write_bytes(state_file.read_bytes()[:-100])
    else:
        raw = bytearray(state_file.read_bytes())
        raw[len(raw) // 2] ^= 0x40
        state_file.write_bytes(bytes(raw))
    assert not checkpoint.verify_step(tmp_path, 3)[0]
    assert not jax_checkpoint.verify_step(tmp_path, 3)[0]
    failures = _counter("kft_checkpoint_verify_failures_total")
    mgr = checkpoint.CheckpointManager(tmp_path)
    state, start = mgr.restore_or_init(_trainer().create_state(4))
    assert start == 2 and state.step == 2
    assert _counter("kft_checkpoint_verify_failures_total") > failures


def test_gc_keeps_the_newest_verified_step(tmp_path):
    state = _trainer().create_state(0)
    mgr = checkpoint.CheckpointManager(tmp_path, max_to_keep=2)
    mgr.save(0, state)
    mgr.wait()
    with faults.injected("checkpoint.save:raise"):
        for step in (1, 2, 3):
            assert mgr.save(step, state)
            with pytest.raises(checkpoint.CheckpointError):
                mgr.wait()
    assert mgr.all_steps() == [0, 2, 3]
    assert mgr.latest_verified_step() == 0
    assert not checkpoint.manifest_path(tmp_path, 1).exists()


def test_a_save_fault_surfaces_at_the_next_save(tmp_path):
    state = _trainer().create_state(0)
    mgr = checkpoint.CheckpointManager(tmp_path)
    failures = _counter("kft_checkpoint_failures_total")
    with faults.injected("checkpoint.save:raise*1") as inj:
        assert mgr.save(0, state)
        for t in list(mgr._threads):
            t.join()
        with pytest.raises(checkpoint.CheckpointError, match="injected"):
            mgr.save(1, state)
        assert inj.fired("checkpoint.save") == 1
    assert _counter("kft_checkpoint_failures_total") == failures + 1
    assert mgr.save(1, state)  # the error was raised once
    mgr.wait()
    assert checkpoint.verify_step(tmp_path, 1)[0]
    assert not checkpoint.verify_step(tmp_path, 0)[0]  # died pre-manifest
    with faults.injected("checkpoint.restore:raise*1") as inj:
        _, start = mgr.restore_or_init(_trainer().create_state(1))
        assert inj.fired("checkpoint.restore") == 2
    # Step 1's restore raised; step 0 has no manifest but is older than
    # every manifested step, so it is a restore candidate, as in the JAX
    # package, and its files are whole.
    assert start == 1


def clis_agree(capsys, *argv):
    """The port's and the JAX package's ``checkpoints`` verbs on one
    directory: the same exit code and the same report; returns both."""
    capsys.readouterr()
    port_rc = port_cli.main(["checkpoints", *argv])
    port_out = capsys.readouterr().out
    jax_rc = jax_cli.main(["checkpoints", *argv])
    jax_out = capsys.readouterr().out
    assert (port_rc, port_out) == (jax_rc, jax_out)
    return port_rc, port_out


def test_jax_verifier_and_cli_accept_a_port_directory(tmp_path, capsys):
    import shutil

    trainer = _trainer(tmp_path)
    trainer.fit(_data(), 4, log_every=0)
    for step in (1, 3):
        assert jax_checkpoint.verify_step(tmp_path, step) == (True, "")
    assert jax_cli.main(["checkpoints", "verify", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "verified" in out
    assert clis_agree(capsys, "verify", str(tmp_path))[0] == 0
    assert "resumes here" in clis_agree(capsys, "list", str(tmp_path))[1]
    # The fused members' layout (runtime/hfta.py: one directory a member
    # under the root): one verdict table a member in both CLIs.
    fused = tmp_path.parent / (tmp_path.name + "-fused")
    for member in ("m0", "m1"):
        shutil.copytree(tmp_path, fused / member)
    rc, out = clis_agree(capsys, "list", str(fused))
    assert rc == 0 and out.count("resumes here") == 2
    (tmp_path / "3" / checkpoint.STATE_FILE).write_bytes(b"x")
    assert jax_cli.main(["checkpoints", "verify", str(tmp_path)]) == 2
    assert clis_agree(capsys, "verify", str(tmp_path))[0] == 2
    assert "corrupt" in clis_agree(capsys, "list", str(tmp_path))[1]


def test_supervised_restart_resumes_from_the_checkpoint(tmp_path):
    control = _trainer(tmp_path / "control")
    want = TrainSupervisor(control, max_restarts=0).run(_data, 6,
                                                        log_every=0)
    trainer = _trainer(tmp_path / "victim")
    sup = TrainSupervisor(trainer, max_restarts=2, backoff_s=5.0)
    sup.run(_data, 4, log_every=0)
    assert trainer.checkpoints.latest_verified_step() == 3
    with faults.injected("train.step:raise*1;train.step:skew=60"):
        got = sup.run(_data, 6, log_every=0)
    assert sup.restarts == 1
    assert sup.steps_seen == sorted(sup.steps_seen)
    assert sup.steps_seen[-1] == 6 and 0 not in sup.steps_seen
    assert got.step == want.step == 6
    _assert_same_params(_params(got), _params(want))
