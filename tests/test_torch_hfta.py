"""The port's horizontally fused training arrays (runtime/hfta.py)
against the JAX package's, and its own HFTA contract.

Float32 on the CPU, ``tests/test_hfta.py``'s configuration (vocab 64,
d_model 16, one layer, seq 16, batch 8) unless a case says otherwise.
Tolerances:

  - the port's width-4 ``FusedTrainer`` against the JAX one from the
    same member weights over 5 steps: per-member loss, grad_norm and
    every parameter within atol=rtol=1e-4 (the Trainer trajectories'
    tolerance, tests/test_torch_train.py);
  - a masked member (early stop, non-finite loss) against its state at
    the freeze point, a resumed run against an uninterrupted one, and a
    run against a rerun: bit-equal (the same program on the same
    inputs; a frozen member's rows are never written);
  - a member of the fused run against a solo ``Trainer`` on the same
    weights and batches (flash, remat, dropout, MoE): atol=rtol=1e-6.
    On this CPU they come out bit-equal; the card's batched products
    may accumulate in another order, so the bound is a float32 one;
  - the stacked optimizers against optax per member over 5 updates:
    atol=1e-6, rtol=1e-5 (tests/test_torch_train.py's optimizer
    tolerance).

torch.func.vmap's fallback for an op without a batching rule is turned
on and its warning is an error here: the fused step runs no member loop.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.parallel import MeshSpec
from kubeflow_tpu.runtime.checkpoint import verify_step as jax_verify_step
from kubeflow_tpu.runtime.hfta import FusedTrainer as JaxFusedTrainer
from kubeflow_tpu.runtime.hfta import default_tx_factory as jax_default_tx
from kubeflow_tpu.runtime.hfta import MemberSpec as JaxMemberSpec
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.models.convert import (
    load_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    lm_task,
)
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.hfta import (
    FusedTrainer,
    MemberSpec,
    _form,
    _stack,
    _unstack,
)
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.runtime.supervisor import TrainSupervisor
from kubeflow_tpu_torch.runtime.train import Trainer, TrainState
from kubeflow_tpu_torch.testing import faults

pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

VOCAB, SEQ, BATCH = 64, 16, 8
SMALL = dict(vocab_size=VOCAB, d_model=16, n_layers=1, n_heads=2,
             n_kv_heads=2, d_ff=32, head_dim=8, max_seq_len=SEQ)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
SOLO_TOL = dict(atol=1e-6, rtol=1e-6)
OPT_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _vmap_fallback_warns():
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def data_factory(poison_at=None):
    r = np.random.RandomState(0)
    for i in itertools.count():
        batch = {"tokens": r.randint(0, VOCAB, size=(BATCH, SEQ))
                 .astype(np.int32)}
        if poison_at is not None:
            batch["poison"] = np.asarray(i == poison_at)
        yield batch


def specs(n=4, stop=None, cls=MemberSpec):
    return [cls(name=f"m{i}", seed=i, lr=1e-3 * (i + 1), tenant=f"t{i % 2}",
                stop_step=(stop if i == 1 else None)) for i in range(n)]


def _null():
    return MetricsLogger(stream=open("/dev/null", "w"))


def port_task(**overrides):
    cfg = TransformerConfig(dtype=torch.float32, **dict(SMALL, **overrides))
    return lm_task(cfg, device="cpu")


def make(members, task=None, ckpt=None, every=1000, **kwargs):
    init_fn, loss_fn = task or port_task()
    return FusedTrainer(init_fn=init_fn, loss_fn=loss_fn, members=members,
                        checkpoint_dir=ckpt, checkpoint_every=every,
                        metrics=_null(), device="cpu", **kwargs)


def leaves(trainer, fused, i):
    return {k: v.detach().clone() for k, v in
            trainer.member_state(fused, i).params.named_parameters()}


def assert_bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def fused4():
    """The port's width-4 reference: specs(4) for 5 steps, no stops."""
    ft = make(specs(4))
    return ft, ft.fit(data_factory(), 5, log_every=10)


# -- against the JAX FusedTrainer ---------------------------------------------


@pytest.fixture(scope="module")
def jax_task():
    cfg = JaxTransformerConfig(dtype="float32", **SMALL)
    mesh = MeshSpec(data=-1).build(jax.devices())
    init_fn, loss_fn = jax_lm_task(cfg, mesh=mesh)
    return init_fn, loss_fn, mesh


def _jax_trainer(jax_task, members, tx_factory):
    init_fn, loss_fn, mesh = jax_task
    return JaxFusedTrainer(
        init_fn=init_fn, loss_fn=loss_fn, members=members, mesh=mesh,
        tx_factory=tx_factory,
        metrics=JaxMetricsLogger(stream=open("/dev/null", "w")))


def _port_states(jstates, members, tx_factory):
    """Each JAX member's initial weights in a port member state (the
    weights bridge, models/convert.py), its optimizer from
    ``tx_factory(lr)`` and its generator from seed + 1."""
    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    out = []
    for js, m in zip(jstates, members):
        tree = jax.tree.map(np.asarray, js.params)
        model = load_params(Transformer(cfg, device="meta"),
                            params_from_jax(tree))
        out.append(TrainState(
            step=0, params=model,
            opt_state=tx_factory(m.lr).init(dict(model.named_parameters())),
            rng=torch.Generator().manual_seed(m.seed + 1)))
    return out


# Each package's default (adamw with the lr in its state) at specs(4)'s
# rates, and sgd with the lr in its state at rates that move every
# parameter well past the tolerance in 5 steps.  Under adamw the
# parameters are not compared: Adam's step g / (|g| + eps) turns the
# float32 cancellation in a gradient near eps into a sizeable share of an
# lr step (one component of m1's embed: gradient 2.1e-8 at step 0, 1.5e-4
# from JAX after it), so the optimizer's parity is held by
# test_stacked_optimizer_matches_optax_per_member and the members'
# parameters under sgd.
TXS = {
    "adamw": (None, optim.default_tx_factory, 1e-3),
    "sgd": (lambda lr: optax.inject_hyperparams(optax.sgd)(learning_rate=lr),
            lambda lr: optim.InjectLearningRate(optim.sgd(0.0), lr), 0.5),
}


@pytest.mark.parametrize("tx", sorted(TXS))
def test_fused_trainer_matches_jax_fused_trainer(jax_task, tx):
    jax_tx, port_tx, lr = TXS[tx]
    jmembers = [dataclasses.replace(m, lr=lr * (i + 1)) for i, m in
                enumerate(specs(4, cls=JaxMemberSpec))]
    members = [dataclasses.replace(m, lr=lr * (i + 1)) for i, m in
               enumerate(specs(4))]
    jft = _jax_trainer(jax_task, jmembers, jax_tx or jax_default_tx)
    ft = make(members, tx_factory=port_tx)
    # Five fused steps through each package's step, per member.
    jinit = [jft.create_member_state(m) for m in jmembers]
    jstate = jft._stack_members(jinit)
    jstep, active = jft.compile_step(), jnp.ones((4,), bool)
    jstops = jnp.full((4,), 5, jnp.int32)
    state = ft._stack_members(_port_states(jinit, members, port_tx))
    step, port_active = ft.compile_step(), torch.ones(4, dtype=torch.bool)
    stops = torch.full((4,), 5)
    for t, batch in zip(range(5), data_factory()):
        jstate, active, jmetrics = jstep(jstate, active, jstops,
                                         jft.shard_batch(batch))
        state, port_active, metrics = step(state, port_active, stops,
                                           ft.shard_batch(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[key].numpy(),
                                       np.asarray(jmetrics[key]),
                                       err_msg=f"step {t} {key}", **JAX_TOL)
    assert port_active.tolist() == np.asarray(active).tolist()
    for i in range(4):
        if jax_tx is None:
            continue
        want = jax.tree.map(np.asarray, jft.member_state(jstate, i).params)
        got = params_to_jax(ft.member_state(state, i).params)
        for name, w in jax.tree_util.tree_leaves_with_path(want):
            g = got
            for key in name:
                g = g[key.key]
            np.testing.assert_allclose(g, w, err_msg=f"m{i} {name}",
                                       **JAX_TOL)
    # fit from the same member weights is that loop.
    initial = _port_states(jinit, members, port_tx)
    start = [{k: v.detach().clone() for k, v in s.params.named_parameters()}
             for s in initial]
    final = ft.fit(data_factory(), 5, log_every=10, member_states=initial)
    for i in range(4):
        assert ft.member_state(final, i).step == 5
        assert_bit_equal(leaves(ft, final, i), leaves(ft, state, i))
        moved = max((leaves(ft, final, i)[k] - v).abs().max().item()
                    for k, v in start[i].items())
        assert jax_tx is None or moved > 100 * JAX_TOL["atol"]
    np.testing.assert_allclose(
        [ft.last_metrics[f"loss/m{i}"] for i in range(4)],
        np.asarray(jmetrics["loss"]), **JAX_TOL)


# -- the mask ------------------------------------------------------------------


def test_stopped_member_freezes_peers_unaffected(fused4):
    """m1 early-stops at step 2: its state freezes bit-exactly at its
    step-2 state while every peer equals the no-stop run."""
    ft = make(specs(4, stop=2))
    s = ft.fit(data_factory(), 5, log_every=10)
    assert ft.last_active == [False, False, False, False]
    assert [ft.member_state(s, i).step for i in range(4)] == [5, 2, 5, 5]
    at_stop = make(specs(4))
    s2 = at_stop.fit(data_factory(), 2, log_every=10)
    assert_bit_equal(leaves(ft, s, 1), leaves(at_stop, s2, 1))
    frozen, want = ft.member_state(s, 1), at_stop.member_state(s2, 1)
    assert frozen.opt_state.inner.count == want.opt_state.inner.count == 2
    for a, b in zip(frozen.opt_state.inner.mu + frozen.opt_state.inner.nu,
                    want.opt_state.inner.mu + want.opt_state.inner.nu):
        assert torch.equal(a, b)
    full, s_full = fused4
    for i in (0, 2, 3):
        assert_bit_equal(leaves(ft, s, i), leaves(full, s_full, i))


def _poisoned(loss_fn):
    """A loss that is NaN for the member whose embed[0, 0] is above 100,
    at the batch marked ``poison``."""

    def fn(model, mutable, batch, rng):
        loss, aux = loss_fn(model, mutable, batch, rng)
        bad = batch["poison"] & (model.embed[0, 0] > 100.0)
        return torch.where(bad, torch.full_like(loss, float("nan")),
                           loss), aux

    return fn


def test_nonfinite_loss_freezes_the_member_generator_included():
    """Dropout 0.1, so each step draws from each member's generator.  m1
    turns non-finite at its third step: it keeps its step-2 parameters,
    moments, count and generator bit-exactly, its peers go on."""
    init_fn, loss_fn = port_task(dropout_rate=0.1)
    task = (init_fn, _poisoned(loss_fn))

    def states(ft):
        out = [ft.create_member_state(m) for m in ft.members]
        with torch.no_grad():
            out[1].params.embed[0, 0] = 1000.0
        return out

    ft = make(specs(4), task=task)
    s = ft.fit(data_factory(poison_at=2), 4, log_every=1,
               member_states=states(ft))
    assert [ft.member_state(s, i).step for i in range(4)] == [4, 2, 4, 4]
    control = make(specs(4), task=task)
    c = control.fit(data_factory(poison_at=-1), 2, log_every=1,
                    member_states=states(control))
    frozen, want = ft.member_state(s, 1), control.member_state(c, 1)
    assert_bit_equal(leaves(ft, s, 1), leaves(control, c, 1))
    assert frozen.opt_state.inner.count == 2
    for a, b in zip(frozen.opt_state.inner.mu + frozen.opt_state.inner.nu,
                    want.opt_state.inner.mu + want.opt_state.inner.nu):
        assert torch.equal(a, b)
    assert torch.equal(frozen.rng.get_state(), want.rng.get_state())
    # A peer drew on: its generator is past the control's.
    assert not torch.equal(ft.member_state(s, 0).rng.get_state(),
                           control.member_state(c, 0).rng.get_state())


# -- checkpoints, resume, supervisor ------------------------------------------


def test_resume_equals_uninterrupted_and_members_restore_solo(
        fused4, tmp_path):
    """Kill after 3 steps, restore every member, run to 5: bit-equal to
    the uninterrupted run.  Each member directory verifies under the JAX
    package's verify_step and resumes in a plain port Trainer on
    default_tx_factory(lr), which steps on as the gang would."""
    straight, s_straight = fused4
    ckpt = str(tmp_path / "fused")
    make(specs(4), ckpt=ckpt).fit(data_factory(), 3, log_every=10)
    resumed = make(specs(4), ckpt=ckpt)
    s_resumed = resumed.fit(data_factory(), 5, log_every=10)
    for i in range(4):
        assert_bit_equal(leaves(straight, s_straight, i),
                         leaves(resumed, s_resumed, i))
    init_fn, loss_fn = port_task()
    batch = next(itertools.islice(data_factory(), 5, None))
    solos = []
    for m in specs(4):
        directory = tmp_path / "fused" / m.name
        assert jax_verify_step(directory, 4) == (True, "")
        solo = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                       tx=optim.default_tx_factory(m.lr), device="cpu",
                       metrics=_null())
        restored, start = CheckpointManager(directory).restore_or_init(
            solo.create_state(m.seed))
        assert start == 5 and restored.step == 5
        assert restored.opt_state.learning_rate == m.lr
        # Step 5 -> 6 from the restored state, as the gang takes it.
        solos.append(solo.compile_step()(restored,
                                         solo.shard_batch(batch))[0])
    on = make(specs(4), ckpt=ckpt)
    s_on = on.fit(data_factory(), 6, log_every=10)
    for i, st in enumerate(solos):
        assert st.step == 6
        got = dict(st.params.named_parameters())
        for name, want in leaves(on, s_on, i).items():
            torch.testing.assert_close(got[name].detach(), want, **SOLO_TOL)


def test_member_checkpoints_and_metrics(tmp_path):
    """A plain CheckpointManager restores each member; the run exports
    the per-member step counters and the active gauge."""
    counter = REGISTRY.counter("kft_train_member_steps_total")
    before = {m: counter.value(member=m) for m in ("m0", "m1")}
    ckpt = str(tmp_path / "fused")
    ft = make(specs(2), ckpt=ckpt)
    s = ft.fit(data_factory(), 3, log_every=10)
    for i, spec in enumerate(specs(2)):
        mgr = CheckpointManager(f"{ckpt}/{spec.name}")
        restored, start = mgr.restore_or_init(ft.create_member_state(spec))
        assert start == 3
        assert_bit_equal({k: v.detach() for k, v in
                          restored.params.named_parameters()},
                         leaves(ft, s, i))
    for m in ("m0", "m1"):
        assert counter.value(member=m) - before[m] == 3
    assert REGISTRY.gauge("kft_train_members_active").value() == 0.0
    assert ft.last_active == [False, False]
    record = ft.metrics.history[-1]
    assert (record["step"], record["members"],
            record["members_active"]) == (2, 2, 0)
    assert set(ft.last_metrics) == {"loss", "loss/m0", "loss/m1"}


def test_member_validation():
    with pytest.raises(ValueError, match="duplicate"):
        make([MemberSpec(name="a"), MemberSpec(name="a")])
    with pytest.raises(ValueError, match="at least one"):
        make([])
    with pytest.raises(NotPortedError, match="item 22"):
        make(specs(2), mesh=object())
    with pytest.raises(NotPortedError, match="item 22"):
        make(specs(2), rules=(("batch", "data"),))
    with pytest.raises(ValueError, match="member states"):
        make(specs(2)).fit(data_factory(), 1, member_states=[])


def test_supervisor_restarts_a_faulted_fused_fit(fused4, tmp_path):
    """TrainSupervisor wraps a FusedTrainer unchanged: a fault at the
    first dispatch restarts from init; a fault raised at the step-2 call
    boundary restarts from the member checkpoints; both end where the
    uninterrupted run does."""
    straight, s_straight = fused4
    sup = TrainSupervisor(make(specs(4)), max_restarts=2, backoff_s=0.0,
                          backoff_max_s=0.0)
    with faults.injected("train.step:raise*1") as inj:
        s = sup.run(data_factory, 5, log_every=0)
    assert sup.restarts == 1 and inj.fired("train.step") == 6
    for i in range(4):
        assert_bit_equal(leaves(sup.trainer, s, i),
                         leaves(straight, s_straight, i))

    raised = []

    def boundary(step):
        if step == 2 and not raised:
            raised.append(step)
            raise faults.FaultInjected("at the step-2 boundary")

    ft = make(specs(4), ckpt=str(tmp_path / "sup"), every=1)
    sup = TrainSupervisor(ft, max_restarts=2, backoff_s=0.0,
                          backoff_max_s=0.0)
    s = sup.run(data_factory, 5, log_every=0, on_step=boundary)
    assert sup.restarts == 1
    assert sup.steps_seen == [1, 2, 2, 3, 4, 5]
    for i in range(4):
        assert_bit_equal(leaves(ft, s, i), leaves(straight, s_straight, i))


def test_member_states_of_a_run_continue_it():
    """fit from member_state copies of a 2-step run re-enters at step 2
    (m1, stopped there, re-enters frozen) and ends where one 5-step run
    does; the given states, generators included, are left as they
    were."""
    members = specs(4, stop=2)
    straight = make(members)
    s_straight = straight.fit(data_factory(), 5, log_every=0)
    first = make(members)
    warm = first.fit(data_factory(), 2, log_every=0)
    states = [first.member_state(warm, i) for i in range(4)]
    before = [{k: v.detach().clone() for k, v in
               st.params.named_parameters()} for st in states]
    gens = [st.rng.get_state() for st in states]
    second = make(members)
    s = second.fit(data_factory(), 5, log_every=0, member_states=states)
    assert [second.member_state(s, i).step for i in range(4)] == [5, 2, 5, 5]
    for i in range(4):
        assert_bit_equal(leaves(second, s, i),
                         leaves(straight, s_straight, i))
        assert_bit_equal({k: v.detach() for k, v in
                          states[i].params.named_parameters()}, before[i])
        assert torch.equal(states[i].rng.get_state(), gens[i])
        assert states[i].step == 2


def test_e2e_hfta_training_lifecycle_twin(tmp_path):
    """The port's twin of testing/e2e.py ``hfta_smoke`` step 4: a width-4
    gang with m1 stopping at 2, killed after 3 steps and resumed to 6
    from its per-member checkpoints, equals an uninterrupted control,
    the early-stopped member included; steps stay monotone and the
    counters and gauge read as step 5 there requires."""
    counter = REGISTRY.counter("kft_train_member_steps_total")
    before = counter.value(member="m0")
    members = specs(4, stop=2)
    control = make(members)
    s_control = control.fit(data_factory(), 6, log_every=0)
    victim = make(members, ckpt=str(tmp_path / "fused"), every=1)
    s_victim = victim.fit(data_factory(), 3, log_every=0)
    cut = [victim.member_state(s_victim, i).step for i in range(4)]
    assert cut == [3, 2, 3, 3]
    resumed = make(members, ckpt=str(tmp_path / "fused"), every=1)
    s_resumed = resumed.fit(data_factory(), 6, log_every=0)
    steps = [resumed.member_state(s_resumed, i).step for i in range(4)]
    assert steps == [6, 2, 6, 6]
    assert all(a >= b for a, b in zip(steps, cut))
    for i in range(4):
        assert_bit_equal(leaves(resumed, s_resumed, i),
                         leaves(control, s_control, i))
    assert counter.value(member="m0") - before >= 6
    assert REGISTRY.gauge("kft_train_members_active").value() == 0.0


# -- the stacked optimizers against optax --------------------------------------


L = 2
# Port per-layer parameters of stacked JAX leaves: a factored [L, 128,
# 160], a layered vector, a matrix and a vector outside the layers.
OPT_SHAPES = {"embed": (130, 144), "final_scale": (144,),
              "layers.w": (L, 128, 160), "layers.scale": (L, 24)}
LRS = (1e-2, 2e-2, 3e-3)


def _jax_tree(flat):
    tree = {"layers": {}}
    for name, value in flat.items():
        if name.startswith("layers."):
            tree["layers"][name.split(".", 1)[1]] = value
        else:
            tree[name] = value
    return tree


def _port_named(flat):
    out = {}
    for name, value in flat.items():
        if name.startswith("layers."):
            for i in range(L):
                out[f"layers.{i}.{name.split('.', 1)[1]}"] = value[i]
        else:
            out[name] = value
    return out


def _to_torch(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_stacked_optimizer_matches_optax_per_member(name):
    """Three members at their own learning rates on one stacked state,
    held to optax per member over 5 updates; m2 is masked from update 3
    on and stays bit-exact at its state after update 2."""
    rng = np.random.default_rng(3)
    inner, jax_tx = {
        "adamw": (optim.adamw(0.0), optax.adamw),
        "adafactor": (optim.adafactor(0.0), optax.adafactor),
        "sgd": (optim.sgd(0.0, momentum=0.9),
                lambda lr: optax.sgd(lr, momentum=0.9)),
    }[name]
    members = [{k: rng.standard_normal(s).astype(np.float32)
                for k, s in OPT_SHAPES.items()} for _ in LRS]
    solo = [_to_torch(_port_named(p)) for p in members]
    txs = [optim.InjectLearningRate(inner, lr) for lr in LRS]
    states = [tx.init(p) for tx, p in zip(txs, solo)]
    params = {k: torch.stack([p[k] for p in solo]) for k in solo[0]}
    state = _stack(states, torch.device("cpu"))
    forms = [_form(s) for s in states]
    jparams = [jax.tree.map(jnp.asarray, _jax_tree(p)) for p in members]
    jtxs = [jax_tx(lr) for lr in LRS]
    jstates = [tx.init(p) for tx, p in zip(jtxs, jparams)]
    frozen = None
    for t in range(5):
        grads = [{k: (rng.standard_normal(s) * rng.choice([1e-3, 1.0, 30.0],
                                                          size=s))
                  .astype(np.float32) for k, s in OPT_SHAPES.items()}
                 for _ in LRS]
        keep = torch.tensor([True, True, t < 2])
        stacked_grads = {k: torch.stack([_to_torch(_port_named(g))[k]
                                         for g in grads]) for k in params}
        txs[0].update_members(stacked_grads, state, params, keep)
        for i, (jtx, g) in enumerate(zip(jtxs, grads)):
            if not keep[i]:
                continue
            jg = jax.tree.map(jnp.asarray, _jax_tree(g))
            updates, jstates[i] = jtx.update(jg, jstates[i], jparams[i])
            jparams[i] = optax.apply_updates(jparams[i], updates)
        if t == 1:
            frozen = ({k: v[2].clone() for k, v in params.items()},
                      _unstack(forms[2], state, 2))
        for i in range(len(LRS)):
            tree = jax.tree.map(np.asarray, jparams[i])
            want = _port_named({**{k: v for k, v in tree.items()
                                   if k != "layers"},
                                **{f"layers.{k}": v for k, v in
                                   tree["layers"].items()}})
            for k, w in want.items():
                np.testing.assert_allclose(
                    params[k][i].numpy(), w, err_msg=f"update {t} m{i} {k}",
                    **OPT_TOL)
    member2 = _unstack(forms[2], state, 2)
    assert member2.inner.count == frozen[1].inner.count == 2
    assert member2.learning_rate == LRS[2]
    assert [_unstack(f, state, i).inner.count
            for i, f in enumerate(forms)] == [5, 5, 2]
    for k, v in frozen[0].items():
        assert torch.equal(params[k][2], v), k
    flat_now, flat_then = _tensors(member2), _tensors(frozen[1])
    assert len(flat_now) == len(flat_then) > 0
    for a, b in zip(flat_now, flat_then):
        assert torch.equal(a, b)


def _tensors(tree):
    leaves_, _ = torch.utils._pytree.tree_flatten(
        [getattr(tree.inner, f) for f in vars(tree.inner)])
    return [t for t in leaves_ if isinstance(t, torch.Tensor)]


# -- flash, remat, dropout, MoE under the member map ---------------------------


FLASH = dict(n_layers=2, n_heads=4, n_kv_heads=2, attention="flash")
VARIANTS = {
    "flash_remat": dict(FLASH, remat=True),
    "flash_remat_dropout": dict(FLASH, remat=True, dropout_rate=0.1),
    "flash_dropout_ce_chunk": dict(FLASH, dropout_rate=0.1, ce_chunk=4),
    "moe_einsum_remat": dict(FLASH, remat=True, moe_experts=4,
                             moe_group_size=16),
}


def _fused_params(overrides, steps=2, members=None):
    ft = make(members or specs(3), task=port_task(**overrides))
    s = ft.fit(data_factory(), steps, log_every=1)
    return ft, s


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_member_equals_its_solo_trainer(variant):
    """Each member of a fused run equals a solo Trainer on its seed, lr
    and the same batches: parameters, last loss and grad_norm."""
    overrides = VARIANTS[variant]
    ft, s = _fused_params(overrides)
    init_fn, loss_fn = port_task(**overrides)
    for i, m in enumerate(specs(3)):
        solo = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                       tx=optim.default_tx_factory(m.lr), device="cpu",
                       metrics=_null())
        st = solo.fit(data_factory(), 2, state=solo.create_state(m.seed),
                      log_every=1)
        got = dict(st.params.named_parameters())
        for name, want in leaves(ft, s, i).items():
            torch.testing.assert_close(got[name].detach(), want, **SOLO_TOL,
                                       msg=f"m{i} {name}")
        np.testing.assert_allclose(ft.last_metrics[f"loss/m{i}"],
                                   solo.last_metrics["loss"], **SOLO_TOL)
        assert torch.equal(ft.member_state(s, i).rng.get_state(),
                           st.rng.get_state())


def test_remat_on_and_off_give_the_same_fused_step():
    _, on = _fused_params(dict(FLASH, remat=True, dropout_rate=0.1))
    ft_off, off = _fused_params(dict(FLASH, remat=False, dropout_rate=0.1))
    for name, p in on.params.items():
        torch.testing.assert_close(p.detach(), off.params[name].detach(),
                                   **SOLO_TOL, msg=name)


def test_dropout_is_seeded_per_member():
    """Two runs give bit-equal members; members that differ only in
    seed draw other masks, and a member's masks are its seed's alone
    (its result does not depend on its peers)."""
    overrides = dict(FLASH, dropout_rate=0.1)
    same = [MemberSpec(name=f"m{i}", seed=7, lr=1e-3) for i in range(2)]
    other = [MemberSpec(name="m0", seed=7, lr=1e-3),
             MemberSpec(name="m1", seed=8, lr=1e-3)]
    ft_a, a = _fused_params(overrides, members=same)
    ft_b, b = _fused_params(overrides, members=same)
    ft_c, c = _fused_params(overrides, members=other)
    assert_bit_equal(leaves(ft_a, a, 0), leaves(ft_b, b, 0))
    assert_bit_equal(leaves(ft_a, a, 0), leaves(ft_a, a, 1))
    assert_bit_equal(leaves(ft_a, a, 0), leaves(ft_c, c, 0))
    assert ft_c.last_metrics["loss/m0"] != ft_c.last_metrics["loss/m1"]
