"""The port's trainer guardrails (``skip_nonfinite``, ``chaos``,
loss-spike rollback) and its copy of ``utils/chaos.py``, on the CPU.

- ``ChaosConfig`` and ``FleetChaosConfig`` carry the JAX package's fields
  and defaults, and the injectors do what the JAX ones do on the same
  numpy inputs (exactly: selects and host arithmetic);
- a poisoned step (``nan_grad_step``) leaves the parameters, BatchNorm's
  statistics, the optimizer state (SGD's trace, AdamW's moments and
  count) and ``step`` bitwise unchanged — compared as bit patterns —
  under SGD, the plain AdamW, ``grad_accum_steps=2`` and ``fused_adamw``'s
  plain route;
- a guarded run with a poisoned batch equals, bitwise, a clean run with
  that update elided, with ``steps_skipped == 1`` and one host fetch an
  epoch; with the guard on and no fault, a run is bitwise the guard-off
  run; the unguarded AdamW step is bitwise the host-scalar arithmetic
  this module's ``_host_scalar_adamw`` restates;
- the skip-step guard against the JAX Trainer's (a poisoned batch in two
  epochs of an MLP, under SGD with momentum, AdamW and ``fused_adamw``'s
  plain route against ``optax.adamw``): the same per-step skipped flags,
  ``steps_skipped``, ``step`` and AdamW count exactly, the per-step and
  epoch losses ``rtol 1e-5``, the parameters and the optimizer's trace or
  moments ``atol 1e-5`` (float32 on both sides: only summation orders
  differ);
- rollback (a chaos loss spike after a ``save``) against the JAX
  Trainer's: one rollback, the epoch kept, training going on, the same
  epoch losses ``rtol 1e-5`` and parameters ``atol 1e-5``, and a loss fetch
  a step counted in ``host_syncs``;
- a checkpoint whose optimizer kept its count on the host restores, and
  training on from it is bitwise training on from the saved trainer;
- a 2-rank gloo world where only rank 1's rows hold a NaN skips the step
  on both ranks.

The JAX pins ``test_skip_step_elides_poisoned_update_and_continues`` and
``test_skip_step_guard_off_path_identical`` are red on this tree (one
float32 ulp), so the JAX Trainer is compared by its actual outputs with
the tolerances above, and the port's bitwise claims (a skipped step
leaves the state unchanged, a guarded run is the clean run with the
update elided, guard-off is the host-scalar step) are held inside the
port.
"""

import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.data import ShardedLoader as JaxLoader
from pytorch_distributed_training_tutorials_tpu.data import datasets as jds
from pytorch_distributed_training_tutorials_tpu.models import MLP as JaxMLP
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_training_tutorials_tpu.utils import chaos as jchaos
from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.launch import coordinator_for_spawn, spawn
from pytorch_distributed_training_tutorials_tpu_torch.models import MLP, from_jax_params, resnet18
from pytorch_distributed_training_tutorials_tpu_torch.ops import fused_optim
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
from pytorch_distributed_training_tutorials_tpu_torch.train import TrainState, Trainer, adamw, sgd
from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
    _init_weights,
    batch_stats,
    make_train_step,
)
from pytorch_distributed_training_tutorials_tpu_torch.utils import chaos

CPU = LocalMesh(torch.device("cpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(t: torch.Tensor) -> torch.Tensor:
    """The bit pattern of a tensor (so -0.0 and 0.0, or two NaNs, differ)."""
    t = t.detach().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t.view(torch.int64) \
        if t.dtype == torch.float64 else t


def same_bits(a: list[torch.Tensor], b: list[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


# -- chaos -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["ChaosConfig", "FleetChaosConfig"])
def test_chaos_configs_are_the_jax_packages(name):
    mine, theirs = getattr(chaos, name), getattr(jchaos, name)
    assert [(f.name, f.default) for f in dataclasses.fields(mine)] == [
        (f.name, f.default) for f in dataclasses.fields(theirs)]
    props = sorted(k for k, v in vars(theirs).items() if isinstance(v, property))
    assert props == sorted(k for k, v in vars(mine).items() if isinstance(v, property))
    for kw in ({}, dict(nan_logit_slot=1, nan_logit_step=2), dict(nan_grad_step=0),
               dict(nan_batch_step=1), dict(spike_loss_step=3), dict(fail_prefill_request=4),
               dict(stall_chain=2, stall_s=0.5), dict(preempt_slot=0, preempt_at_chain=1),
               dict(kill_replica=0, kill_at_chain=1), dict(stall_replica=1, stall_rounds=2)):
        kw = {k: v for k, v in kw.items() if k in {f.name for f in dataclasses.fields(mine)}}
        a, b = mine(**kw), theirs(**kw)
        assert [getattr(a, p) for p in props] == [getattr(b, p) for p in props]


def test_injectors_match_jax():
    rng = np.random.Generator(np.random.PCG64(0))
    logits = rng.standard_normal((4, 7)).astype(np.float32)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3,), (2, 5))]
    for at in (2, 3):
        got = chaos.poison_logits(torch.tensor(logits), torch.tensor(at), 1, 3).numpy()
        want = np.asarray(jchaos.poison_logits(jax.numpy.asarray(logits), at, 1, 3))
        np.testing.assert_array_equal(got, want)
        got_g = chaos.poison_grads([torch.tensor(g) for g in grads], torch.tensor(at), 3)
        want_g = jchaos.poison_grads([jax.numpy.asarray(g) for g in grads], at, 3)
        for a, b in zip(got_g, want_g):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfg_j, cfg_t = jchaos.ChaosConfig(nan_batch_step=2), chaos.ChaosConfig(nan_batch_step=2)
    x, y = np.ones((2, 3), np.float32), np.arange(2, dtype=np.int32)
    for host_step in (1, 2, 3):
        got = chaos.maybe_poison_batch(cfg_t, host_step, (torch.tensor(x), torch.tensor(y)))
        want = jchaos.maybe_poison_batch(cfg_j, host_step, (jax.numpy.asarray(x), y))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    spike_t = chaos.ChaosConfig(spike_loss_step=2, spike_loss_len=2, spike_loss_factor=10.0)
    spike_j = jchaos.ChaosConfig(spike_loss_step=2, spike_loss_len=2, spike_loss_factor=10.0)
    assert [chaos.host_spike_loss(0.5, s, spike_t) for s in range(1, 6)] == [
        jchaos.host_spike_loss(0.5, s, spike_j) for s in range(1, 6)] == [0.5, 5.0, 5.0, 0.5, 0.5]
    fail = chaos.ChaosConfig(fail_prefill_request=3)
    chaos.maybe_fail_prefill(fail, 2)
    with pytest.raises(chaos.ChaosError, match="request 3"):
        chaos.maybe_fail_prefill(fail, 3)
    seen = []

    class Recorder:
        def record(self, kind, **kw):
            seen.append((kind, kw))

    stall = chaos.ChaosConfig(stall_chain=1, stall_s=0.01)
    chaos.maybe_stall(stall, 0, flight=Recorder())
    chaos.maybe_stall(stall, 1, flight=Recorder())
    assert seen == [("stall", {"chain": 1, "stall_s": 0.01})]


# -- the poisoned step -----------------------------------------------------

def _images(n=32, seed=1):
    return jds._synthetic_images(n, (12, 12, 1), 10, template_seed=101, noise_seed=seed, raw=True)


OPTIMIZERS = {
    "sgd": lambda: sgd(0.05, momentum=0.9),
    "adamw": lambda: adamw(1e-3),
    "fused_adamw": lambda: fused_optim.fused_adamw(1e-3),
}


def _opt_tensors(opt_state) -> list[torch.Tensor]:
    if hasattr(opt_state, "mu"):
        return [*opt_state.mu, *opt_state.nu, opt_state.count]
    return list(opt_state.trace)


@pytest.mark.parametrize("opt,accum", [("sgd", 1), ("adamw", 1), ("sgd", 2), ("adamw", 2),
                                       ("fused_adamw", 1)])
def test_poisoned_step_leaves_state_bitwise_unchanged(opt, accum):
    x, y = _images().arrays
    batch = (torch.tensor(x[:16]).float() / 255, torch.tensor(y[:16]))
    model = resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1)
    _init_weights(model, 4, torch.device("cpu"))
    state = TrainState.create(model=model, tx=OPTIMIZERS[opt]())
    kw = dict(has_batch_stats=True, grad_accum_steps=accum, skip_nonfinite=True)
    make_train_step(**kw)(state, batch)  # one clean step: moments, count, stats move
    launches = fused_optim.fused_adamw.launches
    step = make_train_step(**kw, chaos=chaos.ChaosConfig(nan_grad_step=1))

    def snapshot():
        return [t.clone() for t in (*state.params, *batch_stats(model),
                                    *_opt_tensors(state.opt_state), state.step)]

    before = snapshot()
    _, m = step(state, batch)
    assert int(m["skipped"]) == 1 and int(state.step) == 1
    assert same_bits(snapshot(), before)
    _, m = make_train_step(**kw)(state, batch)  # a clean step applies again
    assert int(m["skipped"]) == 0 and int(state.step) == 2
    assert not same_bits(snapshot()[:len(state.params)], before[:len(state.params)])
    assert fused_optim.fused_adamw.launches == launches  # the CPU: the plain route


def _host_scalar_adamw(tx, params, grads, mu, nu, count: int) -> None:
    """The unguarded AdamW step with the bias corrections as host floats
    and the count on the host: the arithmetic the device-scalar form must
    reproduce bitwise."""
    inv1, inv2 = tx.inverse_bias_corrections(count)
    torch._foreach_mul_(mu, tx.b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - tx.b1))
    g2 = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(g2, 1.0 - tx.b2)
    torch._foreach_mul_(nu, tx.b2)
    torch._foreach_add_(nu, g2)
    u = torch._foreach_mul(mu, inv1)
    den = torch._foreach_mul(nu, inv2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, tx.eps)
    torch._foreach_div_(u, den)
    torch._foreach_add_(u, torch._foreach_mul(params, tx.weight_decay))
    torch._foreach_mul_(u, -tx.lr)
    torch._foreach_add_(params, u)


@pytest.mark.parametrize("opt", ["adamw", "fused_adamw"])
def test_unguarded_adamw_is_the_host_scalar_step_bitwise(opt):
    rng = np.random.Generator(np.random.PCG64(3))
    shapes = [(), (300,), (17, 64)]
    params = [torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    ref = [p.clone() for p in params]
    tx = OPTIMIZERS[opt]()
    state = tx.init(params)
    mu, nu = [torch.zeros_like(p) for p in ref], [torch.zeros_like(p) for p in ref]
    # the first 20 counts, then a jump to 1015 and on past the table's
    # first 1024 rows, both sides from the same moments
    for count in [*range(1, 21), *range(1016, 1036)]:
        if count == 1016:
            state.count.fill_(1015)
            state.calls = 1015
        grads = [torch.tensor((rng.standard_normal(s) * 10.0 ** rng.integers(-6, 2))
                              .astype(np.float32)) for s in shapes]
        tx.update_(params, grads, state)
        _host_scalar_adamw(tx, ref, grads, mu, nu, count)
    assert int(state.count) == 1035 and state.table.shape[0] == 2048
    assert same_bits(params + state.mu + state.nu, ref + mu + nu)


def _guard_trainer(opt="sgd", **kw):
    ds = ArrayDataset(_images(64).arrays)
    return Trainer(resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1),
                   ShardedLoader(ds, 16, CPU, transform=lambda x, y: (x.float() / 255, y)),
                   OPTIMIZERS[opt](), quiet=True, seed=4, **kw)


def _state_tensors(t: Trainer) -> list[torch.Tensor]:
    return [*t.model.state_dict().values(), *_opt_tensors(t.state.opt_state), t.state.step]


@pytest.mark.parametrize("opt", ["sgd", "fused_adamw"])
def test_guarded_run_equals_clean_run_with_the_update_elided(opt):
    guarded = _guard_trainer(opt, skip_nonfinite=True, chaos=chaos.ChaosConfig(nan_batch_step=3))
    guarded.train(2)
    assert guarded.steps_skipped == 1
    assert int(guarded.state.step) == 7  # 8 dispatches, 1 elided
    assert guarded.host_syncs == 2  # one fetch an epoch, the skip flags riding it
    assert [e["skipped"] for e in guarded.metrics.step_events()] == [0, 0, 1, 0, 0, 0, 0, 0]
    ref = _guard_trainer(opt)
    for epoch in range(2):
        ref.loader.set_epoch(epoch)
        for i, batch in enumerate(ref.loader, start=1 + 4 * epoch):
            if i != 3:
                ref.state, _ = ref.train_step(ref.state, batch)
    assert same_bits(_state_tensors(guarded), _state_tensors(ref))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_guard_on_without_fault_is_bitwise_the_guard_off_run(opt):
    on, off = _guard_trainer(opt, skip_nonfinite=True), _guard_trainer(opt)
    on.train(1)
    off.train(1)
    assert same_bits(_state_tensors(on), _state_tensors(off))
    assert [e["loss"] for e in on.metrics.step_events()] == [
        e["loss"] for e in off.metrics.step_events()]
    assert on.steps_skipped == 0 and on.host_syncs == off.host_syncs == 1


# -- rollback --------------------------------------------------------------

def _cls_data(n=128, d=16, classes=4, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


def _mlp_pair(jax_tx, port_tx, **kw):
    """The JAX Trainer and the port's on the same seeded data (128 rows, 4
    steps an epoch) and the same weights (the JAX init copied over)."""
    x, y = _cls_data()
    jkw = {k: jchaos.ChaosConfig(**dataclasses.asdict(v)) if k == "chaos" else v
           for k, v in kw.items()}
    jt = JaxTrainer(JaxMLP(features=(32, 4)),
                    JaxLoader(jds.ArrayDataset((x, y)), 32, jax_mesh({"data": 1}), seed=0),
                    jax_tx, quiet=True, **jkw)
    tt = Trainer(MLP(features=(32, 4), in_dim=16),
                 ShardedLoader(ArrayDataset((x, y)), 32, CPU, seed=0), port_tx, quiet=True, **kw)
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    with torch.no_grad():
        for k, v in from_jax_params(params, tt.model, "cpu").items():
            tt.model.state_dict()[k].copy_(v)
    return jt, tt


def _as_port_leaves(tree, model) -> list[np.ndarray]:
    """A params-shaped JAX tree as the port's leaves, in parameter order."""
    conv = from_jax_params(jax.tree_util.tree_map(np.asarray, tree), model, "cpu")
    return [conv[name].numpy() for name, _ in model.named_parameters()]


SKIP_PARITY = {
    "sgd": (lambda: optax.sgd(0.05, momentum=0.9), lambda: sgd(0.05, momentum=0.9)),
    "adamw": (lambda: optax.adamw(1e-2), lambda: adamw(1e-2)),
    "fused_adamw": (lambda: optax.adamw(1e-2), lambda: fused_optim.fused_adamw(1e-2)),
}


@pytest.mark.parametrize("opt,k", [("sgd", 3), ("adamw", 3), ("adamw", 6), ("fused_adamw", 3)])
def test_skip_step_matches_the_jax_trainer(opt, k):
    """The skip-step guard against the JAX Trainer's actual outputs, two
    epochs with batch ``k`` poisoned: the same skipped flags, ``step``,
    ``steps_skipped`` and AdamW count exactly; the per-step losses (NaN at
    the poisoned step on both sides) and the epoch losses ``rtol 1e-5``; the
    parameters and the optimizer's trace or moments ``atol 1e-5`` (float32
    on both sides, an MLP: only summation orders differ)."""
    jt, tt = _mlp_pair(SKIP_PARITY[opt][0](), SKIP_PARITY[opt][1](), skip_nonfinite=True,
                       chaos=chaos.ChaosConfig(nan_batch_step=k))
    jt.train(2)
    tt.train(2)
    flags = [0] * 8
    flags[k - 1] = 1
    assert [int(e["skipped"]) for e in jt.metrics.step_events()] == flags
    assert [int(e["skipped"]) for e in tt.metrics.step_events()] == flags
    assert tt.steps_skipped == jt.steps_skipped == 1
    assert int(tt.state.step) == int(jt.state.step) == 7
    j_loss = [float(e["loss"]) for e in jt.metrics.step_events()]
    t_loss = [float(e["loss"]) for e in tt.metrics.step_events()]
    assert np.isnan(j_loss[k - 1]) and np.isnan(t_loss[k - 1])
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose([e["loss"] for e in tt.metrics.epoch_events()],
                               [e["loss"] for e in jt.metrics.epoch_events()], rtol=1e-5)
    got = [p.detach().numpy() for p in tt.model.parameters()]
    want = _as_port_leaves(jt.state.params, tt.model)
    inner = jt.state.opt_state[0]
    if opt == "sgd":
        got += [t.numpy() for t in tt.state.opt_state.trace]
        want += _as_port_leaves(inner.trace, tt.model)
    else:
        assert int(tt.state.opt_state.count) == int(inner.count) == 7
        got += [t.numpy() for t in (*tt.state.opt_state.mu, *tt.state.opt_state.nu)]
        want += _as_port_leaves(inner.mu, tt.model) + _as_port_leaves(inner.nu, tt.model)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, atol=1e-5)


ROLLBACK = dict(rollback_spike_factor=10.0, rollback_patience=2)
SPIKE = dict(spike_loss_step=6, spike_loss_len=3, spike_loss_factor=1e6)


def test_rollback_matches_the_jax_trainer(tmp_path):
    jt, tt = _mlp_pair(optax.sgd(0.05), sgd(0.05), chaos=chaos.ChaosConfig(**SPIKE), **ROLLBACK)
    for t, ck in ((jt, tmp_path / "jax"), (tt, tmp_path / "port")):
        t.train(1)  # 4 steps a epoch: healthy monitor steps 1-4 seed the EMA
        t.save(ck)
        t.train(3)  # the spike hits monitor steps 6-8: strikes at 6 and 7
    assert tt.rollbacks == jt.rollbacks == 1
    assert tt.epoch == jt.epoch == 3
    assert int(tt.state.step) == int(jt.state.step)
    np.testing.assert_allclose([e["loss"] for e in tt.metrics.epoch_events()],
                               [e["loss"] for e in jt.metrics.epoch_events()], rtol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jt.state.params), tt.model, "cpu")
    for k, v in tt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5)
    # a loss fetch a monitored step (12), one drain an epoch (3), the save
    assert tt.host_syncs == 12 + 3


def test_rollback_validation_and_missing_checkpoint():
    x, y = _cls_data()
    mk = lambda **kw: Trainer(MLP(features=(32, 4), in_dim=16),  # noqa: E731
                              ShardedLoader(ArrayDataset((x, y)), 32, CPU), sgd(0.05),
                              quiet=True, **kw)
    for kw, msg in ((dict(rollback_spike_factor=1.0), "rollback_spike_factor must be > 1"),
                    (dict(rollback_patience=0), "rollback_patience must be >= 1"),
                    (dict(rollback_ema=1.0), r"rollback_ema must be in \[0, 1\)")):
        with pytest.raises(ValueError, match=msg):
            mk(**kw)
    t = mk(rollback_spike_factor=10.0, rollback_patience=1,
           chaos=chaos.ChaosConfig(spike_loss_step=2, spike_loss_factor=1e6))
    with pytest.raises(RuntimeError, match="no checkpoint exists"):
        t.train(1)


# -- checkpoints of the host count -----------------------------------------

def _host_count_checkpoint(t: Trainer, path, count: int) -> None:
    """``t``'s state written as a checkpoint whose optimizer kept its count
    on the host: an int ``count`` and no table (AdamW), or a ``count``
    beside the trace (SGD)."""
    opt = t.state.opt_state
    tree = {"step": t.state.step.clone(), "model": t.model.state_dict(), "epoch": t.epoch,
            "opt_state": ({"count": count, "mu": opt.mu, "nu": opt.nu} if hasattr(opt, "mu")
                          else {"count": count, "trace": opt.trace})}
    os.makedirs(path)
    torch.save(tree, os.path.join(path, "state.pt"))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_restore_reads_a_host_count_checkpoint(opt, tmp_path):
    """A checkpoint with the host count restores: the count lands on the
    device, and training on from it is bitwise training on from the saved
    trainer; a count past the table's rows grows the table to cover it."""
    x, y = _cls_data()
    tx = {"sgd": lambda: sgd(0.05, momentum=0.9), "adamw": lambda: adamw(1e-2)}[opt]

    def mk():
        return Trainer(MLP(features=(32, 4), in_dim=16),
                       ShardedLoader(ArrayDataset((x, y)), 32, CPU, seed=0), tx(), quiet=True,
                       seed=2)

    a = mk()
    a.train(1)
    _host_count_checkpoint(a, tmp_path / "old", 4)
    b = mk()
    b.restore(tmp_path / "old")
    assert b.epoch == 1 and int(b.state.step) == 4
    if opt == "adamw":
        assert int(b.state.opt_state.count) == 4 and b.state.opt_state.calls == 4
    a.train(2)
    b.train(2)
    assert same_bits(_state_tensors(b), _state_tensors(a))
    if opt == "adamw":
        _host_count_checkpoint(a, tmp_path / "late", 3000)
        b.restore(tmp_path / "late")
        assert b.state.opt_state.table.shape[0] == 1024
        b.train(3)
        st = b.state.opt_state
        assert int(st.count) == 3004 and st.table.shape[0] == 4096
        assert st.table[3004].tolist() == list(b.state.tx.inverse_bias_corrections(3004))


# -- data parallel ---------------------------------------------------------

def test_nan_on_one_rank_skips_the_step_on_both(tmp_path):
    from torch_ddp_worker import guard_worker

    spawn(guard_worker, 2, (2, coordinator_for_spawn(), str(tmp_path)), join_timeout_s=120)
    for rank in (0, 1):
        r = torch.load(os.path.join(tmp_path, f"guard{rank}.pt"), weights_only=True)
        assert r["skipped"] == 1
        assert same_bits(r["after"], r["before"])
