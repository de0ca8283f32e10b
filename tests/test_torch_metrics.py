"""The port's ``obs/metrics.py`` MetricsLogger and ``Trainer(metrics=,
log_every=)`` against the JAX package's, on the CPU.

- The same event sequence (device scalars and host floats, extras, a
  verbose step, epochs with the token and FLOP rates) through both
  loggers, each with a JSONL sink: equal lines (losses to 1e-6), equal
  ``tokens_per_sec`` / ``mfu`` and ``last_epoch``. The port's fetches:
  one per drain, plus one per verbose step.
- The ring buffer's capacity, the context manager, the rank-0 gate of the
  sink, the console lines.
- ``Trainer(metrics=, log_every=)``: the port's events (steps, losses,
  which steps printed) equal the JAX Trainer's on the same weights and
  batches; ``log_every=None`` leaves the trainer's one fetch an epoch.
"""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.data import ShardedLoader as JaxLoader
from pytorch_distributed_training_tutorials_tpu.data import datasets as jds
from pytorch_distributed_training_tutorials_tpu.models import LinearRegressor as JaxLinear
from pytorch_distributed_training_tutorials_tpu.obs import MetricsLogger as JaxLogger
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.models import LinearRegressor, from_jax_params
from pytorch_distributed_training_tutorials_tpu_torch.obs import MetricsLogger, metrics
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd

CPU = LocalMesh(torch.device("cpu"))
LOSS_TOL = 1e-6
RATES = dict(tokens_per_sample=4, flops_per_token=10.0, peak_flops=100.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequence(rng):
    """Steps (loss, extra, verbose) and epochs: a seeded mix of host
    floats and device scalars, with the guarded step's skip flag."""
    steps = []
    for i in range(1, 11):
        loss = float(rng.standard_normal() ** 2)
        extra = {"skipped": float(i == 7)} if i % 2 else None
        steps.append((i, loss, extra, i == 4))
    epochs = [{"epoch": e, "loss": 0.5 / (e + 1), "steps_per_sec": 2.0 + e,
               "samples_per_sec": 16.0 * (e + 1)} for e in range(2)]
    return steps, epochs


def _drive(logger, steps, epochs, scalar):
    for (i, loss, extra, verbose) in steps[:5]:
        logger.log_step(i, scalar(loss), verbose=verbose,
                        extra={k: scalar(v) for k, v in extra.items()} if extra else None)
    logger.log_epoch(epochs[0])
    for (i, loss, extra, verbose) in steps[5:]:
        logger.log_step(i, scalar(loss), verbose=verbose,
                        extra={k: scalar(v) for k, v in extra.items()} if extra else None)
    logger.log_epoch(epochs[1])
    logger.close()


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_same_events_give_equal_jsonl_lines_and_rates(tmp_path):
    steps, epochs = _sequence(np.random.Generator(np.random.PCG64(3)))
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jl = JaxLogger(jsonl_path=jpath, quiet=True, **RATES)
    tl = MetricsLogger(jsonl_path=tpath, quiet=True, **RATES)
    _drive(jl, steps, epochs, jnp.float32)
    _drive(tl, steps, epochs, lambda v: torch.tensor(v, dtype=torch.float32))
    want, got = _lines(jpath), _lines(tpath)
    assert len(got) == len(want) == 12
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=LOSS_TOL, abs=LOSS_TOL), k
            else:
                assert g[k] == v, k
    assert got == list(tl.events)
    assert tl.last_epoch == pytest.approx(jl.last_epoch)
    assert tl.last_epoch["tokens_per_sec"] == pytest.approx(32.0 * 4)
    assert tl.last_epoch["mfu"] == pytest.approx(jl.last_epoch["mfu"])
    # two drains (the epochs) and one verbose step's fetch
    assert tl.host_fetches == 3


def test_verbose_step_prints_and_records_the_same_float(capsys):
    for logger in (JaxLogger(), MetricsLogger()):
        logger.log_step(12, 1.23456, verbose=True)
        assert capsys.readouterr().out == "  step 12: loss 1.2346\n"
        logger.flush()
        assert logger.step_events()[0]["loss"] == pytest.approx(1.23456)
    # a host float costs no fetch; a tensor one does, once
    m = MetricsLogger(quiet=True)
    m.log_step(1, 0.5, verbose=True)
    m.log_step(2, torch.tensor(0.25), verbose=True)
    m.flush()
    assert m.host_fetches == 1 and [e["loss"] for e in m.step_events()] == [0.5, 0.25]


def test_quiet_epoch_line_capacity_and_context_manager(tmp_path, capsys):
    m = MetricsLogger()
    m.log_epoch({"epoch": 3, "loss": 0.1234, "steps_per_sec": 12.34, "samples_per_sec": 987.6})
    assert capsys.readouterr().out == "  epoch 3: loss 0.1234 | 12.3 steps/s | 988 samples/s\n"
    q = MetricsLogger(quiet=True, capacity=8)
    for i in range(32):
        q.log_step(i, torch.tensor(float(i)))
    q.flush()
    assert [e["step"] for e in q.step_events()] == list(range(24, 32))
    assert q.host_fetches == 1 and capsys.readouterr().out == ""
    path = str(tmp_path / "m.jsonl")
    with MetricsLogger(jsonl_path=path, quiet=True) as c:
        c.log_step(0, torch.tensor(2.0))
        c.log_epoch({"epoch": 0, "loss": 2.0, "steps_per_sec": 1.0, "samples_per_sec": 8.0})
    assert c._sink is None
    assert [e["kind"] for e in _lines(path)] == ["step", "epoch"]
    assert c.last_epoch["epoch"] == 0 and MetricsLogger().last_epoch is None


def test_sink_is_rank_zero_only(tmp_path, monkeypatch):
    path = tmp_path / "rank1.jsonl"
    m = MetricsLogger(jsonl_path=str(path), quiet=True)
    assert m.is_process_zero
    monkeypatch.setattr(metrics, "process_index", lambda: 1)
    assert not m.is_process_zero
    m.log_step(0, 1.0)
    m.close()
    assert not path.exists() and len(m.step_events()) == 1  # events still record


def _trainers(log_every, jsonl=None):
    ds = jds.synthetic_regression(256, in_dim=8)
    jm = JaxLogger(quiet=True)
    jt = JaxTrainer(JaxLinear(in_dim=8), JaxLoader(ds, 16, jax_mesh({"data": 1})),
                    optax.sgd(1e-2), loss="mse", metrics=jm, log_every=log_every)
    tm = MetricsLogger(quiet=True, jsonl_path=jsonl)
    tt = Trainer(LinearRegressor(in_dim=8), ShardedLoader(ArrayDataset(ds.arrays), 16, CPU),
                 sgd(1e-2), loss="mse", metrics=tm, log_every=log_every)
    sd = from_jax_params(jax_to_np(jt.state.params), tt.model, "cpu")
    with torch.no_grad():
        for k, v in tt.model.state_dict().items():
            v.copy_(sd[k])
    return jt, tt


def jax_to_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("log_every", [None, 3])
def test_trainer_metrics_and_log_every_match_jax(log_every, tmp_path):
    jt, tt = _trainers(log_every, jsonl=str(tmp_path / "t.jsonl"))
    assert tt.metrics is not None and tt.log_every == log_every
    jt.train(2)
    tt.train(2)
    tt.metrics.close()
    js, ts = jt.metrics.step_events(), tt.metrics.step_events()
    assert [e["step"] for e in ts] == [e["step"] for e in js] and len(ts) == 32
    np.testing.assert_allclose([e["loss"] for e in ts], [e["loss"] for e in js], rtol=1e-5)
    assert ([e["epoch"] for e in tt.metrics.epoch_events()]
            == [e["epoch"] for e in jt.metrics.epoch_events()] == [0, 1])
    assert set(tt.metrics.last_epoch) == set(jt.metrics.last_epoch)
    assert _lines(tmp_path / "t.jsonl") == list(tt.metrics.events)
    # one fetch an epoch, plus one for each printed step (16 steps an epoch)
    printed = 0 if log_every is None else 2 * (16 // log_every)
    assert tt.host_syncs == 2 + printed


def test_trainer_log_every_prints_the_jax_step_lines(capsys):
    jt, tt = _trainers(4)
    jt.metrics.quiet = tt.metrics.quiet = False
    jt.train(1)
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("  step")]
    tt.train(1)
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("  step")]
    assert [ln.split(":")[0] for ln in got] == [ln.split(":")[0] for ln in want]
    assert len(got) == 4
