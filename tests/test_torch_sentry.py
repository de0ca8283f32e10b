"""The contract sentry in the PyTorch port (``obs/sentry.py``) through the
ten scenarios of the JAX package's ``tests/test_sentry.py``, rebound to
the port's probes.

The JAX test's toy float LM (vocab 32, d_model 16, 2 layers, 2 heads,
window 48, ``PRNGKey(0)``), converted through
``models/convert.py:from_jax_params``. The probes, restated for torch: the
compile probe counts native library builds and loads (a real load of the
host gather, ``data/native.py``, built with ``g++``, stands in for the
JAX test's fresh jit program); the fetch probe counts ``Tensor.cpu``
calls (and, on a card, sync debug mode's warnings); the re-upload probe
fires on numpy leaves and on tensors off the engine's device. Exact:
``summary()``'s keys are the JAX sentry's; on a composed engine (prefix
cache, chunked prefill, speculation, ``pipeline_depth`` 2) the sentry's
fetches equal a ``Tensor.cpu`` spy laid under it, its budgeted count and
``n_host_syncs``, and the greedy tokens equal the JAX engine's; a stray
fetch inside one round is exactly one violation; a post-steady native
load is exactly one steady recompile and one dump.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pytorch_distributed_training_tutorials_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
)
from pytorch_distributed_training_tutorials_tpu.obs.sentry import (
    ContractSentry as JaxSentry,
)
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.data import native
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.flight import (
    FlightRecorder,
    load_flightlog,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.sentry import ContractSentry
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

CFG = dict(vocab_size=32, d_model=16, n_layers=2, n_heads=2, max_seq_len=48)
# the composed engine: prefix cache, chunks of 8, speculation, depth 2
COMPOSED = dict(n_slots=2, tokens_per_launch=4, prefix_cache_bytes=1 << 20,
                prefill_chunk=8, speculative_k=2, pipeline_depth=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = JaxConfig(**CFG)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           TransformerConfig(**CFG), device="cpu")
    return jmodel, params, port


def _engine(port, **kw):
    return ServeEngine(TransformerLM(TransformerConfig(**CFG)), port, device="cpu", **kw)


def _prompts(n=4, seed=3):
    """The JAX test's prompts: a shared 10-token head and tails of 2 + i."""
    rng = np.random.Generator(np.random.PCG64(seed))
    shared = rng.integers(0, CFG["vocab_size"], (10,)).tolist()
    return [shared + rng.integers(0, CFG["vocab_size"], (2 + i,)).tolist() for i in range(n)]


def _run(engine, prompts, max_new=5, request=Request):
    ids = [engine.submit(request(prompt=p, max_new_tokens=max_new)) for p in prompts]
    toks = {}
    while not engine.idle:
        for c in engine.step():
            toks[c.request_id] = c.tokens
    return [toks[i] for i in ids]


class _Spy:
    """A ``Tensor.cpu`` spy: counts every call, then calls what it wraps."""

    def __init__(self):
        self.n = 0
        self.real = torch.Tensor.cpu

    def __call__(self, t, *a, **k):
        self.n += 1
        return self.real(t, *a, **k)


@pytest.fixture
def cpu_spy(monkeypatch):
    spy = _Spy()
    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    return spy


# ------------------------------------------------------------ the receipt

def test_summary_keys_and_stats_part(tiny_lm):
    """``summary()`` has exactly the JAX sentry's keys, and the engine's
    ``sentry`` stats part is ``{"sentry": 0}`` off, the summary on."""
    assert ContractSentry().summary().keys() == JaxSentry().summary().keys()
    _, _, port = tiny_lm
    assert _engine(port, n_slots=1).stats("sentry") == {"sentry": 0}
    sen = ContractSentry()
    assert _engine(port, n_slots=1, sentry=sen).stats("sentry") == sen.summary()


def test_compile_records_are_bounded():
    sen = ContractSentry(max_compile_records=2)
    for _ in range(5):
        sen._on_compile(1.0)
    assert len(sen.compile_records) == 2
    assert sen.n_compiles == 5  # counters never truncate


# ------------------------------------------------------------ compile probe

def test_post_steady_native_load_is_exactly_one_violation(tmp_path, monkeypatch):
    """A native load before ``mark_steady`` is a plain event; one through
    the real loader after it is exactly one steady recompile — one
    ``compile`` event with ``steady`` set and one dump naming its phase."""
    dump = str(tmp_path / "sentry.jsonl")
    fl = FlightRecorder(capacity=64, dump_path=dump)
    sen = ContractSentry(flight=fl)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    with sen:
        assert native.native_available()        # warmup: built or loaded
        warm = sen.n_compiles
        assert warm == 1 and sen.n_steady_recompiles == 0
        assert native.native_available()        # cached: no load
        assert sen.n_compiles == warm
        sen.set_phase("decode")
        sen.mark_steady()
        native._tried, native._lib = False, None
        assert native.native_available()        # a real load after steady
        assert sen.n_steady_recompiles == 1 and sen.n_compiles == warm + 1
    assert sen.compile_probe == "off"
    snaps = [s for s in load_flightlog(dump) if s["reason"] == "compile"]
    assert len(snaps) == 1
    trig = snaps[0]["trigger"]
    assert trig["kind"] == "compile" and trig["steady"] is True
    assert trig["label"] == "steady" and trig["library"] == "fastgather"
    assert trig["native"] == "loaded"
    warm_evs = [e for e in snaps[0]["events"] if e["kind"] == "compile" and not e["steady"]]
    assert len(warm_evs) == 1


# ------------------------------------------------------------- fetch probe

def test_fetch_accounting_matches_spy_on_composed_engine(tiny_lm, cpu_spy):
    """On a composed engine (prefix cache, chunks, speculation, depth 2)
    the sentry's fetches equal a ``Tensor.cpu`` spy laid UNDER it, its
    budgeted count and the engine's ``n_host_syncs`` = chains + prefills +
    splices; no violation; greedy tokens equal the JAX engine's (prefix
    cache on, tokens exact)."""
    jmodel, params, port = tiny_lm
    prompts = _prompts()
    jeng = JaxServeEngine(jmodel, params, n_slots=2, tokens_per_launch=4,
                          prefix_cache_bytes=1 << 20)
    want = _run(jeng, prompts, request=JaxRequest)
    sen = ContractSentry()
    eng = _engine(port, sentry=sen, **COMPOSED)
    with sen:
        got = _run(eng, prompts)
    assert got == want
    assert eng.n_splices > 0 and eng.n_chunks > 0 and eng.n_verify_forwards > 0
    budget = eng.n_chains + eng.n_prefills + eng.n_splices
    assert sen.n_fetched == cpu_spy.n == sen.n_budgeted == eng.n_host_syncs == budget
    assert sen.n_budget_violations == 0 and sen.n_rounds > 0
    assert sen.summary()["sentry_fetch_budget_ok"] == 1


def test_stray_in_round_fetch_is_exactly_one_violation(tiny_lm):
    """A stray ``.cpu()`` inside ONE step round (through the engine's own
    sweep) is exactly one ``budget_violation``, naming its round; the
    rounds after it stay clean."""
    _, _, port = tiny_lm
    fl = FlightRecorder(capacity=64)
    sen = ContractSentry(flight=fl)
    eng = _engine(port, n_slots=2, tokens_per_launch=4, sentry=sen)
    stray = torch.zeros(())
    with sen:
        _run(eng, _prompts(n=2))
        orig = eng._sweep

        def leaky_sweep():
            stray.cpu()
            return orig()

        eng.submit(Request(prompt=_prompts(n=1)[0], max_new_tokens=3))
        eng._sweep = leaky_sweep
        eng.step()                     # ONE over-budget round
        eng._sweep = orig
        while not eng.idle:
            eng.step()
    assert sen.n_budget_violations == 1
    evs = [e for e in fl.events if e["kind"] == "budget_violation"]
    assert len(evs) == 1
    assert evs[0]["fetched"] == evs[0]["budgeted"] + 1
    assert evs[0]["round"].startswith("step:")


def test_fetches_outside_rounds_never_violate():
    sen = ContractSentry()
    x = torch.ones(3)
    with sen:
        x.cpu()                        # outside any round
        sen.begin_round("clean")
        sen.budgeted_fetch()
        x.cpu()
        sen.end_round()
        sen.note_fetch()               # an event wait, counted by its caller
    assert sen.n_fetched == 3 and sen.n_budgeted == 1
    assert sen.n_rounds == 1 and sen.n_budget_violations == 0


# ---------------------------------------------------------- re-upload probe

def test_numpy_tree_fires_device_twin_silent():
    """A numpy leaf fires with its bytes; the same tree as tensors on the
    engine's device is silent; tensors on another device fire. Repeats
    count, but announce once per label."""
    fl = FlightRecorder(capacity=64)
    sen = ContractSentry(flight=fl)
    host = {"w": np.ones((8, 4), np.float32), "b": [np.zeros((4,), np.float32)]}
    twin = {"w": torch.ones((8, 4)), "b": [torch.zeros(4)]}
    want = 8 * 4 * 4 + 4 * 4
    assert sen.check_args(twin, label="pinned", device="cpu") == 0
    assert sen.check_args(host, label="restore", device="cpu") == want
    assert sen.check_args(host, label="restore", device="cpu") == want
    off = {"w": torch.ones((8, 4), device="meta")}
    assert sen.check_args(off, label="off_device", device="cpu") == 8 * 4 * 4
    assert sen.n_reuploads == 3 and sen.reupload_bytes == 2 * want + 128
    assert sen.n_checked == 4
    evs = [e for e in fl.events if e["kind"] == "reupload"]
    assert [e["label"] for e in evs] == ["restore", "off_device"]
    assert evs[0]["bytes"] == want and evs[0]["n_leaves"] == 2


# ---------------------------------------------- engine off-path + lifecycle

class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_sentry_off_engine_is_identical(tiny_lm):
    """``sentry=None`` keeps the engine's state dict and slot state, its
    host syncs and the operations of its stream; an instrumented engine's
    tokens are the same, with rounds opened and no violation."""
    _, _, port = tiny_lm
    prompts = _prompts(n=3)
    eng_off = _engine(port, n_slots=2, tokens_per_launch=4)
    sen = ContractSentry()
    eng_on = _engine(port, n_slots=2, tokens_per_launch=4, sentry=sen)
    assert eng_off.model.state_dict().keys() == eng_on.model.state_dict().keys()
    assert ([f.name for f in eng_off._state.__dataclass_fields__.values()]
            == [f.name for f in eng_on._state.__dataclass_fields__.values()])
    with _OpCount() as ops_off:
        toks_off = _run(eng_off, prompts)
    with sen, _OpCount() as ops_on:
        toks_on = _run(eng_on, prompts)
    assert toks_on == toks_off
    assert ops_on.n == ops_off.n
    assert eng_on.n_host_syncs == eng_off.n_host_syncs == sen.n_fetched
    assert sen.n_budget_violations == 0 and sen.n_rounds > 0


def test_uninstall_restores_cpu_marker_guarded():
    """Uninstall restores ``Tensor.cpu`` exactly, and leaves a spy laid
    ON TOP of the sentry's wrapper in place (the marker guard)."""
    real = torch.Tensor.cpu
    had = "cpu" in torch.Tensor.__dict__
    sen = ContractSentry()
    sen.install()
    wrapped = torch.Tensor.__dict__["cpu"]
    assert getattr(wrapped, "_contract_sentry", None) is sen
    sen.uninstall()
    assert torch.Tensor.cpu is real and ("cpu" in torch.Tensor.__dict__) == had
    sen2 = ContractSentry()
    sen2.install()

    def spy(t, *a, **k):
        return real(t, *a, **k)

    torch.Tensor.cpu = spy
    try:
        sen2.uninstall()
        assert torch.Tensor.__dict__["cpu"] is spy
    finally:
        if had:
            torch.Tensor.cpu = real
        else:
            del torch.Tensor.cpu
    assert torch.Tensor.cpu is real


# ------------------------------------------------------------- trainer seam

def test_trainer_threads_sentry_phases_and_state_check():
    """``Trainer(sentry=)`` moves the phase to each epoch and walks the
    train state once an epoch: a state on the loader's device is silent."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
    from pytorch_distributed_training_tutorials_tpu_torch.models import LinearRegressor
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd

    rng = np.random.Generator(np.random.PCG64(0))
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = x @ rng.standard_normal((4, 1)).astype(np.float32)
    loader = ShardedLoader(ArrayDataset((x, y)), 8, LocalMesh(torch.device("cpu")))
    sen = ContractSentry()
    trainer = Trainer(LinearRegressor(in_dim=4), loader, sgd(1e-2), loss="mse", quiet=True,
                      sentry=sen)
    with sen:
        trainer.train(2)
    assert sen.n_checked == 2              # one train-state walk an epoch
    assert sen.n_reuploads == 0            # the state is on the device
    assert sen.phase == "epoch 1"          # phases moved with the epochs


# ------------------------------------------------------------- the selftest

def test_selftest_sentry_and_slo_arms():
    """``--sentry`` and ``--slo`` on the CPU: the clean steady stream
    balances against a ``Tensor.cpu`` spy, each injected violation is
    caught once with one dump naming it, and the SLO engine's sentry
    balances."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve.__main__ import selftest

    out = selftest("cpu", sentry=True, slo=True)
    assert out["ok"], out["problems"]
    assert out["sentry_token_exact"] and out["sentry_dump_snapshots"] == 3
    assert out["sentry_injected_recompile_caught"] and out["sentry_injected_budget_caught"]
    assert out["sentry_injected_reupload_caught"]
    assert out["slo_sentry_fetched"] == out["slo_host_syncs"]
    assert out["slo_sentry_violations"] == 0
