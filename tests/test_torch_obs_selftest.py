"""The port's observability selftest and its receipts, on the CPU.

- ``python -m ...obs --selftest --device cpu --json PATH`` in a
  subprocess: exit 0, ``ok``, a valid ``obs_selftest`` receipt stamped
  ``cpu``, its StepReport at most 10% unclassified, the ``--json`` twin
  equal to what stdout printed; without a GPU and without ``--device cpu``
  it raises.
- Its host-only legs against the JAX selftest's, on the same samples
  (``random.Random(7)``): the histogram's counts, the flight recorder's
  summary keys and its counters.
- The serving selftest's ``--json`` receipt validates as
  ``serve_selftest``, stamped ``cpu``, equal to the printed line.
"""

import json
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.obs import FlightRecorder as JaxRecorder
from pytorch_distributed_training_tutorials_tpu.obs import LogHistogram as JaxHistogram
from pytorch_distributed_training_tutorials_tpu_torch.obs import __main__ as obs_main
from pytorch_distributed_training_tutorials_tpu_torch.obs import load_receipt, validate_receipt

REPO = Path(__file__).resolve().parents[1]


def _run(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=600, cwd=REPO, env=env)


def test_obs_selftest_subprocess_on_the_cpu(tmp_path):
    path = str(tmp_path / "obs.json")
    out = _run("pytorch_distributed_training_tutorials_tpu_torch.obs", "--selftest",
               "--device", "cpu", "--json", path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    receipt = json.loads(out.stdout.strip().splitlines()[-1])
    assert receipt["ok"] is True, receipt["problems"]
    assert validate_receipt(receipt, kind="obs_selftest") == []
    assert receipt["env"]["backend"] == "cpu" and receipt["device"] == "cpu"
    assert receipt["step_report"]["unclassified_fraction"] <= obs_main.UNCLASSIFIED_LIMIT
    assert receipt["step_report"]["total_us"] > 0
    assert receipt["last_epoch"]["epoch"] == 1
    # 2 epochs of 32 steps, log_every=2: two drains and 32 verbose fetches
    assert receipt["host_fetches"] == 2 + 32 and receipt["n_events"] == 64 + 2
    assert load_receipt(path) == receipt


def test_obs_selftest_refuses_without_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    out = _run("pytorch_distributed_training_tutorials_tpu_torch.obs", "--selftest")
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def _jax_legs(dump_path):
    """The JAX selftest's pillar 5, its own code, on the JAX package's
    recorder and histogram: the whole-sample histogram and the summary."""
    rng = random.Random(7)
    samples = [rng.lognormvariate(-3.0, 1.5) for _ in range(4000)]
    whole = JaxHistogram()
    for v in samples:
        whole.record(v)
    rec = JaxRecorder(capacity=32, dump_path=dump_path)
    rec.request_submitted(0, p_len=4, max_new=8)
    rec.request_popped(0)
    rec.request_prefilled(0, slot=1)
    rec.chain_start(1, 2)
    rec.chain_end(tokens=8, occupancy=1)
    rec.fault("nonfinite", rid=0, slot=1, chain_step=3)
    rec.request_completed(0, "nonfinite", tokens=3)
    return whole, rec.summary()


def test_host_legs_equal_the_jax_selftests(tmp_path):
    problems = []
    whole = obs_main.histogram_leg(problems)
    fsum = obs_main.flight_leg(str(tmp_path), whole, problems)
    assert problems == []
    jwhole, jsum = _jax_legs(str(tmp_path / "jax_flight.jsonl"))
    assert whole.counts == jwhole.counts and whole.n == jwhole.n
    assert whole.rel_error_bound == jwhole.rel_error_bound
    for q in (0.5, 0.95, 0.99):
        assert whole.quantile(q) == jwhole.quantile(q)
    assert set(fsum) == set(jsum)
    # the counters agree; the times are this run's own
    for k, v in jsum.items():
        if isinstance(v, int) and not k.endswith(("_s", "_util", "_overlap")):
            assert fsum[k] == v, k
    assert fsum["flight_spans_done"] == fsum["e2e_count"] == 1
    assert fsum["flight_dumps"] == jsum["flight_dumps"] == 1
    assert os.path.exists(tmp_path / "flight.jsonl")


def test_serve_selftest_json_receipt(tmp_path):
    path = str(tmp_path / "serve.json")
    out = _run("pytorch_distributed_training_tutorials_tpu_torch.serve", "--selftest",
               "--device", "cpu", "--json", path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    receipt = json.loads(out.stdout.strip().splitlines()[-1])
    assert receipt["ok"] is True and receipt["problems"] == []
    assert validate_receipt(receipt, kind="serve_selftest") == []
    assert receipt["schema"] == "graft-receipt/v1" and receipt["env"]["backend"] == "cpu"
    assert receipt["mismatches"] == 0 and receipt["selftest"] == "serve_torch"
    assert load_receipt(path) == receipt
    assert math.isfinite(receipt["generated_tokens"])
