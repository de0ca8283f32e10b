"""The port's measurement layer against the JAX package's, on the CPU:
``obs/timing.py``'s ``DriftBracket`` and ``launch_overhead_fit``,
``obs/receipt.py``, ``bench/scaling.py`` (its sweep in gloo worlds of 1
and 2 processes, the collective count against the bucket plan, the
prediction and the report), ``launch/pod.py``'s command, and the bench
twin (``python -m ...bench``) at a toy size.

The timing helpers run on a fake clock on both sides, so their results
must be equal; the prediction is the same arithmetic, equal to the last
bit.
"""

import contextlib
import glob
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.bench import scaling as jscaling
from pytorch_distributed_training_tutorials_tpu.obs import receipt as jreceipt
from pytorch_distributed_training_tutorials_tpu.obs import timing as jtiming
from pytorch_distributed_training_tutorials_tpu_torch.bench import scaling
from pytorch_distributed_training_tutorials_tpu_torch.launch import pod_run_command
from pytorch_distributed_training_tutorials_tpu_torch.launch.pod import launch_pod
from pytorch_distributed_training_tutorials_tpu_torch.obs import receipt, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def test_drift_bracket_matches_jax(clock):
    def run(module):
        legs = iter([0.25, 0.5])  # the ceiling before, after
        bracket = module.DriftBracket(lambda: clock.advance(next(legs)), payload_bytes=10**6)
        return bracket.around(lambda: clock.advance(3.0) or "main")

    got, want = run(timing), run(jtiming)
    assert got.result == want.result == "main"
    assert got.to_dict() == want.to_dict()
    assert (got.drift, got.ceiling_s, got.bandwidth_mbs()) == (2.0, 0.25, 4.0)


def test_launch_overhead_fit_matches_jax():
    def time_chain(n):
        return 0.012 + n * 3.4e-5  # 12 ms fixed, 34 us an op

    got, want = timing.launch_overhead_fit(time_chain), jtiming.launch_overhead_fit(time_chain)
    assert got.to_dict() == want.to_dict()
    assert got.naive_per_op_us(64) == want.naive_per_op_us(64)
    np.testing.assert_allclose([got.fixed_ms, got.per_op_us], [12.0, 34.0])
    for module in (timing, jtiming):
        with pytest.raises(ValueError, match="two chain lengths"):
            module.launch_overhead_fit(time_chain, lens=(64,))


@pytest.mark.parametrize("payload,chips,step_s,bw", [
    (44_700_000, 32, 0.01023, 1e11), (183_004, 4, 0.05, 4.5e11), (1, 2, 1.0, 1.0)])
def test_predict_matches_jax(payload, chips, step_s, bw):
    got = scaling.predict_link_efficiency(payload, chips=chips, step_compute_s=step_s,
                                          link_bytes_per_s=bw)
    want = jscaling.predict_ici_efficiency(payload, chips=chips, step_compute_s=step_s,
                                           ici_bytes_per_s=bw)
    for key in ("ring_allreduce_s", "efficiency_no_overlap", "efficiency_full_overlap",
                "allreduce_payload_bytes", "chips", "prediction"):
        assert got[key] == want[key]
    assert got["link_bytes_per_s_assumed"] == bw


def test_receipt_round_trip_and_schema(tmp_path):
    r = receipt.make_receipt("bench_headline", {"metric": "m", "value": 1.5, "unit": "u"},
                             drift={"window_drift": 1.0}, device="cpu")
    assert receipt.SCHEMA == jreceipt.SCHEMA and receipt.KINDS == jreceipt.KINDS
    assert set(r) - {"metric", "value", "unit"} == set(jreceipt._ENVELOPE_KEYS)
    for key in ("torch_version", "cuda_version", "backend", "device_count", "device_name",
                "nvidia_smi"):
        assert key in r["env"]
    path = str(tmp_path / "r.json")
    receipt.write_receipt(path, r)
    back = receipt.load_receipt(path)
    assert back == json.loads(json.dumps(r)) and receipt.validate_receipt(back) == []
    assert receipt.validate_receipt({**back, "kind": "nope"}) == ["unknown kind 'nope'"]
    with pytest.raises(ValueError, match="collide"):
        receipt.make_receipt("serving", {"env": 1})
    with pytest.raises(ValueError, match="invalid receipt"):
        receipt.write_receipt(None, {"schema": receipt.SCHEMA, "kind": "serving"})
    # the legacy receipts checked in before the schema: judged as the JAX package judges them
    for path in sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json"))):
        with open(path) as f:
            legacy = json.load(f)
        assert receipt.validate_receipt(legacy, "bench_headline") == \
            jreceipt.validate_receipt(legacy, "bench_headline")


@pytest.fixture(scope="module")
def gloo_sweep():
    return scaling.sweep([1, 2], per_device_batch=2, image_px=8, num_filters=4, steps=1,
                         reps=1, device="cpu")


def test_sweep_in_gloo_counts_the_bucket_plan(gloo_sweep):
    points = gloo_sweep
    assert [p.num_chips for p in points] == [1, 2]
    for p in points:
        assert p.global_batch == 2 * p.num_chips and p.step_time_s > 0
        assert np.isclose(p.images_per_sec_per_chip, p.images_per_sec / p.num_chips)
    assert points[0].efficiency == 1.0
    plan = scaling.collective_footprint(scaling._model(4))
    assert (points[0].all_reduce_calls, points[0].all_reduce_bytes) == (0, 0)
    assert (points[1].all_reduce_calls, points[1].all_reduce_bytes) == (
        plan["total"]["ops"], plan["total"]["bytes"])
    # 21 BatchNorms (2 all-reduces each) and one gradient bucket at this width
    assert plan["batchnorm_all_reduces"] == 40 and len(plan["gradient_buckets"]) == 1
    assert scaling.collective_stats(1, num_filters=4)["collectives"]["total"]["ops"] == 0
    rep = scaling.report(points, device="cpu")
    want = jscaling.report([jscaling.ScalePoint(**{
        k: v for k, v in vars(p).items() if not k.startswith("all_reduce")}) for p in points])
    assert rep["metric"] == want["metric"] and rep["backend"] == "gloo"
    assert rep["efficiency_at_max_width"] == want["efficiency_at_max_width"]
    assert [{k: v for k, v in p.items() if k in q} for p, q in
            zip(rep["points"], want["points"])] == want["points"]
    with pytest.raises(ValueError, match="exceeds"):
        scaling.sweep([4096], device="cpu")


def test_pod_run_command():
    cmd = pod_run_command("train.py", ["--max_epochs", "10"], nnodes=2, node_rank=1,
                          rdzv_endpoint="host0:29500", nproc_per_node=8, max_restarts=3)
    assert cmd == ["torchrun", "--nnodes", "2", "--node-rank", "1", "--rdzv-endpoint",
                   "host0:29500", "--nproc-per-node", "8", "--max-restarts", "3", "train.py",
                   "--max_epochs", "10"]
    mod = pod_run_command("pkg.launch.train_ddp_env", nnodes=1, node_rank=0,
                          rdzv_endpoint="localhost:1234", module=True)
    assert mod[-2:] == ["-m", "pkg.launch.train_ddp_env"]
    for kw, msg in ((dict(node_rank=2), "outside"), (dict(rdzv_endpoint="host0"), "HOST:PORT"),
                    (dict(max_restarts=-1), "max_restarts")):
        args = dict(nnodes=2, node_rank=0, rdzv_endpoint="h:1") | kw
        with pytest.raises(ValueError, match=msg):
            pod_run_command("t.py", **args)


def test_launch_pod_names_the_command_without_torchrun(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(FileNotFoundError, match="torchrun not found.*--node-rank 0"):
        launch_pod("train.py", nnodes=1, node_rank=0, rdzv_endpoint="localhost:1")


def test_bench_twin_on_cpu():
    from pytorch_distributed_training_tutorials_tpu_torch.bench.__main__ import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        r = main(["--device", "cpu", "--rows", "16", "--per_device_batch", "8",
                  "--chain_len", "2", "--quiet"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(r))
    assert receipt.validate_receipt(r, "bench_headline") == []
    assert r["vs_baseline"] is None and r["unit"] == "images/sec/GPU" and r["value"] > 0
    assert r["env"]["backend"] == "cpu" and r["train_rows"] == 16
    for key in ("streaming_train_images_per_sec_per_gpu", "h2d_ceiling_images_per_sec_per_gpu",
                "h2d_window_drift", "train_step_only_images_per_sec_per_gpu"):
        assert r["breakdown"][key] > 0
    assert set(r["drift"]) >= {"ceiling_before_s", "ceiling_after_s", "window_drift"}
    assert 0.0 <= r["eval_accuracy"] <= 1.0 and r["epochs_trained"] == 2
