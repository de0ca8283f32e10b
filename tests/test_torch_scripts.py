"""The port's script twins (``scripts/``), ``ops/debug.py`` and
``utils/tree.py``, on the CPU.

- ``profile_step``, ``profile_decode`` (whole-slot and paged) and
  ``launch_overhead_probe`` at toy sizes with ``--device cpu``: each prints
  a valid receipt of its kind (``profile_step``, ``profile_decode``,
  ``launch_probe``) stamped ``cpu``; without a GPU and without ``--device
  cpu`` each raises.
- ``flight_view`` renders a ``graft-flightlog/v1`` dump written by the
  port's recorder line for line as the JAX package's script renders it,
  and filters a fleet dump to one request's journey.
- ``per_shard_shapes`` / ``describe_sharding`` with no group: the
  tensor's own shape (the 2-rank world's case rides
  ``tests/test_torch_launch.py``); ``keystr`` equal to the JAX one's
  slash path.
"""

import importlib.util
import json
from pathlib import Path

import jax
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.utils.tree import keystr as jax_keystr
from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder, validate_receipt
from pytorch_distributed_training_tutorials_tpu_torch.ops.debug import (
    describe_sharding,
    per_shard_shapes,
)
from pytorch_distributed_training_tutorials_tpu_torch.scripts import (
    flight_view,
    launch_overhead_probe,
    profile_decode,
    profile_step,
)
from pytorch_distributed_training_tutorials_tpu_torch.utils.tree import keystr

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _receipts(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_profile_step_prints_a_profile_step_receipt(capsys, tmp_path):
    path = str(tmp_path / "step.json")
    assert profile_step.main(["--device", "cpu", "--rows", "32", "--batch", "8",
                              "--chain", "2", "--top", "5", "--json", path]) == 0
    out = capsys.readouterr().out
    (r,) = _receipts(out)
    assert validate_receipt(r, kind="profile_step") == []
    assert r["env"]["backend"] == "cpu" and r["workload"] == "resnet18-bs8-bf16-mnist-train-step"
    rep = r["step_report"]
    assert rep["steps"] == 2 and rep["unclassified_fraction"] <= 0.10
    assert rep["by_category"].get("convolution", 0) > 0 and r["losses_finite"]
    assert len(r["top_ops_ms_per_step"]) == 5 and "| class |" in out
    assert json.loads(Path(path).read_text()) == r


@pytest.mark.parametrize("paged", [False, True])
def test_profile_decode_prints_a_profile_decode_receipt(paged, capsys):
    argv = ["--device", "cpu", "--preset", "toy", "--top", "3"] + (["--paged"] if paged else [])
    assert profile_decode.main(argv) == 0
    (r,) = _receipts(capsys.readouterr().out)
    assert validate_receipt(r, kind="profile_decode") == []
    assert r["paged"] is paged and r["completions"] == 4 and r["decode_steps"] == 8
    assert r["n_layers"] == 2 and r["unclassified_fraction"] <= 0.10
    # the CPU runs the plain versions: no kernel launched or traced
    assert r["port_launches"] == r["counted_launches"] == {}
    assert r["step_report"]["by_category"]["matmul"] > 0


def test_launch_probe_prints_one_receipt_a_body(capsys):
    assert launch_overhead_probe.main(["--device", "cpu", "--lens", "2", "4"]) == 0
    rs = _receipts(capsys.readouterr().out)
    assert [r["body"] for r in rs] == ["bf16_matmul", "int8_matmul"]
    for r in rs:
        assert validate_receipt(r, kind="launch_probe") == []
        assert r["shape"] == [4, 2048, 8192] and set(r["wall_ms"]) == {"2", "4"}


def test_scripts_refuse_without_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    for main, argv in ((profile_step.main, ["--rows", "8"]),
                       (profile_decode.main, ["--preset", "toy"]),
                       (launch_overhead_probe.main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def _jax_flight_view():
    spec = importlib.util.spec_from_file_location("jax_flight_view",
                                                  REPO / "scripts" / "flight_view.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dump(path):
    rec = FlightRecorder(capacity=64, dump_path=str(path))
    for rid in range(3):
        rec.request_submitted(rid, p_len=4 + rid, max_new=8)
    for rid in range(3):
        rec.request_popped(rid)
        rec.request_prefilled(rid, slot=rid)
    rec.chain_start(3, 4, chain=0)
    rec.chain_start(3, 4, chain=1)  # pipelined: the next chain before the first's end
    rec.chain_end(tokens=24, occupancy=3, chain=0)
    rec.record("pool_shed", rid=9, pages=12)
    rec.record("replica_health", replica=1, to="dead")
    rec.chain_end(tokens=24, occupancy=3, chain=1)
    rec.request_completed(0, "length", tokens=8)
    rec.fault("nonfinite", rid=1, slot=1, chain_step=3)
    rec.dump("manual")


def test_flight_view_renders_as_the_jax_script(tmp_path, capsys):
    path = tmp_path / "flight.jsonl"
    _dump(path)
    jview = _jax_flight_view()
    # snapshot 0: the fault's auto-dump (its trigger marked); 1: the manual one
    for argv in ([str(path)], [str(path), "--events", "5", "--snapshot", "0"]):
        assert flight_view.main(argv) == 0
        got = capsys.readouterr().out
        assert jview.main(argv) == 0
        assert got == capsys.readouterr().out
    assert "<-- trigger" in got and "[in flight: chain" not in got  # 5 events: cut
    assert flight_view.main([str(path)]) == 0
    full = capsys.readouterr().out
    assert "[in flight: chain" in full and "[pool exhausted: wanted 12 pages]" in full
    assert "[dead]" in full and "request 0:" in full


def test_flight_view_journey_and_empty_log(tmp_path, capsys):
    path = tmp_path / "fleet.jsonl"
    snap = {"schema": "graft-flightlog/v1", "reason": "fleet", "t": 1.0, "n_events": 3,
            "dropped": 0, "counts": {}, "trigger": None, "histograms": {},
            "events": [{"t": 0.1, "kind": "submit", "gid": 7, "replica": 0},
                       {"t": 0.2, "kind": "submit", "gid": 8, "replica": 1},
                       {"t": 0.3, "kind": "complete", "gid": 7, "replica": 1}],
            "live_spans": [], "done_spans": [{"rid": 0, "gid": 7, "replica": 1}]}
    path.write_text(json.dumps(snap) + "\n")
    jview = _jax_flight_view()
    argv = [str(path), "--journey", "7"]
    assert flight_view.main(argv) == jview.main(argv)
    out = capsys.readouterr().out
    assert out.count("journey gid=7") == 2 and "gid=8" not in out.split("===")[2]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert flight_view.main([str(empty)]) == 1


def test_per_shard_shapes_and_describe_with_no_group():
    x = torch.zeros(32, 8)
    assert per_shard_shapes(x) == [(32, 8)]
    assert describe_sharding(x) == "global (32, 8) torch.float32 -> [rank0 cpu:(32, 8)]"
    assert describe_sharding(x, dim=None).startswith("global (32, 8)")


def test_keystr_is_the_jax_slash_path():
    tree = {"blocks": [{"attn": {"q_proj": 1}}], "tok_emb": 2}
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    for kp, _ in paths:
        assert keystr(kp) == jax_keystr(kp)
    assert keystr("blocks.0.attn.q_proj.weight") == "blocks/0/attn/q_proj/weight"
    assert keystr(("layer_groups", 1, "qt")) == "layer_groups/1/qt"
