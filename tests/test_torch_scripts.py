"""The port's script twins (``scripts/``), ``ops/debug.py`` and
``utils/tree.py``, on the CPU.

- ``receipt_session``: the plan of the fourteen arms re-targeted at the
  port's serving example and LM bench (the JAX script's order, flag
  deltas and output names), ``--dry-run`` printing it and creating
  nothing, ``--only`` refusing an unknown arm;
- ``step_time_experiment``, ``int8_decode_sweep`` and ``flash_bench`` at
  toy sizes with ``--device cpu``: their output stamped ``cpu``;
  ``train_llm_mfu`` at the smoke preset: a valid ``lm_headline`` receipt;
  ``accuracy_demo`` built on a small split, not run (its run is 14
  epochs); without a GPU and without ``--device cpu`` each raises.

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
    accuracy_demo,
    flash_bench,
    flight_view,
    int8_decode_sweep,
    launch_overhead_probe,
    profile_decode,
    profile_step,
    receipt_session,
    step_time_experiment,
    train_llm_mfu,
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


def test_receipt_session_plans_the_fourteen_arms_of_the_port():
    plan = receipt_session.build_session(6, "/ckpt", "/out")
    names = [n for n, _ in plan]
    assert names == list(receipt_session.ARM_NAMES) and len(names) == 14
    cmds = dict(plan)
    serve_arms = [n for n in names if n != "fused_mfu"]
    assert serve_arms[0] == "base"
    for n in serve_arms:
        cmd = cmds[n]
        assert cmd[1:3] == ["-m", "pytorch_distributed_training_tutorials_tpu_torch.examples."
                                  "serve_llm_int8"]
        assert "--server" in cmd and cmd[cmd.index("--preset") + 1] == "1b"
        assert cmd[cmd.index("--ckpt_dir") + 1] == "/ckpt"
        assert cmd[cmd.index("--json") + 1] == f"/out/SERVING_r06_{n}.json"
    fused = cmds["fused_mfu"]
    assert fused[2].endswith("bench.lm_headline") and "--fused" in fused
    assert fused[-1] == "/out/TRAIN_LLM_r06_fused.json"

    def flag(arm, name):
        return cmds[arm][cmds[arm].index(name) + 1]

    assert flag("prefix", "--prefix-overlap") == "0.7" and flag("spec", "--spec-k") == "4"
    assert flag("deadline", "--deadline-s") == "2"
    assert flag("flight", "--flight-log") == "/out/FLIGHT_r06.jsonl"
    assert flag("paged", "--max_seq_len") == "4096" and "--paged" in cmds["paged"]
    assert flag("paged_int4", "--kv-bits") == "4" and "--paged-kernel" in cmds["paged_int4"]
    assert flag("tp", "--tp") == "4" and flag("disagg", "--disaggregate") == "1p2d"
    assert "--slo" in cmds["slo"] and "--replicas" not in cmds["slo"]


def test_receipt_session_dry_run_prints_the_plan_and_creates_nothing(tmp_path, capsys):
    out_dir = tmp_path / "receipts"
    assert receipt_session.main(["--round", "99", "--dry-run", "--out-dir",
                                 str(out_dir)]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]
    assert len(lines) == 14 and any("SERVING_r99_slo.json" in ln for ln in lines)
    assert not out_dir.exists()
    assert receipt_session.main(["--round", "99", "--dry-run", "--only", "tp,slo"]) == 0
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[")]) == 2
    with pytest.raises(SystemExit):
        receipt_session.main(["--round", "7", "--dry-run", "--only", "nonesuch"])


def test_step_time_and_int8_sweep_stamp_the_cpu(capsys):
    assert step_time_experiment.main(["8", "--chain_len", "2", "--rows", "32",
                                      "--device", "cpu"]) == 0
    (r,) = _receipts(capsys.readouterr().out)
    assert r["device_name"] == "cpu" and r["timer"] == "host_clock" and r["ms_per_step"] > 0
    assert int8_decode_sweep.main(["--m", "4", "--shapes", "64x128", "--lens", "2", "4",
                                   "--device", "cpu"]) == 0
    (row,) = _receipts(capsys.readouterr().out)
    assert row["shape"] == [4, 64, 128] and row["route"] == "plain (cpu)"
    assert row["device_name"] == "cpu" and row["fit"]["lens"] == [2, 4]


def test_flash_bench_writes_a_table_stamped_cpu(tmp_path, capsys):
    out = tmp_path / "flash.md"
    assert flash_bench.main(["--seqs", "16", "32", "--b", "1", "--h", "2", "--d", "8",
                             "--device", "cpu", "--out", str(out)]) == 0
    text = out.read_text()
    assert text.startswith("# Flash attention against dense causal attention — cpu")
    rows = [ln for ln in text.splitlines() if ln.startswith("| 16 ") or ln.startswith("| 32 ")]
    assert len(rows) == 2 and all("not measured" in ln for ln in rows)
    assert all(float(ln.split("|")[-2]) < 1e-5 for ln in rows)  # flash == dense


def test_train_llm_mfu_writes_an_lm_headline_receipt(tmp_path, capsys):
    path = tmp_path / "mfu.json"
    r = train_llm_mfu.main(["--preset", "smoke", "--seq", "32", "--batch", "2", "--steps",
                            "2", "--reps", "1", "--attn", "dense", "--device", "cpu",
                            "--json", str(path)])
    assert validate_receipt(json.loads(path.read_text()), kind="lm_headline") == []
    assert r["preset"] == "smoke" and r["all_losses_finite"] and r["env"]["backend"] == "cpu"
    assert len(train_llm_mfu.SWEEP) == 7


def test_accuracy_demo_builds_its_configs():
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, mnist

    small = ArrayDataset(tuple(a[:64] for a in mnist("test", raw=True).arrays))
    trainer, test = accuracy_demo.build(10.0, "cpu", train=small, test=small)
    assert trainer.state.tx.lr == 10.0 and trainer.state.tx.momentum == 0.9
    assert trainer.loader.per_device_batch == test.per_device_batch == accuracy_demo.BATCH
    assert (accuracy_demo.EPOCHS, accuracy_demo.TARGET) == (7, 0.99)


def test_new_scripts_refuse_without_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    for main, argv in ((step_time_experiment.main, ["8", "--rows", "8"]),
                       (int8_decode_sweep.main, ["--shapes", "64x128"]),
                       (flash_bench.main, ["--seqs", "16"]),
                       (train_llm_mfu.main, ["--preset", "smoke"]),
                       (accuracy_demo.main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
