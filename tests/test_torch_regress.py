"""The port's ``bench/regress.py`` against the JAX package's, on the CPU.

Each scenario of the JAX gate's tests (legacy and schema'd receipts,
improving and decaying trajectories, fingerprints that split, the p95
tails) goes through both modules' ``collect`` and ``check`` and both CLIs:
equal groups (the port's key carries the device too: every receipt here
is a TPU-era one, ``"tpu"``), equal verdicts, equal exit codes. Then what
only the port does: a TPU receipt and a card receipt with the same
fingerprint fall into different groups, so neither gates the other (the
JAX gate skips a card receipt as invalid: its stamp has no
``jax_version``); two card rounds gate each other; a card at another power
limit is another device. The CLI exits 0 when clean and nonzero on a
planted drop, and the repo's own receipts are regression-free.
"""

import json
import os

import pytest

from pytorch_distributed_training_tutorials_tpu.bench import regress as jregress
from pytorch_distributed_training_tutorials_tpu_torch.bench import regress
from pytorch_distributed_training_tutorials_tpu_torch.obs import make_receipt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING = {"preset": "1b", "batch": 4, "prompt_len": 2048}
JAX_ENV = {"jax_version": "0", "backend": "tpu", "device_count": 1}


def _schemad(kind, **payload):
    return {"schema": "graft-receipt/v1", "kind": kind, "env": JAX_ENV, **payload}


SCENARIOS = {
    "improving": [("SERVING_r01.json", {**SERVING, "decode_tok_per_s": 100.0}),
                  ("SERVING_r02.json", {**SERVING, "decode_tok_per_s": 140.0})],
    "decaying": [("SERVING_r01.json", {**SERVING, "decode_tok_per_s": 100.0}),
                 ("SERVING_r02.json", {**SERVING, "decode_tok_per_s": 80.0})],
    "latest_vs_best": [(f"SERVING_r0{i}.json", {**SERVING, "decode_tok_per_s": v})
                       for i, v in enumerate([100.0, 97.0, 94.0], start=1)],
    "configs_split": [("SERVING_r01.json", {**SERVING, "decode_tok_per_s": 500.0}),
                      ("SERVING_r02.json", {**SERVING, "kv_cache_dtype": "int8",
                                            "decode_tok_per_s": 100.0})],
    "schemad_mfu": [
        ("TRAIN_LLM_r05.json", {"preset": "760m", "batch": 2, "seq": 2048, "mfu": 0.52,
                                "tokens_per_s": 15000}),
        ("TRAIN_LLM_r06.json", _schemad("lm_headline", preset="760m", batch=2, seq=2048,
                                        mfu=0.40, tokens_per_s=16000)),
        ("TRAIN_LLM_r07.json", _schemad("lm_headline", preset="760m", batch=2, seq=2048,
                                        mfu=0.30, tokens_per_s=16500))],
    "bench_value": [
        ("BENCH_r01.json", {"parsed": {"metric": "m", "value": 100.0, "unit": "images/sec"}}),
        ("BENCH_r02.json", {"parsed": {"metric": "m", "value": 50.0, "unit": "images/sec"}}),
        ("ACC_r01.json", {"metric": "acc", "value": 0.99, "unit": "fraction"}),
        ("ACC_r02.json", {"metric": "acc", "value": 0.50, "unit": "fraction"})],
    "latency_p95": [
        ("SERVING_r01.json", {**SERVING, "decode_tok_per_s": 100.0,
                              "server_p95_latency_s": 2.0, "server_ttft_p95_s": 0.5}),
        ("SERVING_r02.json", {**SERVING, "decode_tok_per_s": 100.0,
                              "server_p95_latency_s": 1.5, "server_ttft_p95_s": 0.4}),
        ("SERVING_r03.json", {**SERVING, "decode_tok_per_s": 100.0,
                              "server_p95_latency_s": 1.9, "server_ttft_p95_s": 0.4})],
    "flight_and_roles": [
        ("SERVING_r01.json", {**SERVING, "decode_tok_per_s": 100.0}),
        ("SERVING_r02.json", {**SERVING, "flight": 1, "decode_tok_per_s": 80.0}),
        ("SERVING_r03.json", {**SERVING, "role": "prefill", "n_prefill_replicas": 2,
                              "n_decode_replicas": 1, "decode_tok_per_s": 40.0}),
        ("SERVING_r04.json", {**SERVING, "role": "prefill", "n_prefill_replicas": 2,
                              "n_decode_replicas": 1, "handoffs_moved": 99,
                              "decode_tok_per_s": 20.0})],
    "invalid_skipped": [("EMPTY_r01.json", {}),
                        ("SERVING_r01.json", {**SERVING, "decode_tok_per_s": 100.0})],
}


def _write(tmp_path, files):
    paths = []
    for name, payload in files:
        p = tmp_path / name
        p.write_text(json.dumps(payload))
        paths.append(str(p))
    return paths


def _no_device(regressions):
    return [{k: v for k, v in r.items() if k != "device"} for r in regressions]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("tolerance", [0.05, 0.25])
def test_same_groups_verdicts_and_exit_codes_as_jax(scenario, tolerance, tmp_path, capsys):
    paths = _write(tmp_path, SCENARIOS[scenario])
    jgroups, jskipped = jregress.collect(paths)
    tgroups, tskipped = regress.collect(paths)
    assert {k[1] for k in tgroups} <= {"tpu"}
    assert {(kind, cfg): recs for (kind, _, cfg), recs in tgroups.items()} == jgroups
    assert len(tskipped) == len(jskipped)
    assert _no_device(regress.check(tgroups, tolerance)) == jregress.check(jgroups, tolerance)
    argv = [str(tmp_path), "--tolerance", str(tolerance)]
    assert regress.main(argv) == jregress.main(argv)
    capsys.readouterr()
    assert regress.main(argv + ["--json"]) == jregress.main(argv + ["--json"])


def _card(tok_s, smi="NVIDIA H100 80GB HBM3, 700.00 W"):
    r = make_receipt("lm_headline", {"preset": "760m", "batch": 2, "seq": 2048,
                                     "tokens_per_s": tok_s}, device="cpu")
    r["env"].update(backend="cuda", device_name="NVIDIA H100 80GB HBM3", nvidia_smi=smi)
    return r


def test_tpu_and_card_rounds_never_gate_each_other(tmp_path, capsys):
    tpu = _schemad("lm_headline", preset="760m", batch=2, seq=2048, tokens_per_s=16000.0)
    _write(tmp_path, [("LM_r01.json", tpu), ("LM_r02.json", _card(9000.0))])
    groups, _ = regress.collect(sorted(str(p) for p in tmp_path.iterdir()))
    assert len(groups) == 2
    assert {k[1] for k in groups} == {"tpu", "cuda:NVIDIA H100 80GB HBM3|NVIDIA H100 80GB "
                                              "HBM3, 700.00 W"}
    assert regress.main([str(tmp_path)]) == 0
    # the JAX gate cannot read a card round at all: its stamp has no
    # jax_version, so the receipt is skipped as invalid
    _, skipped = jregress.collect(sorted(str(p) for p in tmp_path.iterdir()))
    assert [os.path.basename(s.split(":")[0]) for s in skipped] == ["LM_r02.json"]
    capsys.readouterr()
    # two card rounds do gate each other; a card at another limit is apart
    _write(tmp_path, [("LM_r03.json", _card(8000.0))])
    assert regress.main([str(tmp_path), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [(r["metric"], os.path.basename(r["latest_path"])) for r in report["regressions"]] \
        == [("tokens_per_s", "LM_r03.json")]
    assert report["regressions"][0]["device"].startswith("cuda:")
    _write(tmp_path, [("LM_r03.json", _card(8000.0, smi="NVIDIA H100 80GB HBM3, 500.00 W"))])
    assert regress.main([str(tmp_path)]) == 0


def test_cli_clean_planted_and_usage(tmp_path, capsys):
    base = _card(10000.0)
    _write(tmp_path, [("LM_HEADLINE_r01.json", base)])
    assert regress.main([str(tmp_path), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["n_groups"] == 1 and report["regressions"] == []
    _write(tmp_path, [("LM_HEADLINE_r02.json", dict(base, tokens_per_s=9000.0))])
    assert regress.main([str(tmp_path), "--tolerance", "0.05"]) == 1
    assert "REGRESSION lm_headline.tokens_per_s" in capsys.readouterr().out
    assert regress.main([str(tmp_path), "--tolerance", "0.15"]) == 0
    assert regress.main([str(tmp_path), "--tolerance", "1.5"]) == 2


def test_repo_receipts_are_regression_free_as_in_jax(capsys):
    assert regress.main([REPO]) == jregress.main([REPO]) == 0
    capsys.readouterr()
    assert regress.main([]) == 0  # no paths: the repo root
