"""``examples/serve_llm_int8.py --preset toy --tp 2 --device cpu`` of the
port: two spawned gloo ranks, each streaming its shard of the int8
weights (``INT8_TP_RULES``) from the same synthetic checkpoint and serving
through ``TensorParallel`` + ``ServeEngine(strategy=)``. Its greedy tokens
(every request of the ``--server`` stream) equal the unsharded twin's on
the same checkpoint, token-exact; rank 0's
receipt is a valid ``serving`` receipt with the tensor-parallel fields
(the decode audit clean) and the sentry balanced."""

import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.examples import serve_llm_int8 as ex
from pytorch_distributed_training_tutorials_tpu_torch.obs import validate_receipt

torch.set_num_threads(1)
SMALL = ["--preset", "toy", "--device", "cpu", "--prompt_len", "8", "--new_tokens", "4",
         "--batch", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("serve_tp2") / "ck")
    base = SMALL + ["--ckpt_dir", ck]
    server = ["--server", "--requests", "4", "--slots", "2"]
    return {"srv": ex.main(base + server), "srv_tp": ex.main(base + server + ["--tp", "2"])}


def test_server_tokens_equal_the_unsharded_twin_with_rank0s_receipt(runs):
    r = runs["srv_tp"]
    assert validate_receipt(r, kind="serving") == []
    assert r["tp"] == 2 and r["tp_hlo_ok"] and r["mesh_shape"] == "model:2"
    assert r["checkpoint_reused"] and r["server_completed"] == 4
    assert r["tp_kv_bytes_per_chip"] < r["tp_kv_bytes_global"]
    assert r["server_streams"] == runs["srv"]["server_streams"]
    assert all(s["tokens"] is not None for s in r["server_streams"])
    assert r["sentry_fetched"] == r["sentry_budgeted"] and r["sentry_budget_violations"] == 0
