"""The port's driver entry points (``graft_entry.py``) against the
repository's ``__graft_entry__.py``.

- ``entry()``: the ResNet-18 eval forward; on the JAX ``entry()``'s
  variables carried across the weight bridge, its output on the JAX
  example input (zeros, (8, 28, 28, 1)) and on a random one equals the
  JAX function's within ``1e-5`` of the largest logit (float32, eval-mode
  BatchNorm: no batch statistics to amplify rounding);
- ``dryrun_multichip(2, device="cpu")``: a gloo world of 2 prints its
  dp, pp, fsdp and grad-accumulation lines (their asserts held in the
  ranks), and no section that needs a wider world;
- without a GPU and without ``device="cpu"`` both raise: there is no
  fallback to a CPU mesh;
- ``dryrun_multichip(8, device="cpu")``, every section, is ``slow`` as
  the JAX dry run's end-to-end test is.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch import graft_entry
from pytorch_distributed_training_tutorials_tpu_torch.models import from_jax_params, resnet18

torch.set_num_threads(1)


def jax_entry():
    """The JAX ``entry()``'s forward and variables: its model (ResNet-18,
    cifar stem, 10 classes) and ``model.init(PRNGKey(0), zeros (8, 28, 28,
    1), train=False)``, drawn here under ``jit`` — the same values as the
    eager draw (flax's init is a pure function of the key; all 102 leaves
    compared bitwise when this test was written), in a third of the time."""
    from pytorch_distributed_training_tutorials_tpu.models import resnet18 as jresnet18

    model = jresnet18(num_classes=10, stem="cifar")
    x = np.zeros((8, 28, 28, 1), np.float32)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(jax.random.PRNGKey(0), x)
    return jax.jit(lambda v, x: model.apply(v, x, train=False)), variables, x


def test_entry_matches_the_jax_entry_on_bridged_variables():
    jfn, variables, jx = jax_entry()
    fn, (state, x) = graft_entry.entry(device="cpu")
    assert tuple(x.shape) == tuple(jx.shape) == (8, 28, 28, 1) and not x.any()
    assert set(state) == set(resnet18(num_classes=10, stem="cifar", in_channels=1).state_dict())
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    bridged = from_jax_params(to_np(variables["params"]),
                              resnet18(num_classes=10, stem="cifar", in_channels=1), "cpu",
                              batch_stats=to_np(variables["batch_stats"]))
    rand = np.random.Generator(np.random.PCG64(0)).random((8, 28, 28, 1), dtype=np.float32)
    for inp in (jx, rand):
        want = np.asarray(jfn(variables, inp))
        got = fn(bridged, torch.as_tensor(inp)).numpy()
        assert got.shape == want.shape == (8, 10)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(float(np.abs(want).max()), 1.0))
    assert fn(state, x).shape == (8, 10)


def test_dryrun_world_of_two_prints_its_sections(capfd):
    lines = graft_entry.dryrun_multichip(2, device="cpu")
    printed = capfd.readouterr().out
    heads = [ln.split(":")[0] for ln in lines if ln.startswith("dryrun")]
    assert heads == ["dryrun dp", "dryrun pp", "dryrun fsdp", "dryrun grad accum"]
    assert heads == [f"dryrun {name}" for name in graft_entry.sections(2)]
    assert "kernel shard (16, 16)" in lines[[i for i, ln in enumerate(lines)
                                             if ln.startswith("dryrun fsdp")][0]]
    for ln in lines:
        assert ln in printed  # rank 0 printed every line


def test_no_gpu_no_fallback():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


@pytest.mark.slow
def test_dryrun_world_of_eight_runs_every_section():
    lines = graft_entry.dryrun_multichip(8, device="cpu")
    heads = [ln.split(":")[0] for ln in lines if ln.startswith("dryrun")]
    assert heads == [f"dryrun {name}" for name in graft_entry.SECTIONS]
    assert graft_entry.sections(8) == list(graft_entry.SECTIONS)
