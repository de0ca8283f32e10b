"""The PyTorch port's ResNets against the JAX package's flax ones.

Weights from ``model.init`` go through ``from_jax_params`` (HWIO -> OIHW,
the ``batch_stats`` collection -> the norms' buffers); images are drawn
with numpy and fed NHWC to both. Cases: ``resnet18`` with the cifar stem
at 28x28x1 (the MNIST headline: SAME pads (0, 1) at 28 -> 14 and 14 -> 7,
(1, 1) at 7 -> 4), 32x32x3 and an odd 13x13x3; ``resnet50`` with the
imagenet stem at 64x64x3 (16 filters: the structure, not the width, is
under test; the full widths are counted). Each in train mode (logits and
the updated ``batch_stats``) and in eval mode (logits from the running
statistics).

Tolerances and why:

- float64 compute on both sides (JAX under ``jax_enable_x64``): the same
  function, so logits and statistics agree to ``1e-6`` of their largest
  entry (measured 3e-12 on train logits, 3.4e-8 on eval logits, where
  the running statistics leave the activations unnormalized) and one
  step's gradients to ``1e-8`` (measured 7e-9);
- float32 and bfloat16 against the float64 function: no farther from it
  than flax at the same dtype, by more than half again (plus 1e-6 of the
  largest logit in float32, 0.01 in bfloat16). With batch 4 the last
  stages normalize over as few as 16 values a channel and amplify
  rounding, and how much depends on the weights: against float64, flax's
  float32 logits are off by up to 1.2e-3 and the port's by 1.9e-4
  (``resnet50``, |logit| up to 2.3); in bfloat16 0.031 and 0.023
  (``resnet18`` at 28x28). A fixed tolerance
  against flax at the same dtype would measure flax's rounding as much as
  the port's. Float32 gradients are worse conditioned still (up to 21% of
  a parameter's largest entry, either framework), so gradients are held
  in float64. Every bound is relative to the largest entry or 1,
  whichever is larger (means near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax._src.config import enable_x64

from pytorch_distributed_training_tutorials_tpu.models import model_size as jax_model_size
from pytorch_distributed_training_tutorials_tpu.models import resnet as jr
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    from_jax_params,
    init_params,
    model_size,
    resnet18,
    resnet50,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm, same_pads
from pytorch_distributed_training_tutorials_tpu_torch.train import trainer as ttrainer

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SLACK = {"f32": 1e-6, "bf16": 0.01}  # the floors of the float32 / bfloat16 bounds
CASES = {
    # name: (arch, stem, H, C, num_filters)
    "r18-cifar-28x28x1": ("resnet18", "cifar", 28, 1, 64),
    "r18-cifar-32x32x3": ("resnet18", "cifar", 32, 3, 64),
    "r18-cifar-13x13x3": ("resnet18", "cifar", 13, 3, 64),
    "r50-imagenet-64x64x3": ("resnet50", "imagenet", 64, 3, 16),
}
# (case, dtype) pairs: float64 everywhere, float32 on the imagenet stem
# and the headline's input, bfloat16 (the headline's dtype) on the
# headline's input
RUNS = [(c, "f64") for c in CASES] + [
    ("r18-cifar-28x28x1", "f32"), ("r50-imagenet-64x64x3", "f32"),
    ("r18-cifar-28x28x1", "bf16")]
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build(case: str, dtype: str, seed: int = 0):
    """(flax model, its variables, port model loaded from them, images)."""
    arch, stem, h, c, nf = CASES[case]
    jdt, tdt = DTYPES[dtype]
    jm = getattr(jr, arch)(num_classes=10, stem=stem, num_filters=nf, dtype=jdt)
    x = np.random.Generator(np.random.PCG64(seed)).random((BATCH, h, h, c), dtype=np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    tm = {"resnet18": resnet18, "resnet50": resnet50}[arch](
        num_classes=10, stem=stem, num_filters=nf, dtype=tdt, in_channels=c)
    tm.load_state_dict(from_jax_params(to_np(v["params"]), tm, "cpu",
                                       batch_stats=to_np(v["batch_stats"])))
    if dtype == "f64":  # the statistics float64 too, as flax's become
        for m in tm.modules():
            if isinstance(m, BatchNorm):
                m.mean, m.var = m.mean.double(), m.var.double()
    return jm, v, tm, x


def scale(want: np.ndarray) -> float:
    return max(float(np.abs(want).max()), 1.0)


def err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def flax_outputs(case: str, dtype: str) -> dict:
    """Train logits, the updated statistics and eval logits of flax at
    ``dtype`` (the port's model and images beside them)."""
    jdt, _ = DTYPES[dtype]
    with enable_x64(dtype == "f64"):
        jm, v, tm, x = build(case, dtype)
        xj = jnp.asarray(x).astype(jdt)
        out, upd = jm.apply(v, xj, mutable=["batch_stats"])
        eval_out = jm.apply({"params": v["params"], "batch_stats": upd["batch_stats"]}, xj,
                            train=False)
        stats = from_jax_params(to_np(v["params"]), tm, "cpu",
                                batch_stats=to_np(upd["batch_stats"]))
        return {"train": np.asarray(out, np.float64), "eval": np.asarray(eval_out, np.float64),
                "stats": {k: t.double().numpy() for k, t in stats.items()
                          if k.endswith((".mean", ".var"))},
                "model": tm, "x": x}


@pytest.fixture(scope="module")
def reference():
    """flax in float64 per case, computed once."""
    cache: dict = {}

    def get(case: str) -> dict:
        if case not in cache:
            cache[case] = flax_outputs(case, "f64")
        return cache[case]

    return get


@pytest.mark.parametrize("case,dtype", RUNS)
def test_logits_and_batch_stats_match_flax(case, dtype, reference):
    ref = reference(case)
    flax = ref if dtype == "f64" else flax_outputs(case, dtype)
    tm, x = flax["model"], flax["x"]
    xt = torch.from_numpy(x).to(DTYPES[dtype][1])
    with torch.no_grad():
        got = {"train": tm(xt, train=True).double().numpy()}
        got["stats"] = {k: t.double().numpy() for k, t in tm.state_dict().items()
                        if k.endswith((".mean", ".var"))}
        got["eval"] = tm(xt, train=False).double().numpy()  # the running statistics normalize

    def bound(key, want, flax_value):
        if dtype == "f64":
            return 1e-6 * scale(want)
        return 1.5 * err(flax_value, want) + SLACK[dtype] * scale(want)

    for key in ("train", "eval"):
        e, b = err(got[key], ref[key]), bound(key, ref[key], flax[key])
        assert e <= b, f"{key} logits: {e} > {b} (flax at {dtype}: {err(flax[key], ref[key])})"
    for k, want in ref["stats"].items():
        e, b = err(got["stats"][k], want), bound(k, want, flax["stats"][k])
        assert e <= b, f"{k}: {e} > {b}"


def test_same_padding_rule():
    # 3x3 stride 2: even inputs pad (0, 1), odd (1, 1); stride 1 pads (1, 1)
    assert [same_pads(n, 3, 2) for n in (28, 14, 7, 13, 32)] == [
        (0, 1), (0, 1), (1, 1), (1, 1), (0, 1)]
    assert same_pads(28, 3, 1) == (1, 1) and same_pads(28, 1, 2) == (0, 0)
    # the output sizes along the MNIST headline's path
    tm = resnet18(num_classes=10, stem="cifar", num_filters=4, in_channels=1)
    tm.load_state_dict(init_params(tm, 0, "cpu"))
    x = torch.rand(2, 28, 28, 1)
    feats = tm.stage0(x, train=False)
    assert feats.shape == (2, 8, 14, 14)
    y = feats
    for group, hw in zip(tm.layer_groups[2:], (7, 4)):
        for block in group:
            y = block(y, train=False)
        assert y.shape[-1] == hw


def test_one_step_gradients_match_flax():
    """Float64 compute on both sides: the loss and every parameter's
    gradient within 1e-8 of its largest entry."""
    y = np.random.Generator(np.random.PCG64(5)).integers(0, 10, BATCH).astype(np.int32)
    with enable_x64(True):
        jm, v, tm, x = build("r18-cifar-28x28x1", "f64")

        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                              jnp.asarray(x, jnp.float64), mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(out, jnp.asarray(y)).mean()

        loss64, g64 = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
        loss64, g64 = float(loss64), to_np(g64)
    loss = ttrainer._compute_loss("cross_entropy", tm(torch.from_numpy(x).double(), train=True),
                                  torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    np.testing.assert_allclose(float(loss.detach()), loss64, rtol=1e-10)
    want = from_jax_params(g64, tm, "cpu", batch_stats=to_np(v["batch_stats"]))
    for (name, _), g in zip(tm.named_parameters(), grads):
        ref = want[name].double().numpy()
        assert err(g, ref) <= 1e-8 * float(np.abs(ref).max()), name


def test_parameter_count_pin_and_stage_cut():
    full = resnet50()
    assert model_size(full) == 25_557_032
    jax_shapes = jax.eval_shape(jr.resnet50().init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))["params"]
    assert jax_model_size(jax_shapes) == model_size(full)
    # the cut falls after layer group 2 (split_after=2): stem + groups 0-1
    # on stage 0, groups 2-3 + fc on stage 1; the parameter count is
    # invariant under it
    stage_of = {n: full.stage_partition(n) for n, _ in full.named_parameters()}
    jm = jr.resnet50()
    for n, s in stage_of.items():
        top = n.split(".")
        jax_key = (f"layer_groups_{top[1]}_{top[2]}" if top[0] == "layer_groups" else top[0])
        assert jm.stage_partition(jax_key) == s, n
    sizes = [sum(p.numel() for n, p in full.named_parameters() if stage_of[n] == s)
             for s in (0, 1)]
    assert sum(sizes) == 25_557_032 and min(sizes) > 0
    small = resnet18(num_classes=10, stem="cifar", num_filters=4, in_channels=1)
    small.load_state_dict(init_params(small, 1, "cpu"))
    x = torch.rand(2, 28, 28, 1)
    with torch.no_grad():
        assert torch.equal(small.stage1(small.stage0(x, False), False), small(x, train=False))
    with pytest.raises(ValueError, match="unknown param key"):
        small.stage_partition("head.weight")


def test_init_params_distributions():
    tm = resnet18(num_classes=10, stem="cifar", in_channels=1)
    sd = init_params(tm, seed=3, device="cpu")
    w = sd["layer_groups.1.0.convs.0.weight"]  # OIHW (128, 64, 3, 3): fan_in 576
    assert abs(float(w.std()) - (1 / 576) ** 0.5) < 0.05 * (1 / 576) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 576) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(sd["bn1.scale"], torch.ones(64)) and not sd["fc.bias"].any()
    assert torch.equal(sd["layer_groups.0.0.norms.1.var"], torch.ones(64))
    assert torch.equal(init_params(tm, 3, "cpu")["fc.weight"], sd["fc.weight"])


def test_linear_and_mlp_models_match_flax():
    """The linear and MLP twins through the same bridge: float32 outputs
    within 1e-6 (one or two small matmuls)."""
    from pytorch_distributed_training_tutorials_tpu.models import mlp as jmlp
    from pytorch_distributed_training_tutorials_tpu_torch.models import mlp as tmlp

    rng = np.random.Generator(np.random.PCG64(3))
    for jm, tm, width in (
        (jmlp.LinearRegressor(), tmlp.LinearRegressor(), 20),
        (jmlp.SampleModel(), tmlp.SampleModel(), 32),
        (jmlp.MLP(features=(16, 8, 1)), tmlp.MLP(features=(16, 8, 1), in_dim=12), 12),
        (jmlp.ToyModel(in_dim=40), tmlp.ToyModel(in_dim=40), 40),
    ):
        x = rng.standard_normal((5, width)).astype(np.float32)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        tm.load_state_dict(from_jax_params(to_np(v["params"]), tm, "cpu"))
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=1e-6)
    toy = tmlp.ToyModel()
    assert [toy.stage_partition(n) for n, _ in toy.named_parameters()] == [0, 0, 1, 1]
