"""The port's fused AdamW (its plain version, on the CPU) against the JAX
package's fused AdamW (the Pallas kernel in interpret mode) and
``optax.adamw``.

Parameters and 25 steps of gradients are drawn with numpy from a seed,
over leaf shapes that hit the JAX kernel's (rows, 128) packing edges
(rank 0, a vector with a lane tail, a matrix off the tile grid) and
gradients across eight orders of magnitude. Tolerance: the parameters
within two float32 ulps (``rtol 2.5e-7, atol 1e-7``) and the first
moments within ``1e-6`` of each leaf's largest (``b1 m + (1 - b1) g``
cancels, and XLA may contract it into an FMA), far tighter than the JAX test's ``atol 2e-5, rtol 2e-4``:
the same float32 operations, the port in optax's order; only the float32
``pow`` of the bias correction, the port's multiply by its reciprocal
(optax divides) and the association of ``(1 - b2) g g`` may round
differently, and over 25 steps such a rounding reaches a
parameter's last bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.ops.fused_optim import fused_adamw as jax_fused_adamw
from pytorch_distributed_training_tutorials_tpu_torch.ops import fused_optim
from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw
from helpers import requires_pallas_interpret

pytestmark = requires_pallas_interpret

SHAPES = [(), (300,), (129, 130), (17, 64)]
STEPS = 25


def _draws(seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
              for s in SHAPES] for _ in range(STEPS)]
    return params, grads


def _jax_run(tx, params, grads):
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)

    @jax.jit
    def step(p, s, g):
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    for g in grads:
        jp, state = step(jp, state, [jnp.asarray(x) for x in g])
    mu = state.mu if hasattr(state, "mu") else state[0].mu  # fused / optax chain
    return [np.asarray(x) for x in jp], [np.asarray(x) for x in mu]


def _port_run(params, grads):
    tp = [torch.tensor(p) for p in params]
    tx = fused_adamw(3e-4, weight_decay=0.01)
    state = tx.init(tp)
    before = fused_optim.fused_adamw.launches
    for g in grads:
        tx.update_(tp, [torch.tensor(x) for x in g], state)
    assert fused_optim.fused_adamw.launches == before  # CPU: the plain version
    assert state.count == len(grads)
    return [p.numpy() for p in tp], [m.numpy() for m in state.mu]


@pytest.mark.parametrize("reference", ["jax_fused_adamw", "optax_adamw"])
def test_25_steps_match_jax(reference):
    params, grads = _draws()
    tx = (jax_fused_adamw(3e-4, weight_decay=0.01, interpret=True)
          if reference == "jax_fused_adamw" else optax.adamw(3e-4, weight_decay=0.01))
    want_p, want_mu = _jax_run(tx, params, grads)
    got_p, got_mu = _port_run(params, grads)
    for a, b in zip(got_p, want_p):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=2.5e-7)
    for a, b in zip(got_mu, want_mu):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * float(np.abs(b).max()))


def test_plain_path_is_the_foreach_adamw_bitwise():
    """On the CPU the fused optimizer is the plain AdamW of train/optim.py
    (the version the kernel is held to on the card), bitwise."""
    params, grads = _draws(seed=2)
    a = [torch.tensor(p) for p in params]
    b = [torch.tensor(p) for p in params]
    tx, plain = fused_adamw(1e-3), adamw(1e-3)
    sa, sb = tx.init(a), plain.init(b)
    for g in grads[:5]:
        tx.update_(a, [torch.tensor(x) for x in g], sa)
        plain.update_(b, [torch.tensor(x) for x in g], sb)
    for x, y in zip(a + sa.mu + sa.nu, b + sb.mu + sb.nu):
        assert torch.equal(x, y)


def test_refusals():
    with pytest.raises(TypeError, match="static float"):
        fused_adamw(lambda step: 1e-3)
    # a mask must name every leaf (the JAX mask is a pytree of the params)
    named = {"a": torch.zeros(3), "b": torch.zeros(2)}
    with pytest.raises(ValueError, match="no value for"):
        fused_adamw(1e-3, mask={"a": True}).init(named)
    tx = fused_adamw(1e-3)
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="leaf count"):
        tx.update_(p, [torch.zeros(3), torch.zeros(3)], tx.init(p))
    meta = [torch.zeros(3, device="meta")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tx.update_(meta, [torch.zeros(3, device="meta")], tx.init(meta))
