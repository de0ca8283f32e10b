"""The speculative pieces of the PyTorch port against the JAX package's:
``ngram_draft``, ``speculative_accept``, ``rewind_cache_index`` and
``generate(speculative_k=...)``.

Toy models (vocab 64, d_model 32, 2 layers, 4 query and 2 KV heads,
window 64) whose float weights are drawn with numpy from a seed; both
packages get the same values through ``models/convert.py:from_jax_params``.

Tolerances and why:

- ``ngram_draft``, greedy ``speculative_accept`` and ``rewind_cache_index``
  are integer arithmetic: exact.
- Sampled ``speculative_accept``: the port's per-slot generators cannot
  draw JAX's threefry stream, so its arithmetic (``accept_with_draws``) is
  fed the JAX function's own draws, recomputed here from the same keys
  (``jax.random.split(key, 3)``, then ``uniform`` and ``gumbel``;
  ``jax.random.categorical`` is the argmax of logits plus Gumbel noise):
  the decisions and bonus tokens are exact, and the residual
  log-probabilities the bonus is drawn from are within 1e-6 of the JAX
  package's (float32 ``log_softmax`` of the filtered logits).
- ``generate(speculative_k=k)`` greedy: token-exact to the JAX package's
  ``generate`` with the same arguments and to the port's plain
  ``generate``, int8 and float32 weights (the port's float decode is
  within 1e-4 of the JAX package's, ``test_torch_serve_prefill.py``; no
  toy token is a near tie at that bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import sampling as js
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.models.generate import generate as jax_generate
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    KVCache,
    PagedKVCache,
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
    generate,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import sampling as ts
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    rewind_cache_index,
)
from test_torch_serve_prefill import TOY, Int8, _float_tree, _np

V = TOY["vocab_size"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jdraft(hist, hist_len, k, ngram):
    return np.asarray(js.ngram_draft(jnp.asarray(hist, jnp.int32),
                                     jnp.asarray(hist_len, jnp.int32), k, ngram))


def _histories(seed: int):
    """(hist, hist_len) rows over a small vocabulary (so matches happen):
    random rows at random lengths, one of length 1, one with no repeated
    token, one whose trailing n-gram also ends the history one step
    earlier (a match at the end)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    hist = rng.integers(0, 4, (12, 24))
    hist_len = rng.integers(2, 25, 12)
    hist_len[0] = 1
    hist[1, :10], hist_len[1] = np.arange(10, 20), 10
    hist[2, :8], hist_len[2] = [5, 5, 5, 5, 6, 6, 6, 6], 8
    return hist, hist_len


@pytest.mark.parametrize("ngram", [1, 3])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_ngram_draft_matches_jax(k, ngram):
    hist, hist_len = _histories(10 * k + ngram)
    got = ts.ngram_draft(torch.as_tensor(hist), torch.as_tensor(hist_len), k, ngram)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _jdraft(hist, hist_len, k, ngram))


def test_ngram_draft_copies_the_continuation_of_the_longest_match():
    """The JAX package's pins: a repeated trailing n-gram drafts what
    followed its earlier occurrence; no repeat falls back to the last
    token; a longer match beats a shorter one and, at equal length, the
    most recent occurrence wins."""
    hist = torch.tensor([[8, 9, 5, 6, 7, 8, 9, 0, 0, 0], [1, 2, 3, 4, 0, 0, 0, 0, 0, 0]])
    draft = ts.ngram_draft(hist, torch.tensor([7, 4]), k=3, ngram=2)
    assert draft.tolist() == [[5, 6, 7], [4, 4, 4]]
    hist = torch.tensor([[2, 3, 7, 1, 2, 3, 9, 2, 3, 0]])
    assert ts.ngram_draft(hist, torch.tensor([9]), k=1, ngram=2).tolist() == [[9]]


def test_greedy_tie_break_is_lowest_index():
    """The JAX package's pin: an exact logit tie resolves to the lowest
    vocabulary index in every greedy consumer — one-shot, per slot and the
    speculative verify — so speculation cannot change a greedy token."""
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0]])
    assert ts.greedy_token(logits).tolist() == [1, 0]
    assert ts.sample_logits(logits, None, 0.0).tolist() == [1, 0]
    assert ts.sample_logits_per_slot(logits, [None, None], 0.0).tolist() == [1, 0]
    emitted, _ = ts.speculative_accept(logits[:, None].repeat(1, 2, 1),
                                       torch.tensor([[1], [0]]), [None, None], 0.0)
    assert emitted.tolist() == [[1, 1], [0, 0]]


def test_speculative_accept_greedy_matches_jax():
    """Greedy: the accepted prefix is where the draft equals the
    verifier's greedy rollout, and the emitted block IS that rollout; half
    the rows draft the rollout itself so long prefixes are accepted."""
    rng = np.random.Generator(np.random.PCG64(3))
    b, k = 16, 4
    logits = rng.standard_normal((b, k + 1, V)).astype(np.float32)
    logits[1, 2, :] = logits[1, 2, 0]  # an exact tie: the lowest index wins
    greedy = logits.argmax(-1)
    draft = rng.integers(0, V, (b, k))
    draft[::2] = greedy[::2, :k]
    draft[2, 3] = (greedy[2, 3] + 1) % V  # rejected at the last draft
    want_e, want_n, _ = js.speculative_accept(jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
                                              jnp.zeros((b, 2), jnp.uint32), 0.0)
    gens = [torch.Generator().manual_seed(i) for i in range(b)]
    states = [g.get_state() for g in gens]
    emitted, n_acc = ts.speculative_accept(torch.as_tensor(logits), torch.as_tensor(draft),
                                           gens, 0.0)
    np.testing.assert_array_equal(emitted.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(want_n))
    assert int(n_acc.max()) == k and int(n_acc[2]) == 3
    assert all(torch.equal(g.get_state(), s) for g, s in zip(gens, states))


def test_speculative_accept_greedy_prefix_and_bonus():
    """The JAX package's unit pin: drafts accepted in full, rejected at
    position 1, and rejected at once."""
    logits = torch.full((1, 3, 8), -10.0)
    logits[0, 0, 3] = logits[0, 1, 5] = logits[0, 2, 1] = 0.0
    for draft, n, head in (([3, 5], 2, [3, 5, 1]), ([3, 4], 1, [3, 5]), ([0, 5], 0, [3])):
        emitted, n_acc = ts.speculative_accept(logits, torch.tensor([draft]), [None], 0.0)
        assert int(n_acc[0]) == n and emitted[0, :n + 1].tolist() == head


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0),
                                                     (1.3, 0, 0.9)])
def test_sampled_accept_with_jax_draws_matches_jax(temperature, top_k, top_p):
    """The port's sampled arithmetic fed the JAX function's draws: the
    same accepted lengths and emitted blocks (bonus tokens included), and
    residuals within 1e-6 of the JAX package's filtered log-softmax with
    the rejected token masked."""
    rng = np.random.Generator(np.random.PCG64(4))
    b, k = 64, 3
    # peaked rows (the draft carries most of the mass) beside flat ones,
    # so every accepted length occurs
    logits = rng.standard_normal((b, k + 1, V)).astype(np.float32)
    draft = rng.integers(0, V, (b, k))
    for r in range(0, b, 2):
        logits[r, np.arange(k), draft[r]] += rng.uniform(1.0, 6.0, k).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(100, 100 + b))
    want_e, want_n, _ = js.speculative_accept(jnp.asarray(logits),
                                              jnp.asarray(draft, jnp.int32), keys,
                                              temperature, top_k, top_p)
    split = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(split[:, 1])
    g = jax.vmap(lambda kk: jax.random.gumbel(kk, (V,)))(split[:, 2])
    emitted, n_acc, residual = ts.accept_with_draws(
        torch.as_tensor(logits), torch.as_tensor(draft), torch.as_tensor(np.array(u)),
        torch.as_tensor(np.array(g)), temperature, top_k, top_p)
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(emitted.numpy(), np.asarray(want_e))
    assert set(n_acc.tolist()) == set(range(k + 1))
    logp = jax.nn.log_softmax(js.filter_logits(jnp.asarray(logits) / temperature, top_k,
                                               top_p), axis=-1)
    want_n = np.asarray(want_n)
    want_res = np.array(logp)[np.arange(b), want_n]
    rej = want_n < k
    want_res[np.nonzero(rej)[0], draft[rej, want_n[rej]]] = -np.inf
    np.testing.assert_allclose(residual.numpy(), want_res, atol=1e-6, rtol=0)


def test_sampled_accept_point_mass_limits():
    """The rejection rule at its limits, on the port's own generators: a
    draft carrying all the mass is always accepted; one carrying none is
    rejected and the bonus never repeats it; each row's draws come from its
    own generator only."""
    k = 2
    sure = torch.full((1, k + 1, 8), -30.0)
    sure[0, 0, 3] = sure[0, 1, 5] = sure[0, 2, 1] = 0.0
    for seed in range(16):
        gen = [torch.Generator().manual_seed(seed)]
        e, n = ts.speculative_accept(sure, torch.tensor([[3, 5]]), gen, 1.0)
        assert int(n[0]) == 2 and e[0].tolist() == [3, 5, 1]
        e, n = ts.speculative_accept(sure, torch.tensor([[0, 5]]), gen, 1.0)
        assert int(n[0]) == 0 and int(e[0, 0]) != 0
    logits = torch.randn((2, k + 1, 8), generator=torch.Generator().manual_seed(1))
    draft = torch.tensor([[1, 2], [3, 4]])
    alone = ts.speculative_accept(logits[1:], draft[1:], [torch.Generator().manual_seed(9)], 1.0)
    pair = ts.speculative_accept(logits, draft, [torch.Generator().manual_seed(5),
                                                 torch.Generator().manual_seed(9)], 1.0)
    assert torch.equal(pair[0][1:], alone[0]) and torch.equal(pair[1][1:], alone[1])


def test_rewind_cache_index_matches_jax():
    """Only the per-row positions move, by the same steps as the JAX
    package's rewind of its ``cache_index`` counters; K/V stay."""
    steps = np.array([0, 2, 1, 3])
    index = np.array([9, 17, 4, 30])
    jtree = {"block_0": {"attn": {"cache_index": jnp.asarray(index, jnp.int32),
                                  "cached_key": jnp.ones((4, 8, 2, 4))}}}
    want = np.asarray(jt.rewind_cache_index(jtree, jnp.asarray(steps))["block_0"]["attn"]
                      ["cache_index"])
    cfg = TransformerConfig(**TOY)
    paged = TransformerConfig(**TOY, kv_pages=16, kv_page_size=8)
    for cache in (KVCache.zeros(cfg, 4, device="cpu"), PagedKVCache.zeros(paged, 4, device="cpu")):
        cache.index.copy_(torch.as_tensor(index))
        k = cache.k.clone()
        assert rewind_cache_index(cache, torch.as_tensor(steps)) is cache
        assert cache.index.tolist() == want.tolist()
        assert torch.equal(cache.k, k)
    cache = KVCache.zeros(cfg, 4, device="cpu")
    rewind_cache_index(cache, -2)  # a scalar moves every row
    assert cache.index.tolist() == [2, 2, 2, 2]


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX model, JAX params, port model holding the same
    weights): the toy int8 LM, and a float32 one."""
    int8 = Int8()
    tree = _float_tree(jt.TransformerConfig(**TOY), seed=3, scale=0.1)
    cfg = TransformerConfig(**TOY)
    model = TransformerLM(cfg)
    bind_params(model, from_jax_params(_np(tree), cfg, device="cpu"))
    return {"int8": (int8.jmodel(), int8.qtree, int8.model()),
            "float": (jt.TransformerLM(jt.TransformerConfig(**TOY)), tree, model)}


def _spec_prompts():
    """A repetitive row, so drafting fires, and a random one."""
    rep = np.tile([3, 4, 5], 3)[:8]
    rand = np.random.Generator(np.random.PCG64(5)).integers(0, V, 8)
    return np.stack([rep, rand])


@pytest.mark.parametrize("kind", ["int8", "float"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_generate_greedy_matches_jax_and_plain(models, kind, k):
    """Greedy speculative generate: token-exact to the JAX package's
    ``generate(speculative_k=k)`` and to the port's plain ``generate`` on a
    batch of 2 whose rows accept different lengths (the per-row rewind)."""
    jmodel, jparams, model = models[kind]
    prompt = _spec_prompts()
    want = jax_generate(jmodel, jparams, jnp.asarray(prompt, jnp.int32), 14, speculative_k=k)
    got = generate(model, None, prompt, 14, device="cpu", speculative_k=k)
    plain = generate(model, None, prompt, 14, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == plain.tolist()


def test_spec_generate_one_token_sampled_and_validation(models):
    """max_new_tokens 1 through the speculative path equals the plain one;
    sampled speculative generation stays in the vocabulary and is
    reproducible per generator seed, another seed changes it; the JAX
    package's argument checks."""
    _, _, model = models["int8"]
    prompt = [[3, 4, 5, 3, 4, 5, 3, 4]]
    assert (generate(model, None, prompt, 1, device="cpu", speculative_k=2).tolist()
            == generate(model, None, prompt, 1, device="cpu").tolist())
    kw = dict(max_new_tokens=12, temperature=0.9, speculative_k=2, device="cpu")
    a, b, c = (generate(model, None, prompt, generator=torch.Generator().manual_seed(s), **kw)
               for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(((a >= 0) & (a < V)).all())
    with pytest.raises(ValueError, match="speculative_k"):
        generate(model, None, prompt, 4, device="cpu", speculative_k=-1)
    with pytest.raises(ValueError, match="spec_ngram"):
        generate(model, None, prompt, 4, device="cpu", speculative_k=2, spec_ngram=0)
    for k, ngram in ((0, 3), (2, 0)):
        with pytest.raises(ValueError):
            ts.ngram_draft(torch.zeros((1, 4), dtype=torch.int64), torch.ones(1, dtype=torch.int64),
                           k, ngram)
