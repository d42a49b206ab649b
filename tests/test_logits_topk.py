"""The fused logits + top-K + logsumexp path (ops/logits_topk.py).

The Pallas kernel runs here in interpret mode: its tiling over rows and
vocabulary, the masked vocabulary tail, the running top-k set and its
tie rule, and the online logsumexp are the same code the GPU compiles.
It is compared with the plain XLA reference, which in turn is checked
against numpy.  The choice of path by platform, the dp ``shard_map``
wrapper on the 8-virtual-device mesh, and beam search / greedy decode
through the kernel complete the picture.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from vae_captioning.ops import logits_topk as lt
from vae_captioning.ops.decoding import beam_search

# small blocks so a few rows and a few hundred columns span several
# row blocks, vocabulary tiles and H chunks
BLOCKS = (16, 128, 32, 4, 2)


_PALLAS = lt.logits_top_k_pallas


def kernel(h, w, b, k, blocks=BLOCKS, min_blocks=lt._MIN_BLOCKS):
    return _PALLAS(h, w, b, k, interpret=True, blocks=blocks,
                   min_blocks=min_blocks)


def _problem(M, H, V, seed=0):
    rng = np.random.default_rng(seed)
    h = jnp.asarray(rng.normal(size=(M, H)), jnp.float32)
    w = jnp.asarray(rng.normal(0, H ** -0.5, size=(H, V)), jnp.float32)
    b = jnp.asarray(rng.normal(0, 0.5, size=(V,)), jnp.float32)
    return h, w, b


def _assert_same(got, want):
    (v1, i1, l1), (v2, i2, l2) = got, want
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("min_blocks", [1, lt._MIN_BLOCKS],
                         ids=["one-split", "vocab-split"])
@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("shape", [
    (16, 64, 128),     # one row block, one vocabulary tile
    (24, 64, 300),     # V not a power of two: masked tail tile
    (40, 64, 1000),    # several row blocks and tiles
    (8, 32, 11),       # V smaller than one tile
    (33, 96, 513),     # row padding + a 1-column tail tile
    (64, 64, 2048),    # exact multiples everywhere
])
def test_kernel_matches_xla(k, shape, min_blocks):
    """min_blocks=1 runs each row block over the whole vocabulary;
    the default splits the vocabulary over blocks (few rows here) and
    merges the splits' top-k and logsumexp."""
    h, w, b = _problem(*shape, seed=sum(shape) + k)
    got = kernel(h, w, b, k, min_blocks=min_blocks)
    assert got[0].shape == got[1].shape == (shape[0], k)
    assert got[2].shape == (shape[0],)
    _assert_same(got, lt.logits_top_k_xla(h, w, b, k))


@pytest.mark.parametrize("min_blocks", [1, lt._MIN_BLOCKS])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_kernel_ties_break_to_lowest_index(k, min_blocks):
    """Equal logits across vocabulary tiles (and splits) and inside one
    tile: the lower index wins, as lax.top_k."""
    M, H, V = 16, 32, 400
    h = jnp.zeros((M, H), jnp.float32)
    w = jnp.zeros((H, V), jnp.float32)
    b = np.zeros((V,), np.float32)
    b[[5, 130, 131, 260, 399]] = 2.0     # tie at the top across tiles
    b[[7, 9, 300]] = 1.0
    b = jnp.asarray(b)
    got = kernel(h, w, b, k, min_blocks=min_blocks)
    want = lt.logits_top_k_xla(h, w, b, k)
    _assert_same(got, want)
    np.testing.assert_array_equal(
        np.asarray(got[1])[0], [5, 130, 131, 260, 399, 7, 9, 300, 0, 1][:k])


@pytest.mark.parametrize("bm", [16, 32])
@pytest.mark.parametrize("M", [1, 17, 33])
def test_kernel_row_padding(bm, M):
    h, w, b = _problem(M, 64, 200, seed=M)
    got = kernel(h, w, b, 3, blocks=(bm, 64, 32, 4, 2))
    assert got[0].shape == (M, 3)
    _assert_same(got, lt.logits_top_k_xla(h, w, b, 3))


@pytest.mark.parametrize("V", [10, 127, 128, 129])
def test_kernel_vocab_tail(V):
    """Columns past V are masked: never selected, never in the sum."""
    h, w, b = _problem(16, 32, V, seed=V)
    got = kernel(h, w, b, 3, blocks=(16, 128, 32, 4, 2))
    assert int(np.asarray(got[1]).max()) < V
    _assert_same(got, lt.logits_top_k_xla(h, w, b, 3))


def test_kernel_bias_matters():
    h, w, b = _problem(16, 32, 256)
    hot = b.at[77].set(100.0)
    _, idx, lse = kernel(h, w, hot, 1)
    assert (np.asarray(idx)[:, 0] == 77).all()
    np.testing.assert_allclose(np.asarray(lse),
                               np.asarray(lt.logits_top_k_xla(h, w, hot,
                                                              1)[2]),
                               atol=1e-5)


def test_kernel_rejects_bad_shapes():
    h, w, b = _problem(16, 48, 100)
    with pytest.raises(ValueError, match="multiple"):
        kernel(h, w, b, 3, blocks=(16, 128, 32, 4, 2))
    h, w, b = _problem(16, 32, 2)
    with pytest.raises(ValueError, match="exceeds"):
        kernel(h, w, b, 3)


@pytest.mark.parametrize("row_blocks,want", [
    (1, (90, 1)),      # a handful of rows: one tile per split
    (32, (9, 10)),     # greedy at batch 4,096 with 128-row blocks
    (96, (3, 30)),     # beam 3 at batch 4,096
    (768, (1, 90)),    # beam 3 at batch 32,768: rows alone fill the card
])
def test_vocab_splits(row_blocks, want):
    splits, per = lt.vocab_splits(row_blocks, 90)
    assert (splits, per) == want
    assert splits * row_blocks >= min(lt._MIN_BLOCKS, 90 * row_blocks)
    assert (splits - 1) * per < 90 <= splits * per      # none empty


@pytest.mark.parametrize("k", [1, 3, 10])
def test_kernel_lowers_for_cuda(k):
    """The Pallas→Triton lowering (which primitives the GPU route
    supports) runs without a card; Triton's compile is left to it."""
    text = jax.jit(lambda h, w, b: lt.logits_top_k_pallas(h, w, b, k)).trace(
        jax.ShapeDtypeStruct((4096, 512), jnp.float32),
        jax.ShapeDtypeStruct((512, 11500), jnp.float32),
        jax.ShapeDtypeStruct((11500,), jnp.float32)).lower(
            lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()


# ---------------------------------------------------------------- reference

@pytest.mark.parametrize("k", [1, 3, 10])
def test_top_k_logsumexp_matches_numpy(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(12, 500)).astype(np.float32)
    x[3, [4, 40, 400]] = 9.0                      # a tie
    vals, idx, lse = lt.top_k_logsumexp(jnp.asarray(x), k)
    order = np.argsort(-x, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(idx), order)
    np.testing.assert_allclose(np.asarray(vals),
                               np.take_along_axis(x, order, 1), rtol=1e-6)
    m = x.max(1, keepdims=True)
    want = (m + np.log(np.exp(x - m).sum(1, keepdims=True)))[:, 0]
    np.testing.assert_allclose(np.asarray(lse), want, rtol=1e-5)


def test_xla_reference_uses_bf16_operands():
    h, w, b = _problem(8, 64, 50)
    v, _, _ = lt.logits_top_k_xla(h, w, b, 1)
    want = (np.asarray(h.astype(jnp.bfloat16), np.float32)
            @ np.asarray(w.astype(jnp.bfloat16), np.float32) + np.asarray(b))
    np.testing.assert_allclose(np.asarray(v)[:, 0], want.max(1), rtol=1e-5)
    v32, _, _ = lt.logits_top_k_xla(h, w, b, 1, jnp.float32)
    with jax.default_matmul_precision("highest"):
        exact = np.asarray(jnp.dot(h, w) + b)
    np.testing.assert_allclose(np.asarray(v32)[:, 0], exact.max(1),
                               rtol=1e-5)


# ---------------------------------------------------------------- dispatch

@pytest.mark.parametrize("platform,dtype,want", [
    ("gpu", jnp.bfloat16, True),
    ("gpu", "bfloat16", True),
    ("gpu", jnp.float32, False),
    ("cpu", jnp.bfloat16, False),
])
def test_use_kernel_by_platform_and_dtype(platform, dtype, want):
    assert lt.use_kernel(dtype, platform) is want


def test_dispatch_takes_xla_on_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel called on the CPU")
    monkeypatch.setattr(lt, "logits_top_k_pallas", boom)
    h, w, b = _problem(8, 32, 40)
    _assert_same(lt.logits_top_k(h, w, b, 3), lt.logits_top_k_xla(h, w, b, 3))


@pytest.fixture()
def interpreted(monkeypatch):
    monkeypatch.setattr(lt, "logits_top_k_pallas",
                        functools.partial(kernel, blocks=BLOCKS))


@pytest.mark.parametrize("k", [1, 3])
def test_shard_map_wrapper_matches_single(interpreted, k):
    assert len(jax.devices()) == 8
    mesh = Mesh(np.asarray(jax.devices()), ("dp",))
    h, w, b = _problem(64, 64, 300, seed=k)
    got = jax.jit(lambda h, w, b: lt.logits_top_k(
        h, w, b, k, kernel=True, mesh=mesh))(h, w, b)
    _assert_same(got, lt.logits_top_k(h, w, b, k, kernel=True))
    _assert_same(got, lt.logits_top_k_xla(h, w, b, k))


def test_shard_map_wrapper_uneven_rows_run_unsharded(interpreted):
    mesh = Mesh(np.asarray(jax.devices()), ("dp",))
    h, w, b = _problem(20, 64, 100)                # 20 % 8 != 0
    _assert_same(lt.logits_top_k(h, w, b, 3, kernel=True, mesh=mesh),
                 lt.logits_top_k_xla(h, w, b, 3))


# ---------------------------------------------------------------- decoding

def _tiny_lm(V=40, H=32, E=16, seed=0):
    rng = np.random.default_rng(seed)
    emb = jnp.asarray(rng.normal(size=(V, E)), jnp.float32)
    w_in = jnp.asarray(rng.normal(0, 0.4, size=(E + H, H)), jnp.float32)
    w_out = jnp.asarray(rng.normal(0, 0.5, size=(H, V)), jnp.float32)
    b_out = jnp.asarray(rng.normal(0, 0.5, size=(V,)), jnp.float32)

    def hidden(carry, tokens):
        h = jnp.tanh(jnp.concatenate([emb[tokens], carry], -1) @ w_in)
        return h, h

    def step_fn(carry, tokens):
        carry, h = hidden(carry, tokens)
        logits = jax.lax.dot_general(
            h.astype(jnp.bfloat16), w_out.astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        return carry, logits + b_out

    def step_topk_fn(k):
        def fn(carry, tokens):
            carry, h = hidden(carry, tokens)
            v, i, l = lt.logits_top_k(h, w_out, b_out, k, kernel=True)
            return carry, v, i, l
        return fn

    return step_fn, step_topk_fn


@pytest.mark.parametrize("beam", [2, 3])
def test_beam_search_through_kernel_matches_logits_path(interpreted, beam):
    B, H = 4, 32
    step_fn, step_topk_fn = _tiny_lm(H=H)
    carry = jnp.asarray(np.random.default_rng(1).normal(size=(B, H)),
                        jnp.float32)
    kw = dict(beam_size=beam, bos_id=1, eos_id=2, max_len=6)
    a = beam_search(step_fn, carry, B, **kw)
    b = beam_search(step_fn, carry, B, step_topk_fn=step_topk_fn(beam), **kw)
    np.testing.assert_array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
    np.testing.assert_allclose(np.asarray(a.scores), np.asarray(b.scores),
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["beam_search", "greedy"])
def test_decode_fns_kernel_path_matches_xla(interpreted, mode):
    """make_decode_fns through the kernel (interpret mode) decodes the
    same tokens as the plain XLA path on a tiny CVAE."""
    from vae_captioning.config import Config
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_decode_fns
    from vae_captioning.train import init_model

    cfg = Config(embed_size=16, latent_size=8, encoder_hidden=32,
                 decoder_hidden=32, gen_z_samples=4, prior="AG",
                 use_c_v=True, gen_max_len=6, beam_size=3)
    cfg.vocab_size = 40
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(36)])
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(8, 4096)), jnp.float32)
    c_v = rng.random((8, 90)).astype(np.float32)
    c_v = jnp.asarray(c_v / c_v.sum(-1, keepdims=True))
    key = jax.random.PRNGKey(5)
    out = {}
    for use in (True, False):
        fn = make_decode_fns(model, cfg, vocab, kernel=use)[mode]
        out[use] = jax.tree.map(np.asarray, fn(params, feats, c_v, key))
    a, b = out[True], out[False]
    if mode == "greedy":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], atol=1e-5)
