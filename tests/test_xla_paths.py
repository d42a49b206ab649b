"""The plain-XLA paths that replaced the hand-written kernels, against
numpy oracles: the masked teacher-forcing LSTM scan, the AG and GMM
posterior heads, the latent draw and its projection, the CE loss, and
the beam-search gathers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vae_captioning.models.cvae import compute_loss
from vae_captioning.models.encoder import Encoder
from vae_captioning.ops import distributions as dist
from vae_captioning.ops.decoding import _gather_beams
from vae_captioning.ops.layers import dense
from vae_captioning.ops.lstm import LSTMStack


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def np_lstm(xs, lengths, kernel, bias, H):
    """dynamic_rnn semantics: gates [x, h] @ W + b in (i, f, g, o) order,
    forget bias 1; state frozen and output zero past each length."""
    B, T, _ = xs.shape
    c = np.zeros((B, H), np.float64)
    h = np.zeros((B, H), np.float64)
    out = np.zeros((B, T, H), np.float64)
    for t in range(T):
        g = np.concatenate([xs[:, t], h], -1) @ kernel + bias
        i, f, gg, o = np.split(g, 4, axis=-1)
        nc = _sigmoid(f + 1.0) * c + _sigmoid(i) * np.tanh(gg)
        nh = _sigmoid(o) * np.tanh(nc)
        live = (t < lengths)[:, None]
        c, h = np.where(live, nc, c), np.where(live, nh, h)
        out[:, t] = np.where(live, nh, 0.0)
    return (c, h), out


@pytest.mark.parametrize("lengths", [[6, 6, 6], [6, 3, 1], [2, 5, 4]])
def test_lstm_scan_matches_numpy(lengths):
    B, T, E, H = 3, 6, 5, 7
    rng = np.random.default_rng(sum(lengths))
    xs = rng.normal(size=(B, T, E)).astype(np.float32)
    stack = LSTMStack(H)
    params = stack.init(jax.random.PRNGKey(0), stack.zero_carry(B),
                        jnp.asarray(xs), jnp.asarray(lengths))["params"]
    (carry,), out = stack.apply({"params": params}, stack.zero_carry(B),
                                jnp.asarray(xs), jnp.asarray(lengths))
    cell = params["cell_0"]
    (c, h), want = np_lstm(xs, np.asarray(lengths),
                           np.asarray(cell["kernel"], np.float64),
                           np.asarray(cell["bias"], np.float64), H)
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)
    np.testing.assert_allclose(np.asarray(carry[0]), c, atol=2e-5)
    np.testing.assert_allclose(np.asarray(carry[1]), h, atol=2e-5)


def test_lstm_scan_time_major_and_no_outputs():
    B, T, E, H = 4, 5, 3, 6
    xs = jnp.asarray(np.random.default_rng(0).normal(size=(B, T, E)),
                     jnp.float32)
    lengths = jnp.asarray([5, 2, 4, 1])
    stack = LSTMStack(H)
    v = stack.init(jax.random.PRNGKey(1), stack.zero_carry(B), xs, lengths)
    c1, bm = stack.apply(v, stack.zero_carry(B), xs, lengths)
    c2, tm = stack.apply(v, stack.zero_carry(B), xs, lengths,
                         time_major_out=True)
    c3, none = stack.apply(v, stack.zero_carry(B), xs, lengths,
                           collect_outputs=False)
    np.testing.assert_array_equal(np.asarray(bm),
                                  np.asarray(tm).swapaxes(0, 1))
    assert none is None
    for a, b in ((c1, c2), (c1, c3)):
        np.testing.assert_array_equal(np.asarray(a[0][1]),
                                      np.asarray(b[0][1]))


def test_lstm_dropout_path_masks_and_scales():
    B, T, E, H = 3, 5, 4, 8
    xs = jnp.asarray(np.random.default_rng(2).normal(size=(B, T, E)),
                     jnp.float32)
    lengths = jnp.asarray([5, 3, 1])
    stack = LSTMStack(H, output_keep_rate=0.5)
    v = stack.init(jax.random.PRNGKey(0), stack.zero_carry(B), xs, lengths)
    _, ref = stack.apply(v, stack.zero_carry(B), xs, lengths)
    carry, out = stack.apply(v, stack.zero_carry(B), xs, lengths,
                             dropout_key=jax.random.PRNGKey(9))
    out, ref = np.asarray(out), np.asarray(ref)
    assert np.all(out[1, 3:] == 0) and np.all(out[2, 1:] == 0)
    kept = out != 0
    assert 0.2 < kept[0].mean() < 0.8
    # the first step sees no dropped state yet: kept units are 2x
    np.testing.assert_allclose(out[:, 0][kept[:, 0]],
                               2 * ref[:, 0][kept[:, 0]], rtol=1e-5)


def _encoder_problem(prior, K, L, B=5, H=6, seed=0):
    rng = np.random.default_rng(seed)
    enc = Encoder(vocab_size=20, embed_size=4, hidden_size=H, latent_size=L,
                  prior=prior, num_clusters=K, use_c_v=True)
    h = rng.normal(size=(B, H)).astype(np.float32)
    w = rng.normal(0, 0.3, size=(H, 2 * K * L)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(2 * K * L,)).astype(np.float32)
    cv = rng.random((B, K)).astype(np.float32)
    cv /= cv.sum(-1, keepdims=True)
    return enc, h, w, b, cv


@pytest.mark.parametrize("K,L", [(7, 150), (90, 3)])
def test_ag_heads_match_numpy(K, L):
    enc, h, w, b, cv = _encoder_problem("AG", K, L)
    mean, std = enc._posterior({"kernel": jnp.asarray(w),
                                "bias": jnp.asarray(b)},
                               jnp.asarray(h), jnp.asarray(cv), None)
    q = h.astype(np.float64) @ w + b
    means = q[:, :K * L].reshape(-1, K, L)
    stds = np.exp(q[:, K * L:]).reshape(-1, K, L)
    np.testing.assert_allclose(np.asarray(mean),
                               np.einsum("bk,bkl->bl", cv, means),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(std),
                               np.einsum("bk,bkl->bl", cv, stds),
                               rtol=2e-5, atol=2e-5)


def test_gmm_head_selects_one_cluster_exactly():
    K, L = 6, 4
    enc, h, w, b, cv = _encoder_problem("GMM", K, L)
    p = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    mean, std = enc._posterior(p, jnp.asarray(h), jnp.asarray(cv),
                               jax.random.PRNGKey(3))
    q = np.asarray(dense(p, jnp.asarray(h)))
    means = q[:, :K * L].reshape(-1, K, L)
    stds = np.exp(q[:, K * L:]).reshape(-1, K, L)
    for r in range(h.shape[0]):
        hit = [c for c in range(K) if np.array_equal(np.asarray(mean[r]),
                                                     means[r, c])]
        assert len(hit) == 1, r
        np.testing.assert_allclose(np.asarray(std[r]), stds[r, hit[0]],
                                   rtol=1e-6)


def test_latent_draw_and_projection_match_numpy():
    B, KZ, L, E = 6, 5, 4, 3
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(B, L)).astype(np.float32)
    std = np.exp(rng.normal(0, 0.3, size=(B, L))).astype(np.float32)
    w = rng.normal(size=(KZ * L, E)).astype(np.float32)
    b = rng.normal(size=(E,)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    z = dist.sample_gaussian(key, jnp.asarray(mean), jnp.asarray(std), KZ)
    eps = np.asarray(jax.random.normal(key, (B, KZ, L)))
    want_z = mean[:, None] + std[:, None] * eps
    np.testing.assert_allclose(np.asarray(z), want_z, rtol=1e-6, atol=1e-6)
    proj = dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                 z.reshape(B, -1))
    np.testing.assert_allclose(np.asarray(proj),
                               want_z.reshape(B, -1) @ w + b, rtol=1e-4,
                               atol=1e-4)


def test_decode_z_at_std_zero_is_the_projected_mean():
    """Decode std 0 draws nothing: the z input is the projected prior
    mean, the limit of the draw as std → 0."""
    from vae_captioning.models.decoder import Decoder
    B, KZ, L, E = 6, 5, 4, 3
    rng = np.random.default_rng(5)
    w = rng.normal(size=(KZ * L, E)).astype(np.float32)
    b = rng.normal(size=(E,)).astype(np.float32)
    mean = rng.normal(size=(B, L)).astype(np.float32)
    params = {"z_rnn": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    dec = Decoder(vocab_size=10, embed_size=E, hidden_size=4)
    key = jax.random.PRNGKey(2)
    got = dec.gen_z_embedding(params, key, jnp.asarray(mean), 0.0, KZ)
    want = mean @ w.reshape(KZ, L, E).sum(0) + b
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)
    tiny = dec.gen_z_embedding(params, key, jnp.asarray(mean), 1e-6, KZ)
    np.testing.assert_allclose(np.asarray(got), np.asarray(tiny), atol=1e-4)


@pytest.mark.parametrize("time_major", [False, True])
def test_ce_loss_matches_numpy(time_major):
    rng = np.random.default_rng(5)
    N, T, V = 4, 6, 9
    logits = rng.normal(size=(N, T, V)).astype(np.float32)
    labels = rng.integers(1, V, size=(N, T)).astype(np.int32)
    labels[1, 3:] = 0
    labels[3, 1:] = 0
    out = {"logits": jnp.asarray(logits)}
    lab = jnp.asarray(labels)
    if time_major:
        out = {"logits": jnp.asarray(logits.swapaxes(0, 1))}
        lab = lab.T
    got = compute_loss(out, lab, prior="Normal", no_encoder=True,
                       time_major=time_major)
    m = logits.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    ce = lse - np.take_along_axis(logits, labels[..., None], -1)[..., 0]
    mask = labels != 0
    np.testing.assert_allclose(float(got["rec_loss"]),
                               (ce * mask).sum() / mask.sum(), rtol=1e-5)
    assert float(got["kld"]) == 0.0


def test_gather_beams_matches_numpy():
    B, K, H = 3, 4, 5
    rng = np.random.default_rng(7)
    c = rng.normal(size=(B * K, H)).astype(np.float32)
    toks = rng.integers(0, 50, size=(B * K,)).astype(np.int32)
    parent = rng.integers(0, K, size=(B, K)).astype(np.int32)
    got_c, got_t = _gather_beams((jnp.asarray(c), jnp.asarray(toks)),
                                 jnp.asarray(parent), B, K)
    rows = (np.arange(B)[:, None] * K + parent).reshape(-1)
    np.testing.assert_array_equal(np.asarray(got_c), c[rows])
    np.testing.assert_array_equal(np.asarray(got_t), toks[rows])
