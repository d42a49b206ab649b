"""ops-layer tests: KL closed forms vs scipy, sampling, annealing,
cluster means, AG decode prior, and LSTM masking semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vae_captioning.ops import distributions as dist
from vae_captioning.ops.lstm import LSTMCell, LSTMStack


# ---------------------------------------------------------------- KL math

def _kl_normal_scipy(mu, sigma):
    """Exact KL(N(mu, sigma^2) || N(0, 1)) summed over dims, batch-meaned."""
    kl = 0.5 * (sigma**2 + mu**2 - 1.0 - np.log(sigma**2))
    return kl.sum(axis=-1).mean()


def test_kl_standard_normal_matches_closed_form():
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(8, 16)).astype(np.float32)
    sigma = np.exp(rng.normal(size=(8, 16)) * 0.3).astype(np.float32)
    got = float(dist.kl_standard_normal(jnp.asarray(mu), jnp.asarray(sigma)))
    want = _kl_normal_scipy(mu, sigma)
    # the reference's +1e-5 inside the log perturbs slightly
    assert got == pytest.approx(want, rel=1e-3)


def test_kl_standard_normal_zero_at_prior():
    mu = jnp.zeros((4, 10))
    sigma = jnp.ones((4, 10))
    assert float(dist.kl_standard_normal(mu, sigma)) == pytest.approx(0.0, abs=1e-3)


def test_kl_ag_matches_manual():
    """AG KLD vs a direct per-dim transcription of main.py:136-145."""
    rng = np.random.default_rng(1)
    B, L, C = 4, 8, 90
    mu = rng.normal(size=(B, L)).astype(np.float32)
    std = np.exp(rng.normal(size=(B, L)) * 0.2).astype(np.float32)
    c_v = rng.random((B, C)).astype(np.float32)
    c_v /= c_v.sum(-1, keepdims=True)
    c_means = dist.init_cluster_means(C, L, seed=3)
    sig_c = 0.1
    prior_mu = c_v @ c_means
    inner = (0.5 + np.log(std + 1e-5) - np.log(sig_c + 1e-5)
             - ((mu - prior_mu) ** 2 + std**2) / (2 * sig_c**2 + 1e-7))
    want = (-0.5 * inner.sum(-1)).mean()
    got = float(dist.kl_ag(jnp.asarray(mu), jnp.asarray(std),
                           jnp.asarray(c_v), jnp.asarray(c_means)))
    assert got == pytest.approx(want, rel=1e-5)


def test_kl_ag_sum_reduce():
    """reduce='sum' (Config.ag_kl_sum, the reference's implicit batch-sum
    weighting) = mean x number of VALID rows, masked rows excluded."""
    rng = np.random.default_rng(2)
    B, L, C = 6, 8, 90
    mu = jnp.asarray(rng.normal(size=(B, L)).astype(np.float32))
    std = jnp.asarray(np.exp(rng.normal(size=(B, L)) * 0.2)
                      .astype(np.float32))
    c_v = rng.random((B, C)).astype(np.float32)
    c_v = jnp.asarray(c_v / c_v.sum(-1, keepdims=True))
    c_means = jnp.asarray(dist.init_cluster_means(C, L, seed=3))
    mask = jnp.asarray(np.array([1, 1, 1, 1, 0, 0], np.bool_))

    mean_red = float(dist.kl_ag(mu, std, c_v, c_means, row_mask=mask))
    sum_red = float(dist.kl_ag(mu, std, c_v, c_means, row_mask=mask,
                               reduce="sum"))
    assert sum_red == pytest.approx(4.0 * mean_red, rel=1e-5)
    # unmasked: sum = B x mean
    assert float(dist.kl_ag(mu, std, c_v, c_means, reduce="sum")) == \
        pytest.approx(B * float(dist.kl_ag(mu, std, c_v, c_means)), rel=1e-5)


def test_kl_ag_zero_when_at_prior():
    """KL should be ~0 when q equals the AG prior N(c_v@means, sigma_c)."""
    B, L, C = 3, 6, 90
    c_v = np.zeros((B, C), np.float32)
    c_v[:, 5] = 1.0
    c_means = dist.init_cluster_means(C, L, seed=0)
    mu = jnp.asarray(c_v @ c_means)
    std = jnp.full((B, L), 0.1)
    got = float(dist.kl_ag(mu, std, jnp.asarray(c_v), jnp.asarray(c_means),
                           cluster_sigma=0.1))
    assert abs(got) < 0.01


def test_kl_gmm_single_component_is_exact_gaussian_kl():
    """With all weight on one component, the variational bound collapses
    to the closed-form Gaussian-Gaussian KL; with that component at the
    origin and sigma_c=1 it must equal the standard-normal KL
    (VERDICT r2 #6's reduction check)."""
    rng = np.random.default_rng(2)
    B, L, C = 5, 12, 90
    mu = rng.normal(size=(B, L)).astype(np.float32)
    std = np.exp(rng.normal(size=(B, L)) * 0.2).astype(np.float32)
    c_v = np.zeros((B, C), np.float32)
    c_v[:, 7] = 1.0
    c_means = np.zeros((C, L), np.float32)
    got = float(dist.kl_gmm(jnp.asarray(mu), jnp.asarray(std),
                            jnp.asarray(c_v), jnp.asarray(c_means),
                            cluster_sigma=1.0))
    want = float(dist.kl_standard_normal(jnp.asarray(mu), jnp.asarray(std)))
    assert got == pytest.approx(want, rel=1e-3)


def test_kl_gmm_tight_upper_bound_on_mc_estimate():
    """The variational bound must upper-bound an MC estimate of the true
    mixture KL, and be tight when components are well separated."""
    rng = np.random.default_rng(3)
    B, L, C = 4, 6, 8
    sig_c = 0.1
    c_means = (dist.init_cluster_means(C, L, seed=5) * 5.0)  # separated
    c_v = rng.random((B, C)).astype(np.float32)
    # q concentrated AT one component per row: the true KL is then
    # ≈ KL(q‖p_k) − log w_k and the bound is tight in absolute terms
    picks = np.arange(B) % C
    mu = c_means[picks] + rng.normal(size=(B, L)).astype(np.float32) * 0.02
    std = np.full((B, L), 0.08, np.float32)
    got = float(dist.kl_gmm(jnp.asarray(mu), jnp.asarray(std),
                            jnp.asarray(c_v), jnp.asarray(c_means),
                            cluster_sigma=sig_c))
    # MC estimate of KL(q || mix) with 20k draws per row
    w = c_v / c_v.sum(-1, keepdims=True)
    S = 20000
    z = mu[:, None, :] + std[:, None, :] * rng.normal(
        size=(B, S, L)).astype(np.float32)          # [B, S, L]
    log_q = (-0.5 * (((z - mu[:, None, :]) / std[:, None, :]) ** 2)
             - np.log(std[:, None, :]) - 0.5 * np.log(2 * np.pi)).sum(-1)
    d2 = ((z[:, :, None, :] - c_means[None, None, :, :]) ** 2).sum(-1)
    log_comp = (-0.5 * d2 / sig_c**2
                - L * (np.log(sig_c) + 0.5 * np.log(2 * np.pi)))  # [B,S,C]
    from scipy.special import logsumexp
    log_p = logsumexp(log_comp + np.log(w[:, None, :] + 1e-30), axis=-1)
    mc = float((log_q - log_p).mean())
    assert got >= mc - 0.02          # upper bound (mc noise margin)
    assert got == pytest.approx(mc, abs=0.1)  # tight when separated


def test_kl_gmm_zero_cv_falls_back_to_uniform():
    rng = np.random.default_rng(4)
    B, L, C = 3, 6, 10
    mu = rng.normal(size=(B, L)).astype(np.float32)
    std = np.full((B, L), 0.3, np.float32)
    c_means = dist.init_cluster_means(C, L, seed=1)
    zeros = jnp.zeros((B, C))
    uniform = jnp.full((B, C), 1.0 / C)
    got0 = float(dist.kl_gmm(jnp.asarray(mu), jnp.asarray(std), zeros,
                             jnp.asarray(c_means)))
    gotu = float(dist.kl_gmm(jnp.asarray(mu), jnp.asarray(std), uniform,
                             jnp.asarray(c_means)))
    assert np.isfinite(got0)
    assert got0 == pytest.approx(gotu, rel=1e-6)


def test_compute_loss_gmm_true_kl_opt_in():
    """Config.gmm_true_kl routes the GMM prior through kl_gmm; default
    keeps the reference's standard-normal placeholder."""
    from vae_captioning.models.cvae import compute_loss
    rng = np.random.default_rng(5)
    B, T, V, L, C = 4, 6, 20, 8, 90
    outputs = {
        "logits": jnp.asarray(rng.normal(size=(B, T, V)).astype(np.float32)),
        "q_mean": jnp.asarray(rng.normal(size=(B, L)).astype(np.float32)),
        "q_std": jnp.asarray(np.exp(rng.normal(size=(B, L)) * 0.2)
                             .astype(np.float32)),
        "c_v": jnp.asarray((rng.random((B, C)) *
                            (rng.random((B, C)) > 0.8)).astype(np.float32)),
    }
    labels = jnp.asarray(rng.integers(1, V, (B, T)), jnp.int32)
    c_means = jnp.asarray(dist.init_cluster_means(C, L, seed=0))
    off = compute_loss(outputs, labels, prior="GMM", no_encoder=False,
                       cluster_means=c_means)
    on = compute_loss(outputs, labels, prior="GMM", no_encoder=False,
                      cluster_means=c_means, gmm_true_kl=True)
    assert float(off["kld"]) == pytest.approx(float(
        dist.kl_standard_normal(outputs["q_mean"], outputs["q_std"])), 1e-5)
    assert float(on["kld"]) == pytest.approx(float(
        dist.kl_gmm(outputs["q_mean"], outputs["q_std"], outputs["c_v"],
                    c_means)), 1e-5)
    assert float(on["rec_loss"]) == pytest.approx(float(off["rec_loss"]))


# ---------------------------------------------------------------- sampling

def test_sample_gaussian_shape_and_stats():
    key = jax.random.PRNGKey(0)
    mean = jnp.broadcast_to(jnp.asarray([1.0, -2.0]), (4, 2))
    z = dist.sample_gaussian(key, mean, jnp.asarray(0.001), 64)
    assert z.shape == (4, 64, 2)
    np.testing.assert_allclose(np.asarray(z.mean(axis=1)), np.asarray(mean),
                               atol=0.001)


def test_sample_gaussian_per_image_samples_contiguous():
    # each image's K samples must depend only on its own mean
    key = jax.random.PRNGKey(0)
    mean = jnp.asarray([[0.0], [100.0]])
    z = dist.sample_gaussian(key, mean, jnp.asarray(0.1), 8)
    assert np.abs(np.asarray(z[0])).max() < 10
    assert np.asarray(z[1]).min() > 90


# ---------------------------------------------------------------- annealing

def test_kl_annealing():
    # ann_param <= 1 → constant 1 (ref main.py:166-170)
    assert float(dist.kl_annealing(jnp.asarray(0), 0.0)) == 1.0
    assert float(dist.kl_annealing(jnp.asarray(0), 1.0)) == 1.0
    # ramp: ~0 early, 0.5 at 1000*ann_param, →1 late
    a = dist.kl_annealing
    assert float(a(jnp.asarray(0), 5.0)) < 0.01
    assert float(a(jnp.asarray(5000), 5.0)) == pytest.approx(0.5, abs=1e-5)
    assert float(a(jnp.asarray(100000), 5.0)) == pytest.approx(1.0, abs=1e-5)
    # force_one (fine_tune / restore, ref main.py:163-164)
    assert float(a(jnp.asarray(0), 5.0, force_one=True)) == 1.0


# ---------------------------------------------------------------- clusters

def test_cluster_means_unit_norm_and_deterministic():
    m1 = dist.init_cluster_means(90, 150, seed=7)
    m2 = dist.init_cluster_means(90, 150, seed=7)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_allclose(np.linalg.norm(m1, axis=1), 1.0, rtol=1e-5)
    m3 = dist.init_cluster_means(90, 150, seed=8)
    assert not np.allclose(m1, m3)


def test_ag_prior_mean_active_clusters():
    C, L = 90, 4
    means = jnp.asarray(dist.init_cluster_means(C, L, seed=0))
    c_v = np.zeros((2, C), np.float32)
    c_v[0, 3] = 0.5
    c_v[0, 10] = 0.5
    # image 1: no detections → fallback over used classes
    out = dist.ag_prior_mean(jnp.asarray(c_v), means)
    want0 = (np.asarray(means)[3] + np.asarray(means)[10]) / 2
    np.testing.assert_allclose(np.asarray(out[0]), want0, rtol=1e-5)
    # fallback excludes the blacklisted ids (shifted into 90-dim space)
    used = np.ones(C, np.float32)
    for cls in dist.AG_UNUSED_CLASSES:
        if 0 <= cls - 1 < C:
            used[cls - 1] = 0.0
    want1 = (used[:, None] * np.asarray(means)).sum(0) / used.sum()
    np.testing.assert_allclose(np.asarray(out[1]), want1, rtol=1e-4)


# ---------------------------------------------------------------- LSTM

def test_lstm_cell_step():
    cell = LSTMCell(hidden_size=8)
    x = jnp.ones((2, 4))
    carry = (jnp.zeros((2, 8)), jnp.zeros((2, 8)))
    params = cell.init(jax.random.PRNGKey(0), carry, x)
    (c, h), out = cell.apply(params, carry, x)
    assert c.shape == (2, 8) and h.shape == (2, 8)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(h))
    assert np.abs(np.asarray(h)).max() <= 1.0  # tanh-bounded


def test_lstm_masked_scan_copy_through():
    """Carry must freeze at t >= length; outputs zero (dynamic_rnn parity)."""
    stack = LSTMStack(hidden_size=8)
    B, T, E = 3, 6, 4
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(size=(B, T, E)).astype(np.float32))
    lengths = jnp.asarray([6, 3, 1])
    init = stack.init(jax.random.PRNGKey(0),
                      stack.zero_carry(B), xs, lengths)
    carry, outputs = stack.apply(init, stack.zero_carry(B), xs, lengths)
    assert outputs.shape == (B, T, 8)
    # outputs beyond length are zeros
    assert np.abs(np.asarray(outputs[1, 3:])).max() == 0.0
    assert np.abs(np.asarray(outputs[2, 1:])).max() == 0.0
    assert np.abs(np.asarray(outputs[0])).min() >= 0.0  # full length: no zeroing

    # final carry equals a manual unrolled run up to each length
    def manual(b, n):
        c = stack.zero_carry(1)
        for t in range(n):
            c, _ = stack.apply(init, c, xs[b:b+1, t], method=stack.step)
        return c
    for b, n in [(0, 6), (1, 3), (2, 1)]:
        want = manual(b, n)
        np.testing.assert_allclose(np.asarray(carry[0][1][b]),
                                   np.asarray(want[0][1][0]), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(carry[0][0][b]),
                                   np.asarray(want[0][0][0]), rtol=2e-5, atol=1e-6)


def test_lstm_step_equals_scan_first_step():
    stack = LSTMStack(hidden_size=8)
    B, E = 2, 4
    xs = jnp.ones((B, 1, E))
    init = stack.init(jax.random.PRNGKey(1), stack.zero_carry(B), xs,
                      jnp.asarray([1, 1]))
    carry_scan, _ = stack.apply(init, stack.zero_carry(B), xs,
                                jnp.asarray([1, 1]))
    carry_step, _ = stack.apply(init, stack.zero_carry(B), xs[:, 0],
                                method=stack.step)
    np.testing.assert_allclose(np.asarray(carry_scan[0][0]),
                               np.asarray(carry_step[0][0]), rtol=1e-6)


def test_lstm_multi_layer():
    stack = LSTMStack(hidden_size=8, num_layers=2)
    B, T, E = 2, 3, 4
    xs = jnp.ones((B, T, E))
    lengths = jnp.asarray([3, 2])
    init = stack.init(jax.random.PRNGKey(0), stack.zero_carry(B), xs, lengths)
    carry, outputs = stack.apply(init, stack.zero_carry(B), xs, lengths)
    assert len(carry) == 2
    assert outputs.shape == (B, T, 8)


def test_lstm_forget_bias():
    """With zero weights, forget gate must be sigmoid(1.0) ≈ 0.731."""
    cell = LSTMCell(hidden_size=2)
    x = jnp.zeros((1, 2))
    c0 = jnp.ones((1, 2))
    h0 = jnp.zeros((1, 2))
    params = cell.init(jax.random.PRNGKey(0), (c0, h0), x)
    zeroed = jax.tree.map(jnp.zeros_like, params)
    (c1, _), _ = cell.apply(zeroed, (c0, h0), x)
    np.testing.assert_allclose(np.asarray(c1), 1 / (1 + np.exp(-1.0)),
                               rtol=1e-5)


# ---------------------------------------------------------------- layers

def test_highway_network():
    from vae_captioning.ops.layers import HighwayNetwork
    hw = HighwayNetwork(num_layers=2)
    x = jnp.ones((4, 16))
    params = hw.init(jax.random.PRNGKey(0), x)
    y = hw.apply(params, x)
    assert y.shape == x.shape
    # with zeroed params the gate is sigmoid(-1)≈0.27 → mostly carry
    zeroed = jax.tree.map(jnp.zeros_like, params)
    # restore the -1 bias on the transform gates
    zeroed = jax.tree_util.tree_map_with_path(
        lambda path, x: x - 1.0 if (path[-2].key.startswith("t_")
                                    and path[-1].key == "bias") else x,
        zeroed)
    y0 = hw.apply(zeroed, x)
    carry = 1 / (1 + np.exp(-1.0))  # 1 - sigmoid(-1) = sigmoid(1)
    np.testing.assert_allclose(np.asarray(y0), carry**2, rtol=1e-4)


def test_kl_row_mask_excludes_padding():
    rng = np.random.default_rng(0)
    mu = jnp.asarray(rng.normal(size=(4, 8)).astype(np.float32))
    std = jnp.asarray(np.exp(rng.normal(size=(4, 8)) * 0.2).astype(np.float32))
    mask = jnp.asarray([True, True, False, False])
    got = float(dist.kl_standard_normal(mu, std, row_mask=mask))
    want = float(dist.kl_standard_normal(mu[:2], std[:2]))
    assert got == pytest.approx(want, rel=1e-6)
