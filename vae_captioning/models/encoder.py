"""CVAE recognition network q(z | x, f(I)) with Normal / GMM / AG heads.

Rebuilds ``vae_model/encoder.py:24-110``:

  * The LSTM init-state protocol is preserved: step the cell once on the
    embedded image feature, optionally once more on the embedded cluster
    vector, then run the caption (``:38-48``).
  * The 90 per-cluster (μ, logσ) heads of GMM/AG are **one** dense
    producing ``[B, 90, L]`` — one matmul instead of 90 tiny layers
    (``:76-99`` builds 90 separate variable scopes).
  * GMM cluster selection: the reference passes the probability vector
    to ``tf.multinomial``, which expects *logits* — effectively sampling
    near-uniformly (``:72``).  We sample from the actual categorical
    distribution over c_v (zero-sum vectors fall back to uniform);
    documented deviation, CIDEr-validated.

Params: ``{"enc_embeddings", "lstm", "q_heads"}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from vae_captioning.ops.layers import (Params, Path, dense, dense_init,
                                           embed, embed_init)
from vae_captioning.ops.lstm import LSTMStack


@dataclasses.dataclass(frozen=True)
class Encoder:
    vocab_size: int
    embed_size: int
    hidden_size: int
    latent_size: int
    num_layers: int = 1
    prior: str = "Normal"          # Normal | GMM | AG
    num_clusters: int = 90
    use_c_v: bool = False
    compute_dtype: Any = jnp.float32

    @property
    def lstm(self) -> LSTMStack:
        return LSTMStack(self.hidden_size, self.num_layers, self.compute_dtype)

    @property
    def q_half(self) -> int:
        return (self.latent_size if self.prior == "Normal"
                else self.num_clusters * self.latent_size)

    def init_params(self, root: jax.Array, path: Path = ("encoder",)
                    ) -> Params:
        # ONE dense for (μ ‖ logσ): the reference builds separate
        # lz_mean/lz_logstd layers (Normal, ref :60-66) and 90 per-cluster
        # variable scopes ×2 (GMM/AG, ref :76-99) — here all heads are a
        # single [H, 2·K·L] matmul with the exp/combine epilogue fused
        # into its consumer
        return {"enc_embeddings": embed_init(
                    root, path + ("enc_embeddings",), self.vocab_size,
                    self.embed_size),
                "lstm": self.lstm.init_params(root, path + ("lstm",),
                                              self.embed_size),
                "q_heads": dense_init(root, path + ("q_heads",),
                                      self.hidden_size, 2 * self.q_half)}

    def __call__(
        self,
        params: Params,
        images_fv: jax.Array,            # [B, E] embedded image feature
        captions: jax.Array,             # [B, T] token ids (w1..wN <EOS>)
        lengths: jax.Array,              # [B]
        c_emb: Optional[jax.Array] = None,   # [B, E] embedded cluster vec
        c_v: Optional[jax.Array] = None,     # [B, 90] raw cluster weights
        sample_key: Optional[jax.Array] = None,  # GMM cluster draw
    ) -> Tuple[jax.Array, jax.Array]:
        """Returns the posterior (mean, std), each [B, L]."""
        B = images_fv.shape[0]
        lstm, lp = self.lstm, params["lstm"]
        carry = lstm.zero_carry(B)
        carry, _ = lstm.step(lp, carry, images_fv)
        if c_emb is not None and self.use_c_v:
            carry, _ = lstm.step(lp, carry, c_emb)
        # collect_outputs=False: only the final carry is read below, so
        # the [T, B, H] output stack is never materialised
        carry, _ = lstm(lp, carry, embed(params["enc_embeddings"], captions),
                        lengths, collect_outputs=False)
        # the reference reads the FIRST layer's hidden state
        # (final_state[0][1], ref :56-58) — identical at the default one
        # layer, and matched here for multi-layer parity
        h = carry[0][1]

        with jax.named_scope("q_heads"):
            return self._posterior(params["q_heads"], h, c_v, sample_key)

    def _posterior(self, p: Params, h: jax.Array, c_v, sample_key):
        B = h.shape[0]
        q = dense(p, h)                           # [B, 2·(K·)L] one dot
        half = self.q_half
        raw_mean, raw_logstd = q[:, :half], q[:, half:]

        if self.prior == "Normal":
            return raw_mean, jnp.exp(raw_logstd)

        K, L = self.num_clusters, self.latent_size
        means = raw_mean.reshape(B, K, L)
        stds = jnp.exp(raw_logstd).reshape(B, K, L)

        if c_v is None:
            raise ValueError(f"the {self.prior} prior needs cluster vectors")
        if self.prior == "GMM":
            if sample_key is None:
                raise ValueError("the GMM prior needs a 'sample' key")
            total = jnp.sum(c_v, axis=-1, keepdims=True)
            probs = jnp.where(total > 0, c_v / jnp.maximum(total, 1e-9),
                              jnp.ones_like(c_v) / K)
            cluster = jax.random.categorical(
                sample_key, jnp.log(probs + 1e-9), axis=-1)      # [B]
            idx = cluster[:, None, None]
            mean = jnp.take_along_axis(means, idx, axis=1)[:, 0]
            std = jnp.take_along_axis(stds, idx, axis=1)[:, 0]
            return mean, std

        # AG: convex combination by the cluster weights (ref :105-107)
        mean = jnp.einsum("bk,bkl->bl", c_v, means)
        std = jnp.einsum("bk,bkl->bl", c_v, stds)
        return mean, std
