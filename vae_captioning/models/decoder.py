"""Caption decoder p(x | z, f(I)): conditional LSTM language model.

Rebuilds ``vae_model/decoder.py:34-143``.  The init-state protocol is
kept: step the cell on the embedded image feature, optionally on the
embedded cluster vector, then on the z-projection; the resulting carry
seeds teacher-forced training and incremental decoding alike
(``:96-114``).  In ``no_encoder`` (baseline LSTM) mode z is skipped
(``:103-106``).

The TF1 ``rnn_placeholders`` state-injection trick is unnecessary: decode
carries the LSTM state PyTree explicitly (see ops/decoding.py).

Params: ``{"dec_embeddings", "lstm", "z_rnn" (not in baseline mode),
"rnn_logits"}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from vae_captioning.ops.layers import (KeyStream, Params, Path, dense,
                                           dense_init, dropout, embed,
                                           embed_init)
from vae_captioning.ops.lstm import Carry, LSTMStack


@dataclasses.dataclass(frozen=True)
class Decoder:
    vocab_size: int
    embed_size: int
    hidden_size: int
    num_layers: int = 1
    use_c_v: bool = False
    dec_keep_rate: float = 1.0     # caption-input dropout keep rate (ref :85-87)
    dec_lstm_drop: float = 1.0     # LSTM output dropout keep rate (ref :88-95)
    compute_dtype: Any = jnp.float32
    use_bias_fold: bool = False  # train-path logits: ones-augmented
    #                              matmul so the dW product yields db as
    #                              its last row (Config.ce_bias_fold)

    @property
    def lstm(self) -> LSTMStack:
        return LSTMStack(self.hidden_size, self.num_layers,
                         self.compute_dtype,
                         output_keep_rate=self.dec_lstm_drop)

    def init_params(self, root: jax.Array,
                    z_features: Optional[int] = None,
                    path: Path = ("decoder",)) -> Params:
        """``z_features`` = K_z·L, the width of the sampled latents the
        ``z_rnn`` projection takes; None in baseline mode (no z)."""
        p = {"dec_embeddings": embed_init(root, path + ("dec_embeddings",),
                                          self.vocab_size, self.embed_size),
             "lstm": self.lstm.init_params(root, path + ("lstm",),
                                           self.embed_size),
             "rnn_logits": dense_init(root, path + ("rnn_logits",),
                                      self.hidden_size, self.vocab_size)}
        if z_features is not None:  # ref :111-112
            p["z_rnn"] = dense_init(root, path + ("z_rnn",), z_features,
                                    self.embed_size)
        return p

    # ------------------------------------------------------------------
    def init_state(
        self,
        params: Params,
        images_fv: jax.Array,              # [B, E]
        c_emb: Optional[jax.Array] = None,  # [B, E]
        z_flat: Optional[jax.Array] = None,  # [B, K_z * L]; None = no_encoder
        drop: Optional[KeyStream] = None,   # dropout keys (training)
        z_dec: Optional[jax.Array] = None,  # [B, E] pre-projected z input
    ) -> Carry:
        lstm, lp = self.lstm, params["lstm"]
        key = drop if drop is not None else (lambda: None)
        carry = lstm.zero_carry(images_fv.shape[0])
        carry, _ = lstm.step(lp, carry, images_fv, key())
        if c_emb is not None and self.use_c_v:
            carry, _ = lstm.step(lp, carry, c_emb, key())
        if z_dec is None and z_flat is not None:
            z_dec = dense(params["z_rnn"], z_flat)
        if z_dec is not None:
            carry, _ = lstm.step(lp, carry, z_dec, key())
        return carry

    # ------------------------------------------------------------------
    def gen_z_embedding(self, params: Params, rng: jax.Array,
                        z_mean: jax.Array, std,
                        n_samples: int) -> jax.Array:
        """Generation-time z step input [B, E], sampled in the PROJECTED
        space.

        At decode, z only enters through the linear ``z_proj``:
        ``z_proj(concat of K_z iid draws of N(z_mean, std²I))`` is
        Gaussian with mean ``z_mean @ Σ_s W_s + b`` and covariance
        ``std²·WᵀW`` (W: [K_z·L, E]) — so an E-dim draw shaped by a
        Cholesky factor of WᵀW is distributionally identical to drawing
        all K_z·L latents, with an [B, E] draw in place of a
        [B, K_z·L] one.  A tiny diagonal jitter (1e-6·max(diag)) keeps
        the factorisation stable; at std = 0.1 it is noise-level-
        irrelevant."""
        kernel = params["z_rnn"]["kernel"]                # [K_z·L, E]
        bias = params["z_rnn"]["bias"]
        L = z_mean.shape[-1]
        E = kernel.shape[-1]
        hi = jax.lax.Precision.HIGHEST
        w_sum = kernel.reshape(n_samples, L, E).sum(axis=0)  # [L, E]
        mean_part = jnp.dot(z_mean, w_sum, precision=hi) + bias
        if std == 0:
            return mean_part  # z at its mean: nothing to draw
        cov = jnp.dot(kernel.T, kernel, precision=hi)        # [E, E]
        jitter = 1e-6 * jnp.max(jnp.diagonal(cov))
        chol = jnp.linalg.cholesky(cov + jitter * jnp.eye(E))
        eps = jax.random.normal(rng, (z_mean.shape[0], E))
        noise = jnp.dot(eps, chol.T, precision=hi)
        return mean_part + jnp.asarray(std, jnp.float32) * noise

    # ------------------------------------------------------------------
    def teacher_forcing(
        self,
        params: Params,
        carry: Carry,
        dec_inputs: jax.Array,   # [B, T] (<BOS> w1 ...)
        lengths: jax.Array,      # [B]
        drop: Optional[KeyStream] = None,
        time_major: bool = False,
    ) -> jax.Array:
        """Full-sequence logits [B, T, V] in COMPUTE dtype.
        ``time_major=True`` returns [T, B, V] — the scan's native layout;
        the train step uses it so no relayout copies sit between the
        LSTM scan, the logits head and the CE (pair it with transposed
        [T, B] labels).

        The head computes in compute dtype, so an astype(f32) here would
        add no precision and double the bytes of the step's largest
        tensor; ``compute_loss`` upcasts inside its reductions instead."""
        x = embed(params["dec_embeddings"], dec_inputs)
        if drop is not None and self.dec_keep_rate < 1.0:
            x = dropout(drop(), x, self.dec_keep_rate)
        _, outputs = self.lstm(params["lstm"], carry, x, lengths,
                               dropout_key=drop() if drop else None,
                               time_major_out=time_major)
        head = params["rnn_logits"]
        dt = self.compute_dtype
        if self.use_bias_fold:
            # logits = [h ‖ 1] @ [[W], [b]]: same compute class as the
            # dense head, but db is the last row of the dW' product
            # instead of a standalone [N, V] column sum in the backward
            ones = jnp.ones((*outputs.shape[:-1], 1), dt)
            hb = jnp.concatenate([outputs.astype(dt), ones], axis=-1)
            wb = jnp.concatenate([head["kernel"], head["bias"][None, :]],
                                 axis=0).astype(dt)
            return jax.lax.dot_general(
                hb, wb, (((hb.ndim - 1,), (0,)), ((), ())))
        return dense(head, outputs, dt)

    # ------------------------------------------------------------------
    def step_hidden(self, params: Params, carry: Carry,
                    tokens: jax.Array) -> Tuple[Carry, jax.Array]:
        """Decode step stopping at the hidden state [B, H] — the input to
        the fused logits + top-K path (ops/logits_topk.py), which applies
        the rnn_logits projection itself."""
        x = embed(params["dec_embeddings"], tokens)
        return self.lstm.step(params["lstm"], carry, x)

    def step(self, params: Params, carry: Carry,
             tokens: jax.Array) -> Tuple[Carry, jax.Array]:
        """One decode step: tokens [B] → (carry, logits [B, V] f32)."""
        carry, h = self.step_hidden(params, carry, tokens)
        logits = dense(params["rnn_logits"], h, self.compute_dtype)
        return carry, logits.astype(jnp.float32)
