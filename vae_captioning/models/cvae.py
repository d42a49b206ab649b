"""The assembled captioning model family + loss.

One model covers all four reference variants (``README.md:5-6``):

  * ``no_encoder=True``  → VGG16+LSTM baseline (no z, rec loss only)
  * ``prior='Normal'``   → CVAE with standard-normal prior
  * ``prior='GMM'``      → GMM-prior CVAE (KL is the Normal formula — the
                           reference's acknowledged TODO, ``main.py:125-135``)
  * ``prior='AG'``       → additive-Gaussian CVAE over cluster vectors

Graph-assembly parity (``main.py:84-117``): a single shared ``imf_emb``
dense maps fc2 features into embedding space for both encoder and
decoder; a single shared ``cv_emb`` embeds cluster vectors; features are
tiled on device when K captions per image are used (``main.py:84-89``).

z handling: K_z = ``gen_z_samples`` reparameterized samples per example,
concatenated per image to ``[B, K_z·L]`` and densely projected — the
clean form of the reference's sample-major reshape
(``vae_model/decoder.py:108-113``; see ops/distributions.sample_gaussian).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from vae_captioning.config import Config
from vae_captioning.models.decoder import Decoder
from vae_captioning.models.encoder import Encoder
from vae_captioning.ops import distributions as dist
from vae_captioning.ops.layers import (KeyStream, Module, Params, Path,
                                           dense, dense_init, fold_in_path,
                                           params_key)
from vae_captioning.ops.lstm import Carry


@dataclasses.dataclass(frozen=True)
class CVAEModel(Module):
    """Flagship model.  Construct via ``CVAEModel.from_config(cfg)``.

    Params: ``{"imf_emb", "cv_emb" (with cluster vectors), "encoder"
    (not in baseline mode), "decoder"}``."""

    vocab_size: int
    embed_size: int = 256
    latent_size: int = 150
    encoder_hidden: int = 512
    decoder_hidden: int = 512
    encoder_layers: int = 1
    decoder_layers: int = 1
    num_clusters: int = 90
    gen_z_samples: int = 100
    prior: str = "Normal"
    no_encoder: bool = False
    use_c_v: bool = False
    dec_keep_rate: float = 1.0
    dec_lstm_drop: float = 1.0
    decode_std: float = 0.1
    cluster_seed: int = 0
    compute_dtype: Any = jnp.float32
    use_bias_fold: bool = False

    @classmethod
    def from_config(cls, cfg: Config) -> "CVAEModel":
        if not cfg.vocab_size:
            raise ValueError("set cfg.vocab_size (from the Vocabulary) first")
        return cls(
            vocab_size=cfg.vocab_size,
            embed_size=cfg.embed_size,
            latent_size=cfg.latent_size,
            encoder_hidden=cfg.encoder_hidden,
            decoder_hidden=cfg.decoder_hidden,
            encoder_layers=cfg.encoder_rnn_layers,
            decoder_layers=cfg.decoder_rnn_layers,
            num_clusters=cfg.num_clusters,
            gen_z_samples=cfg.gen_z_samples,
            prior=cfg.prior,
            no_encoder=cfg.no_encoder,
            use_c_v=cfg.use_c_v,
            dec_keep_rate=cfg.dec_keep_rate,
            dec_lstm_drop=cfg.dec_lstm_drop,
            decode_std=cfg.std,
            cluster_seed=cfg.seed,
            compute_dtype=jnp.dtype(cfg.compute_dtype),
            use_bias_fold=cfg.ce_bias_fold,
        )

    # ------------------------------------------------------------------
    @property
    def encoder(self) -> Encoder:
        return Encoder(
            vocab_size=self.vocab_size, embed_size=self.embed_size,
            hidden_size=self.encoder_hidden, latent_size=self.latent_size,
            num_layers=self.encoder_layers, prior=self.prior,
            num_clusters=self.num_clusters, use_c_v=self.use_c_v,
            compute_dtype=self.compute_dtype)

    @property
    def decoder(self) -> Decoder:
        return Decoder(
            vocab_size=self.vocab_size, embed_size=self.embed_size,
            hidden_size=self.decoder_hidden, num_layers=self.decoder_layers,
            use_c_v=self.use_c_v, dec_keep_rate=self.dec_keep_rate,
            dec_lstm_drop=self.dec_lstm_drop,
            compute_dtype=self.compute_dtype,
            use_bias_fold=self.use_bias_fold)

    @property
    def cluster_means(self) -> jax.Array:
        """Fixed (non-trainable) cluster means, deterministic in the seed
        — replaces the pickled matrix of utils/vae_utils.py:6-31."""
        return jnp.asarray(dist.init_cluster_means(
            self.num_clusters, self.latent_size, self.cluster_seed))

    @property
    def _needs_c_v(self) -> bool:
        return self.use_c_v or self.prior in ("GMM", "AG")

    def init_params(self, root: jax.Array, feature_size: int,
                    path: Path = ()) -> Params:
        params = {"imf_emb": dense_init(root, path + ("imf_emb",),
                                        feature_size,
                                        self.embed_size)}  # main.py:94
        if self._needs_c_v:
            params["cv_emb"] = dense_init(root, path + ("cv_emb",),
                                          self.num_clusters,
                                          self.embed_size)  # main.py:108
        z_features = None
        if not self.no_encoder:
            params["encoder"] = self.encoder.init_params(
                root, path + ("encoder",))
            z_features = self.gen_z_samples * self.latent_size
        params["decoder"] = self.decoder.init_params(
            root, z_features, path + ("decoder",))
        return params

    def init(self, rngs, features: jax.Array, *args, **kw) -> Params:
        """``{"params": tree}``; only the feature width is read from the
        example inputs."""
        return {"params": self.init_params(params_key(rngs),
                                           features.shape[-1])}

    # ------------------------------------------------------------------
    def _embed_conditioning(self, params: Params, features: jax.Array,
                            c_v: Optional[jax.Array]):
        images_fv = dense(params["imf_emb"], features)
        c_emb = None
        if self._needs_c_v and c_v is not None:
            c_emb = dense(params["cv_emb"], c_v)
        return images_fv, c_emb

    # ------------------------------------------------------------------
    def __call__(
        self,
        params: Params,
        features: jax.Array,       # [B, 4096] fc2 features
        enc_captions: jax.Array,   # [B*K, T]  (w1..wN <EOS>) — encoder input
        dec_captions: jax.Array,   # [B*K, T]  (<BOS> w1..wN) — decoder input
        lengths: jax.Array,        # [B*K]
        c_v: Optional[jax.Array] = None,  # [B, 90]
        deterministic: bool = True,
        time_major: bool = False,
        rngs: Optional[Dict[str, jax.Array]] = None,
    ) -> Dict[str, jax.Array]:
        """Training/eval forward.  K = captions per image is inferred from
        the leading dims and features are tiled on device (main.py:84-89).
        ``time_major`` flips logits to [T, B·K, V] (the LSTM scan's
        native layout — the train step uses it with transposed labels;
        see compute_loss).  ``rngs``: "z" (latent draws), "sample" (GMM
        cluster choice) and, unless ``deterministic``, "dropout"."""
        rngs = rngs or {}
        B = features.shape[0]
        K = enc_captions.shape[0] // B
        images_fv, c_emb = self._embed_conditioning(params, features, c_v)
        if K > 1:
            images_fv = jnp.repeat(images_fv, K, axis=0)
            c_emb = None if c_emb is None else jnp.repeat(c_emb, K, axis=0)
            c_v = None if c_v is None else jnp.repeat(c_v, K, axis=0)
        drop = None
        if not deterministic and (self.dec_keep_rate < 1.0
                                  or self.dec_lstm_drop < 1.0):
            drop = KeyStream(rngs["dropout"])

        out: Dict[str, jax.Array] = {}
        z_flat = None
        if not self.no_encoder:
            sample = rngs.get("sample")
            with jax.named_scope("encoder"):
                q_mean, q_std = self.encoder(
                    params["encoder"], images_fv, enc_captions, lengths,
                    c_emb=c_emb, c_v=c_v,
                    sample_key=None if sample is None
                    else fold_in_path(sample, "encoder", 1))
            # z is stored in compute dtype: its only consumer is the
            # z_proj matmul's input, and the [B·K, K_z·L] draw is the
            # largest tensor of the latent path
            with jax.named_scope("z_sample"):
                z = dist.sample_gaussian(
                    fold_in_path(rngs["z"], 1), q_mean, q_std,
                    self.gen_z_samples, dtype=self.compute_dtype)
                z_flat = z.reshape(z.shape[0], -1)         # [B*K, K_z*L]
            out["q_mean"], out["q_std"] = q_mean, q_std

        dec = self.decoder
        with jax.named_scope("decoder"):
            carry = dec.init_state(params["decoder"], images_fv, c_emb,
                                   z_flat, drop=drop)
            out["logits"] = dec.teacher_forcing(
                params["decoder"], carry, dec_captions, lengths, drop=drop,
                time_major=time_major)
        if c_v is not None:
            out["c_v"] = c_v
        return out

    # ------------------------------------------------------------------
    def decode_init(
        self,
        params: Params,
        features: jax.Array,               # [B, 4096]
        c_v: Optional[jax.Array] = None,   # [B, 90]
        rngs: Optional[Dict[str, jax.Array]] = None,
    ) -> Carry:
        """Generation-time initial LSTM state (ref decoder.py:41-114,
        gen_mode): z ~ N(z_mean, decode_std) with z_mean = 0, except the
        AG prior which centers on the image's active cluster means.

        The K_z z-samples are drawn directly in the projected space
        (Decoder.gen_z_embedding): exact same distribution, an E-dim
        draw instead of a K_z·L one."""
        B = features.shape[0]
        images_fv, c_emb = self._embed_conditioning(params, features, c_v)
        z_dec = None
        if not self.no_encoder:
            z_mean = jnp.zeros((B, self.latent_size), jnp.float32)
            if self.prior == "AG" and c_v is not None:
                z_mean = dist.ag_prior_mean(c_v, self.cluster_means)
            z_dec = self.decoder.gen_z_embedding(
                params["decoder"], fold_in_path(rngs["z"], 1), z_mean,
                self.decode_std,
                self.gen_z_samples)
        return self.decoder.init_state(params["decoder"], images_fv, c_emb,
                                       z_dec=z_dec)

    def decode_step(self, params: Params, carry: Carry,
                    tokens: jax.Array) -> Tuple[Carry, jax.Array]:
        """tokens [B] → (carry, logits [B, V])."""
        return self.decoder.step(params["decoder"], carry, tokens)

    def decode_step_hidden(self, params: Params, carry: Carry,
                           tokens: jax.Array) -> Tuple[Carry, jax.Array]:
        """tokens [B] → (carry, hidden [B, H]); see Decoder.step_hidden."""
        return self.decoder.step_hidden(params["decoder"], carry, tokens)


def logits_head_params(params) -> Tuple[jax.Array, jax.Array]:
    """(kernel, bias) of the decoder's rnn_logits head — single source of
    truth for the params-tree layout (CVAEModel: params['decoder'],
    FineTuneModel: params['cvae'][...])."""
    sub = params["cvae"] if "cvae" in params else params
    head = sub["decoder"]["rnn_logits"]
    return head["kernel"], head["bias"]


# ----------------------------------------------------------------------
# loss assembly (ref main.py:118-177)
# ----------------------------------------------------------------------

def compute_loss(
    outputs: Dict[str, jax.Array],
    labels: jax.Array,            # [B*K, T], 0 = PAD
    *,
    prior: str,
    no_encoder: bool,
    cluster_means: Optional[jax.Array] = None,
    cluster_sigma: float = 0.1,
    annealing: jax.Array | float = 1.0,
    gmm_true_kl: bool = False,
    ag_kl_sum: bool = False,
    time_major: bool = False,
) -> Dict[str, jax.Array]:
    """Masked CE + prior KL + annealing → lower bound.

    rec: sparse softmax CE over all positions, PAD masked via label sign,
    mean over real tokens (main.py:152-158).  total = rec + ann·kld/10 —
    the reference's fixed /10 KL weight (main.py:172-174).

    ``time_major=True``: the model forward ran with ``time_major=True``
    and ``labels`` is [T, B·K] (caller transposes — an s32 [B·K, T]
    relayout is ~100 KB vs the 63-126 MB activation relayouts it
    avoids).  The CE math is positionwise so only the KL row mask needs
    the axis flip.
    """
    # CE with f32 accumulation over compute-dtype (bf16) logits.
    # Same math as optax.softmax_cross_entropy_with_integer_labels on
    # logits.astype(f32) — the values are already bf16-rounded by the
    # head, so the upcast adds no precision — but the converts sit inside
    # single-consumer elementwise chains, so XLA fuses them into the
    # reductions instead of materialising an f32 [B·K, T, V] copy of the
    # step's largest tensor.
    #
    # The label logit is an iota==label masked reduction, not
    # take_along_axis: all three V-reductions then fuse into one pass
    # over the logits, and the backward is elementwise (softmax − onehot)
    # instead of a scatter.
    with jax.named_scope("ce_loss"):
        logits = outputs["logits"]
        m = jax.lax.stop_gradient(jnp.max(logits, axis=-1, keepdims=True))
        sumexp = jnp.sum(jnp.exp((logits - m).astype(jnp.float32)), axis=-1)
        lse = jnp.log(sumexp) + m[..., 0].astype(jnp.float32)
        onehot = (labels[..., None] == jax.lax.broadcasted_iota(
            jnp.int32, (1,) * labels.ndim + (logits.shape[-1],),
            labels.ndim))
        label_logit = jnp.sum(
            jnp.where(onehot, logits, 0).astype(jnp.float32), axis=-1)
        ce = lse - label_logit
        mask = (labels != 0).astype(jnp.float32)
        rec_loss = jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)
    # rows that are entirely padding (mesh-padded batches, images with
    # fewer than K captions) must not contribute to the KL mean either
    row_mask = jnp.any(labels != 0, axis=0 if time_major else -1)

    if no_encoder:
        kld = jnp.asarray(0.0, jnp.float32)
    elif prior == "AG":
        # ag_kl_sum restores the reference's implicit batch-sum weighting
        # of the AG KL (Config.ag_kl_sum; A/B in PERF.md)
        kld = dist.kl_ag(outputs["q_mean"], outputs["q_std"],
                         outputs["c_v"], cluster_means, cluster_sigma,
                         row_mask=row_mask,
                         reduce="sum" if ag_kl_sum else "mean")
    elif prior == "GMM" and gmm_true_kl:
        # opt-in true mixture KL (Config.gmm_true_kl); the default GMM
        # branch below keeps the reference's placeholder for parity
        kld = dist.kl_gmm(outputs["q_mean"], outputs["q_std"],
                          outputs["c_v"], cluster_means, cluster_sigma,
                          row_mask=row_mask)
    else:  # Normal; GMM uses the same formula (ref TODO, main.py:125-135)
        kld = dist.kl_standard_normal(outputs["q_mean"], outputs["q_std"],
                                      row_mask=row_mask)

    annealing = jnp.asarray(annealing, jnp.float32)
    lower_bound = rec_loss + annealing * kld / 10.0
    return {"loss": lower_bound, "rec_loss": rec_loss, "kld": kld,
            "annealing": annealing}
