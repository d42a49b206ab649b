"""End-to-end fine-tune model: VGG16 backbone + CVAE head in one model.

The reference's fine-tune mode (``main.py:46-89``): raw 224×224 images
feed VGG16 under scope ``cnn`` (with dropout + L2 regularization while
training), fc2 features feed the captioning graph; two optimizers update
disjoint variable sets, with ``fine_tune_fe`` / ``fine_tune_top`` gating
conv vs fc trainability (``utils/image_embeddings.py:16-19``).

Here: one model with params tree ``{'vgg16': …, 'cvae': …}``; the
optimizer routes ``vgg16/conv*`` and ``vgg16/fc*`` to separate
(possibly frozen) chains — see ``train.make_finetune_optimizer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from vae_captioning.config import Config
from vae_captioning.models.cvae import CVAEModel
from vae_captioning.models.vgg16 import VGG16
from vae_captioning.ops.layers import Module, Params, params_key
from vae_captioning.ops.lstm import Carry


@dataclasses.dataclass(frozen=True)
class FineTuneModel(Module):
    config: Config

    @classmethod
    def from_config(cls, cfg: Config) -> "FineTuneModel":
        return cls(config=cfg)

    @property
    def vgg16(self) -> VGG16:
        cfg = self.config
        return VGG16(
            compute_dtype=jnp.dtype(cfg.compute_dtype),
            dropout_keep=cfg.cnn_dropout if cfg.mode == "training" else 1.0,
            trainable_top=True)  # enables dropout gating as in the ref

    @property
    def cvae(self) -> CVAEModel:
        return CVAEModel.from_config(self.config)

    def init(self, rngs, images: jax.Array, *args, **kw) -> Params:
        root = params_key(rngs)
        return {"params": {
            "vgg16": self.vgg16.init_params(root, images.shape[1],
                                            ("vgg16",)),
            "cvae": self.cvae.init_params(root, self.config.cnn_feature_size,
                                          ("cvae",))}}

    # ------------------------------------------------------------------
    def _features(self, params: Params, images: jax.Array,
                  deterministic: bool, rngs) -> jax.Array:
        vgg_rngs = None
        if rngs and "dropout" in rngs:
            vgg_rngs = {"dropout": jax.random.fold_in(rngs["dropout"], 1)}
        return self.vgg16(params["vgg16"], images, deterministic, vgg_rngs)

    def extract_features(self, params: Params, images: jax.Array,
                         deterministic: bool = True) -> jax.Array:
        return self._features(params, images, deterministic, None)

    def __call__(self, params: Params, images: jax.Array,
                 enc_captions: jax.Array, dec_captions: jax.Array,
                 lengths: jax.Array, c_v: Optional[jax.Array] = None,
                 deterministic: bool = True, time_major: bool = False,
                 rngs: Optional[Dict[str, jax.Array]] = None
                 ) -> Dict[str, jax.Array]:
        features = self._features(params, images, deterministic, rngs)
        return self.cvae(params["cvae"], features, enc_captions,
                         dec_captions, lengths, c_v, deterministic,
                         time_major, rngs)

    def decode_init(self, params: Params, images: jax.Array,
                    c_v: Optional[jax.Array] = None,
                    rngs: Optional[Dict[str, jax.Array]] = None) -> Carry:
        features = self._features(params, images, True, None)
        return self.cvae.decode_init(params["cvae"], features, c_v, rngs)

    def decode_step(self, params: Params, carry: Carry,
                    tokens: jax.Array) -> Tuple[Carry, jax.Array]:
        return self.cvae.decode_step(params["cvae"], carry, tokens)

    def decode_step_hidden(self, params: Params, carry: Carry,
                           tokens: jax.Array) -> Tuple[Carry, jax.Array]:
        return self.cvae.decode_step_hidden(params["cvae"], carry, tokens)


def load_vgg_into_params(params: Any, weights_path: str) -> Any:
    """Replace the ``vgg16`` subtree with the Caffe-npz ImageNet weights
    (ref main.py:205-208 loads them on every fresh run)."""
    from vae_captioning.models.vgg16 import load_npz_weights

    loaded = load_npz_weights(weights_path)
    new_params = dict(params)
    new_params["vgg16"] = jax.tree.map(jnp.asarray, loaded)
    return new_params
