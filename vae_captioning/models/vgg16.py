"""VGG16 vision backbone in plain JAX.

Mirrors the reference's hand-written TF1 VGG16
(``utils/image_embeddings.py:14-238``): 13 conv layers in 5 blocks with
2×2 max-pool, fc1/fc2 (4096) — fc2 (post-ReLU) is the image feature.
ImageNet mean subtraction with the same hard-coded RGB means
(``:30-34``) happens inside the module, so callers feed raw [0,255] RGB.

``load_npz_weights`` consumes the Caffe-converted ``vgg16_weights.npz``
by sorted key order, first 30 arrays (``:240-246``) — fc8 (the 1000-way
classifier) is dropped.  TF's ``[3,3,in,out]`` conv layout and NHWC
flatten order match the HWIO/NHWC layout here, so weights map over
unchanged.

Convs run in ``compute_dtype`` (bfloat16 by default); dropout on fc1/fc2
only when the top is trainable, as in the reference
(``:225-226,236-237``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vae_captioning.ops.layers import (Module, Params, Path, conv3x3,
                                           conv3x3_init, dense, dense_init,
                                           dropout, max_pool2x2, params_key)

# (name, out_channels) per conv layer; pools after each block
_CONV_BLOCKS = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)

_IMAGENET_MEAN = (123.68, 116.779, 103.939)  # RGB, ref :31-33


@dataclasses.dataclass(frozen=True)
class VGG16(Module):
    """Feature extractor: images [B, S, S, 3] (RGB, 0..255) → fc2 [B, 4096].
    S is 224 for the ImageNet weights; the module is shape-polymorphic
    (fc1's input width follows S)."""

    compute_dtype: Any = jnp.float32
    dropout_keep: float = 1.0       # keep rate; applied only if trainable_top
    trainable_top: bool = False     # gates dropout exactly like the ref

    def init_params(self, root: jax.Array, image_size: int = 224,
                    path: Path = ()) -> Params:
        params: Params = {}
        in_ch, size = 3, image_size
        for block in _CONV_BLOCKS:
            for name, features in block:
                params[name] = conv3x3_init(root, path + (name,), in_ch,
                                            features)
                in_ch = features
            size = math.ceil(size / 2)              # SAME 2×2 pool
        params["fc1"] = dense_init(root, path + ("fc1",),
                                   size * size * in_ch, 4096)
        params["fc2"] = dense_init(root, path + ("fc2",), 4096, 4096)
        return params

    def init(self, rngs, images: jax.Array, *args, **kw) -> Params:
        return {"params": self.init_params(params_key(rngs),
                                           images.shape[1])}

    def __call__(self, params: Params, images: jax.Array,
                 deterministic: bool = True,
                 rngs: Optional[Dict[str, jax.Array]] = None) -> jax.Array:
        cd = self.compute_dtype
        # subtract in f32 regardless of input dtype: uint8 images (the
        # packed stores ship raw pixels) must NOT wrap modulo 256
        x = images.astype(jnp.float32) - jnp.asarray(_IMAGENET_MEAN,
                                                     jnp.float32)
        x = x.astype(cd)
        for block in _CONV_BLOCKS:
            for name, _ in block:
                x = jax.nn.relu(conv3x3(params[name], x, cd))
            x = max_pool2x2(x)
        x = x.reshape((x.shape[0], -1))  # NHWC flatten, matches TF order
        drop = (self.trainable_top and self.dropout_keep < 1.0
                and not deterministic)
        for i, name in enumerate(("fc1", "fc2")):
            x = jax.nn.relu(dense(params[name], x, cd))
            if drop:
                x = dropout(jax.random.fold_in(rngs["dropout"], i), x,
                            self.dropout_keep)
        return x.astype(jnp.float32)


def load_npz_weights(weights_path: str) -> Dict[str, Any]:
    """Load the Caffe-converted npz into a VGG16 params dict.

    Key layout: ``conv1_1_W ... conv5_3_b, fc6_W, fc6_b, fc7_W, fc7_b,
    fc8_*`` — sorted order puts all conv arrays first, then fc6..fc8; the
    reference assigns the first 30 sorted arrays positionally
    (``utils/image_embeddings.py:240-246``).  We map by name, asserting
    the same shapes, and drop fc8.
    """
    raw = np.load(weights_path)
    params: Dict[str, Any] = {}
    for block in _CONV_BLOCKS:
        for name, features in block:
            kernel = np.asarray(raw[f"{name}_W"], np.float32)
            bias = np.asarray(raw[f"{name}_b"], np.float32)
            if kernel.shape[-1] != features:
                raise ValueError(
                    f"{name}: expected {features} filters, got {kernel.shape}")
            params[name] = {"kernel": kernel, "bias": bias}
    params["fc1"] = {"kernel": np.asarray(raw["fc6_W"], np.float32),
                     "bias": np.asarray(raw["fc6_b"], np.float32)}
    params["fc2"] = {"kernel": np.asarray(raw["fc7_W"], np.float32),
                     "bias": np.asarray(raw["fc7_b"], np.float32)}
    if params["fc1"]["kernel"].shape != (25088, 4096):
        raise ValueError("fc6 kernel must be [25088, 4096] "
                         f"(got {params['fc1']['kernel'].shape})")
    return params
