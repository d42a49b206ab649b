"""Plain-JAX layer primitives and the model calling convention.

Every model in the package is a frozen dataclass of hyperparameters plus
an explicit parameter pytree:

* ``model.init(rngs, *example_args)`` returns ``{"params": tree}``;
  ``rngs`` is a key or a dict holding one under ``"params"``;
* ``model.apply(variables, *args, method=Cls.fn, **kw)`` calls
  ``fn(model, variables["params"], *args, **kw)``.

Randomness is explicit: methods that draw take ``rngs``, a dict of keys
(``"z"`` latent samples, ``"sample"`` GMM cluster choice, ``"dropout"``).

Initialisation: LeCun-normal dense and conv kernels, zero biases,
fan-in-normal embeddings, Glorot-uniform LSTM kernels.  Each parameter's
key is ``fold_in_path(root, *module_path, n)`` — the root key folded
with the SHA-1 of its module path and its 1-based index within the
module.  That is the derivation the parameter trees were first built
with, so a seed reproduces the same parameters (and latent draws) as
checkpoints and results made before.

``HighwayNetwork`` mirrors the reference's ``highway_network``
(``utils/rnn_model.py:53-74`` — present there but never called; kept in
the capability surface as a usable, tested module):

  y = g · relu(W_h x + b_h) + (1 − g) · x,   g = sigmoid(W_t x + b_t)

with the reference's −1.0 transform-gate bias init (biases the network
toward carry behaviour early in training).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, Any]
Path = Tuple[str, ...]

_lecun_normal = jax.nn.initializers.lecun_normal()
_embed_normal = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "normal", out_axis=0)


class Module:
    """Base for the dataclass models: ``apply`` dispatches to a method
    with the params tree as its first argument."""

    def apply(self, variables: Params, *args, method=None, **kw):
        fn = method if method is not None else type(self).__call__
        fn = getattr(fn, "__func__", fn)   # accept bound methods too
        return fn(self, variables["params"], *args, **kw)


def params_key(rngs) -> jax.Array:
    """The init key from a bare key or a ``{"params": key, ...}`` dict."""
    return rngs["params"] if isinstance(rngs, dict) else rngs


def fold_in_path(key: jax.Array, *path) -> jax.Array:
    """``key`` folded with the SHA-1 of a static path of names and ints."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class KeyStream:
    """Distinct keys drawn in call order from one base key."""

    def __init__(self, key: jax.Array):
        self._key = key
        self._n = 0

    def __call__(self) -> jax.Array:
        self._n += 1
        return jax.random.fold_in(self._key, self._n)


# ----------------------------------------------------------------------
# dense / embedding / conv
# ----------------------------------------------------------------------

def dense_init(root: jax.Array, path: Path, in_features: int,
               out_features: int, bias: float = 0.0) -> Params:
    return {"kernel": _lecun_normal(fold_in_path(root, *path, 1),
                                    (in_features, out_features),
                                    jnp.float32),
            "bias": jnp.full((out_features,), bias, jnp.float32)}


def dense(p: Params, x: jax.Array, dtype: Any = None) -> jax.Array:
    """``x @ kernel + bias`` over the last axis.  ``dtype=None`` computes
    in the promoted dtype of input and params (f32); a given dtype casts
    all three operands, so the output is in that dtype."""
    kernel, bias = p["kernel"], p["bias"]
    if dtype is None:
        dtype = jnp.result_type(x, kernel)
    y = jax.lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    return y + bias.astype(dtype)


def embed_init(root: jax.Array, path: Path, vocab_size: int,
               features: int) -> Params:
    return {"embedding": _embed_normal(fold_in_path(root, *path, 1),
                                       (vocab_size, features), jnp.float32)}


def embed(p: Params, ids: jax.Array) -> jax.Array:
    return jnp.take(p["embedding"], ids, axis=0)


def conv3x3_init(root: jax.Array, path: Path, in_ch: int,
                 out_ch: int) -> Params:
    return {"kernel": _lecun_normal(fold_in_path(root, *path, 1),
                                    (3, 3, in_ch, out_ch), jnp.float32),
            "bias": jnp.zeros((out_ch,), jnp.float32)}


def conv3x3(p: Params, x: jax.Array, dtype: Any) -> jax.Array:
    """SAME-padded stride-1 NHWC convolution with an HWIO kernel."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + p["bias"].astype(dtype)


def max_pool2x2(x: jax.Array) -> jax.Array:
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "SAME")


def dropout(key: jax.Array, x: jax.Array, keep: float) -> jax.Array:
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


# ----------------------------------------------------------------------
# highway network
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HighwayNetwork(Module):
    num_layers: int = 1
    transform_bias_init: float = -1.0

    def init(self, rngs, x: jax.Array) -> Params:
        root, f = params_key(rngs), x.shape[-1]
        params = {}
        for i in range(self.num_layers):
            params[f"h_{i}"] = dense_init(root, (f"h_{i}",), f, f)
            params[f"t_{i}"] = dense_init(root, (f"t_{i}",), f, f,
                                          self.transform_bias_init)
        return {"params": params}

    def __call__(self, params: Params, x: jax.Array,
                 rngs: Optional[dict] = None) -> jax.Array:
        for i in range(self.num_layers):
            h = jax.nn.relu(dense(params[f"h_{i}"], x))
            gate = jax.nn.sigmoid(dense(params[f"t_{i}"], x))
            x = gate * h + (1.0 - gate) * x
        return x
