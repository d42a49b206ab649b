"""LSTM machinery in plain JAX.

Replaces the reference's cell plumbing (``utils/rnn_model.py:7-51``:
MultiRNNCell + DropoutWrapper + ``rnn_placeholders`` state injection) and
``tf.nn.dynamic_rnn``.  Design:

  * One **fused cell**: a single ``[E+H, 4H]`` matmul per step instead of
    four small ones.  Gate order (i, f, g, o) and the TF-LSTMCell
    ``forget_bias = 1.0`` are preserved because they shape early
    training dynamics.
  * **`lax.scan` over time** with per-step length masking replaces
    ``dynamic_rnn(sequence_length=...)``: carry copies through after a
    sequence ends, outputs are zeroed — identical semantics, one compiled
    loop.
  * **No state placeholders.** Decode carries the ``(c, h)`` PyTree
    explicitly through jitted step functions (see ops/decoding.py); the
    ``rnn_placeholders`` trick exists only because TF1 graphs can't.

Params are fp32; matmuls run in ``compute_dtype`` (bfloat16 by default)
with fp32 accumulation via ``preferred_element_type``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from vae_captioning.ops.layers import (Module, Params, Path, dropout,
                                           fold_in_path, params_key)

# carry for one layer: (c, h), each [B, H]
LayerCarry = Tuple[jax.Array, jax.Array]
# carry for a stack: tuple over layers
Carry = Tuple[LayerCarry, ...]

_glorot_uniform = jax.nn.initializers.glorot_uniform()


def _mm(x: jax.Array, w: jax.Array, cd: Any) -> jax.Array:
    return jax.lax.dot_general(
        x.astype(cd), w.astype(cd), (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


@dataclasses.dataclass(frozen=True)
class LSTMCell(Module):
    """Fused LSTM cell: gates = [x, h] @ W + b, W: [E+H, 4H].

    Two calling forms, one parameter set:
      * ``x: [B, E]`` — single step, concat form (decode path).
      * ``x: [B, T, E]`` with ``mask: [B, T]`` — masked teacher-forcing
        sequence.  The input half of the gate matmul is HOISTED out of
        the time scan as one big ``[B·T, E] @ [E, 4H]`` matmul
        (teacher-forcing inputs are known up front); the scan body is
        only ``h @ W_h`` + elementwise, and no per-step ``concat(x, h)``
        copies sit in the loop.
    """

    hidden_size: int
    compute_dtype: Any = jnp.float32
    forget_bias: float = 1.0

    def init_params(self, root: jax.Array, path: Path,
                    in_features: int) -> Params:
        H = self.hidden_size
        return {"kernel": _glorot_uniform(fold_in_path(root, *path, 1),
                                          (in_features + H, 4 * H),
                                          jnp.float32),
                "bias": jnp.zeros((4 * H,), jnp.float32)}

    def init(self, rngs, carry: LayerCarry, x: jax.Array, *args,
             **kw) -> Params:
        return {"params": self.init_params(params_key(rngs), (),
                                           x.shape[-1])}

    def _gate_math(self, gates, c):
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        new_c = (jax.nn.sigmoid(f + self.forget_bias) * c
                 + jax.nn.sigmoid(i) * jnp.tanh(g))
        return new_c, jax.nn.sigmoid(o) * jnp.tanh(new_c)

    def __call__(self, params: Params, carry: LayerCarry, x: jax.Array,
                 mask: Optional[jax.Array] = None,
                 time_major_out: bool = False,
                 collect_outputs: bool = True):
        c, h = carry
        kernel, bias = params["kernel"], params["bias"]
        cd = self.compute_dtype
        in_features = x.shape[-1]

        if x.ndim == 2:  # single step, concat form
            gates = _mm(jnp.concatenate([x, h], axis=-1), kernel, cd) + bias
            new_c, new_h = self._gate_math(gates, c)
            return (new_c, new_h), new_h

        # masked sequence [B, T, E]: hoisted input projection.  Transpose
        # to time-major BEFORE the matmul: the scan consumes [T, B, 4H],
        # and transposing the [B, T, E] input moves 4-8× fewer bytes than
        # transposing the [B, T, 4H] gates after.
        if mask is None:
            raise ValueError("a [B, T, E] sequence needs its [B, T] mask")
        w_h = kernel[in_features:].astype(cd)
        xw = _mm(x.swapaxes(0, 1), kernel[:in_features], cd)   # [T, B, 4H]

        def body(ch, inp):
            c, h = ch
            xw_t, m_t = inp                                     # [B, 4H], [B]
            gates = xw_t + _mm(h, w_h, cd) + bias
            new_c, new_h = self._gate_math(gates, c)
            m = m_t[:, None]
            new_ch = (jnp.where(m, new_c, c), jnp.where(m, new_h, h))
            if not collect_outputs:
                return new_ch, None
            return new_ch, jnp.where(m, new_h, 0.0)

        (c, h), hs = jax.lax.scan(body, (c, h), (xw, mask.T))
        if hs is None or time_major_out:
            return (c, h), hs                                   # [T, B, H] / None
        return (c, h), hs.swapaxes(0, 1)                        # [B, T, H]


@dataclasses.dataclass(frozen=True)
class LSTMStack(Module):
    """Multi-layer LSTM with single-step and masked-sequence application.

    ``num_layers`` defaults to 1 in every reference config
    (``utils/parameters.py:20,25``); the stack mirrors MultiRNNCell for
    the general case.  ``output_keep_rate`` reproduces DropoutWrapper's
    output dropout (``utils/rnn_model.py:36-38``), active only when a
    dropout key is passed.  Params: ``{"cell_0": ..., "cell_1": ...}``.
    """

    hidden_size: int
    num_layers: int = 1
    compute_dtype: Any = jnp.float32
    output_keep_rate: float = 1.0

    @property
    def cell(self) -> LSTMCell:
        return LSTMCell(self.hidden_size, self.compute_dtype)

    def init_params(self, root: jax.Array, path: Path,
                    in_features: int) -> Params:
        return {f"cell_{i}": self.cell.init_params(
                    root, path + (f"cell_{i}",),
                    in_features if i == 0 else self.hidden_size)
                for i in range(self.num_layers)}

    def init(self, rngs, carry: Carry, xs: jax.Array, *args,
             **kw) -> Params:
        return {"params": self.init_params(params_key(rngs), (),
                                           xs.shape[-1])}

    def zero_carry(self, batch_size: int) -> Carry:
        z = jnp.zeros((batch_size, self.hidden_size), jnp.float32)
        return tuple((z, z) for _ in range(self.num_layers))

    def _dropping(self, key: Optional[jax.Array]) -> bool:
        return key is not None and self.output_keep_rate < 1.0

    def step(self, params: Params, carry: Carry, x: jax.Array,
             dropout_key: Optional[jax.Array] = None
             ) -> Tuple[Carry, jax.Array]:
        """One timestep through all layers; input [B, E] → output [B, H].
        ``dropout_key`` turns on output dropout (training)."""
        new_carry = []
        inp = x
        for i, layer_carry in enumerate(carry):
            layer_carry, inp = self.cell(params[f"cell_{i}"], layer_carry,
                                         inp)
            if self._dropping(dropout_key):
                inp = dropout(jax.random.fold_in(dropout_key, i), inp,
                              self.output_keep_rate)
            new_carry.append(layer_carry)
        return tuple(new_carry), inp

    def __call__(self, params: Params, carry: Carry, xs: jax.Array,
                 lengths: jax.Array,
                 dropout_key: Optional[jax.Array] = None,
                 time_major_out: bool = False,
                 collect_outputs: bool = True) -> Tuple[Carry, jax.Array]:
        """Masked sequence run (dynamic_rnn semantics).

        xs: [B, T, E], lengths: [B] → (final_carry_at_length, outputs [B, T, H]).
        Steps at t >= length copy the carry through and emit zeros.

        ``time_major_out`` returns the outputs as [T, B, H] (the scan's
        native layout); ``collect_outputs=False`` skips stacking outputs
        entirely (the encoder only uses the final carry).  Both apply to
        the LAST layer only; with multiple layers the inter-layer handoff
        keeps the batch-major convention.
        """
        T = xs.shape[1]
        t_index = jnp.arange(T, dtype=lengths.dtype)
        mask = t_index[None, :] < lengths[:, None]  # [B, T]

        if not self._dropping(dropout_key):
            # per-layer hoisted-input scan (see LSTMCell).  Inter-layer
            # masking zeroes each layer's masked outputs instead of only
            # the last one's — observationally identical (downstream
            # carries are mask-frozen either way).
            new_carry = []
            inp = xs
            last = len(carry) - 1
            for i, layer_carry in enumerate(carry):
                layer_carry, inp = self.cell(
                    params[f"cell_{i}"], layer_carry, inp, mask,
                    time_major_out=(i == last and time_major_out),
                    collect_outputs=(i != last or collect_outputs))
                new_carry.append(layer_carry)
            return tuple(new_carry), inp

        # dropout path: a fresh dropout key per timestep
        def body(carry, inp):
            t, x_t, m_t = inp
            stepped, h = self.step(params, carry, x_t,
                                   jax.random.fold_in(dropout_key, t))
            carry = jax.tree.map(
                lambda n, o: jnp.where(m_t[:, None], n, o), stepped, carry)
            return carry, jnp.where(m_t[:, None], h, 0.0)

        carry, hs = jax.lax.scan(
            body, carry, (jnp.arange(T), xs.swapaxes(0, 1), mask.T))
        if not collect_outputs:
            return carry, None
        return carry, hs if time_major_out else hs.swapaxes(0, 1)
