"""Decode-step logits head fused with top-K and logsumexp.

Every beam-search and greedy step needs, per row of the decoder's hidden
state ``h [N, H]``, only the top-K of ``logits = h @ W + b`` and their
normaliser ``logsumexp(logits)``.  XLA computes the product with cuBLAS,
writes the ``[N, V]`` logits to device memory and reads them back for the
top-K and the reduction: at N = 98,304 rows (batch 32,768 × beam 3) and
V = 11,500 that is gigabytes per step, against ~24 MB of operands.  A
cuBLAS GEMM cannot be fused with a top-K epilogue, so this module carries
one Pallas kernel (Triton route) that keeps the logits on chip:

* the grid runs over row blocks; each block loops over the vocabulary
  in ``bv``-wide tiles and, inside each tile, over ``H`` in ``bk``-deep
  chunks (bf16 operands, f32 accumulation).  When there are too few row
  blocks to fill the card's 132 SMs (a greedy step at batch 4,096 has 64
  of 64 rows), a second grid axis splits the vocabulary; each split
  emits its own top-k and logsumexp, and a small XLA merge (``top_k``
  over splits·k candidates, ``logsumexp`` over splits) finishes;
* the running max and exp-sum of an online logsumexp and an unsorted
  set of the best ``kp`` (value, index) pairs live in registers; each
  tile's top-k is folded in by k extraction passes that evict the set's
  worst entry;
* ``W`` (512 × 11,500 bf16 = 11.8 MB) fits the 50 MB L2, so the per-block
  re-reads of each weight tile are L2 hits;
* the vocabulary tail is handled by masked loads (bias ``-inf``), and
  ties break to the lowest index, as ``lax.top_k`` does.

``use_kernel`` is the one place that decides the path: the kernel on a
GPU, the plain XLA reference everywhere else.  ``logits_top_k_xla`` is
that reference; the kernel's tests compare against it in interpret mode.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
from jax.sharding import Mesh, PartitionSpec as P

_BIG = 2 ** 30


def use_kernel(dtype: Any = jnp.bfloat16,
               platform: Optional[str] = None) -> bool:
    """True where the compiled kernel runs: a GPU, with the model in
    bfloat16 (the kernel's operand type).  Everywhere else — the CPU
    test backend, float32 models — decode takes ``logits_top_k_xla``."""
    if platform is None:
        platform = jax.devices()[0].platform
    return platform == "gpu" and jnp.dtype(dtype) == jnp.bfloat16


# ----------------------------------------------------------------------
# plain XLA
# ----------------------------------------------------------------------

def top_k_logsumexp(logits: jax.Array, k: int
                    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Materialised logits [N, V] → (values [N, k], indices [N, k],
    logsumexp [N]); ties go to the lowest index (``lax.top_k``)."""
    vals, idx = jax.lax.top_k(logits, k)
    return vals, idx, jax.scipy.special.logsumexp(logits, axis=-1)


def logits_top_k_xla(h: jax.Array, w: jax.Array, b: jax.Array, k: int,
                     dtype: Any = jnp.bfloat16
                     ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Reference: ``dtype`` product with f32 accumulation (bf16, as the
    kernel, by default)."""
    logits = jax.lax.dot_general(
        h.astype(dtype), w.astype(dtype),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32) + b.astype(jnp.float32)[None, :]
    return top_k_logsumexp(logits, k)


# ----------------------------------------------------------------------
# Pallas kernel (Triton route)
# ----------------------------------------------------------------------

def _kernel(h_ref, w_ref, b_ref, vals_ref, idx_ref, lse_ref, *,
            k: int, kp: int, v_real: int, bm: int, bv: int, bk: int,
            tiles_per_split: int, rows_total: int):
    i, split = pl.program_id(0), pl.program_id(1)
    rows = pl.ds(i * bm, bm)
    out_rows = pl.ds(split * rows_total + i * bm, bm)
    n_k = h_ref.shape[1] // bk
    lane = jnp.arange(bv, dtype=jnp.int32)
    slot = jnp.arange(kp, dtype=jnp.int32)[None, :]          # [1, kp]
    neg = jnp.float32(-jnp.inf)

    def tile(j, carry):
        rv, ri, m, s = carry
        col1 = j * bv + lane                                  # [bv]
        col = col1[None, :]                                   # [1, bv]
        cols = pl.ds(j * bv, bv)
        in_vocab = col1 < v_real

        def chunk(kk, acc):
            ks = pl.ds(kk * bk, bk)
            hk = h_ref[rows, ks]
            wk = plgpu.load(w_ref.at[ks, cols],
                            mask=jnp.broadcast_to(in_vocab[None, :],
                                                  (bk, bv)),
                            other=0.0)
            return acc + pl.dot(hk, wk)

        acc = jax.lax.fori_loop(0, n_k, chunk,
                                jnp.zeros((bm, bv), jnp.float32))
        bias = plgpu.load(b_ref.at[cols], mask=in_vocab, other=neg)
        logits = acc + bias[None, :]

        # online logsumexp
        m_new = jnp.maximum(m, jnp.max(logits, axis=1))
        s = (s * jnp.exp(m - m_new)
             + jnp.sum(jnp.exp(logits - m_new[:, None]), axis=1))

        # fold this tile's top-k into the running set: each pass takes
        # the tile's best remaining (value, lowest index) and evicts the
        # set's worst entry (lowest value, then highest index) if beaten
        work = logits
        for _ in range(k):
            v = jnp.max(work, axis=1)
            vi = jnp.min(jnp.where(work == v[:, None], col, _BIG), axis=1)
            work = jnp.where(col == vi[:, None], neg, work)
            lo = jnp.min(rv, axis=1)
            evict = jnp.max(jnp.where(rv == lo[:, None], ri, -1), axis=1)
            hit = (ri == evict[:, None]) & (v > lo)[:, None]
            rv = jnp.where(hit, v[:, None], rv)
            ri = jnp.where(hit, vi[:, None], ri)
        return rv, ri, m_new, s

    carry = (jnp.full((bm, kp), neg),
             _BIG + jnp.broadcast_to(slot, (bm, kp)),          # unique
             jnp.full((bm,), neg), jnp.zeros((bm,), jnp.float32))
    first = split * tiles_per_split
    last = jnp.minimum(first + tiles_per_split, pl.cdiv(v_real, bv))
    rv, ri, m, s = jax.lax.fori_loop(first, last, tile, carry)

    # sort the set best-first (value desc, index asc)
    out_v = jnp.full((bm, kp), neg)
    out_i = jnp.zeros((bm, kp), jnp.int32)
    for t in range(k):
        v = jnp.max(rv, axis=1)
        vi = jnp.min(jnp.where(rv == v[:, None], ri, _BIG), axis=1)
        out_v = jnp.where(slot == t, v[:, None], out_v)
        out_i = jnp.where(slot == t, vi[:, None], out_i)
        rv = jnp.where(ri == vi[:, None], neg, rv)
    vals_ref[out_rows, :] = out_v
    idx_ref[out_rows, :] = out_i
    lse_ref[out_rows] = m + jnp.log(s)


# (bm, bv, bk, num_warps, num_stages), by k: a 256-wide vocabulary tile
# halves the tile-loop overhead while the extraction passes are few; at
# k = 10 its ten passes over [128, 256] run 2.9x slower than over a
# 128-wide tile (block sweep on the H100, PERF.md)
_BLOCKS_FEW_K = (128, 256, 64, 8, 3)
_BLOCKS = (128, 128, 64, 8, 3)
# grid blocks wanted before the vocabulary is split: two per SM of the
# H100's 132
_MIN_BLOCKS = 264


def vocab_splits(row_blocks: int, n_tiles: int,
                 min_blocks: int = _MIN_BLOCKS) -> Tuple[int, int]:
    """(splits, tiles per split): the fewest vocabulary splits that give
    at least ``min_blocks`` grid blocks, none of them empty."""
    splits = min(n_tiles, max(1, pl.cdiv(min_blocks, row_blocks)))
    per_split = pl.cdiv(n_tiles, splits)
    return pl.cdiv(n_tiles, per_split), per_split


@functools.partial(jax.jit, static_argnames=("k", "interpret", "blocks",
                                             "min_blocks"))
def logits_top_k_pallas(h: jax.Array, w: jax.Array, b: jax.Array, k: int,
                        interpret: bool = False, blocks=None,
                        min_blocks: int = _MIN_BLOCKS
                        ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """h [M, H], w [H, V], b [V] → (top-k values [M, k] f32, indices
    [M, k] i32, logsumexp [M] f32) of ``h @ w + b``, with no [M, V]
    array in device memory.  H must be a multiple of ``bk``.  ``blocks``
    (bm, bv, bk, num_warps, num_stages) defaults by k."""
    if blocks is None:
        blocks = _BLOCKS_FEW_K if k <= 4 else _BLOCKS
    bm, bv, bk, num_warps, num_stages = blocks
    M, H = h.shape
    V = w.shape[1]
    if H % bk:
        raise ValueError(f"hidden size {H} is not a multiple of {bk}")
    if V < k:
        raise ValueError(f"k={k} exceeds the vocabulary ({V})")
    kp = max(2, int(pl.next_power_of_2(k)))
    h16 = h.astype(jnp.bfloat16)
    m_pad = (-M) % bm
    if m_pad:
        h16 = jnp.pad(h16, ((0, m_pad), (0, 0)))
    Mp = h16.shape[0]
    splits, per_split = vocab_splits(Mp // bm, pl.cdiv(V, bv), min_blocks)

    vals, idx, lse = pl.pallas_call(
        functools.partial(_kernel, k=k, kp=kp, v_real=V, bm=bm, bv=bv,
                          bk=bk, tiles_per_split=per_split, rows_total=Mp),
        grid=(Mp // bm, splits),
        out_shape=(jax.ShapeDtypeStruct((splits * Mp, kp), jnp.float32),
                   jax.ShapeDtypeStruct((splits * Mp, kp), jnp.int32),
                   jax.ShapeDtypeStruct((splits * Mp,), jnp.float32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="logits_top_k",
        cost_estimate=pl.CostEstimate(
            flops=2 * Mp * H * V, transcendentals=Mp * V,
            bytes_accessed=(Mp * H * 2 * splits + H * V * 2 + V * 4
                            + splits * Mp * kp * 8)),
    )(h16, w.astype(jnp.bfloat16), b.astype(jnp.float32))
    vals = vals.reshape(splits, Mp, kp)[:, :M, :k]
    idx = idx.reshape(splits, Mp, kp)[:, :M, :k]
    lse = lse.reshape(splits, Mp)[:, :M]
    if splits == 1:
        return vals[0], idx[0], lse[0]
    # candidates split-major: equal values keep the lowest column first,
    # so top_k's lowest-position tie rule is the lowest-index rule
    cat_v = vals.transpose(1, 0, 2).reshape(M, splits * k)
    cat_i = idx.transpose(1, 0, 2).reshape(M, splits * k)
    top_v, pos = jax.lax.top_k(cat_v, k)
    return (top_v, jnp.take_along_axis(cat_i, pos, axis=1),
            jax.scipy.special.logsumexp(lse, axis=0))


# ----------------------------------------------------------------------
# dispatch + data-parallel wrapper
# ----------------------------------------------------------------------

def logits_top_k(h: jax.Array, w: jax.Array, b: jax.Array, k: int, *,
                 dtype: Any = jnp.bfloat16, kernel: Optional[bool] = None,
                 mesh: Optional[Mesh] = None, axis: str = "dp"):
    """Top-k + logsumexp of ``h @ w + b`` on the path ``use_kernel``
    picks (``kernel`` overrides it; ``dtype`` is the model's compute
    dtype).  A ``pallas_call`` has no partitioning rule, so with a
    multi-device ``mesh`` the kernel runs under ``shard_map``: rows split
    over ``axis``, weights replicated, no collectives (every output is
    per row).  A row count the mesh does not divide runs unsharded."""
    if kernel is None:
        kernel = use_kernel(dtype)
    if not kernel:
        return logits_top_k_xla(h, w, b, k, dtype)
    fn = functools.partial(logits_top_k_pallas, k=k)
    n = 1 if mesh is None else int(np.prod(mesh.devices.shape))
    if n <= 1 or h.shape[0] % n:
        return fn(h, w, b)
    return jax.shard_map(fn, mesh=mesh, in_specs=(P(axis), P(), P()),
                         out_specs=(P(axis), P(axis), P(axis)),
                         check_vma=False)(h, w, b)
