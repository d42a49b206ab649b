"""Device mesh + sharding rules.

The reference is strictly single-process / single-GPU
(``utils/parameters.py:163-164``; SURVEY §2 'Parallelism strategies:
None').  The equivalent here (SURVEY §5) is pure data parallelism over
the cards: at ~15M parameters the model needs no tensor/pipeline split,
so params are replicated and the batch is sharded over the ``dp`` axis.
The SPMD partitioner then inserts the gradient all-reduce; the same code
path covers several hosts via ``jax.distributed``.

Decode is embarrassingly parallel over images, so beam search shards the
image batch the same way — no traffic between cards during generation.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def create_mesh(devices: Optional[Sequence[jax.Device]] = None,
                axis_name: str = "dp") -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = "dp") -> NamedSharding:
    """Shard the leading (batch) dim; everything else replicated."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree: Any, mesh: Mesh, axis_name: str = "dp") -> Any:
    """Device_put every leaf with its batch dim sharded over the mesh.

    Multi-host (``jax.process_count() > 1``): each process passes its
    OWN slice of the global batch (global_batch / process_count rows)
    and the leaves are assembled into global arrays via
    ``make_array_from_process_local_data`` — the standard JAX multi-host
    input path (SURVEY §5: DCN handled by the same code path)."""
    sharding = batch_sharding(mesh, axis_name)
    if jax.process_count() > 1:
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(sharding, x),
            tree)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def initialize_multihost() -> None:
    """Join the jax.distributed cluster (multi-host training).  Reads the
    standard coordinator env vars; call once at process start."""
    jax.distributed.initialize()


def replicate(tree: Any, mesh: Mesh) -> Any:
    sharding = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def prepare_process_batch(arrays: Sequence[np.ndarray], K: int,
                          n_devices: int, P: int = 1, pid: int = 0):
    """Pure multi-host batch prep: pad, then slice this process's rows.

    ``arrays`` is the flattened train batch
    ``(features[B], enc[B*K], dec[B*K], lengths[B*K], c_v[B])``.
    The image dim ``B`` is padded up to a multiple of ``n_devices`` (the
    GLOBAL device count) and the caption arrays to ``B' * K`` — padding
    the two leading dims independently would break the model's
    K = rows(captions)/rows(features) inference and silently mispair
    images with captions.  With ``P`` processes, each contributes only
    its contiguous ``B'/P`` image rows (and the matching caption rows);
    every process must have built the SAME seed-deterministic global
    batch, otherwise ``make_array_from_process_local_data`` would
    assemble P duplicated copies and multi-host training would silently
    degenerate to single-host gradients.

    Raises if the mesh does not split evenly over processes — the only
    configuration where ``B' // P`` would drop rows.
    """
    features, enc, dec, lengths, c_v = arrays
    B = int(features.shape[0])
    if enc.shape[0] != B * K or dec.shape[0] != B * K \
            or lengths.shape[0] != B * K:
        raise ValueError(
            f"caption rows {enc.shape[0]} != B*K = {B}*{K}")
    if n_devices % P != 0:
        raise ValueError(
            f"global device count {n_devices} not divisible by process "
            f"count {P}; the dp mesh must span all processes evenly")
    if not (0 <= pid < P):
        raise ValueError(f"process_index {pid} out of range for P={P}")
    Bp = -(-B // n_devices) * n_devices  # n_devices | Bp and P | Bp

    def pad_to(x, rows):
        x = np.asarray(x)
        if x.shape[0] == rows:
            return x
        block = np.zeros((rows - x.shape[0], *x.shape[1:]), x.dtype)
        return np.concatenate([x, block])

    out = (pad_to(features, Bp), pad_to(enc, Bp * K), pad_to(dec, Bp * K),
           pad_to(lengths, Bp * K), pad_to(c_v, Bp))
    if P > 1:
        rows_b = Bp // P
        sl = lambda x, r: x[pid * r:(pid + 1) * r]
        out = (sl(out[0], rows_b), sl(out[1], rows_b * K),
               sl(out[2], rows_b * K), sl(out[3], rows_b * K),
               sl(out[4], rows_b))
    return out


def pad_to_multiple(batch_leaf: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading dim up to a multiple of the mesh size so every
    shard has equal extent (XLA requires even sharding)."""
    n = batch_leaf.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch_leaf
    pad = multiple - rem
    pad_block = np.zeros((pad, *batch_leaf.shape[1:]), batch_leaf.dtype)
    return np.concatenate([batch_leaf, pad_block])
