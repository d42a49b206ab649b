"""Checkpointing to plain numpy archives.

Replaces ``tf.train.Saver`` (``main.py:186-191,286-290``): one PyTree
(params + opt_state + step) saved per epoch with ``max_to_keep``
retention, plus JSON sidecars for the config and vocabulary — the
reference's pickled ``Parameters`` / vocab pickle / cluster-means pickle
(cluster means are seed-deterministic here, no sidecar needed).

Layout: ``<directory>/<name>/<step>/state.npz`` holds every leaf under
its key path (``jax.tree_util.keystr``).  A save snapshots the state to
host memory and writes it on a background thread into a temporary
directory that is renamed into place, so a crash mid-write never leaves
a half-written step behind.  Restore takes an abstract target tree (its
structure, shapes and dtypes) and fills it leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vae_captioning.config import Config


# ----------------------------------------------------------------------
# Pre-round-4 checkpoint compatibility: the encoder's posterior heads
# were two dense layers (``lz_mean`` / ``lz_logstd``); round 4 fused
# them into ONE ``q_heads`` dense whose kernel/bias are the two halves
# concatenated MEAN-FIRST along the last axis (models/encoder.py:55,
# ref vae_model/encoder.py:60-66).  Checkpoints written before the
# rename no longer match the live param tree — ``restore`` migrates
# them in place (VERDICT r4 #7; the reference keeps whole-Saver compat
# by construction, main.py:186-191).

def _walk_dicts(node: Any, fn: Callable[[dict], dict]) -> Any:
    """Apply ``fn`` bottom-up to every dict node of a PyTree, preserving
    container types (dicts, lists, tuples/namedtuples — optax states and
    TrainState — and dataclasses)."""
    if isinstance(node, dict):
        return fn({k: _walk_dicts(v, fn) for k, v in node.items()})
    if isinstance(node, tuple):
        mapped = [_walk_dicts(v, fn) for v in node]
        if hasattr(node, "_fields"):          # namedtuple (optax states)
            return type(node)(*mapped)
        return tuple(mapped)
    if isinstance(node, list):
        return [_walk_dicts(v, fn) for v in node]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node)(**{
            f.name: _walk_dicts(getattr(node, f.name), fn)
            for f in dataclasses.fields(node)})
    return node


def _half(leaf: Any, which: int) -> Any:
    """Half of a concatenated leaf along the last axis: slices real
    arrays, reconstructs ShapeDtypeStructs (abstract trees)."""
    h = leaf.shape[-1] // 2
    if isinstance(leaf, jax.ShapeDtypeStruct):
        return jax.ShapeDtypeStruct(leaf.shape[:-1] + (h,), leaf.dtype)
    return leaf[..., :h] if which == 0 else leaf[..., h:]


def split_q_heads(tree: Any) -> tuple[Any, int]:
    """New-layout tree -> pre-rename layout (q_heads -> lz_mean +
    lz_logstd).  Applies everywhere the pattern occurs — the optimizer
    moments mirror the param tree, so Adam's mu/nu migrate too.
    Returns (tree, number of nodes rewritten)."""
    n = [0]

    def fix(node: dict) -> dict:
        qh = node.get("q_heads")
        if isinstance(qh, dict) and qh:
            n[0] += 1
            out = {k: v for k, v in node.items() if k != "q_heads"}
            out["lz_mean"] = {k: _half(v, 0) for k, v in qh.items()}
            out["lz_logstd"] = {k: _half(v, 1) for k, v in qh.items()}
            return out
        return node

    return _walk_dicts(tree, fix), n[0]


def merge_q_heads(tree: Any) -> tuple[Any, int]:
    """Pre-rename layout -> new layout (lz_mean ++ lz_logstd ->
    q_heads, mean-first).  Returns (tree, number of nodes rewritten)."""
    n = [0]

    def fix(node: dict) -> dict:
        m, s = node.get("lz_mean"), node.get("lz_logstd")
        if isinstance(m, dict) and isinstance(s, dict) and set(m) == set(s):
            n[0] += 1
            out = {k: v for k, v in node.items()
                   if k not in ("lz_mean", "lz_logstd")}
            out["q_heads"] = {
                k: jnp.concatenate([m[k], s[k]], axis=-1) for k in m}
            return out
        return node

    return _walk_dicts(tree, fix), n[0]


_STATE_FILE = "state.npz"


def _flatten(tree: Any) -> Dict[str, Any]:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(path): leaf for path, leaf in leaves}


def _fill(abstract: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """Leaves of ``arrays`` in the structure of ``abstract``; KeyError
    names the first key path the archive lacks."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(abstract)
    leaves = []
    for path, ref in paths:
        key = jax.tree_util.keystr(path)
        if key not in arrays:
            raise KeyError(key)
        arr = arrays[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(ref.shape)}")
        leaves.append(jnp.asarray(arr, dtype=ref.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


class Checkpointer:
    def __init__(self, directory: str, name: str = "last_run",
                 max_to_keep: int = 5):
        self.directory = os.path.abspath(os.path.join(directory, name))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, state: Any, step: Optional[int] = None) -> None:
        """Async save: returns once the state is snapshotted to host
        memory; the write completes on a background thread.  A
        still-running previous save is drained first."""
        self.wait()
        step = int(state.step) if step is None else int(step)
        host = {k: np.asarray(v) for k, v in
                jax.device_get(_flatten(state)).items()}
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host), daemon=True)
        self._thread.start()

    def _write(self, step: int, host: Dict[str, np.ndarray]) -> None:
        try:
            final = os.path.join(self.directory, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, _STATE_FILE), **host)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self._steps()[:-self.max_to_keep or None]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        except BaseException as e:  # re-raised by wait() in the caller
            self._error = e

    def wait(self) -> None:
        """Block until the pending save is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, _STATE_FILE)))

    def restore(self, abstract_state: Any,
                step: Optional[int] = None) -> Any:
        """Restore into the structure of ``abstract_state`` (arrays or
        ShapeDtypeStructs).  Checkpoints written with the pre-rename
        posterior heads (lz_mean/lz_logstd) are migrated to q_heads."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        path = os.path.join(self.directory, str(step), _STATE_FILE)
        with np.load(path) as archive:
            arrays = {k: archive[k] for k in archive.files}
        try:
            return _fill(abstract_state, arrays)
        except KeyError as e:
            old_abstract, n_split = split_q_heads(abstract_state)
            if n_split == 0:
                raise
            try:
                old_state = _fill(old_abstract, arrays)
            except KeyError:
                raise KeyError(
                    f"checkpoint {path} matches neither the current param "
                    f"layout (fused q_heads) nor the pre-rename layout "
                    f"(lz_mean/lz_logstd); missing {e}") from e
            migrated, n_merged = merge_q_heads(old_state)
            if n_merged != n_split:
                raise RuntimeError(
                    f"migrated {n_merged} of {n_split} lz_mean/lz_logstd "
                    f"node(s) in {path}")
            print(f"[checkpoint] migrated pre-rename layout: "
                  f"{n_merged} lz_mean/lz_logstd node(s) -> q_heads")
            return migrated

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        self.wait()
        return self._steps()

    def close(self) -> None:
        self.wait()


def save_sidecars(cfg: Config, vocab, directory: str,
                  name: str = "last_run") -> None:
    base = os.path.join(directory, name)
    os.makedirs(base, exist_ok=True)
    cfg.save(os.path.join(base, "config.json"))
    vocab.save(os.path.join(base, "vocab.json"))


def load_sidecars(directory: str, name: str = "last_run"):
    from vae_captioning.data.vocabulary import Vocabulary

    base = os.path.join(directory, name)
    cfg = Config.load(os.path.join(base, "config.json"))
    vocab = Vocabulary.load(os.path.join(base, "vocab.json"))
    return cfg, vocab
