"""Synthetic captioning task for benchmarks and smoke runs.

A fixed set of caption templates, each a random token sequence tied to
a random fc2-feature anchor and cluster vector.  Images are anchors plus
small noise, so a model trained for a few steps learns sharply peaked
next-token distributions: decodes end early and the beam-search
early-exit bound fires, as on a trained model.  Random weights never
reach that regime.

The batcher follows ``CaptionBatcher``'s interface (``train_batches``,
``eval_batches``), so it drives ``Trainer`` and ``generate_captions``
unchanged.  Everything is made from ``seed``; no files are read.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from vae_captioning.data.batcher import Batch


class PeakedBatcher:
    def __init__(self, vocab_size: int, bos_id: int, eos_id: int,
                 batch_size: int, *, num_batches: int = 1,
                 n_templates: int = 64, max_len: int = 16,
                 feature_size: int = 4096, num_clusters: int = 90,
                 noise: float = 0.05, seed: int = 1):
        rng = np.random.default_rng(seed)
        self.batch_size, self.num_batches = batch_size, num_batches
        self.noise = noise
        self._rng = rng
        T = max_len
        lens = rng.integers(5, T - 1, size=n_templates)
        words = rng.integers(3, vocab_size, size=(n_templates, T - 1))
        self.anchors = rng.normal(size=(n_templates, feature_size)).astype(
            np.float32)
        cvs = rng.random((n_templates, num_clusters)).astype(np.float32)
        self.cluster_vectors = cvs / cvs.sum(-1, keepdims=True)
        self.dec_rows = np.zeros((n_templates, T), np.int32)   # [BOS, w...]
        self.lab_rows = np.zeros((n_templates, T), np.int32)   # [w..., EOS]
        for t, L in enumerate(lens):
            self.dec_rows[t, 0] = bos_id
            self.dec_rows[t, 1:L + 1] = words[t, :L]
            self.lab_rows[t, :L] = words[t, :L]
            self.lab_rows[t, L] = eos_id
        self.row_len = (lens + 1).astype(np.int32)

    def _batch(self, num_captions: int, start: Optional[int]) -> Batch:
        B, K = self.batch_size, num_captions
        n = self.anchors.shape[0]
        ids = (self._rng.integers(0, n, B) if start is None
               else (start + np.arange(B)) % n)
        features = self.anchors[ids] + self.noise * self._rng.normal(
            size=(B, self.anchors.shape[1])).astype(np.float32)
        rep = lambda a: np.repeat(a[ids][:, None], K, axis=1)  # noqa: E731
        return Batch(features=features.astype(np.float32),
                     dec_inputs=rep(self.dec_rows), labels=rep(self.lab_rows),
                     lengths=rep(self.row_len),
                     cluster_vectors=self.cluster_vectors[ids],
                     image_ids=np.arange(B, dtype=np.int64) + (start or 0),
                     valid=B)

    def train_batches(self, num_captions: int = 1,
                      drop_remainder: bool = True) -> Iterator[Batch]:
        for _ in range(self.num_batches):
            yield self._batch(num_captions, None)

    def eval_batches(self, num_captions: int = 1,
                     with_ids: bool = True) -> Iterator[Batch]:
        for i in range(self.num_batches):
            yield self._batch(num_captions, i * self.batch_size)
