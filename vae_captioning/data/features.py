"""Pre-extracted VGG16 fc2 feature storage + jitted batch extraction.

Replaces the reference's per-image ``sess.run`` feature loop
(``utils/data.py:86-130``, hot loop #0 in SURVEY §3.1): here a jitted
batched VGG16 forward processes ``extract_batch_size`` images per device
step, and features land in one contiguous ``[N, 4096]`` float32 array
with a name→row index — not a pickle-of-dicts.
"""

from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Optional, Sequence

import numpy as np


class FeatureStore:
    """Contiguous feature matrix with name-keyed row lookup."""

    def __init__(self, names: Sequence[str], features: np.ndarray):
        assert len(names) == features.shape[0]
        self.names = [os.path.basename(n) for n in names]
        self.features = np.asarray(features, dtype=np.float32)
        self._row = {n: i for i, n in enumerate(self.names)}

    def __contains__(self, filename: str) -> bool:
        return os.path.basename(filename) in self._row

    def __len__(self) -> int:
        return self.features.shape[0]

    @property
    def feature_size(self) -> int:
        return self.features.shape[1]

    def get_batch(self, filenames: Sequence[str]) -> np.ndarray:
        rows = [self._row[os.path.basename(fn)] for fn in filenames]
        return self.features[rows]

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, names=np.array(self.names), features=self.features)

    @classmethod
    def load(cls, path: str) -> "FeatureStore":
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls([str(n) for n in data["names"]], data["features"])

    @classmethod
    def from_reference_pickle(cls, path: str) -> "FeatureStore":
        """Read the reference's ``pickles/<split>.pickle`` {name: [1, 4096]}
        format (ref utils/data.py:100-105) for migration."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        names = sorted(d)
        feats = np.concatenate([np.asarray(d[n]).reshape(1, -1) for n in names])
        return cls(names, feats)

    def merge(self, other: "FeatureStore") -> "FeatureStore":
        return FeatureStore(self.names + other.names,
                            np.concatenate([self.features, other.features]))


def extract_features_from_dir(
    data_dir: str,
    weights_path: str,
    cache_dir: Optional[str] = None,
    batch_size: int = 64,
    compute_dtype: str = "bfloat16",
    progress: bool = True,
) -> FeatureStore:
    """Extract fc2 features for every jpg in ``data_dir`` (cached).

    Cache key mirrors the reference's per-split naming
    (ref utils/data.py:100-103): ``<cache_dir>/<dirname>.features.npz``.
    """
    split = os.path.basename(os.path.normpath(data_dir))
    cache_path = None
    if cache_dir:
        cache_path = os.path.join(cache_dir, f"{split}.features.npz")
        if os.path.exists(cache_path):
            return FeatureStore.load(cache_path)

    # local imports keep data layer usable without jax
    import jax
    import jax.numpy as jnp

    from vae_captioning.data.images import (load_image_batch,
                                                optional_import)
    from vae_captioning.models.vgg16 import VGG16, load_npz_weights

    paths = sorted(glob(os.path.join(data_dir, "*.jpg")))
    if not paths:
        raise FileNotFoundError(f"no jpgs in {data_dir}")
    model = VGG16(compute_dtype=jnp.dtype(compute_dtype))
    params = jax.device_put(load_npz_weights(weights_path))

    @jax.jit
    def fc2(params, images):
        return model.apply({"params": params}, images)

    feats = np.empty((len(paths), 4096), dtype=np.float32)
    iterator = range(0, len(paths), batch_size)
    if progress:
        tqdm = optional_import("tqdm", "tqdm").tqdm
        iterator = tqdm(iterator, desc=f"extract {split}")
    for start in iterator:
        chunk = paths[start:start + batch_size]
        images = load_image_batch(chunk)
        if len(chunk) < batch_size:  # pad to the jitted static shape
            pad = np.zeros((batch_size - len(chunk), *images.shape[1:]),
                           dtype=images.dtype)
            images = np.concatenate([images, pad])
        out = np.asarray(fc2(params, jnp.asarray(images)), dtype=np.float32)
        feats[start:start + len(chunk)] = out[: len(chunk)]
    store = FeatureStore(paths, feats)
    if cache_path:
        store.save(cache_path)
    return store


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Extract VGG16 fc2 features for "
                                "a directory of jpgs")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--weights", required=True, help="vgg16_weights.npz path")
    p.add_argument("--cache_dir", default="./cache")
    p.add_argument("--batch_size", type=int, default=64)
    args = p.parse_args(argv)
    store = extract_features_from_dir(args.data_dir, args.weights,
                                      args.cache_dir, args.batch_size)
    print(f"extracted {len(store)} feature vectors")


if __name__ == "__main__":
    main()
