"""Native C++ batch loader: build, correctness vs numpy, prefetch,
fallback path, and a small gather throughput sanity check."""

import os
import time

import numpy as np
import pytest

from vae_captioning.data.native_loader import (
    RawImageStore, load_library, pack_images_to_raw)


@pytest.fixture(scope="module")
def packed(tmp_path_factory, mini_coco):
    out = str(tmp_path_factory.mktemp("raw") / "images.bin")
    index = pack_images_to_raw(
        [os.path.join(mini_coco, "images", "train2014")], out, size=64)
    return out, index


def test_library_builds():
    lib = load_library()
    assert lib is not None, "g++ toolchain expected in this environment"


def test_pack_and_meta(packed):
    out, index = packed
    assert len(index) == 10
    assert os.path.getsize(out) == 10 * 64 * 64 * 3
    assert os.path.exists(out + ".meta.json")


def test_native_gather_matches_numpy(packed):
    out, index = packed
    native = RawImageStore(out, num_threads=4)
    fallback = RawImageStore(out, force_numpy=True)
    names = list(index)[::-1][:7]  # reversed order, odd count
    a = native.get_batch(names)
    b = fallback.get_batch(names)
    assert a.shape == (7, 64, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    native.close()


def test_native_gather_repeated_and_interleaved(packed):
    out, index = packed
    store = RawImageStore(out, num_threads=2)
    names = list(index)
    # repeated rows in one request must all be filled
    req = [names[3], names[3], names[0], names[3]]
    got = store.get_batch(req)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[1], got[3])
    # many sequential jobs through the same pool (generation handling)
    for i in range(20):
        got = store.get_batch([names[i % len(names)]])
        assert got.shape == (1, 64, 64, 3)
    store.close()


def test_prefetch_is_safe(packed):
    out, index = packed
    store = RawImageStore(out)
    store.prefetch(list(index)[:5])
    got = store.get_batch(list(index)[:5])
    assert got.shape[0] == 5
    store.close()


def test_unknown_name_raises(packed):
    out, _ = packed
    store = RawImageStore(out)
    with pytest.raises(KeyError):
        store.get_batch(["missing.jpg"])
    store.close()


def test_gather_throughput(packed):
    """Native gather of 500 batches should comfortably beat 100 MB/s —
    a loose bound that still catches pathological serialization."""
    out, index = packed
    store = RawImageStore(out, num_threads=4)
    names = list(index) * 4  # 40 records/batch
    store.get_batch(names)  # warm
    t0 = time.perf_counter()
    n = 50
    for _ in range(n):
        store.get_batch(names)
    dt = time.perf_counter() - t0
    mb = n * len(names) * 64 * 64 * 3 / 1e6
    assert mb / dt > 100, f"native gather too slow: {mb/dt:.1f} MB/s"
    store.close()


def test_hdf5_store_scatter_order(tmp_path, mini_coco):
    """Hdf5ImageStore must return rows in request order despite h5py's
    increasing-index requirement (ref utils/batch_gen.py:152-162)."""
    from vae_captioning.data.images import Hdf5ImageStore, pack_images_to_hdf5
    out = str(tmp_path / "imgs.h5")
    index = pack_images_to_hdf5(
        [os.path.join(mini_coco, "images", "train2014")], out, size=32)
    store = Hdf5ImageStore(out)
    names = list(index)
    # duplicate filename in one batch: legal (h5py itself would reject
    # repeated indices — the store dedupes and expands)
    got = store.get_batch([names[5], names[1], names[8], names[5]])
    import h5py
    with h5py.File(out) as h5:
        np.testing.assert_array_equal(got[0], h5["images"][index[names[5]]])
        np.testing.assert_array_equal(got[1], h5["images"][index[names[1]]])
        np.testing.assert_array_equal(got[2], h5["images"][index[names[8]]])
        np.testing.assert_array_equal(got[3], h5["images"][index[names[5]]])
    store.close()


def test_batcher_prefetches_next_batch(packed, mini_coco):
    """train_batches must call image_store.prefetch with the NEXT chunk."""
    out, index = packed
    from vae_captioning.data.coco import CocoCaptions, coco_paths
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.data.batcher import CaptionBatcher
    paths = coco_paths(mini_coco)
    caps = CocoCaptions(paths["train_cap_json"])
    vocab = Vocabulary.build(caps.all_tokenized(), keep_words=1)
    caps.index_captions(vocab)

    calls = []

    class SpyStore(RawImageStore):
        def prefetch(self, filenames):
            calls.append(list(filenames))
            super().prefetch(filenames)

    store = SpyStore(out)
    from glob import glob
    files = sorted(glob(os.path.join(paths["train_dir"], "*.jpg")))
    batcher = CaptionBatcher(files, caps.captions_indexed, 4,
                             image_store=store, seed=0)
    batches = list(batcher.train_batches())
    assert len(batches) == 2
    # lookahead fired before each batch (2nd looks past the epoch's limit
    # into the dropped remainder — harmless page warming)
    assert len(calls) == 2
    assert len(calls[0]) == 4
    store.close()
