"""Data facade — the entry point the drivers use.

Replaces the reference's ``Data`` class (``utils/data.py:16-172``):
resolves the COCO layout, builds/caches the vocabulary, extracts or loads
VGG16 features, performs the train/val repartition, and hands out
batchers for the train / val / test splits.
"""

from __future__ import annotations

import os
import warnings
from glob import glob
from typing import Dict, Optional

import numpy as np

from vae_captioning.config import Config
from vae_captioning.data import cluster_vectors as cv_lib
from vae_captioning.data.batcher import CaptionBatcher, repartition
from vae_captioning.data.coco import CocoCaptions, coco_paths, load_test_image_ids
from vae_captioning.data.features import FeatureStore, extract_features_from_dir
from vae_captioning.data.vocabulary import Vocabulary


class Data:
    def __init__(self, config: Config, extract_features: bool = True):
        self.config = config
        self.paths = coco_paths(config.coco_dir)
        cache = config.cache_dir
        os.makedirs(cache, exist_ok=True)

        self.captions_tr = CocoCaptions(self.paths["train_cap_json"],
                                        config.cap_max_length)
        self.captions_val = CocoCaptions(self.paths["valid_cap_json"],
                                         config.cap_max_length)

        vocab_path = os.path.join(cache, "vocab.json")
        if os.path.exists(vocab_path):
            self.vocab = Vocabulary.load(vocab_path)
        else:
            self.vocab = Vocabulary.build(self.captions_tr.all_tokenized(),
                                          config.keep_words)
            self.vocab.save(vocab_path)
        self.captions_tr.index_captions(self.vocab)
        self.captions_val.index_captions(self.vocab)
        self.config.vocab_size = self.vocab.vocab_size

        self._rng = np.random.default_rng(config.seed)
        self._extract = extract_features
        self._stores: Dict[str, FeatureStore] = {}
        self._cluster_vecs: Optional[Dict[str, np.ndarray]] = None
        self._cluster_vecs_test: Optional[Dict[str, np.ndarray]] = None

        # Repartition (ref main.py:21-26 + utils/batch_gen.py:71-96) is
        # decided here, deterministically in the seed, so a later
        # inference-mode run recovers the SAME heldout generation split
        # that training left out.
        self._train_pool = self._split_files(self.paths["train_dir"])
        self._heldout_val: list = []
        if config.gen_val_captions >= 0:
            val_files = self._split_files(self.paths["valid_dir"])
            self._train_pool, self._heldout_val = repartition(
                self._train_pool, val_files, config.gen_val_captions,
                self._rng)

    # ------------------------------------------------------------------
    def _feature_store(self, split_dir: str) -> Optional[FeatureStore]:
        if not self._extract or self.config.fine_tune:
            return None
        key = os.path.basename(os.path.normpath(split_dir))
        if key not in self._stores:
            self._stores[key] = extract_features_from_dir(
                split_dir,
                self.config.image_net_weights_path,
                cache_dir=self.config.cache_dir,
                batch_size=self.config.extract_batch_size,
                compute_dtype=self.config.compute_dtype,
            )
        return self._stores[key]

    def _image_store(self):
        if not self.config.fine_tune:
            return None
        # preference order: native mmap loader → HDF5 → per-jpg decode
        if os.path.exists(self.config.raw_images_file):
            from vae_captioning.data.native_loader import RawImageStore
            return RawImageStore(self.config.raw_images_file)
        if self.config.use_hdf5 and os.path.exists(self.config.hdf5_file):
            from vae_captioning.data.images import Hdf5ImageStore
            return Hdf5ImageStore(self.config.hdf5_file)
        return None  # CaptionBatcher falls back to per-jpg loading

    def cluster_vectors(self, test: bool = False) -> Optional[Dict[str, np.ndarray]]:
        """Load (or build from instance annotations) the cluster vectors.

        Search order: our npz → reference pickle → regenerate from
        instances_*2014.json (the notebooks' outputs are not shippable,
        see SURVEY §2 'Cluster-vector tooling')."""
        if not self.config.needs_cluster_vectors:
            return None
        attr = "_cluster_vecs_test" if test else "_cluster_vecs"
        if getattr(self, attr) is not None:
            return getattr(self, attr)
        base = self.config.obj_vectors_dir
        name = "c_v_test" if test else "c_v"
        for candidate in (os.path.join(base, name + ".npz"),
                          os.path.join(base, name + ".pickle")):
            if os.path.exists(candidate):
                setattr(self, attr, cv_lib.load(candidate))
                return getattr(self, attr)
        if test:
            # test split has no ground-truth instances; detector outputs
            # must be supplied (ref prepare_test_vectors.ipynb cells 3-7
            # ran Faster-RCNN).  Convenience: a COCO-results-format
            # detections JSON dropped at obj_vectors/test_detections.json
            # is converted automatically.
            det_json = os.path.join(base, "test_detections.json")
            if os.path.exists(det_json):
                vecs = cv_lib.build_from_detections(
                    cv_lib.load_detections_json(det_json))
                cv_lib.save(vecs, os.path.join(base, "c_v_test.npz"))
                setattr(self, attr, vecs)
                return vecs
            # Zero vectors (the batcher fallback) keep decoding
            # functional but degrade c_v-conditioned quality — be LOUD
            # (VERDICT r2 #7), don't let a missing file silently move
            # CIDEr.
            warnings.warn(
                "no test-split cluster vectors found (looked for "
                f"{os.path.join(base, name)}.npz/.pickle and {det_json}); "
                "test-split decoding will use ZERO cluster vectors. For "
                "AG/c_v models this collapses the conditional prior to "
                "its all-used-classes fallback and degrades caption "
                "quality. Run a detector over the test images and "
                "convert its output with: python -m "
                "vae_captioning.data.cluster_vectors "
                "--detections_json dets.json --output "
                f"{os.path.join(base, 'c_v_test.npz')}",
                stacklevel=2)
            setattr(self, attr, {})
            return getattr(self, attr)
        merged: Dict[str, np.ndarray] = {}
        for key in ("train_instances_json", "valid_instances_json"):
            path = self.paths[key]
            if os.path.exists(path):
                merged.update(cv_lib.build_from_instances(path))
        out = os.path.join(base, "c_v.npz")
        if merged:
            cv_lib.save(merged, out)
        setattr(self, attr, merged)
        return merged

    # ------------------------------------------------------------------
    def _split_files(self, split_dir: str) -> list:
        return sorted(glob(os.path.join(split_dir, "*.jpg")))

    def train_batcher(self, batch_size: Optional[int] = None) -> CaptionBatcher:
        cfg = self.config
        batch_size = batch_size or cfg.batch_size
        store = self._feature_store(self.paths["train_dir"])
        extra = None
        if cfg.gen_val_captions >= 0:  # val images folded into the pool
            val_store = self._feature_store(self.paths["valid_dir"])
            if store is not None and val_store is not None:
                store = store.merge(val_store)
            extra = self.captions_val.captions_indexed
        return CaptionBatcher(
            self._train_pool, self.captions_tr.captions_indexed, batch_size,
            extra_captions=extra,
            feature_store=store,
            image_store=self._image_store(),
            cluster_vectors=self.cluster_vectors(),
            bucket_multiple=cfg.bucket_multiple,
            cap_max_length=cfg.cap_max_length,
            seed=cfg.seed,
        )

    def val_batcher(self, batch_size: Optional[int] = None) -> CaptionBatcher:
        """Validation/generation split: the repartition holdout if one was
        made, else all of val2014 (ref utils/data.py:132-151)."""
        cfg = self.config
        files = self._heldout_val or self._split_files(self.paths["valid_dir"])
        return CaptionBatcher(
            files, self.captions_val.captions_indexed,
            batch_size or cfg.batch_size,
            feature_store=self._feature_store(self.paths["valid_dir"]),
            image_store=self._image_store(),
            cluster_vectors=self.cluster_vectors(),
            filename_to_imid=self.captions_val.filename_to_imid,
            bucket_multiple=cfg.bucket_multiple,
            cap_max_length=cfg.cap_max_length,
            seed=cfg.seed,
        )

    def val_references(self) -> Dict[str, list]:
        """``image_id (str) -> [plain caption strings]`` for the val
        split — ground truth for the per-epoch quality hook
        (``inference.make_quality_hook``).  Text is the tokenizer's
        word stream (control tokens stripped), i.e. the same surface
        form decoded hypotheses have."""
        from vae_captioning.data.tokenizer import detokenize
        fn2id = self.captions_val.filename_to_imid
        return {str(fn2id[fn]): [detokenize(c) for c in caps]
                for fn, caps in self.captions_val.captions.items()
                if fn in fn2id}

    def test_batcher(self, batch_size: Optional[int] = None) -> Optional[CaptionBatcher]:
        cfg = self.config
        test_dir = self.paths["test_dir"]
        files = self._split_files(test_dir)
        if not files:
            return None
        fn_to_id = {}
        if os.path.exists(self.paths["test_info_json"]):
            fn_to_id = load_test_image_ids(self.paths["test_info_json"])
        return CaptionBatcher(
            files, {}, batch_size or cfg.batch_size,
            feature_store=self._feature_store(test_dir),
            cluster_vectors=self.cluster_vectors(test=True),
            filename_to_imid=fn_to_id,
            bucket_multiple=cfg.bucket_multiple,
            cap_max_length=cfg.cap_max_length,
            seed=cfg.seed,
        )
