"""Single-image caption API + CLI.

Replaces ``gen_caption.py``: ``Generator(checkpoint_dir, name)`` loads the
JSON config/vocab sidecars + checkpoint once, builds the jitted
decode functions once, and then ``generate_caption(img_path)`` runs
feature-extraction + decode per call.

Differences from the reference, on purpose:
  * features come from the same VGG16/npz path used in training, not a
    separately-downloaded Keras model with different preprocessing
    (``gen_caption.py:14-17,51-65`` subtracts ImageNet means in BGR
    order — a train/serve skew we do not reproduce);
  * cluster vectors can be supplied explicitly; the reference's
    ``_c_v_generator`` is an unimplemented stub (``gen_caption.py:40-42``).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vae_captioning.checkpoint import Checkpointer, load_sidecars
from vae_captioning.data.images import load_image
from vae_captioning.inference import make_decode_fns
from vae_captioning.ops.decoding import tokens_to_text


class Generator:
    """Generate captions for arbitrary images from a trained checkpoint."""

    def __init__(self, checkpoint_dir: str = "./checkpoints",
                 name: str = "last_run", gen_method: str = "greedy",
                 weights_path: Optional[str] = None,
                 detections_json: Optional[str] = None):
        """``detections_json``: optional COCO-results-format detector
        output (``[{"image_id"|"file_name", "category_id", "score"}]``).
        When given, images found in it get detector-derived cluster
        vectors automatically — the capability the reference's
        ``_c_v_generator`` stub never implemented (gen_caption.py:40-42;
        its test vectors came from a Faster-RCNN pass in
        prepare_test_vectors.ipynb cells 3-7)."""
        cfg, vocab = load_sidecars(checkpoint_dir, name)
        if gen_method not in ("greedy", "sample", "beam_search"):
            raise ValueError(f"unknown gen_method {gen_method!r}")
        self.cfg = cfg.replace(sample_gen=gen_method)
        self.cfg.vocab_size = vocab.vocab_size
        self.vocab = vocab
        self.gen_method = gen_method
        self.weights_path = weights_path or cfg.image_net_weights_path

        from vae_captioning.train import (
            TrainState, build_model, init_model, make_finetune_optimizer,
            make_optimizer)
        model, params = init_model(self.cfg, jax.random.PRNGKey(self.cfg.seed))
        tx = (make_finetune_optimizer(self.cfg) if self.cfg.fine_tune
              else make_optimizer(self.cfg))
        state = TrainState.create(params, tx)
        ckpt = Checkpointer(checkpoint_dir, name)
        state = ckpt.restore(state)
        ckpt.close()
        self.params = state.params
        self.model = build_model(self.cfg)
        # decode-fn sets cached per beam size: alternating beam sizes
        # must not recompile (each set is a fresh jit per beam width)
        self._fns_by_beam: Dict[int, Dict] = {
            self.cfg.beam_size: make_decode_fns(self.model, self.cfg, vocab)}
        self._rng = jax.random.PRNGKey(self.cfg.seed)
        self._det_vectors: Optional[Dict[str, np.ndarray]] = None
        if detections_json:
            from vae_captioning.data import cluster_vectors as cv_lib
            self._det_vectors = cv_lib.build_from_detections(
                cv_lib.load_detections_json(detections_json))

    # ------------------------------------------------------------------
    @lru_cache(maxsize=1)
    def _feature_fn(self):
        from vae_captioning.models.vgg16 import VGG16, load_npz_weights

        vgg = VGG16(compute_dtype=jnp.dtype(self.cfg.compute_dtype))
        vgg_params = jax.device_put(load_npz_weights(self.weights_path))

        @jax.jit
        def fc2(p, images):
            return vgg.apply({"params": p}, images)

        return lambda images: fc2(vgg_params, images)

    def _get_features(self, img_path: str) -> jnp.ndarray:
        if not os.path.exists(img_path):
            raise FileNotFoundError(f"image not found: {img_path}")
        img = load_image(img_path)[None]
        return self._feature_fn()(jnp.asarray(img))

    # ------------------------------------------------------------------
    def generate_caption(self, img_path: str, beam_size: Optional[int] = None,
                         cluster_vector: Optional[np.ndarray] = None,
                         seed: Optional[int] = None,
                         return_beams: bool = False) -> List[Dict]:
        """→ ``[{'image_id': <file name>, 'caption': <str>}]``
        (the reference's return shape, gen_caption.py:67-130).

        ``return_beams=True`` (beam_search only) puts a best-first list of
        all beam captions under 'caption' — the reference's ``ret_beams``
        (vae_model/decoder.py:311-319)."""
        cfg = self.cfg
        beam = beam_size if beam_size is not None else cfg.beam_size
        if beam not in self._fns_by_beam:
            self._fns_by_beam[beam] = make_decode_fns(
                self.model, cfg.replace(beam_size=beam), self.vocab)
        fns = self._fns_by_beam[beam]
        if cfg.fine_tune:
            # fine-tuned checkpoints embed the VGG16 — feed raw pixels
            if not os.path.exists(img_path):
                raise FileNotFoundError(f"image not found: {img_path}")
            features = jnp.asarray(load_image(img_path)[None])
        else:
            features = self._get_features(img_path)
        if cluster_vector is not None:
            c_v = jnp.asarray(np.asarray(cluster_vector, np.float32)[None])
        elif self._det_vectors is not None:
            # detector-derived vector (91-dim indicator; the model takes
            # categories 1..90, same slice the batcher applies)
            key = os.path.basename(img_path)
            vec = self._det_vectors.get(key)
            if vec is None:
                vec = np.zeros(cfg.num_clusters + 1, np.float32)
            c_v = jnp.asarray(vec[None, 1:])
        else:
            c_v = jnp.zeros((1, cfg.num_clusters), jnp.float32)
        rng = (jax.random.PRNGKey(seed) if seed is not None else self._rng)
        if return_beams:
            if self.gen_method != "beam_search":
                raise ValueError("return_beams requires gen_method="
                                 "'beam_search'")
            tokens, _ = fns["beam_search_all"](self.params, features,
                                               c_v, rng)
            beams = [tokens_to_text(row, self.vocab.idx2word,
                                    self.vocab.eos_id, self.vocab.bos_id)
                     for row in np.asarray(tokens[0])]
            return [{"image_id": os.path.basename(img_path),
                     "caption": beams}]
        res = fns[self.gen_method](self.params, features, c_v, rng)
        tokens = np.asarray(res[0] if isinstance(res, tuple) else res)
        caption = tokens_to_text(tokens[0], self.vocab.idx2word,
                                 self.vocab.eos_id, self.vocab.bos_id)
        return [{"image_id": os.path.basename(img_path), "caption": caption}]


def main(argv=None) -> None:
    import argparse

    platform = os.environ.get("VCT_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)

    p = argparse.ArgumentParser(description="Generate a caption for one image")
    p.add_argument("--img_path", required=True)
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--checkpoint", default="last_run")
    p.add_argument("--gen_method", default="greedy",
                   choices=["greedy", "sample", "beam_search"])
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--weights", default=None,
                   help="override vgg16_weights.npz path")
    p.add_argument("--detections", default=None,
                   help="detections JSON (COCO results format) for "
                        "detector-derived cluster vectors")
    args = p.parse_args(argv)
    gen = Generator(args.checkpoint_dir, args.checkpoint, args.gen_method,
                    weights_path=args.weights,
                    detections_json=args.detections)
    out = gen.generate_caption(args.img_path, beam_size=args.beam_size)
    print(out[0]["caption"])


if __name__ == "__main__":
    main()
