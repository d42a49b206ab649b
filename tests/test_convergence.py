"""Learning sanity: overfit the synthetic mini-COCO and verify the full
loop — train step → decode → COCO-eval JSON → in-repo CIDEr/BLEU —
produces high scores on the training images.

This is the strongest end-to-end correctness signal available without
the real dataset: if any piece (masking, z-plumbing, init-state
protocol, decode, detokenization, scoring) is broken, the model cannot
reproduce its training captions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from vae_captioning.config import Config
from vae_captioning.data.batcher import CaptionBatcher
from vae_captioning.data.coco import CocoCaptions, coco_paths
from vae_captioning.data.vocabulary import Vocabulary
from vae_captioning.eval.scorers import cider_d, corpus_bleu
from vae_captioning.inference import make_decode_fns
from vae_captioning.models.cvae import CVAEModel
from vae_captioning.ops.decoding import tokens_to_text
from vae_captioning.train import (
    TrainState, init_model, make_optimizer, make_train_step)


def _overfit(mini_coco, prior, epochs=60):
    """Overfit a tiny model on the mini-COCO; returns the trained pieces."""
    paths = coco_paths(mini_coco)
    caps = CocoCaptions(paths["train_cap_json"])
    vocab = Vocabulary.build(caps.all_tokenized(), keep_words=1)
    caps.index_captions(vocab)

    cfg = Config(prior=prior, use_c_v=prior == "AG", embed_size=32,
                 latent_size=8, encoder_hidden=64, decoder_hidden=64,
                 gen_z_samples=4,
                 batch_size=10, learning_rate=0.01, gen_max_len=16,
                 std=0.01)  # tight decode prior → deterministic captions
    cfg.vocab_size = vocab.vocab_size

    import os
    from glob import glob
    files = sorted(glob(os.path.join(paths["train_dir"], "*.jpg")))

    class HashFeatures:
        """Distinct deterministic pseudo-features per image."""
        def get_batch(self, fns):
            out = []
            for f in fns:
                rng = np.random.default_rng(abs(hash(os.path.basename(f)))
                                            % 2**31)
                out.append(rng.normal(size=4096).astype(np.float32))
            return np.stack(out)

    cluster_vecs = None
    if prior == "AG":
        from vae_captioning.data import cluster_vectors as cv_lib
        cluster_vecs = cv_lib.build_from_instances(
            paths["train_instances_json"])
    batcher = CaptionBatcher(files, caps.captions_indexed, 10,
                             feature_store=HashFeatures(),
                             cluster_vectors=cluster_vecs, seed=0)

    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    state = TrainState.create(params, tx)
    step = make_train_step(model, tx, cfg, donate=False)
    from vae_captioning.train import _flatten_batch

    losses = []
    for epoch in range(epochs):
        for batch in batcher.train_batches(num_captions=1):
            args = [jnp.asarray(x) for x in _flatten_batch(batch)]
            state, m = step(state, *args, jax.random.PRNGKey(42))
            losses.append(float(m["rec_loss"]))
    return cfg, model, state, vocab, caps, batcher, losses


@pytest.mark.parametrize("prior", ["Normal", "AG"])
def test_overfit_reproduces_training_captions(mini_coco, prior):
    import os
    cfg, model, state, vocab, caps, batcher, losses = _overfit(
        mini_coco, prior)
    assert losses[-1] < 0.8, f"did not overfit: {losses[::40]}"

    # decode the training images and score against their own captions
    fns = make_decode_fns(model, cfg, vocab)
    batch = next(iter(batcher.eval_batches(with_ids=False)))
    tokens = np.asarray(fns["greedy"](
        state.params, jnp.asarray(batch.features),
        jnp.asarray(batch.cluster_vectors), jax.random.PRNGKey(0)))

    hyps, refs = {}, {}
    for i, fn in enumerate(batcher.filenames):
        key = os.path.basename(fn)
        hyps[key] = tokens_to_text(tokens[i], vocab.idx2word, vocab.eos_id)
        refs[key] = [" ".join(c[1:-1]) for c in caps.captions[key]]
    bleu = corpus_bleu(hyps, refs)
    cider = cider_d(hyps, refs)
    # an overfit model must reproduce one of its 5 training captions
    assert bleu[0] > 0.6, (bleu, hyps)
    assert cider > 1.0, (cider, hyps)
