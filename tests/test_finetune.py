"""Fine-tune path: combined VGG16+CVAE model, npz init, frozen groups,
image-input train step and decode (ref main.py:46-89 + optimizers).

Logic tests (routing, freezing, decode wiring) run on a thin 64×64 VGG
(the module is shape-polymorphic; routing is about param labels, not
25088-wide matmuls) so the default tier stays fast; only the ImageNet
npz load needs real 224 shapes and is marked slow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vae_captioning.config import Config
from vae_captioning.models.finetune import FineTuneModel
from vae_captioning.train import (
    TrainState, init_model, make_finetune_optimizer, make_train_step)

VOCAB = 30
IMG = 32  # 32×32 → 1×1×512 = 512-wide fc1; full VGG depth, 49× fewer pixels


def ft_config(**kw) -> Config:
    base = dict(embed_size=8, latent_size=4, encoder_hidden=8,
                decoder_hidden=8, gen_z_samples=2, batch_size=2,
                fine_tune=True, prior="Normal", image_size=IMG,
                image_net_weights_path="/nonexistent.npz")
    base.update(kw)
    cfg = Config(**base)
    cfg.vocab_size = VOCAB
    return cfg


def make_image_batch(B=2, T=6, seed=0, size=IMG):
    rng = np.random.default_rng(seed)
    images = jnp.asarray(rng.uniform(0, 255, (B, size, size, 3))
                         .astype(np.float32))
    dec = jnp.asarray(rng.integers(1, VOCAB, (B, T)), jnp.int32)
    enc = jnp.asarray(rng.integers(1, VOCAB, (B, T)), jnp.int32)
    lengths = jnp.full((B,), T - 1, jnp.int32)
    c_v = rng.random((B, 90)).astype(np.float32)
    return images, enc, dec, lengths, jnp.asarray(c_v)


def test_finetune_model_forward():
    cfg = ft_config()
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    assert isinstance(model, FineTuneModel)
    assert "vgg16" in params and "cvae" in params
    images, enc, dec, lengths, c_v = make_image_batch()
    out = model.apply({"params": params}, images, enc, dec, lengths, None,
                      rngs={"z": jax.random.PRNGKey(1)})
    assert out["logits"].shape == (2, 6, VOCAB)


@pytest.mark.slow
def test_finetune_npz_init(vgg_npz):
    # real 224 shapes: the loader pins fc6 to [25088, 4096]
    cfg = ft_config(image_net_weights_path=vgg_npz, image_size=224)
    _, params = init_model(cfg, jax.random.PRNGKey(0))
    loaded = np.load(vgg_npz)
    np.testing.assert_allclose(
        np.asarray(params["vgg16"]["conv1_1"]["kernel"]),
        loaded["conv1_1_W"], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(params["vgg16"]["fc2"]["kernel"]), loaded["fc7_W"],
        rtol=1e-6)


def test_finetune_train_step_updates_both_groups():
    cfg = ft_config(cnn_lr=0.01, learning_rate=0.01)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_finetune_optimizer(cfg)
    state = TrainState.create(params, tx)
    step = make_train_step(model, tx, cfg, donate=False)
    args = make_image_batch()
    before_conv = np.asarray(params["vgg16"]["conv1_1"]["kernel"]).copy()
    before_dec = np.asarray(
        jax.tree.leaves(params["cvae"]["decoder"])[0]).copy()
    state, m = step(state, *args, jax.random.PRNGKey(1))
    assert np.isfinite(float(m["loss"]))
    after_conv = np.asarray(state.params["vgg16"]["conv1_1"]["kernel"])
    after_dec = np.asarray(
        jax.tree.leaves(state.params["cvae"]["decoder"])[0])
    assert not np.allclose(before_conv, after_conv)  # CNN updated
    assert not np.allclose(before_dec, after_dec)    # main updated


def test_finetune_frozen_conv():
    cfg = ft_config(fine_tune_fe=False, cnn_lr=0.01)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_finetune_optimizer(cfg)
    state = TrainState.create(params, tx)
    step = make_train_step(model, tx, cfg, donate=False)
    before = np.asarray(params["vgg16"]["conv1_1"]["kernel"]).copy()
    state, _ = step(state, *make_image_batch(), jax.random.PRNGKey(1))
    np.testing.assert_array_equal(
        before, np.asarray(state.params["vgg16"]["conv1_1"]["kernel"]))


def test_finetune_decode_from_images():
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_decode_fns
    cfg = ft_config(gen_max_len=5, beam_size=2)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(VOCAB - 4)])
    assert vocab.vocab_size == VOCAB
    fns = make_decode_fns(model, cfg, vocab)
    images, _, _, _, c_v = make_image_batch()
    tokens = fns["greedy"](params, images, c_v, jax.random.PRNGKey(0))
    assert np.asarray(tokens).shape == (2, 5)
    beam_tokens, scores = fns["beam_search"](params, images, c_v,
                                             jax.random.PRNGKey(0))
    assert np.asarray(beam_tokens).shape == (2, 5)
    assert np.isfinite(np.asarray(scores)).all()
