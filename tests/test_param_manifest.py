"""Parameter trees stay what checkpoints were written with.

``tests/data/param_manifest.json`` records, for every model variant, the
key path and shape of each parameter at reference widths (vocab 11,500),
and for a tiny config the sum and first element of each leaf at seed 0,
both taken from the trees the checkpoints in use were made with.  The
shapes pin the layout; the values pin the per-parameter key derivation
(``ops.layers.fold_in_path``), so a seed still gives the same model.
"""

import json
import os

import jax
import numpy as np
import pytest

from vae_captioning.config import Config
from vae_captioning.train import init_model

with open(os.path.join(os.path.dirname(__file__), "data",
                       "param_manifest.json")) as f:
    MANIFEST = json.load(f)

VARIANTS = {
    "baseline": dict(no_encoder=True),
    "Normal": dict(prior="Normal"),
    "GMM": dict(prior="GMM", use_c_v=True),
    "AG": dict(prior="AG", use_c_v=True),
    "finetune_AG": dict(prior="AG", use_c_v=True, fine_tune=True,
                        image_net_weights_path="/nonexistent.npz"),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_key_paths_and_shapes(name):
    cfg = Config(**VARIANTS[name])
    cfg.vocab_size = 11500
    shapes = jax.eval_shape(lambda r: init_model(cfg, r)[1],
                            jax.random.PRNGKey(0))
    got = {"/".join(k.key for k in path): list(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert got == MANIFEST["shapes_vocab_11500"][name]


@pytest.mark.parametrize("name,kw", [
    ("AG", dict(prior="AG", use_c_v=True)),
    ("finetune_Normal", dict(prior="Normal", fine_tune=True, image_size=32,
                             image_net_weights_path="/nonexistent.npz")),
])
def test_init_values_reproduce_recorded_trees(name, kw):
    cfg = Config(embed_size=16, latent_size=8, encoder_hidden=16,
                 decoder_hidden=16, gen_z_samples=4, **kw)
    cfg.vocab_size = 40
    _, params = init_model(cfg, jax.random.PRNGKey(0))
    want = MANIFEST["init_sum_and_first_tiny_seed0"][name]
    got = {jax.tree_util.keystr(p): v
           for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(got) == set(want)
    for key, (total, first) in want.items():
        leaf = np.asarray(got[key])
        assert float(leaf.ravel()[0]) == first, key
        assert float(leaf.astype(np.float64).sum()) == pytest.approx(
            total, rel=1e-9, abs=1e-9), key
