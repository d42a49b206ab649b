"""Numpy checkpoints, config sidecars, and a main path free of Flax and
Orbax."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vae_captioning.checkpoint import Checkpointer
from vae_captioning.config import Config
from vae_captioning.train import TrainState, init_model, make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(**kw):
    cfg = Config(embed_size=16, latent_size=8, encoder_hidden=16,
                 decoder_hidden=16, gen_z_samples=4, **kw)
    cfg.vocab_size = 30
    _, params = init_model(cfg, jax.random.PRNGKey(0))
    return TrainState.create(params, make_optimizer(cfg))


def _abstract(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        tree)


@pytest.mark.parametrize("kw", [
    dict(prior="Normal"), dict(prior="AG", use_c_v=True),
    dict(no_encoder=True)])
def test_round_trip_bit_equal(tmp_path, kw):
    state = _state(**kw)
    state = state.replace(step=jnp.asarray(7, jnp.int32))
    ckpt = Checkpointer(str(tmp_path), "run")
    ckpt.save(state)
    restored = ckpt.restore(_abstract(state))
    ckpt.close()
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert os.path.exists(os.path.join(str(tmp_path), "run", "7",
                                       "state.npz"))


def test_max_to_keep_rotation(tmp_path):
    state = _state()
    ckpt = Checkpointer(str(tmp_path), "rot", max_to_keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(state, step=s)
    assert ckpt.all_steps() == [3, 4]
    assert ckpt.latest_step() == 4
    assert sorted(os.listdir(ckpt.directory)) == ["3", "4"]
    ckpt.close()


def test_restore_rejects_mismatched_shape(tmp_path):
    state = _state()
    ckpt = Checkpointer(str(tmp_path), "bad")
    ckpt.save(state, step=1)
    wrong = jax.tree.map(lambda x: x, _abstract(state))
    wrong = wrong.replace(params=dict(
        wrong.params, imf_emb={"kernel": jax.ShapeDtypeStruct((3, 3),
                                                              jnp.float32),
                               "bias": wrong.params["imf_emb"]["bias"]}))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(wrong)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path), "empty").restore(_abstract(state))


def test_async_write_error_surfaces(tmp_path, monkeypatch):
    state = _state()
    ckpt = Checkpointer(str(tmp_path), "err")

    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", fail)
    ckpt.save(state, step=1)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    assert ckpt.all_steps() == []


def test_sidecar_with_removed_keys_loads(tmp_path):
    """Config sidecars written before the kernel flags were removed keep
    loading: unknown keys are dropped."""
    old = json.loads(Config(prior="AG").to_json())
    old.update(fused_decode=True, fused_lstm_step=True, fused_heads=True,
               fused_z=True, fused_lstm_seq=True, fused_force=False,
               fused_ce=False, ce_hybrid=True, ce_xla_bwd=False,
               decode_int8=True)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(old))
    cfg = Config.load(str(path))
    assert cfg.prior == "AG"
    assert not hasattr(cfg, "fused_decode")
    assert not hasattr(cfg, "decode_int8")


def test_main_path_imports_without_flax_and_orbax():
    code = """
import sys
for name in ("flax", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None
import vae_captioning.train, vae_captioning.inference
import vae_captioning.checkpoint, vae_captioning.cli
import vae_captioning.generate, vae_captioning.models.finetune
import vae_captioning.ops.logits_topk
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
