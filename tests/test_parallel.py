"""Multi-chip (8 virtual CPU devices) tests: sharded decode parity,
mesh helpers, and the driver's dryrun_multichip entry."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vae_captioning.parallel import mesh as mesh_lib


def test_mesh_helpers():
    mesh = mesh_lib.create_mesh()
    assert mesh.devices.size == 8
    x = np.arange(16, dtype=np.float32).reshape(16, 1)
    sharded = mesh_lib.shard_batch(x, mesh)
    assert len(sharded.sharding.device_set) == 8
    rep = mesh_lib.replicate(x, mesh)
    assert len(rep.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(sharded), x)


def test_pad_to_multiple():
    x = np.ones((5, 3), np.float32)
    out = mesh_lib.pad_to_multiple(x, 8)
    assert out.shape == (8, 3)
    assert (out[5:] == 0).all()
    same = mesh_lib.pad_to_multiple(np.ones((8, 3), np.float32), 8)
    assert same.shape == (8, 3)


def _fake_flat_batch(B, K, T=6, F=16, seed=0):
    """Flattened train batch with row-identifiable contents: feature row i
    is filled with value i; caption row j (= image i, caption k) with
    100*i + k — so any image↔caption mispairing is detectable."""
    feats = np.stack([np.full((F,), i, np.float32) for i in range(B)])
    enc = np.stack([np.full((T,), 100 * (j // K) + j % K, np.int32)
                    for j in range(B * K)])
    dec = enc + 1
    lengths = np.arange(B * K, dtype=np.int32) + 1
    c_v = np.stack([np.full((90,), i, np.float32) for i in range(B)])
    return (feats, enc, dec, lengths, c_v)


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("B,K", [(16, 1), (16, 5), (13, 5)])
def test_prepare_process_batch_slices_reconstruct_global(P, B, K):
    """Concatenating every process's slice must reproduce the padded
    global batch exactly, with caption rows aligned to their image."""
    n_devices = 8 * P  # mesh spans all processes' local devices
    global_arrays = _fake_flat_batch(B, K)
    # the padded single-process view is the ground truth
    padded = mesh_lib.prepare_process_batch(global_arrays, K, n_devices,
                                            P=1, pid=0)
    Bp = padded[0].shape[0]
    assert Bp % n_devices == 0 and Bp % P == 0
    assert padded[1].shape[0] == Bp * K

    slices = [mesh_lib.prepare_process_batch(global_arrays, K, n_devices,
                                             P=P, pid=pid)
              for pid in range(P)]
    for arr_i in range(5):
        rebuilt = np.concatenate([s[arr_i] for s in slices])
        np.testing.assert_array_equal(rebuilt, padded[arr_i])
    # per-process alignment: caption row j of a slice belongs to image
    # row j // K of the SAME slice (feature fill value == enc // 100)
    for s in slices:
        feats_s, enc_s = s[0], s[1]
        for j in range(enc_s.shape[0]):
            img_val = feats_s[j // K, 0]
            cap_img = enc_s[j, 0] // 100
            if enc_s[j, 0] != 0:  # skip zero padding rows
                assert cap_img == img_val, (j, cap_img, img_val)


def test_prepare_process_batch_guards():
    arrays = _fake_flat_batch(8, 2)
    with pytest.raises(ValueError, match="not divisible by process"):
        mesh_lib.prepare_process_batch(arrays, 2, n_devices=8, P=3, pid=0)
    with pytest.raises(ValueError, match="out of range"):
        mesh_lib.prepare_process_batch(arrays, 2, n_devices=8, P=2, pid=2)
    with pytest.raises(ValueError, match="caption rows"):
        mesh_lib.prepare_process_batch(arrays, 4, n_devices=8, P=1, pid=0)


def test_multistep_sharded_trajectory_matches_single_device():
    """≥5 train steps on the 8-device dp mesh must track the unsharded
    param trajectory (loss each step + final params)."""
    from vae_captioning.config import Config
    from vae_captioning.train import (TrainState, init_model,
                                          make_optimizer, make_train_step)

    # SGD, not Adam: Adam's sqrt(v) normalization turns float32
    # reduction-order noise on near-zero grads into ±lr sign flips,
    # which would make param comparison meaningless
    cfg = Config(embed_size=16, latent_size=8, encoder_hidden=16,
                 decoder_hidden=16, gen_z_samples=4, batch_size=8,
                 prior="Normal", learning_rate=0.05, optimizer="SGD")
    cfg.vocab_size = 40
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    step = make_train_step(model, tx, cfg, donate=False)

    rng_np = np.random.default_rng(3)
    batches = []
    for _ in range(6):
        B, T = 8, 6
        dec = rng_np.integers(1, 40, size=(B, T)).astype(np.int32)
        enc = np.concatenate([dec[:, 1:], np.zeros((B, 1), np.int32)], -1)
        lengths = np.full((B,), T - 1, np.int32)
        c_v = rng_np.random((B, 90)).astype(np.float32)
        batches.append((rng_np.normal(size=(B, 4096)).astype(np.float32),
                        enc, dec, lengths, c_v / c_v.sum(-1, keepdims=True)))

    rng = jax.random.PRNGKey(7)
    s1 = TrainState.create(params, tx)
    losses1 = []
    for b in batches:
        s1, m = step(s1, *[jnp.asarray(x) for x in b], rng)
        losses1.append(float(m["loss"]))

    mesh = mesh_lib.create_mesh()
    s2 = TrainState.create(mesh_lib.replicate(params, mesh), tx)
    losses2 = []
    for b in batches:
        sb = mesh_lib.shard_batch(tuple(b), mesh)
        s2, m = step(s2, *sb, rng)
        losses2.append(float(m["loss"]))

    # float32 psum reduction order differs from the single-device sum, so
    # trajectories drift slightly; they must stay locked to ~1e-3
    np.testing.assert_allclose(losses1, losses2, rtol=1e-3)
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=2e-4)


@pytest.mark.slow
def test_multihost_two_process_training():
    """REAL multi-host training: 2 jax.distributed processes × 4 virtual
    CPU devices (Gloo collectives), production Trainer, 4 steps — both
    processes must agree with each other AND with the single-process
    8-device trajectory on the same seed-deterministic batches.
    Exercises jax.distributed.initialize, per-process batch slicing, and
    make_array_from_process_local_data end-to-end (SURVEY §5
    distributed-comm rebuild; VERDICT r1 'unexercised multi-host')."""
    import json
    import socket
    import subprocess
    import sys

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()

    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "multihost_worker.py"),
         str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    results = {}
    results_full = {}
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        rec = json.loads(out.strip().splitlines()[-1])
        results[rec["pid"]] = rec["losses"]
        results_full[rec["pid"]] = rec
    assert set(results) == {0, 1}
    # both processes compute the same global loss every step
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)

    # single-process reference on this process's own 8-device mesh
    from vae_captioning.config import Config
    from vae_captioning.data.batcher import Batch
    from vae_captioning.train import Trainer

    cfg = Config(embed_size=16, latent_size=8, encoder_hidden=16,
                 decoder_hidden=16, gen_z_samples=4, batch_size=16,
                 prior="Normal", learning_rate=0.05, optimizer="SGD")
    cfg.vocab_size = 40
    trainer = Trainer(cfg)
    ref_losses = []
    for step in range(4):
        rng = np.random.default_rng(step)
        B, K, T = 16, 2, 8
        dec = rng.integers(1, 40, size=(B, K, T)).astype(np.int32)
        lab = np.concatenate([dec[:, :, 1:],
                              np.zeros((B, K, 1), np.int32)], -1)
        lengths = np.full((B, K), T - 1, np.int32)
        c_v = rng.random((B, 90)).astype(np.float32)
        c_v /= c_v.sum(-1, keepdims=True)
        batch = Batch(features=rng.normal(size=(B, 4096))
                      .astype(np.float32),
                      dec_inputs=dec, labels=lab, lengths=lengths,
                      cluster_vectors=c_v, valid=B)
        ref_losses.append(float(trainer.run_step(batch)["loss"]))
    # 2×4-device distributed must track the 8-device single-process run
    np.testing.assert_allclose(results[0], ref_losses, rtol=1e-3)

    # ---- decode parity: the workers greedy-decoded a seed-deterministic
    # batch over the GLOBAL 2×4 mesh and reduced to one checksum; both
    # processes must agree, and the single-process 8-device run of the
    # identical decode must produce the same tokens (decode is
    # embarrassingly parallel — sharding never changes per-row math)
    assert results_full[0]["decode_checksum"] == \
        results_full[1]["decode_checksum"]

    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_decode_fns
    from vae_captioning.models.cvae import CVAEModel

    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(cfg.vocab_size - 4)])
    greedy = make_decode_fns(CVAEModel.from_config(cfg), cfg, vocab)[
        "greedy"]
    # same FRESH seed-deterministic params as the workers (trained
    # params drift between Gloo and XLA reduction orders; argmax is
    # discontinuous, so exact equality needs identical params)
    from vae_captioning.train import init_model
    _, decode_params = init_model(cfg, jax.random.PRNGKey(cfg.seed))
    rngd = np.random.default_rng(99)
    Bg = 16
    feats = rngd.normal(size=(Bg, 4096)).astype(np.float32)
    c_v = rngd.random((Bg, 90)).astype(np.float32)
    c_v /= c_v.sum(-1, keepdims=True)
    tokens = greedy(decode_params, jnp.asarray(feats),
                    jnp.asarray(c_v), jax.random.PRNGKey(3))
    w = np.arange(1, tokens.size + 1).reshape(tokens.shape)
    ref_checksum = int(np.sum(np.asarray(tokens) * w))
    assert results_full[0]["decode_checksum"] == ref_checksum


def test_sharded_beam_decode_matches_unsharded():
    """Decode with the batch sharded over the dp mesh must equal the
    single-device result (decode is embarrassingly parallel, SURVEY §5)."""
    from vae_captioning.config import Config
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_decode_fns
    from vae_captioning.models.cvae import CVAEModel
    from vae_captioning.train import init_model

    cfg = Config(embed_size=16, latent_size=8, encoder_hidden=16,
                 decoder_hidden=16, gen_z_samples=4, prior="AG",
                 use_c_v=True, gen_max_len=6, beam_size=3)
    cfg.vocab_size = 40
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(36)])
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    fns = make_decode_fns(CVAEModel.from_config(cfg), cfg, vocab)

    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(16, 4096)).astype(np.float32))
    c_v = rng.random((16, 90)).astype(np.float32)
    c_v = jnp.asarray(c_v / c_v.sum(-1, keepdims=True))
    key = jax.random.PRNGKey(5)

    t1, s1 = fns["beam_search"](params, feats, c_v, key)

    mesh = mesh_lib.create_mesh()
    feats_s, cv_s = mesh_lib.shard_batch((np.asarray(feats),
                                          np.asarray(c_v)), mesh)
    params_r = mesh_lib.replicate(params, mesh)
    t2, s2 = fns["beam_search"](params_r, feats_s, cv_s, key)
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-5)


def test_dryrun_multichip_entry():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))),
            "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)  # must not raise


def test_entry_forward_jits():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry2", os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))),
            "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out))
