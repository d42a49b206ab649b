"""Training-stack tests: optimizer semantics, jitted train step, 8-device
data-parallel sharding, checkpoint round-trip, overfit sanity."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from vae_captioning.config import Config
from vae_captioning.data.batcher import Batch
from vae_captioning.parallel import mesh as mesh_lib
from vae_captioning.train import (
    TrainState, Trainer, _lr_schedule, init_model, make_optimizer,
    make_train_step)

VOCAB = 40


def small_config(**kw) -> Config:
    base = dict(embed_size=16, latent_size=8, encoder_hidden=16,
                decoder_hidden=16, gen_z_samples=4, batch_size=8,
                num_ex_per_epoch=64)
    base.update(kw)
    cfg = Config(**base)
    cfg.vocab_size = VOCAB
    return cfg


def make_host_batch(B=8, K=1, T=8, seed=0) -> Batch:
    rng = np.random.default_rng(seed)
    dec = rng.integers(1, VOCAB, size=(B, K, T)).astype(np.int32)
    lab = np.concatenate([dec[:, :, 1:], np.zeros((B, K, 1), np.int32)], -1)
    lengths = np.full((B, K), T - 1, np.int32)
    c_v = rng.random((B, 90)).astype(np.float32)
    c_v /= c_v.sum(-1, keepdims=True)
    return Batch(features=rng.normal(size=(B, 4096)).astype(np.float32),
                 dec_inputs=dec, labels=lab, lengths=lengths,
                 cluster_vectors=c_v, valid=B)


# ---------------------------------------------------------------- optimizer

def test_lr_schedule_staircase():
    cfg = small_config(num_ex_per_epoch=100, batch_size=10,
                       num_epochs_per_decay=2)
    sched = _lr_schedule(cfg, 0.1, "SGD")
    # decay_steps = 100/10.001 * 2 ≈ 19
    assert float(sched(0)) == pytest.approx(0.1)
    assert float(sched(18)) == pytest.approx(0.1)
    assert float(sched(19)) == pytest.approx(0.05)
    assert float(sched(38)) == pytest.approx(0.025)


def test_adam_constant_lr():
    cfg = small_config()
    assert _lr_schedule(cfg, 0.1, "Adam") == 0.1  # ref :37-40, no decay


def test_optimizer_clips_global_norm():
    cfg = small_config(lstm_clip_by_norm=1.0, optimizer="SGD",
                       learning_rate=1.0)
    tx = make_optimizer(cfg)
    params = {"w": jnp.ones((4,)) * 0.0}
    grads = {"w": jnp.ones((4,)) * 100.0}
    state = tx.init(params)
    updates, _ = tx.update(grads, state, params)
    assert float(optax.global_norm(updates)) == pytest.approx(1.0, rel=1e-5)


def test_finetune_optimizer_labels_and_freezing():
    from vae_captioning.train import make_finetune_optimizer
    cfg = small_config(fine_tune=True, fine_tune_fe=False, fine_tune_top=True,
                       cnn_optimizer="SGD", optimizer="SGD")
    tx = make_finetune_optimizer(cfg)
    params = {"vgg16": {"conv1_1": {"kernel": jnp.ones(3)},
                        "fc1": {"kernel": jnp.ones(3)}},
              "cvae": {"w": jnp.ones(3)}}
    state = tx.init(params)
    grads = jax.tree.map(jnp.ones_like, params)
    updates, _ = tx.update(grads, state, params)
    # conv frozen (fine_tune_fe=False) → zero update
    np.testing.assert_array_equal(
        np.asarray(updates["vgg16"]["conv1_1"]["kernel"]), 0.0)
    # fc trainable → nonzero update
    assert np.abs(np.asarray(updates["vgg16"]["fc1"]["kernel"])).max() > 0
    assert np.abs(np.asarray(updates["cvae"]["w"])).max() > 0


# ---------------------------------------------------------------- step

def test_train_step_updates_and_reduces_loss():
    cfg = small_config(prior="Normal", ann_param=0.0, learning_rate=0.01)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    state = TrainState.create(params, tx)
    step = make_train_step(model, tx, cfg, donate=False)
    b = make_host_batch()
    from vae_captioning.train import _flatten_batch
    features, enc, dec, lengths, c_v = [jnp.asarray(x) for x in
                                        _flatten_batch(b)]
    rng = jax.random.PRNGKey(1)
    losses = []
    for _ in range(60):
        state, m = step(state, features, enc, dec, lengths, c_v, rng)
        losses.append(float(m["loss"]))
    assert int(state.step) == 60
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
    assert np.isfinite(losses).all()


def test_train_step_ag_prior():
    cfg = small_config(prior="AG", use_c_v=True)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    state = TrainState.create(params, tx)
    step = make_train_step(model, tx, cfg, donate=False)
    from vae_captioning.train import _flatten_batch
    args = [jnp.asarray(x) for x in _flatten_batch(make_host_batch())]
    state, m = step(state, *args, jax.random.PRNGKey(1))
    assert np.isfinite(float(m["loss"]))
    assert float(m["kld"]) != 0.0


def test_loss_fn_gradient_is_the_train_steps():
    """make_loss_fn is the objective the step differentiates: its loss
    and gradient norm at a step equal the step's metrics."""
    from vae_captioning.train import _flatten_batch, make_loss_fn
    cfg = small_config(prior="AG", use_c_v=True)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    step = make_train_step(model, tx, cfg, donate=False)
    args = [jnp.asarray(x) for x in _flatten_batch(make_host_batch())]
    rng = jax.random.PRNGKey(1)
    state, _ = step(TrainState.create(params, tx), *args, rng)
    _, m = step(state, *args, rng)
    grads, losses = jax.jit(jax.grad(make_loss_fn(model, cfg),
                                     has_aux=True))(
        state.params, state.step, *args, rng)
    np.testing.assert_allclose(float(losses["loss"]), float(m["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(optax.global_norm(grads)),
                               float(m["grad_norm"]), rtol=1e-5)


def test_train_step_bias_fold_matches_dense():
    """Config.ce_bias_fold ([h ‖ 1] @ [[W],[b]] logits head) must track
    the Dense path: same param tree, losses equal to the one-extra-bf16-
    rounding class over real update steps."""
    losses = {}
    for fold in (False, True):
        cfg = small_config(prior="AG", use_c_v=True, ce_bias_fold=fold)
        model, params = init_model(cfg, jax.random.PRNGKey(0))
        tx = make_optimizer(cfg)
        state = TrainState.create(params, tx)
        step = make_train_step(model, tx, cfg, donate=False)
        from vae_captioning.train import _flatten_batch
        args = [jnp.asarray(x) for x in _flatten_batch(make_host_batch())]
        run = []
        for i in range(3):
            state, m = step(state, *args,
                            jax.random.fold_in(jax.random.PRNGKey(1), i))
            run.append(float(m["loss"]))
        losses[fold] = np.asarray(run)
        # identical param tree either way (the Dense branch runs at init)
        paths = {"/".join(str(k) for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
        assert any("rnn_logits" in s for s in paths), paths
    np.testing.assert_allclose(losses[False], losses[True], rtol=2e-3)


def test_train_step_ag_kl_sum():
    """Config.ag_kl_sum = the reference's implicit batch-sum AG-KL
    weighting: the reported kld at identical params/rng is exactly
    n_valid_rows x the default batch-meaned kld."""
    kld = {}
    for flag in (False, True):
        cfg = small_config(prior="AG", use_c_v=True, ag_kl_sum=flag)
        model, params = init_model(cfg, jax.random.PRNGKey(0))
        tx = make_optimizer(cfg)
        state = TrainState.create(params, tx)
        step = make_train_step(model, tx, cfg, donate=False)
        from vae_captioning.train import _flatten_batch
        args = [jnp.asarray(x) for x in _flatten_batch(make_host_batch())]
        _, m = step(state, *args, jax.random.PRNGKey(1))
        kld[flag] = float(m["kld"])
    assert kld[True] == pytest.approx(8 * kld[False], rel=1e-4)


# ---------------------------------------------------------------- sharding

def test_trainer_runs_on_8_device_mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    cfg = small_config(prior="AG", use_c_v=True, num_captions=2)
    trainer = Trainer(cfg)
    assert trainer.mesh.devices.size == 8
    m = trainer.run_step(make_host_batch(B=8, K=2))
    assert np.isfinite(float(m["loss"]))
    # params stay replicated across the mesh
    leaf = jax.tree.leaves(trainer.state.params)[0]
    assert len(leaf.sharding.device_set) == 8
    m2 = trainer.run_step(make_host_batch(B=8, K=2, seed=1))
    assert int(trainer.state.step) == 2


def test_trainer_pads_uneven_batches():
    cfg = small_config()
    trainer = Trainer(cfg)
    # batch of 5 → padded to 8 lanes internally, still runs
    m = trainer.run_step(make_host_batch(B=5))
    assert np.isfinite(float(m["loss"]))


def test_data_parallel_equals_single_device():
    """The dp-sharded step must produce the same loss as an unsharded run."""
    cfg = small_config(prior="Normal")
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    step = make_train_step(model, tx, cfg, donate=False)
    from vae_captioning.train import _flatten_batch
    args = [jnp.asarray(x) for x in _flatten_batch(make_host_batch())]
    rng = jax.random.PRNGKey(1)

    s1 = TrainState.create(params, tx)
    _, m1 = step(s1, *args, rng)

    mesh = mesh_lib.create_mesh()
    sharded_args = mesh_lib.shard_batch(tuple(args), mesh)
    s2 = TrainState.create(mesh_lib.replicate(params, mesh), tx)
    _, m2 = step(s2, *sharded_args, rng)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    from vae_captioning.checkpoint import Checkpointer
    cfg = small_config()
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    state = TrainState.create(params, tx)
    ckpt = Checkpointer(str(tmp_path), "testrun", max_to_keep=2)
    ckpt.save(state, step=0)
    state2 = state.replace(step=state.step + 5)
    ckpt.save(state2, step=5)
    assert ckpt.latest_step() == 5
    restored = ckpt.restore(jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state))
    assert int(restored.step) == 5
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ckpt.close()


def test_restore_pre_rename_checkpoint(tmp_path):
    """Round 4 fused the encoder posterior heads (lz_mean/lz_logstd ->
    ONE q_heads dense, mean-first concat).  A checkpoint written with
    the OLD layout must still restore: Checkpointer.restore retries
    against the split layout and concatenates the halves back —
    including the Adam moments, which mirror the param tree
    (VERDICT r4 #7; ref keeps whole-Saver compat, main.py:186-191)."""
    from vae_captioning.checkpoint import Checkpointer, split_q_heads
    cfg = small_config(prior="AG")
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    state = TrainState.create(params, tx)

    old_state, n_split = split_q_heads(state)
    assert n_split >= 1, "fixture must actually exercise the rename"
    # the fixture really is the pre-rename layout
    flat_old = {"/".join(str(k) for k in p): None
                for p, _ in jax.tree_util.tree_flatten_with_path(
                    old_state.params)[0]}
    assert not any("q_heads" in k for k in flat_old)
    assert any("lz_mean" in k for k in flat_old)

    ckpt = Checkpointer(str(tmp_path), "prerename")
    ckpt.save(old_state, step=3)
    ckpt.wait()
    abstract = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    restored = ckpt.restore(abstract)
    ckpt.close()

    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_sidecars(tmp_path):
    from vae_captioning.checkpoint import load_sidecars, save_sidecars
    from vae_captioning.data.vocabulary import Vocabulary
    cfg = small_config(prior="AG")
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>", "cat"])
    save_sidecars(cfg, vocab, str(tmp_path), "run1")
    cfg2, vocab2 = load_sidecars(str(tmp_path), "run1")
    assert cfg2.prior == "AG"
    assert vocab2.word2idx == vocab.word2idx


def test_padded_multicaption_batch_matches_unpadded_loss():
    """Regression: with B=4 (< 8 devices) and K=5 captions, the padded
    dp-sharded step must produce EXACTLY the unpadded loss — independent
    per-array padding used to mispair images with captions."""
    cfg = small_config(prior="Normal", num_captions=5, batch_size=4)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    step = make_train_step(model, tx, cfg, donate=False)
    from vae_captioning.train import _flatten_batch
    batch = make_host_batch(B=4, K=5)
    rng = jax.random.PRNGKey(1)

    # direct, unpadded
    args = [jnp.asarray(x) for x in _flatten_batch(batch)]
    s1 = TrainState.create(params, tx)
    _, m1 = step(s1, *args, rng)

    # through the Trainer (pads B 4→8 on the 8-device mesh)
    trainer = Trainer(cfg)
    trainer.state = TrainState.create(
        mesh_lib.replicate(params, trainer.mesh), tx)
    trainer._rng = rng
    m2 = trainer.run_step(batch)
    # padded caption rows are fully masked; rec_loss must match exactly
    assert float(m1["rec_loss"]) == pytest.approx(float(m2["rec_loss"]),
                                                  rel=1e-5), \
        (float(m1["rec_loss"]), float(m2["rec_loss"]))


class _FakeBatcher:
    """Restartable fake batcher: N batches of B images per sweep."""

    def __init__(self, n_batches=5, B=8, K=1, with_ids=False):
        self.n, self.B, self.K, self.with_ids = n_batches, B, K, with_ids

    def train_batches(self, num_captions=1, drop_remainder=True):
        for i in range(self.n):
            yield make_host_batch(B=self.B, K=self.K, seed=i)

    def eval_batches(self, num_captions=1, with_ids=False):
        for i in range(self.n):
            b = make_host_batch(B=self.B, K=self.K, seed=100 + i)
            if with_ids:
                b.image_ids = np.arange(i * self.B, (i + 1) * self.B)
                b.valid = self.B
            yield b


def test_step_cadence_checkpointing(tmp_path):
    """Config.ckpt_every_steps > 0 must save mid-epoch so a crash costs
    at most N steps, and a fresh Trainer must resume from the latest
    mid-epoch step (VERDICT r1 #6)."""
    from vae_captioning.checkpoint import Checkpointer
    cfg = small_config(ckpt_every_steps=2, num_epochs=1,
                       num_ex_per_epoch=40, batch_size=8)
    trainer = Trainer(cfg)
    ckpt = Checkpointer(str(tmp_path), "cadence")
    trainer.fit(_FakeBatcher(n_batches=6), checkpointer=ckpt)
    # 6 steps ran: cadence saves at 2, 4, 6 (+ epoch-end save at 6)
    assert trainer.host_step == 6
    assert ckpt.all_steps() == [2, 4, 6]

    resumed = Trainer(small_config(ckpt_every_steps=2, restore=True))
    resumed.restore_from(ckpt)
    assert resumed.host_step == 6
    for a, b in zip(jax.tree.leaves(resumed.state.params),
                    jax.tree.leaves(trainer.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ckpt.close()


def test_fit_quality_hook_logged(tmp_path):
    """The per-epoch quality hook's metrics must land in the JSONL log
    and the returned metrics (SURVEY §5: CIDEr/BLEU hooks)."""
    import json
    cfg = small_config(num_epochs=1, num_ex_per_epoch=16, batch_size=8,
                       logging=True, log_dir=str(tmp_path), checkpoint="qh")
    trainer = Trainer(cfg)
    calls = []

    def hook(params, vb, rng):
        calls.append(1)
        return {"val_CIDEr-D": 1.23, "val_BLEU-4": 0.5}

    out = trainer.fit(_FakeBatcher(n_batches=3), _FakeBatcher(n_batches=1),
                      quality_hook=hook)
    assert calls == [1]
    assert out["val_CIDEr-D"] == pytest.approx(1.23)
    lines = [json.loads(l) for l in
             (tmp_path / "qh.metrics.jsonl").read_text().splitlines()]
    assert any(r.get("val_CIDEr-D") == 1.23 for r in lines)


def test_make_quality_hook_scores_decodes():
    """End-to-end hook: greedy decode a fake val batcher, score against
    references keyed by image id."""
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_quality_hook
    cfg = small_config(prior="Normal", gen_max_len=6)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(VOCAB - 4)])
    assert vocab.vocab_size == VOCAB
    refs = {str(i): [f"w1 w2 w3 w{i % 5}"] for i in range(16)}
    hook = make_quality_hook(cfg, vocab, refs)
    out = hook(params, _FakeBatcher(n_batches=2, with_ids=True),
               jax.random.PRNGKey(1))
    assert set(out) == {"val_CIDEr-D", "val_BLEU-4", "val_ROUGE-L",
                        "val_METEOR_es"}
    assert all(np.isfinite(v) and v >= 0.0 for v in out.values())


def test_prefetcher_order_exceptions_close():
    from vae_captioning.utils.prefetch import Prefetcher
    assert list(Prefetcher(range(100), depth=3)) == list(range(100))
    assert list(Prefetcher(iter(()), depth=1)) == []

    def boom():
        yield 1
        raise RuntimeError("source failed")

    p = Prefetcher(boom())
    assert next(p) == 1
    with pytest.raises(RuntimeError, match="source failed"):
        next(p)
    # early exit: close() unblocks the producer thread
    p2 = Prefetcher(range(10**6), depth=1)
    assert next(p2) == 0
    p2.close()
    p2._thread.join(timeout=5)
    assert not p2._thread.is_alive()


def test_fit_uses_prefetcher_and_matches_inline():
    """Same 6-step trajectory with prefetch on and off."""
    losses = {}
    for depth in (0, 2):
        cfg = small_config(prefetch_batches=depth, num_epochs=1,
                           num_ex_per_epoch=40, batch_size=8)
        trainer = Trainer(cfg)
        out = trainer.fit(_FakeBatcher(n_batches=6), log_every=1)
        assert np.isfinite(out["loss"])
        losses[depth] = (trainer.host_step, out["loss"])
    assert losses[0] == losses[2]


def test_fit_raises_on_dataset_smaller_than_batch():
    """Regression: fit() used to spin forever when train_batches yielded
    nothing (dataset < batch_size with drop_remainder)."""
    cfg = small_config(batch_size=32, num_epochs=1, num_ex_per_epoch=100)
    trainer = Trainer(cfg)

    class EmptyBatcher:
        def train_batches(self, num_captions=1, drop_remainder=True):
            return iter(())

    with pytest.raises(ValueError, match="batch_size"):
        trainer.fit(EmptyBatcher())


def test_kl_ignores_mesh_padding_rows():
    """Padded rows (all-PAD captions) must not shift the KL term."""
    cfg = small_config(prior="Normal", batch_size=4)
    model, params = init_model(cfg, jax.random.PRNGKey(0))
    tx = make_optimizer(cfg)
    step = make_train_step(model, tx, cfg, donate=False)
    from vae_captioning.train import _flatten_batch
    batch = make_host_batch(B=4, K=1)
    args = [jnp.asarray(x) for x in _flatten_batch(batch)]
    rng = jax.random.PRNGKey(1)
    _, m1 = step(TrainState.create(params, tx), *args, rng)
    trainer = Trainer(cfg)  # pads 4 → 8 on the mesh
    trainer.state = TrainState.create(
        mesh_lib.replicate(params, trainer.mesh), tx)
    trainer._rng = rng
    m2 = trainer.run_step(batch)
    assert float(m1["kld"]) == pytest.approx(float(m2["kld"]), rel=1e-5)
    assert float(m1["rec_loss"]) == pytest.approx(float(m2["rec_loss"]),
                                                  rel=1e-5)


def test_optax_flatten_parity():
    """cfg.optax_flatten raveled-vector chain must produce the same
    trajectory as the per-leaf chain (clip is a global norm, Adam is
    elementwise — identity up to float assoc; checked over 10 steps)."""
    from vae_captioning.train import _flatten_batch
    traj = {}
    for flat in (False, True):
        cfg = small_config(prior="Normal", optax_flatten=flat,
                           learning_rate=0.01)
        model, params = init_model(cfg, jax.random.PRNGKey(0))
        tx = make_optimizer(cfg)
        state = TrainState.create(params, tx)
        step = make_train_step(model, tx, cfg, donate=False)
        args = [jnp.asarray(x) for x in _flatten_batch(make_host_batch())]
        rng = jax.random.PRNGKey(1)
        losses = []
        for _ in range(10):
            state, m = step(state, *args, rng)
            losses.append(float(m["loss"]))
        traj[flat] = (losses, state.params)
    np.testing.assert_allclose(traj[False][0], traj[True][0], rtol=1e-5)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6),
        traj[False][1], traj[True][1])
