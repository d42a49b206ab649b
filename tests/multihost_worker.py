"""Multi-host test worker: one REAL jax.distributed process.

Launched by tests/test_parallel.py::test_multihost_two_process_training
as ``python multihost_worker.py <pid> <P> <port>``.  Each process gets 4
virtual CPU devices; the dp mesh spans all P×4 global devices (Gloo
collectives).  Runs the production Trainer for 4 steps on
seed-deterministic batches (identical in every process — the multi-host
contract ``prepare_process_batch`` documents) and prints one JSON line
with the per-step losses.
"""

import json
import os
import sys


def main() -> None:
    pid, P, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=P, process_id=pid)
    assert jax.process_count() == P
    assert jax.device_count() == 4 * P

    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vae_captioning.config import Config
    from vae_captioning.data.batcher import Batch
    from vae_captioning.train import Trainer

    cfg = Config(embed_size=16, latent_size=8, encoder_hidden=16,
                 decoder_hidden=16, gen_z_samples=4, batch_size=16,
                 prior="Normal", learning_rate=0.05, optimizer="SGD")
    cfg.vocab_size = 40
    trainer = Trainer(cfg)

    losses = []
    for step in range(4):
        rng = np.random.default_rng(step)  # same batch in EVERY process
        B, K, T = 16, 2, 8
        dec = rng.integers(1, 40, size=(B, K, T)).astype(np.int32)
        lab = np.concatenate([dec[:, :, 1:], np.zeros((B, K, 1), np.int32)],
                             -1)
        lengths = np.full((B, K), T - 1, np.int32)
        c_v = rng.random((B, 90)).astype(np.float32)
        c_v /= c_v.sum(-1, keepdims=True)
        batch = Batch(features=rng.normal(size=(B, 4096)).astype(np.float32),
                      dec_inputs=dec, labels=lab, lengths=lengths,
                      cluster_vectors=c_v, valid=B)
        m = trainer.run_step(batch)
        losses.append(float(m["loss"]))

    # ---- decode parity across the global mesh: greedy-decode a
    # seed-deterministic feature batch sharded over all P×4 devices and
    # reduce the tokens to one replicated checksum every process can
    # fetch.  Greedy decode is deterministic given (params, features,
    # rng), and batch sharding never changes per-row math, so the
    # checksum must agree across processes AND with the single-process
    # reference the launching test computes.  Decode uses FRESH
    # seed-deterministic params (not the trained ones): Gloo vs XLA
    # reduction order makes trained params drift ~1e-5, and argmax is
    # discontinuous — exact token equality is only guaranteed for
    # identical params.
    import jax.numpy as jnp
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_decode_fns
    from vae_captioning.models.cvae import CVAEModel
    from vae_captioning.parallel import mesh as pmesh
    from vae_captioning.train import init_model

    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(cfg.vocab_size - 4)])
    greedy = make_decode_fns(CVAEModel.from_config(cfg), cfg, vocab)[
        "greedy"]
    _, decode_params = init_model(cfg, jax.random.PRNGKey(cfg.seed))
    decode_params = pmesh.replicate(decode_params, trainer.mesh)
    rngd = np.random.default_rng(99)
    Bg = 16
    feats = rngd.normal(size=(Bg, 4096)).astype(np.float32)
    cv = rngd.random((Bg, 90)).astype(np.float32)
    cv /= cv.sum(-1, keepdims=True)
    rows = Bg // P
    loc = slice(pid * rows, (pid + 1) * rows)
    gfeats, gcv = pmesh.shard_batch(
        (feats[loc], cv[loc]), trainer.mesh)
    tokens = greedy(decode_params, gfeats, gcv, jax.random.PRNGKey(3))
    w = jnp.arange(1, Bg * tokens.shape[1] + 1,
                   dtype=jnp.int64 if jax.config.jax_enable_x64
                   else jnp.int32).reshape(Bg, -1)
    checksum = int(jax.jit(lambda t: jnp.sum(t * w))(tokens))
    print(json.dumps({"pid": pid, "losses": losses,
                      "decode_checksum": checksum}), flush=True)


if __name__ == "__main__":
    main()
