"""Benchmark: COCO-style caption generation throughput at beam 3, per card.

Runs the flagship AG-CVAE (reference default dims: embed 256, LSTM 512,
latent 150, 100 z samples, vocab 11,500) end to end on the GPU: features
→ cluster-conditioned z draw → init state → batched beam search, one jit,
no host round trips inside the timed region.  Each call ends in
``block_until_ready``; the median of the timed calls is reported.

Stdout's last line is one JSON metric line,
``{"metric": "captions_per_sec_per_chip_beam3", "value": ..., "unit":
"captions/sec/chip", "device": {...}, "batch": ...}``, for the fastest
batch of the schedule.  Earlier lines (stderr) give each batch's time,
the device, its count and the card's name and power limit.  Without a
GPU the script exits with status 2 and prints no metric.

``--trained N`` first fits N synthetic steps on a peaked task
(``data/synthetic.py``) so the decode runs where the beam-search
early-exit bound fires; the metric name then ends in ``_trained``.

  python bench.py [--batches 4096 32768] [--trained 50]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BEAM = 3
GEN_MAX_LEN = 30
VOCAB = 11500
BATCHES = (4096, 32768)


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def metric_line(metric: str, per_chip: float, device: dict,
                batch: int) -> str:
    return json.dumps({"metric": metric, "value": per_chip,
                       "unit": "captions/sec/chip", "device": device,
                       "batch": batch})


def _time_decode(beam_fn, params, features, c_v, iters: int):
    """(median seconds per call, setup seconds).  Setup is the first
    call: compilation, transfers and one execution."""
    import jax

    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    jax.block_until_ready(beam_fn(params, features, c_v, key))
    setup_s = time.perf_counter() - t0
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(
            beam_fn(params, features, c_v, jax.random.fold_in(key, i)))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), setup_s


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trained", type=int, default=0, metavar="STEPS",
                   help="train STEPS synthetic steps first; time decode "
                        "on the peaked (early-exit-active) model")
    p.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--vocab", type=int, default=VOCAB)
    args = p.parse_args(argv)

    from vae_captioning.utils import device
    from vae_captioning.utils.compile_cache import enable_compile_cache

    dev = device.require_gpu()
    _log(f"device {dev}; {device.nvidia_smi()}")
    _log(f"compile cache {enable_compile_cache()}")

    import jax

    from vae_captioning.config import Config
    from vae_captioning.data.synthetic import PeakedBatcher
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_decode_fns
    from vae_captioning.train import Trainer

    cfg = Config(prior="AG", use_c_v=True, beam_size=BEAM,
                 gen_max_len=GEN_MAX_LEN, sample_gen="beam_search",
                 batch_size=128, num_captions=1)
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(args.vocab - 4)])
    trainer = Trainer(cfg, vocab_size=vocab.vocab_size)
    pool = PeakedBatcher(vocab.vocab_size, vocab.bos_id, vocab.eos_id,
                         cfg.batch_size, num_batches=args.trained)
    for batch in pool.train_batches(cfg.num_captions):
        trainer.run_step(batch)
    params = trainer.state.params
    beam_fn = make_decode_fns(trainer.model, cfg, vocab)["beam_search"]

    metric = ("captions_per_sec_per_chip_beam3"
              + ("_trained" if args.trained else ""))
    best = None
    rng = np.random.default_rng(0)
    for batch in args.batches:
        ids = rng.integers(0, pool.anchors.shape[0], batch)
        features = jax.numpy.asarray(
            pool.anchors[ids] + pool.noise * rng.normal(
                size=(batch, cfg.cnn_feature_size)).astype(np.float32))
        c_v = jax.numpy.asarray(pool.cluster_vectors[ids])
        dt, setup_s = _time_decode(beam_fn, params, features, c_v,
                                   args.iters)
        per_chip = batch / dt / dev["count"]
        _log(f"batch {batch}: {dt * 1e3:.3f} ms/call, {per_chip:.1f} "
             f"captions/s/chip (setup {setup_s:.1f} s)")
        if best is None or per_chip > best[0]:
            best = (per_chip, batch)
    print(metric_line(metric, best[0], dev, best[1]), flush=True)


if __name__ == "__main__":
    main()
