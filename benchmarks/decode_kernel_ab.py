"""Decode with the fused logits top-K kernel against plain XLA, on the GPU.

For each decode mode (beam 3, beam 10, greedy) and batch (4,096 and
32,768 images), both paths of ``make_decode_fns`` are compiled, warmed
up, then timed in turns — XLA, kernel, kernel, XLA — ``--reps`` times,
each call ending in ``block_until_ready``.  Weights are random from a
seed, so neither path's beams finish early and both run all
``gen_max_len`` = 30 steps: the difference is the per-step cost of the
logits head + top-K.  It also reports the share of captions both paths
decode identically.

``--blocks`` additionally times the kernel alone against the XLA
reference alone at 4,096, 12,288 and 98,304 rows for each block
configuration (bm, bv, bk, num_warps, num_stages).

  python benchmarks/decode_kernel_ab.py [--batches 4096 32768] [--reps 3]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MODES = {"beam3": ("beam_search", 3), "beam10": ("beam_search", 10),
         "greedy": ("greedy", 3)}
BLOCKS = [(128, 128, 64, 8, 3), (64, 128, 64, 4, 3), (64, 128, 128, 4, 2),
          (128, 128, 128, 8, 2), (128, 256, 64, 8, 3)]


def timed(fn, *args) -> float:
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def sweep_blocks() -> None:
    import jax
    import jax.numpy as jnp

    from vae_captioning.ops import logits_topk as lt

    rng = np.random.default_rng(0)
    H, V = 512, 11500
    w = jnp.asarray(rng.normal(0, H ** -0.5, (H, V)), jnp.float32)
    b = jnp.asarray(rng.normal(0, 0.1, (V,)), jnp.float32)
    for rows in (4096, 12288, 98304):
        h = jnp.asarray(rng.normal(size=(rows, H)), jnp.float32)
        for k in (1, 3, 10):
            xla = jax.jit(lambda h, w, b, k=k: lt.logits_top_k_xla(h, w, b, k))
            timed(xla, h, w, b)
            t_x = np.median([timed(xla, h, w, b) for _ in range(5)])
            row = [f"rows={rows} k={k}: xla {t_x * 1e3:.3f} ms"]
            for blocks in BLOCKS:
                fn = jax.jit(lambda h, w, b, k=k, bl=blocks:
                             lt.logits_top_k_pallas(h, w, b, k, blocks=bl))
                try:
                    timed(fn, h, w, b)
                except Exception as e:  # a config the compiler refuses
                    row.append(f"{blocks} failed ({type(e).__name__})")
                    continue
                t = np.median([timed(fn, h, w, b) for _ in range(5)])
                row.append(f"{blocks} {t * 1e3:.3f} ms")
            print(" | ".join(row), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batches", type=int, nargs="+", default=[4096, 32768])
    p.add_argument("--modes", nargs="+", default=list(MODES))
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--blocks", action="store_true")
    args = p.parse_args(argv)

    from vae_captioning.utils import device
    from vae_captioning.utils.compile_cache import enable_compile_cache

    dev = device.require_gpu()
    print(f"device {dev}; {device.nvidia_smi()}", flush=True)
    enable_compile_cache()

    import jax

    from vae_captioning.config import Config
    from vae_captioning.data.synthetic import PeakedBatcher
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_decode_fns
    from vae_captioning.train import init_model

    if args.blocks:
        sweep_blocks()
    V = 11500
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(V - 4)])
    for mode in args.modes:
        fn_name, beam = MODES[mode]
        cfg = Config(prior="AG", use_c_v=True, beam_size=beam)
        cfg.vocab_size = V
        model, params = init_model(cfg, jax.random.PRNGKey(0))
        fns = {use: make_decode_fns(model, cfg, vocab, kernel=use)[fn_name]
               for use in (False, True)}
        for B in args.batches:
            batch = next(PeakedBatcher(V, vocab.bos_id, vocab.eos_id, B,
                                       seed=5).eval_batches())
            a = (params, jax.numpy.asarray(batch.features),
                 jax.numpy.asarray(batch.cluster_vectors),
                 jax.random.PRNGKey(0))
            setup = {use: timed(fns[use], *a) for use in (False, True)}
            times = {False: [], True: []}
            for _ in range(args.reps):
                for use in (False, True, True, False):
                    times[use].append(timed(fns[use], *a))
            out = {use: jax.tree.map(np.asarray, fns[use](*a))
                   for use in (False, True)}
            toks = [o[0] if isinstance(o, (tuple, list)) else o
                    for o in (out[False], out[True])]
            same = float(np.mean(np.all(toks[0] == toks[1], axis=1)))
            tx, tk = np.median(times[False]), np.median(times[True])
            print(f"{mode} batch {B}: xla {tx * 1e3:.2f} ms, kernel "
                  f"{tk * 1e3:.2f} ms (kernel/xla {tk / tx:.3f}); "
                  f"{B / tx:.0f} vs {B / tk:.0f} captions/s; identical "
                  f"{same:.4f}; runs xla {np.round(np.array(times[False]) * 1e3, 2).tolist()} "
                  f"kernel {np.round(np.array(times[True]) * 1e3, 2).tolist()}; "
                  f"first call xla {setup[False]:.1f} s kernel "
                  f"{setup[True]:.1f} s", flush=True)


if __name__ == "__main__":
    main()
