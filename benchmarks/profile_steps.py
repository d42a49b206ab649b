"""Profiler traces of the flagship train step and beam-3 decode on the GPU.

Traces, each in a run of its own after warm-up:

* ``train``        — 3 steps of ``Trainer.run_step`` at full width,
                     B 256, K 5, T 24 (AG prior with cluster vectors);
* ``beam3_<B>``    — one ``make_decode_fns(...)["beam_search"]`` call at
                     batch B (4,096 and 32,768 by default), 30 steps.

Each trace is written under ``<out>/<name>/`` and reduced with
``vae_captioning.utils.xplane``: device busy share of the traced
window, the top device ops, and the device time under each named scope
the model code sets (encoder, q_heads, z_sample, decoder, ce_loss,
lstm_step, logits_topk).  XLA runs steps as CUDA graphs (command
buffers), and library GEMMs inside a graph carry no op path; for the
per-scope split trace with ``XLA_FLAGS=--xla_gpu_enable_command_buffer=``
and take busy and idle shares from a run with the default flags.

  python benchmarks/profile_steps.py [--out traces]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# named scopes the model code sets, plus "while": the bodies of the
# LSTM scans (train) and of the decode loop
SCOPES = ("encoder", "q_heads", "z_sample", "decoder", "ce_loss",
          "lstm_step", "logits_topk", "while")


def dump_structure(trace_dir: str, out: str) -> None:
    """Planes, lines and a few events with their stats, for reading a
    trace by hand."""
    from vae_captioning.utils import xplane

    with open(out, "w") as f:
        for plane in xplane.load_trace(trace_dir).planes:
            lines = list(plane.lines)
            f.write(f"PLANE {plane.name} ({len(lines)} lines)\n")
            for line in lines[:12]:
                evs = list(line.events)
                f.write(f"  LINE {line.name!r} ({len(evs)} events)\n")
                for ev in evs[:4]:
                    f.write(f"    {ev.name[:100]!r} {ev.duration_ns:.0f} ns "
                            f"{dict(ev.stats)}\n")


def report(name: str, trace_dir: str, top: int, hlo_text: str) -> None:
    from vae_captioning.utils import xplane

    path = xplane.resolve_trace_path(trace_dir)
    busy, window = xplane.device_busy(path)
    print(f"== {name}: device busy {busy / 1e6:.3f} ms of a "
          f"{window / 1e6:.3f} ms window (idle share "
          f"{1 - busy / max(window, 1):.4f})", flush=True)
    names = xplane.hlo_op_names(hlo_text)
    for scope, ns in xplane.scope_times(path, SCOPES, names).items():
        print(f"   scope {scope:14s} {ns / 1e6:10.3f} ms "
              f"({ns / max(busy, 1):.4f} of busy)", flush=True)
    print(xplane.format_report(xplane.aggregate(path, device_only=True),
                               top=top), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="traces")
    p.add_argument("--batches", type=int, nargs="+", default=[4096, 32768])
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)

    from vae_captioning.utils import device
    from vae_captioning.utils.compile_cache import enable_compile_cache

    dev = device.require_gpu()
    print(f"device {dev}; {device.nvidia_smi()}; XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    enable_compile_cache()

    import jax

    from vae_captioning.config import Config
    from vae_captioning.data.synthetic import PeakedBatcher
    from vae_captioning.data.vocabulary import Vocabulary
    from vae_captioning.inference import make_decode_fns
    from vae_captioning.train import Trainer

    V = 11500
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(V - 4)])
    cfg = Config(prior="AG", use_c_v=True, batch_size=256, num_captions=5,
                 beam_size=3)
    trainer = Trainer(cfg, vocab_size=V)
    pool = PeakedBatcher(V, vocab.bos_id, vocab.eos_id, 256, num_batches=6,
                         max_len=24)
    batches = list(pool.train_batches(5))
    for b in batches[:3]:
        jax.block_until_ready(trainer.run_step(b))
    d = os.path.join(args.out, "train")
    with jax.profiler.trace(d):
        for i, b in enumerate(batches[3:]):
            with jax.profiler.StepTraceAnnotation("train", step_num=i):
                m = trainer.run_step(b)
        jax.block_until_ready(m)
    dump_structure(d, os.path.join(args.out, "train_structure.txt"))
    arrays = trainer._device_batch(batches[0])
    hlo = trainer.train_step.lower(trainer.state, *arrays,
                                   trainer._rng).compile().as_text()
    with open(os.path.join(args.out, "train.hlo.txt"), "w") as f:
        f.write(hlo)
    report("train B=256 K=5 T=24 (3 steps)", d, args.top, hlo)

    params = trainer.state.params
    beam = make_decode_fns(trainer.model, cfg, vocab)["beam_search"]
    for B in args.batches:
        dpool = PeakedBatcher(V, vocab.bos_id, vocab.eos_id, B, seed=5)
        batch = next(dpool.eval_batches())
        feats = jax.numpy.asarray(batch.features)
        cv = jax.numpy.asarray(batch.cluster_vectors)
        key = jax.random.PRNGKey(0)
        t0 = time.perf_counter()
        jax.block_until_ready(beam(params, feats, cv, key))
        print(f"beam3 batch {B}: first call {time.perf_counter() - t0:.1f} s",
              flush=True)
        d = os.path.join(args.out, f"beam3_{B}")
        with jax.profiler.trace(d):
            jax.block_until_ready(beam(params, feats, cv, key))
        hlo = beam.lower(params, feats, cv, key).compile().as_text()
        with open(os.path.join(args.out, f"beam3_{B}.hlo.txt"), "w") as f:
            f.write(hlo)
        report(f"beam3 decode batch {B} (one call)", d, args.top, hlo)


if __name__ == "__main__":
    main()
