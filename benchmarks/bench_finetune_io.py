"""End-to-end fine-tune pipeline benchmark: disk → native loader →
host batch assembly → device step, all overlapped.

SURVEY §3.1's two hot loops are the offline feature extraction (#0) and
the train step fed by a synchronous Python pipeline (#1).  The rebuild's
claim is that the async stack (C++ mmap/thread-pool RawImageStore with
page prefetch + the Prefetcher thread + pipelined dispatch) makes the
fine-tune step cost ≈ max(compute, IO), not compute + IO.  This harness
measures that end-to-end on a synthetic 224² image pack:

  1. writes N random JPEGs, packs them with pack_images_to_raw,
  2. builds the production Batcher (image_store = RawImageStore,
     K captions/image, cluster vectors) and a fine-tune Trainer,
  3. times the steady-state wall per step over the real fit loop
     machinery (Prefetcher + run_step, metrics fetched once at the end).

Runs on the GPU and refuses to run without one (the loader-only mode
needs no device):

    python benchmarks/bench_finetune_io.py [--images 1024] [--steps 40]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from vae_captioning.utils.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()


def build_dataset(root: str, n_images: int, k: int, vocab: int, t_len: int,
                  threads: int = 8):
    import cv2

    from vae_captioning.data.native_loader import (RawImageStore,
                                                       pack_images_to_raw)

    img_dir = os.path.join(root, "imgs")
    out_bin = os.path.join(root, "pack.bin")
    rng = np.random.default_rng(0)
    names = [f"img_{i:06d}.jpg" for i in range(n_images)]
    # pack is content-addressed by (root, n_images): reuse across runs —
    # a 50k pack (7.5 GB) takes minutes to JPEG-encode
    if not (os.path.exists(out_bin)
            and os.path.exists(os.path.join(img_dir, names[-1]))):
        os.makedirs(img_dir, exist_ok=True)
        t0 = time.perf_counter()
        for i, fn in enumerate(names):
            path = os.path.join(img_dir, fn)
            if not os.path.exists(path):
                cv2.imwrite(path,
                            rng.integers(0, 255, (224, 224, 3), np.uint8))
        print(f"jpegs written in {time.perf_counter() - t0:.0f}s",
              file=sys.stderr)
        pack_images_to_raw([img_dir], out_bin)
    store = RawImageStore(out_bin, num_threads=threads)

    captions = {}
    cluster_vectors = {}
    for fn in names:
        caps = []
        for _ in range(k):
            L = int(rng.integers(6, t_len - 2))
            caps.append([1] + rng.integers(3, vocab, L).tolist() + [2])
        captions[fn] = caps
        cv = rng.random(91).astype(np.float32)  # 91-dim; batcher drops idx 0
        cluster_vectors[fn] = cv / cv.sum()
    return names, captions, cluster_vectors, store


def drop_page_cache() -> bool:
    """Evict the OS page cache (root only) so the next pass measures
    DISK, not RAM.  Returns False when the environment forbids it."""
    try:
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except OSError:
        return False


def loader_sweep(store, names, bs: int, tag: str) -> dict:
    """One shuffled epoch through the native loader with the production
    prefetch pattern (next batch's pages prefetched while the current
    one is copied) — the IO half of the fine-tune hot loop."""
    rng = np.random.default_rng(1)
    order = rng.permutation(len(names))
    files = [names[i] for i in order]
    n = len(files) - len(files) % bs
    t0 = time.perf_counter()
    for start in range(0, n, bs):
        nxt = files[start + bs:start + 2 * bs]
        if nxt:
            store.prefetch(nxt)
        batch = store.get_batch(files[start:start + bs])
    dt = time.perf_counter() - t0
    img_bytes = int(np.prod(batch.shape[1:])) * batch.dtype.itemsize
    res = {
        "component": f"native_loader_sweep_{tag}",
        "images": n,
        "batch": bs,
        "images_per_sec": round(n / dt, 1),
        "gbytes_per_sec": round(n * img_bytes / dt / 1e9, 3),
        "ms_per_batch": round(dt / (n // bs) * 1000, 3),
    }
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=1024)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--root", default=None,
                   help="pack directory (kept; reused when it exists)")
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--loader_only", action="store_true",
                   help="measure the native loader's GB/s alone (no JAX, "
                        "no device): cold page cache when droppable, then "
                        "warm — VERDICT r3 #7's IO half")
    args = p.parse_args(argv)

    if args.loader_only:
        root = args.root or tempfile.mkdtemp(prefix="ft_io_")
        os.makedirs(root, exist_ok=True)
        t0 = time.perf_counter()
        names, _, _, store = build_dataset(root, args.images, 1, 64, 24,
                                           threads=args.threads)
        print(f"pack ready in {time.perf_counter() - t0:.1f}s "
              f"({args.images} images, "
              f"{args.images * 224 * 224 * 3 / 1e9:.2f} GB)",
              file=sys.stderr)
        if drop_page_cache():
            loader_sweep(store, names, args.bs, "cold")
        else:
            print("page cache not droppable; skipping cold pass",
                  file=sys.stderr)
        loader_sweep(store, names, args.bs, "warm")
        store.close()
        return

    import jax

    from vae_captioning.utils import device
    print(f"device {device.require_gpu()}; {device.nvidia_smi()}",
          file=sys.stderr)

    from vae_captioning.config import Config
    from vae_captioning.data.batcher import CaptionBatcher
    from vae_captioning.train import Trainer
    from vae_captioning.utils.prefetch import Prefetcher

    VOCAB, K = 11500, 5
    cfg = Config(prior="AG", use_c_v=True, fine_tune=True,
                 fine_tune_fe=True, fine_tune_top=True,
                 batch_size=args.bs, num_captions=K,
                 image_net_weights_path="/nonexistent")
    cfg.vocab_size = VOCAB

    root = tempfile.mkdtemp(prefix="ft_io_")
    t0 = time.perf_counter()
    names, captions, cvs, store = build_dataset(root, args.images, K,
                                                VOCAB, 24)
    print(f"dataset built in {time.perf_counter() - t0:.1f}s "
          f"({args.images} images)", file=sys.stderr)

    batcher = CaptionBatcher(names, captions, args.bs, image_store=store,
                      cluster_vectors=cvs)
    trainer = Trainer(cfg)

    def step_stream():
        # mirror Trainer.fit: batch assembly AND device_put ride the
        # prefetch thread, overlapping the transfer with device compute
        def device_batches():
            while True:
                for b in batcher.train_batches(K):
                    yield trainer._device_batch(b)
        return Prefetcher(device_batches(), cfg.prefetch_batches)

    stream = step_stream()
    # warmup: compile + fill the pipeline
    for _ in range(6):
        trainer.run_step_arrays(next(stream))
    jax.block_until_ready(trainer.state)

    t0 = time.perf_counter()
    for _ in range(args.steps):
        trainer.run_step_arrays(next(stream))
    jax.block_until_ready(trainer.state)  # one sync at the end
    dt = (time.perf_counter() - t0) / args.steps
    store.close()
    print(json.dumps({
        "component": "finetune_e2e_step",
        "ms_per_step": round(dt * 1000, 2),
        "images_per_sec": round(args.bs / dt, 1),
        "batch": args.bs,
        "note": "disk->native loader->host batch->device, pipelined",
    }))


if __name__ == "__main__":
    main()
