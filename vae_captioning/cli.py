"""Main CLI — train / inference driver (``python -m vae_captioning.cli``).

Replaces ``main.py:19-315`` with the same flag surface (see config.py):

  training:   build Data → Trainer → epoch loop with per-epoch validation
              + checkpoints + config/vocab sidecars
  inference:  restore checkpoint → val beam/greedy JSON + test greedy JSON
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from vae_captioning.checkpoint import Checkpointer, load_sidecars, save_sidecars
from vae_captioning.config import Config, parse_args
from vae_captioning.data.dataset import Data
from vae_captioning.inference import run_inference
from vae_captioning.train import Trainer


def run_training(cfg: Config, data: Optional[Data] = None) -> Trainer:
    data = data or Data(cfg, extract_features=not cfg.fine_tune)
    train_batcher = data.train_batcher()
    val_batcher = data.val_batcher()

    trainer = Trainer(cfg, vocab_size=data.vocab.vocab_size)
    ckpt = Checkpointer(cfg.checkpoint_dir, cfg.checkpoint,
                        cfg.max_checkpoints_to_keep)
    save_sidecars(cfg, data.vocab, cfg.checkpoint_dir, cfg.checkpoint)
    if cfg.restore and ckpt.latest_step() is not None:
        print(f"Restoring from checkpoint step {ckpt.latest_step()}")
        trainer.restore_from(ckpt)

    quality_hook = None
    if cfg.eval_metrics:
        from vae_captioning.inference import make_quality_hook
        quality_hook = make_quality_hook(cfg, data.vocab,
                                         data.val_references())

    trainer.fit(train_batcher, val_batcher, checkpointer=ckpt,
                quality_hook=quality_hook)
    ckpt.close()
    return trainer


def run_inference_mode(cfg: Config, data: Optional[Data] = None):
    # reload the training-time config for model shape, keep decode flags
    try:
        saved_cfg, vocab = load_sidecars(cfg.checkpoint_dir, cfg.checkpoint)
        model_cfg = saved_cfg.replace(
            mode="inference", sample_gen=cfg.sample_gen,
            beam_size=cfg.beam_size, temperature=cfg.temperature,
            gen_batch_size=cfg.gen_batch_size,    # run-time preference
            gen_name=cfg.gen_name, coco_dir=cfg.coco_dir,
            hdf5_file=cfg.hdf5_file,            # keep coco_dir-derived
            raw_images_file=cfg.raw_images_file,  # paths consistent
            checkpoint=cfg.checkpoint, checkpoint_dir=cfg.checkpoint_dir,
            std=cfg.std)
    except FileNotFoundError:
        model_cfg, vocab = cfg, None

    data = data or Data(model_cfg, extract_features=not model_cfg.fine_tune)
    if vocab is None:
        vocab = data.vocab
    model_cfg.vocab_size = vocab.vocab_size

    from vae_captioning.train import (
        TrainState, init_model, make_finetune_optimizer, make_optimizer)
    _, params = init_model(model_cfg, jax.random.PRNGKey(model_cfg.seed))
    tx = (make_finetune_optimizer(model_cfg) if model_cfg.fine_tune
          else make_optimizer(model_cfg))
    state = TrainState.create(params, tx)
    ckpt = Checkpointer(model_cfg.checkpoint_dir, model_cfg.checkpoint,
                        model_cfg.max_checkpoints_to_keep)
    print("Restoring from checkpoint")
    state = ckpt.restore(state)
    ckpt.close()

    # decode throughput grows with batch; gen_batch_size lets batch
    # inference use a large one without touching the training batch size
    written = run_inference(model_cfg, state.params, vocab,
                            data.val_batcher(model_cfg.gen_batch_size),
                            data.test_batcher(model_cfg.gen_batch_size))
    return written


def main(argv=None) -> None:
    # VCT_PLATFORM=cpu forces the JAX backend (useful where a site hook
    # pins JAX_PLATFORMS, e.g. CI)
    platform = os.environ.get("VCT_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    # persistent executable cache (JAX_COMPILATION_CACHE_DIR when set)
    from vae_captioning.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    cfg = parse_args(argv)
    if cfg.multihost:
        from vae_captioning.parallel.mesh import initialize_multihost
        initialize_multihost()
    if cfg.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if cfg.save_params:
        path = os.path.join(cfg.checkpoint_dir, cfg.checkpoint, "config.json")
        print("Saving params to:", path)
        cfg.save(path)
    if cfg.mode == "training":
        run_training(cfg)
    else:
        run_inference_mode(cfg)


if __name__ == "__main__":
    main()
