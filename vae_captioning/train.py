"""Training: optimizers, train state, jitted data-parallel step, epoch loop.

Replaces ``main.py:19-290`` + ``ops/optimizers.py``.  Semantics kept:

  * Two optimizer groups (``ops/optimizers.py``): the non-CNN group
    (encoder/decoder/imf_emb/cv_emb) with global-norm clip 5.0, and — in
    fine-tune mode — the CNN group at ``cnn_lr`` with L2 weight decay
    (``main.py:69-78``); implemented as one ``optax.multi_transform``
    over param labels instead of two tf optimizers on variable
    collections.
  * Per-optimizer: SGD/Momentum use the ×0.5-every-N-epochs staircase
    decay; Adam uses a constant lr with β1 = 0.8
    (``ops/optimizers.py:27-46``).
  * tanh KL annealing driven by the global step (``main.py:162-170``),
    forced to 1.0 on fine-tune/restore.
  * epoch structure: ``num_ex_per_epoch`` examples per epoch, loss print
    every 500 steps, per-epoch validation rec-loss + checkpoint
    (``main.py:213-290``).

One jitted step over a ``dp`` mesh — params replicated, batch sharded,
gradient all-reduce inserted by the SPMD partitioner.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from vae_captioning.config import Config
from vae_captioning.data.batcher import Batch
from vae_captioning.models.cvae import CVAEModel, compute_loss
from vae_captioning.ops import distributions as dist
from vae_captioning.parallel import mesh as mesh_lib


# ----------------------------------------------------------------------
# optimizers (ref ops/optimizers.py)
# ----------------------------------------------------------------------

def _lr_schedule(cfg: Config, base_lr: float, kind: str):
    """×0.5 staircase decay for SGD/Momentum; constant for Adam
    (ref ops/optimizers.py:24-46 — Adam ignores the decay)."""
    if kind == "Adam":
        return base_lr
    num_batches_per_epoch = cfg.num_ex_per_epoch / (cfg.batch_size + 0.001)
    decay_steps = max(int(num_batches_per_epoch * cfg.num_epochs_per_decay), 1)
    return optax.exponential_decay(base_lr, transition_steps=decay_steps,
                                   decay_rate=0.5, staircase=True)


def _base_optimizer(kind: str, lr) -> optax.GradientTransformation:
    if kind == "SGD":
        return optax.sgd(lr)
    if kind == "Adam":
        return optax.adam(lr, b1=0.8)       # β1=0.8, ref :39
    if kind == "Momentum":
        return optax.sgd(lr, momentum=0.9)  # ref :42
    raise ValueError(f"unknown optimizer {kind!r}")


def _main_tx(cfg: Config) -> optax.GradientTransformation:
    return optax.chain(
        optax.clip_by_global_norm(cfg.lstm_clip_by_norm),
        _base_optimizer(cfg.optimizer,
                        _lr_schedule(cfg, cfg.learning_rate, cfg.optimizer)),
    )


def _cnn_tx(cfg: Config) -> optax.GradientTransformation:
    return optax.chain(
        optax.add_decayed_weights(cfg.weight_decay),  # ≙ tf l2_regularizer grad
        _base_optimizer(cfg.cnn_optimizer,
                        _lr_schedule(cfg, cfg.cnn_lr, cfg.cnn_optimizer)),
    )


def make_optimizer(cfg: Config) -> optax.GradientTransformation:
    """The non-CNN optimizer chain (ref non_cnn_optimizer).

    With ``cfg.optax_flatten`` the whole chain runs on one raveled
    vector (``optax.flatten``): clip_by_global_norm's norm is the same
    global norm and Adam is elementwise, so updates are bit-comparable
    to the per-leaf path while XLA sees a handful of length-N vector
    ops instead of ~#leaves small kernels.  All params are f32 masters
    so the concatenation does not promote dtypes.
    """
    tx = _main_tx(cfg)
    if getattr(cfg, "optax_flatten", False):
        tx = optax.flatten(tx)
    return tx


def make_finetune_optimizer(cfg: Config) -> optax.GradientTransformation:
    """Fine-tune routing (ref ops/optimizers.py cnn_optimizer +
    image_embeddings trainable_fe/trainable_top): VGG conv layers and fc
    layers each get the CNN chain or are frozen, everything else gets the
    main chain."""
    frozen = optax.set_to_zero()

    def label(path, _):
        if path[0].key != "vgg16":
            return "main"
        return "cnn_top" if str(path[1].key).startswith("fc") else "cnn_fe"

    def label_fn(params):
        return jax.tree_util.tree_map_with_path(label, params)

    return optax.multi_transform(
        {
            "main": _main_tx(cfg),
            "cnn_fe": _cnn_tx(cfg) if cfg.fine_tune_fe else frozen,
            "cnn_top": _cnn_tx(cfg) if cfg.fine_tune_top else frozen,
        },
        label_fn,
    )


# ----------------------------------------------------------------------
# train state
# ----------------------------------------------------------------------

class TrainState(NamedTuple):
    step: jax.Array
    params: Any
    opt_state: Any

    def replace(self, **kw) -> "TrainState":
        return self._replace(**kw)

    @classmethod
    def create(cls, params, tx) -> "TrainState":
        return cls(step=jnp.asarray(0, jnp.int32), params=params,
                   opt_state=tx.init(params))


def build_model(cfg: Config):
    """The right module for the config: feature-fed CVAE, or the combined
    VGG16+CVAE fine-tune model."""
    if cfg.fine_tune:
        from vae_captioning.models.finetune import FineTuneModel
        return FineTuneModel.from_config(cfg)
    return CVAEModel.from_config(cfg)


def init_model(cfg: Config, rng: jax.Array,
               model: Optional[Any] = None) -> Tuple[Any, Any]:
    """Initialize params with dummy shapes; in fine-tune mode also loads
    the ImageNet npz into the vgg16 subtree when the file exists."""
    model = model or build_model(cfg)
    if cfg.fine_tune:
        s = cfg.image_size
        params = model.init(rng, jnp.zeros((1, s, s, 3)))["params"]
        if os.path.exists(cfg.image_net_weights_path):
            from vae_captioning.models.finetune import load_vgg_into_params
            params = load_vgg_into_params(params, cfg.image_net_weights_path)
        return model, params
    return model, model.init(
        rng, jnp.zeros((1, cfg.cnn_feature_size)))["params"]


# ----------------------------------------------------------------------
# jitted step
# ----------------------------------------------------------------------

def _flatten_batch(batch: Batch):
    """[B, K, T] host batch → flat device arrays."""
    B, K, T = batch.dec_inputs.shape
    return (batch.features,
            batch.labels.reshape(B * K, T),      # encoder input = labels
            batch.dec_inputs.reshape(B * K, T),
            batch.lengths.reshape(B * K),
            batch.cluster_vectors)


def make_loss_fn(model: CVAEModel, cfg: Config):
    """The training objective: ``(params, step, features, enc, dec,
    lengths, c_v, rng) → (loss, losses dict)``, with the step's latent,
    cluster and dropout draws and KL annealing derived from ``step``."""
    force_one = cfg.fine_tune or cfg.restore
    cluster_means = jnp.asarray(dist.init_cluster_means(
        cfg.num_clusters, cfg.latent_size, cfg.seed))
    needs_cv = cfg.needs_cluster_vectors

    def loss_fn(params, step, features, enc, dec, lengths, c_v, rng):
        step_rng = jax.random.fold_in(rng, step)
        rngs = {"z": jax.random.fold_in(step_rng, 0),
                "sample": jax.random.fold_in(step_rng, 1),
                "dropout": jax.random.fold_in(step_rng, 2)}
        annealing = dist.kl_annealing(step, cfg.ann_param, force_one)
        # time-major: logits come out [T, B·K, V] (the LSTM scan's
        # native layout) and the s32 labels are transposed to match,
        # which keeps activation relayouts out of the step
        out = model.apply({"params": params}, features, enc, dec,
                          lengths, c_v if needs_cv else None,
                          deterministic=False, rngs=rngs, time_major=True)
        losses = compute_loss(
            out, enc.T, prior=cfg.prior, no_encoder=cfg.no_encoder,
            cluster_means=cluster_means, annealing=annealing,
            gmm_true_kl=cfg.gmm_true_kl, ag_kl_sum=cfg.ag_kl_sum,
            time_major=True)
        return losses["loss"], losses

    return loss_fn


def make_train_step(model: CVAEModel, tx: optax.GradientTransformation,
                    cfg: Config, donate: bool = True):
    """Build the jitted train step.  Called once per caption-length
    bucket shape; XLA caches compilations per shape."""
    loss_fn = make_loss_fn(model, cfg)

    def step_fn(state: TrainState, features, enc, dec, lengths, c_v, rng):
        grads, metrics = jax.grad(loss_fn, has_aux=True)(
            state.params, state.step, features, enc, dec, lengths, c_v, rng)
        metrics["grad_norm"] = optax.global_norm(grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = state.replace(step=state.step + 1, params=params,
                                  opt_state=opt_state)
        return new_state, metrics

    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())


def make_eval_step(model: CVAEModel, cfg: Config):
    """Validation rec-loss (ref main.py:262-284 computes rec only)."""
    cluster_means = jnp.asarray(dist.init_cluster_means(
        cfg.num_clusters, cfg.latent_size, cfg.seed))
    needs_cv = cfg.needs_cluster_vectors

    def eval_fn(params, features, enc, dec, lengths, c_v, rng):
        rngs = {"z": rng, "sample": jax.random.fold_in(rng, 1)}
        out = model.apply({"params": params}, features, enc, dec, lengths,
                          c_v if needs_cv else None,
                          deterministic=True, rngs=rngs, time_major=True)
        losses = compute_loss(out, enc.T, prior=cfg.prior,
                              no_encoder=cfg.no_encoder,
                              cluster_means=cluster_means, annealing=1.0,
                              gmm_true_kl=cfg.gmm_true_kl,
                              ag_kl_sum=cfg.ag_kl_sum, time_major=True)
        return losses["rec_loss"]

    return jax.jit(eval_fn)


# ----------------------------------------------------------------------
# driver loop
# ----------------------------------------------------------------------

class Trainer:
    def __init__(self, cfg: Config, vocab_size: Optional[int] = None,
                 mesh=None):
        if vocab_size is not None:
            cfg.vocab_size = vocab_size
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else mesh_lib.create_mesh(
            axis_name=cfg.mesh_axis)
        self.model, params = init_model(cfg, jax.random.PRNGKey(cfg.seed))
        self.tx = (make_finetune_optimizer(cfg) if cfg.fine_tune
                   else make_optimizer(cfg))
        # the whole state (step and optimizer moments too) replicated on
        # the mesh, as the jitted step returns it: otherwise the second
        # step sees other input shardings and compiles again
        self.state = mesh_lib.replicate(TrainState.create(params, self.tx),
                                        self.mesh)
        self.train_step = make_train_step(self.model, self.tx, cfg)
        self.eval_step = make_eval_step(self.model, cfg)
        self._rng = jax.random.PRNGKey(cfg.seed + 1)
        # host-side mirror of state.step: reading the device scalar every
        # iteration would force a sync and serialize the async pipeline
        self.host_step = 0

    # --------------------------------------------------------------
    def restore_from(self, checkpointer) -> None:
        """Restore the train state and re-replicate it onto the mesh
        (checkpoint sharding metadata may not match this run's mesh)."""
        restored = checkpointer.restore(self.state)
        self.state = mesh_lib.replicate(restored, self.mesh)
        self.host_step = int(restored.step)

    # --------------------------------------------------------------
    def _device_batch(self, batch: Batch):
        """Shard a host batch: pad the image dim B to a mesh multiple and
        (multi-host) slice this process's rows — all via the pure
        ``mesh_lib.prepare_process_batch`` (unit-tested for row/caption
        alignment across fake process grids)."""
        arrays = _flatten_batch(batch)
        B = arrays[0].shape[0]
        K = arrays[1].shape[0] // B
        arrays = mesh_lib.prepare_process_batch(
            arrays, K, n_devices=len(self.mesh.devices.ravel()),
            P=jax.process_count(), pid=jax.process_index())
        return mesh_lib.shard_batch(arrays, self.mesh, self.cfg.mesh_axis)

    def run_step(self, batch: Batch) -> Dict[str, float]:
        return self.run_step_arrays(self._device_batch(batch))

    def run_step_arrays(self, arrays) -> Dict[str, float]:
        """One step on already-device-put sharded arrays (the fit loop
        moves ``_device_batch`` onto the prefetch thread so the host→
        device transfer of batch t+1 overlaps step t's compute — at
        fine-tune shapes the raw-image upload otherwise serializes with
        the step, benchmarks/bench_finetune_io.py)."""
        features, enc, dec, lengths, c_v = arrays
        self.state, metrics = self.train_step(
            self.state, features, enc, dec, lengths, c_v, self._rng)
        self.host_step += 1
        return metrics

    def validate(self, batcher) -> float:
        # dispatch every batch first (async), fetch scalars after — no
        # per-batch device sync serializing the sweep; batch assembly +
        # device_put ride the prefetch thread like the fit loop
        stream = (self._device_batch(b) for b in batcher.eval_batches(
            num_captions=self.cfg.num_captions, with_ids=False))
        if self.cfg.prefetch_batches > 0:
            from vae_captioning.utils.prefetch import Prefetcher
            stream = Prefetcher(stream, self.cfg.prefetch_batches)
        vals = []
        try:
            for features, enc, dec, lengths, c_v in stream:
                vals.append(self.eval_step(self.state.params, features, enc,
                                           dec, lengths, c_v, self._rng))
        finally:
            # stop the producer thread even if eval_step raises mid-sweep;
            # otherwise its queued device arrays pin HBM until process exit
            if hasattr(stream, "close"):
                stream.close()
        return float(np.mean([float(v) for v in vals])) if vals \
            else float("nan")

    # --------------------------------------------------------------
    def fit(self, train_batcher, val_batcher=None, checkpointer=None,
            log_every: int = 500, quality_hook=None) -> Dict[str, float]:
        """``quality_hook``: optional ``(params, val_batcher, rng) ->
        {metric: float}`` (see ``inference.make_quality_hook``), called
        after each epoch's validation and merged into the metric log."""
        cfg = self.cfg
        metrics: Dict[str, float] = {}
        logger = None
        if cfg.logging:  # structured JSONL metrics (SURVEY §5 rebuild)
            from vae_captioning.utils.logging import MetricLogger
            logger = MetricLogger(cfg.log_dir, echo=False,
                                  run_name=cfg.checkpoint)
        profiling = False
        for epoch in range(cfg.num_epochs):
            seen = 0
            t0 = time.time()
            while seen <= cfg.num_ex_per_epoch:
                epoch_batches = 0
                batches = train_batcher.train_batches(cfg.num_captions)
                # device transfers ride the prefetch thread too: batch
                # t+1 is assembled AND device_put while step t runs
                stream = ((self._device_batch(b), b.batch_size)
                          for b in batches)
                if cfg.prefetch_batches > 0:
                    from vae_captioning.utils.prefetch import Prefetcher
                    stream = Prefetcher(stream, cfg.prefetch_batches)
                try:
                    for arrays, bsize in stream:
                        epoch_batches += 1
                        m = self.run_step_arrays(arrays)
                        seen += bsize
                        step = self.host_step
                        if cfg.profile:  # steps 10-20 → Perfetto trace
                            if step == 10 and not profiling:
                                jax.profiler.start_trace(cfg.log_dir)
                                profiling = True
                            elif step == 20 and profiling:
                                jax.profiler.stop_trace()
                                profiling = False
                                print(f"profiler trace written to {cfg.log_dir}")
                                try:  # in-repo op-cost summary (utils/xplane)
                                    from vae_captioning.utils import xplane
                                    agg = xplane.aggregate(cfg.log_dir)
                                    rep = xplane.format_report(
                                        agg, top=10, plane_filter="device:")
                                    # CPU-only traces have no device plane
                                    print(rep or xplane.format_report(agg, 10))
                                except Exception as e:  # summary is best-effort
                                    print(f"(xplane summary unavailable: {e})")
                        if step % log_every == 0:
                            metrics = {k: float(np.mean(v)) for k, v in m.items()}
                            rate = seen / max(time.time() - t0, 1e-9)
                            print(f"Epoch: {epoch} Iteration: {step} "
                                  f"VLB: {metrics['loss']:.4f} "
                                  f"Rec Loss: {metrics['rec_loss']:.4f} "
                                  f"KLD: {metrics['kld']:.4f} "
                                  f"Annealing: {metrics['annealing']:.3f} "
                                  f"({rate:.1f} ex/s)")
                            if logger is not None:
                                logger.log(step, metrics, epoch=epoch,
                                           examples_per_sec=round(rate, 1))
                        if (checkpointer is not None
                                and cfg.ckpt_every_steps > 0
                                and step % cfg.ckpt_every_steps == 0):
                            # async mid-epoch save keyed by the host step —
                            # no device sync, the write drains in background
                            checkpointer.save(self.state, step=step)
                        if seen > cfg.num_ex_per_epoch:
                            break
                finally:
                    # stop the producer thread even on a mid-epoch
                    # exception — queued device arrays pin HBM otherwise
                    if hasattr(stream, "close"):
                        stream.close()
                if epoch_batches == 0:
                    raise ValueError(
                        "train_batches yielded nothing — dataset smaller "
                        f"than batch_size ({cfg.batch_size})? Lower --bs.")
            epoch_extra: Dict[str, float] = {}
            if val_batcher is not None:
                val_rec = self.validate(val_batcher)
                print(f"Validation reconstruction loss: {val_rec}")
                metrics["val_rec_loss"] = val_rec
                epoch_extra["val_rec_loss"] = val_rec
                if quality_hook is not None:
                    qm = quality_hook(self.state.params, val_batcher,
                                      jax.random.fold_in(self._rng, epoch))
                    print("Validation metrics: " + " ".join(
                        f"{k}: {v}" for k, v in qm.items()))
                    metrics.update(qm)
                    epoch_extra.update(qm)
            if logger is not None:  # epoch-end record (short runs never
                # reach the per-500-step cadence)
                logger.log(self.host_step,
                           {k: float(np.mean(v)) for k, v in m.items()},
                           epoch=epoch, **epoch_extra)
            if checkpointer is not None:
                checkpointer.save(self.state)
        if logger is not None:
            logger.close()
        return {k: float(np.mean(v)) for k, v in
                (metrics or {"loss": np.nan}).items()}
