"""The training driver: epochs, dev evaluation, checkpoints, early stop,
plateau learning-rate reduction, non-finite batch reporting (the
counterpart of `stt_tpu.train.trainer`, on one device).

- Before training, a dummy run over the longest samples fails fast on an
  out-of-memory batch.
- A step's metrics are fetched three steps late, so the host keeps
  queueing work for the card instead of waiting on each step.
- A step whose loss is not finite for some samples names them.
- `last` is saved every `checkpoint_secs` and after every epoch;
  `best_dev` whenever the dev loss improves.
- Early stop after `es_epochs` epochs without an improvement of
  `es_min_delta`; on a plateau of `plateau_epochs` the best checkpoint is
  reloaded and the learning rate (Adam's param_groups) shrinks by
  `plateau_reduction`.
- Scalars go to `summary_dir/scalars.jsonl`.
- Pre-flight: the alphabet resolves and `scorer_path`'s package loads.
- Input: `--augment` specs, featurized on `input_workers` threads with
  `prefetch_batches` batches assembled ahead, and the `--feature_cache`
  (dropped every `cache_for_epochs` epochs so that augmentations are drawn
  anew).
- `--profile_dir`: a torch.profiler trace (CPU, and CUDA on the card) of
  epoch 0's first `profile_steps` steps, as `trace.json` in that directory.
- `--graph_augs_on_device`: the host stops at the spectrogram, and the
  spectrogram and features augmentations and the MFCC run in one pass on
  the step's device (`data.device_augment`) before each step. With
  several processes it warns and keeps the host's augmentations, as
  stt_tpu does.
- Several processes (`--num_processes`, joined by
  `config.maybe_initialize_distributed`): data parallelism. Each rank
  featurizes its rows of every global batch (`row_range`), re-padded to the
  global batch's lengths, and the step all-reduces (`train.step`), so every
  rank holds the same parameters. Rank 0 writes the checkpoints, the
  best-dev bookkeeping, the logs, the scalars and the profile; dev losses
  are computed on the ranks' shares of the dev batches and merged.
- `--n_model_parallel K` (tensor parallelism): the --num_processes ranks
  form a (num_processes / K, K) mesh (`parallel.mesh`). The K model ranks
  of a data index feed the same rows and each holds a shard of the
  parameters and of Adam's moments; the step is `make_train_step_tp`.
  Checkpoints hold the full parameters and Adam state, gathered over the
  model ranks and written by rank 0, so one file loads at any K. Dev
  epochs run on the gathered model (the inference kernel K1), each rank
  on its share of the dev batches, so the merged dev loss is one
  process's.

The step runs on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from stt_tpu_torch.config import SttConfig, log_error, log_info, log_warn
from stt_tpu_torch.data.augmentations import parse_augmentations
from stt_tpu_torch.data.feeding import create_batches
from stt_tpu_torch.data.sources import samples_from_sources
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.parallel import distributed, make_mesh
from stt_tpu_torch.train.checkpoints import CheckpointManager, load_or_init_graph_for_training
from stt_tpu_torch.train.step import (
    Batch,
    TrainState,
    create_optimizer,
    create_train_state,
    gather_model,
    gather_train_state,
    make_eval_step,
    make_train_step,
    make_train_step_audio,
    make_train_step_tp,
    shard_train_state,
)

METRICS_LAG = 3  # steps between a step's dispatch and the fetch of its metrics


def set_learning_rate(state: TrainState, lr: float) -> None:
    for group in state.optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def create_optimizer_with_hyperparams(config: SttConfig, params) -> torch.optim.Adam:
    """Adam over `params` at the config's learning rate, betas and epsilon."""
    return create_optimizer(params, learning_rate=config.learning_rate, beta1=config.beta1,
                            beta2=config.beta2, epsilon=config.epsilon)


def make_summary_writer(summary_dir: str) -> Optional[Callable[[int, dict], None]]:
    """Scalar logger writing one JSON line per call to
    summary_dir/scalars.jsonl, or None without a directory."""
    if not summary_dir:
        return None
    os.makedirs(summary_dir, exist_ok=True)
    path = os.path.join(summary_dir, "scalars.jsonl")

    def write(step: int, scalars: dict) -> None:
        with open(path, "a") as f:
            f.write(json.dumps({"step": step, **scalars}) + "\n")

    return write


def early_training_checks(config: SttConfig) -> None:
    """Pre-flight validation (train.py:238-246): the alphabet resolves and
    the scorer package, if one is named, loads."""
    config.resolve_alphabet()
    if config.scorer_path:
        from stt_tpu_torch.decode.scorer_package import KenLMScorer

        KenLMScorer(config.scorer_path)  # raises on an invalid package


def start_profiler(device: torch.device) -> torch.profiler.profile:
    """A running torch.profiler session: the host's ops, and the card's
    kernels when training on the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler: torch.profiler.profile, device: torch.device, profile_dir: str) -> None:
    """Ends the session once the card has run what it queued, and writes its
    Chrome trace to profile_dir/trace.json."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    log_info(f"Wrote profiler trace to {path}")


def train(config: SttConfig, device="cuda") -> TrainState:
    # several processes: the config's command line joined the process group
    # (config.maybe_initialize_distributed); every rank runs this in lockstep
    proc_id, proc_count = distributed.process_index(), distributed.process_count()
    is_coordinator = proc_id == 0
    device = distributed.local_device(resolve_device(device))
    log = log_info if is_coordinator else (lambda *args: None)
    early_training_checks(config)
    alphabet = config.resolve_alphabet()
    model_config = config.model_config(training=True)
    feature_config = config.feature_config
    # the (data, model) mesh, and this rank's data index's rows of every
    # global batch (the batch must divide over the data axis)
    mesh = make_mesh(n_model=config.n_model_parallel)
    tensor_parallel = mesh.n_model > 1
    host_rows = mesh.rows(config.train_batch_size)
    state = create_train_state(
        model_config, seed=config.seed, device=device, learning_rate=config.learning_rate,
        beta1=config.beta1, beta2=config.beta2, epsilon=config.epsilon,
    )

    # every rank reads the checkpoints (resume, the plateau's reload); rank
    # 0 alone writes them
    manager: Optional[CheckpointManager] = None
    if config.save_checkpoint_dir:
        manager = CheckpointManager(config.save_checkpoint_dir, max_to_keep=config.max_to_keep)
        if is_coordinator:
            manager.save_run_files(config.to_dict(), alphabet.serialize_text())
    saver = manager if is_coordinator else None

    method = "init"
    if config.load_checkpoint_dir:
        state, method = load_or_init_graph_for_training(
            CheckpointManager(config.load_checkpoint_dir, config.max_to_keep), state,
            load_train=config.load_train, drop_source_layers=config.drop_source_layers,
        )
    log(f"Initialized model from '{method}'")
    if method != "init" and config.force_initialize_learning_rate:
        set_learning_rate(state, config.learning_rate)
        log(f"Re-initialized learning rate to {config.learning_rate} "
            "(--force_initialize_learning_rate)")

    if tensor_parallel:
        state = shard_train_state(state, mesh)
        # every layout, as stt_tpu's trainer (GSPMD over param_sharding):
        # a width that does not divide over the model ranks stays replicated
        train_step = make_train_step_tp(
            model_config, mesh, feature_config if config.device_featurize else None,
            replicate_uneven=True)
    elif config.device_featurize:
        train_step = make_train_step_audio(feature_config)
    else:
        train_step = make_train_step()
    eval_step = make_eval_step()
    step_seed = config.seed + 1

    train_samples = list(samples_from_sources(config.train_files, labeled=True))
    augmentations = parse_augmentations(config.augment)
    input_workers = config.input_workers
    if input_workers < 0:
        input_workers = min(8, os.cpu_count() or 1)
    feature_cache = None
    if config.feature_cache or config.cache_for_epochs:
        from stt_tpu_torch.data.feature_cache import FeatureCache

        feature_cache = FeatureCache(config.feature_cache, config.cache_for_epochs)
        if augmentations and config.cache_for_epochs == 0:
            log_warn(
                "Due to your feature-cache settings, augmentations of "
                "the first epoch will be repeated on all following "
                "epochs. This may lead to unintended over-fitting. You "
                "can use --cache_for_epochs <n_epochs> to invalidate "
                "the cache after a given number of epochs."
            )
    # a bf16 step casts its features at its first op: upload them in bf16
    feature_dtype = (torch.bfloat16 if model_config.dtype == torch.bfloat16
                     and not config.device_featurize else None)

    # on-device graph augmentations: the host stops at the spectrogram
    device_augment = None
    if config.graph_augs_on_device:
        if proc_count > 1:
            log_warn("--graph_augs_on_device runs in one process only; keeping the host's "
                     "graph augmentations")
        else:
            from stt_tpu_torch.data.device_augment import DeviceAugmentPipeline

            pipeline = DeviceAugmentPipeline(augmentations, feature_config)
            if pipeline.has_work():
                device_augment = pipeline

    def batches(epoch: int, reverse=False, limit=0):
        """(the batch on the step's device, sample ids)."""
        made = create_batches(
            train_samples, alphabet, feature_config, batch_size=config.train_batch_size,
            augmentations=augmentations, train_phase=True, epoch=epoch,
            total_epochs=config.epochs, reverse=reverse, limit=limit,
            # every global batch is whole, so that each rank's rows exist
            drop_remainder=proc_count > 1, shuffle_batches=config.shuffle_batches,
            row_range=host_rows if proc_count > 1 else None, num_workers=input_workers,
            prefetch=config.prefetch_batches, device_augment=device_augment,
            device_featurize=config.device_featurize, feature_cache=feature_cache,
            feature_dtype=feature_dtype,
        )
        for batch, ids, *drawn in made:
            batch = batch.to(device)
            if drawn:  # spectrograms and their drawn parameters
                feats, lens = device_augment.apply(batch.features, batch.feature_lengths,
                                                   drawn[0])
                batch = Batch(feats, lens, batch.labels, batch.label_lengths)
            if proc_count > 1:
                features, labels = distributed.agree_global_padding(batch.features, batch.labels)
                batch = batch._replace(features=features, labels=labels)
            yield batch, ids

    def full_state() -> TrainState:
        """The whole state: under tensor parallelism gathered over the model
        ranks (a collective: every rank calls it at the same point)."""
        return gather_train_state(state, mesh) if tensor_parallel else state

    def save(tag: str, dev_loss=None) -> None:
        if manager is None:  # the same on every rank
            return
        full = full_state()
        if saver is not None:
            saver.save(full, tag, dev_loss=dev_loss)

    def run_eval_epoch(files: List[str], model) -> float:
        """The mean finite loss over the files; with several processes each
        rank evaluates every proc_count-th batch and the sums merge."""
        losses: List[float] = []
        for index, (batch, _) in enumerate(create_batches(files, alphabet, feature_config,
                                                          batch_size=config.dev_batch_size)):
            if index % proc_count != proc_id:
                continue
            batch_losses, _ = eval_step(model, batch.to(device))
            losses.extend(batch_losses.cpu().tolist())
        finite = [l for l in losses if np.isfinite(l)]
        if proc_count > 1:
            total, count = distributed.allreduce_sum_across_hosts([sum(finite), len(finite)])
            return float(total / count) if count else float("inf")
        return float(np.mean(finite)) if finite else float("inf")

    # dummy run: the longest samples first, to find an out-of-memory batch
    if config.limit_train >= 0 and train_samples:
        probe_limit = min(config.train_batch_size * 2, len(train_samples))
        for batch, _ in batches(0, reverse=True, limit=probe_limit):
            state, _ = train_step(state, batch, step_seed)
            break
        log("Dummy run (longest samples) OK: no out-of-memory")

    best_dev_loss = manager.best_dev_loss() if manager else float("inf")
    epochs_without_improvement = 0
    last_save = time.time()
    frame_seconds = feature_config.step_samples / feature_config.sample_rate
    summary_writer = make_summary_writer(config.summary_dir) if is_coordinator else None

    profiler = None
    for epoch in range(config.epochs):
        if feature_cache is not None and feature_cache.maybe_invalidate(epoch):
            log(f"Feature cache invalidated at epoch {epoch} "
                     f"(--cache_for_epochs {config.cache_for_epochs})")
        epoch_losses: List[float] = []
        epoch_audio_s = 0.0
        t0 = time.time()
        pending: List[tuple] = []  # (step, metrics, ids)

        def drain_metrics(entry) -> None:
            step_no, metrics, ids = entry
            loss = metrics.loss.item()
            epoch_losses.append(loss)
            if summary_writer is not None:
                summary_writer(step_no, {"train/step_loss": loss})
            bad = metrics.non_finite.cpu().numpy()
            if bad.any():
                bad_ids = [i for i, b in zip(ids, bad[: len(ids)]) if b]
                log_error(f"Non-finite loss in step {step_no}; offending samples: {bad_ids}")

        for step_in_epoch, (batch, ids) in enumerate(batches(epoch)):
            if config.profile_dir and is_coordinator and epoch == 0 and step_in_epoch == 0:
                profiler = start_profiler(device)
            epoch_audio_s += float(batch.feature_lengths.sum()) * frame_seconds
            state, metrics = train_step(state, batch, step_seed)
            pending.append((state.step, metrics, ids))
            if len(pending) > METRICS_LAG:
                drain_metrics(pending.pop(0))
            if profiler is not None and step_in_epoch + 1 >= config.profile_steps:
                stop_profiler(profiler, device, config.profile_dir)
                profiler = None
            due = saver is not None and time.time() - last_save > config.checkpoint_secs
            if tensor_parallel and manager is not None:  # the gather needs every rank: rank 0 decides
                due = distributed.broadcast_flag(due)
            if due:
                save("last")
                last_save = time.time()
        for entry in pending:
            drain_metrics(entry)
        if profiler is not None:  # fewer steps than profile_steps in the epoch
            stop_profiler(profiler, device, config.profile_dir)
            profiler = None
        mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
        epoch_wall = time.time() - t0
        throughput = epoch_audio_s / max(epoch_wall, 1e-9)
        msg = (f"Epoch {epoch} | train loss {mean_loss:.4f} | {epoch_wall:.1f}s | "
               f"{throughput:.1f} audio-s/s | lr {get_learning_rate(state):.6f}")
        if summary_writer is not None:
            summary_writer(state.step, {
                "train/epoch_loss": mean_loss,
                "train/audio_seconds_per_second": throughput,
                "train/learning_rate": get_learning_rate(state),
            })

        dev_loss = None
        eval_model = None
        if config.dev_files or config.metrics_files:
            eval_model = gather_model(state, mesh) if tensor_parallel else state.model
        if config.dev_files:
            dev_loss = run_eval_epoch(config.dev_files, eval_model)
            msg += f" | dev loss {dev_loss:.4f}"
            if summary_writer is not None:
                summary_writer(state.step, {"dev/loss": dev_loss})
        # metrics datasets are tracked each epoch but steer nothing
        for metrics_csv in config.metrics_files:
            m_loss = run_eval_epoch([metrics_csv], eval_model)
            name = os.path.basename(metrics_csv)
            msg += f" | metrics[{name}] loss {m_loss:.4f}"
            if summary_writer is not None:
                summary_writer(state.step, {f"metrics/{name}_loss": m_loss})
        log(msg)

        # the merged dev loss is the same on every rank, so are these decisions
        if dev_loss is not None:
            if dev_loss < best_dev_loss - config.es_min_delta:
                epochs_without_improvement = 0
            else:
                epochs_without_improvement += 1
            if dev_loss < best_dev_loss:
                save("best_dev", dev_loss=dev_loss)
            best_dev_loss = min(best_dev_loss, dev_loss)
        save("last")
        last_save = time.time()

        if config.early_stop and epochs_without_improvement >= config.es_epochs:
            log(f"Early stop triggered: dev loss has not improved by more than "
                     f"{config.es_min_delta} in {config.es_epochs} epochs")
            break

        if (config.reduce_lr_on_plateau and manager is not None
                and epochs_without_improvement > 0
                and epochs_without_improvement % config.plateau_epochs == 0):
            distributed.barrier()  # rank 0's best_dev is written
            try:
                if tensor_parallel:
                    state = shard_train_state(manager.restore(full_state(), "best_dev"), mesh)
                else:
                    manager.restore(state, "best_dev")
            except FileNotFoundError:
                pass
            new_lr = get_learning_rate(state) * config.plateau_reduction
            set_learning_rate(state, new_lr)
            log(f"Plateau: reloaded best checkpoint, reduced LR to {new_lr}")

    final = full_state()
    if saver is not None:
        saver.save(final, "last")
    return final
