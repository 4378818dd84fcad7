"""Framework configuration: one dataclass -> command-line flags -> derived
geometry (the counterpart of `stt_tpu.config`, with the same flag names
and defaults, so a run script written for one package runs the other).

Flags of parts that are not ported yet would raise NotImplementedError,
naming their ROADMAP.md slice, when set away from their defaults
(`NOT_PORTED`; empty: every flag is ported). --num_processes, --process_id and
--coordinator_address run data parallelism across processes
(`maybe_initialize_distributed`); --n_model_parallel K lays the ranks out on
a (num_processes / K, K) mesh and trains tensor-parallel.
`fused_lstm` stays for the flag set's sake, and only at its default: the
port has no scan to fall back to, and every LSTM on the card runs in its
kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional

from stt_tpu_torch.alphabet import Alphabet, UTF8Alphabet
from stt_tpu_torch.frontend import FeatureConfig
from stt_tpu_torch.models import ModelConfig

# flag -> (its default, the ROADMAP.md slice that ports it)
NOT_PORTED: dict = {}
DEVICE_DECODE_MODES = ("auto", "full", "prune", "off")  # stt_tpu's; auto = prune


@dataclass
class SttConfig:
    # -- datasets ----------------------------------------------------------
    train_files: List[str] = field(default_factory=list)
    dev_files: List[str] = field(default_factory=list)
    test_files: List[str] = field(default_factory=list)
    metrics_files: List[str] = field(default_factory=list)
    auto_input_dataset: str = ""

    # -- alphabet / outputs ------------------------------------------------
    alphabet_config_path: str = ""
    bytes_output_mode: bool = False

    # -- geometry ----------------------------------------------------------
    n_hidden: int = 2048
    layer_norm: bool = False
    relu_clip: float = 20.0

    # -- audio / features --------------------------------------------------
    audio_sample_rate: int = 16000
    feature_win_len: int = 32  # ms
    feature_win_step: int = 20  # ms

    # -- training ----------------------------------------------------------
    epochs: int = 75
    train_batch_size: int = 1
    dev_batch_size: int = 1
    test_batch_size: int = 1
    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    # reset the checkpoint-restored (possibly plateau-reduced) learning
    # rate to --learning_rate when resuming
    force_initialize_learning_rate: bool = False
    dropout_rate: float = 0.05
    dropout_rate2: float = -1.0  # <0: same as dropout_rate
    dropout_rate3: float = -1.0
    dropout_rate5: float = -1.0
    augment: List[str] = field(default_factory=list)
    reverse_train: bool = False
    limit_train: int = 0
    shuffle_batches: bool = True
    # featurize threads (-1: up to 8) and batches assembled ahead
    input_workers: int = -1
    prefetch_batches: int = 2
    feature_cache: str = ""
    cache_for_epochs: int = 0
    graph_augs_on_device: bool = False
    # raw audio to the device, the MFCC frontend inside the train step
    device_featurize: bool = False

    # -- checkpointing -----------------------------------------------------
    checkpoint_dir: str = ""
    save_checkpoint_dir: str = ""
    load_checkpoint_dir: str = ""
    checkpoint_secs: int = 600
    max_to_keep: int = 5
    load_train: str = "auto"  # auto | best | last | init
    load_evaluate: str = "auto"  # auto | best | last
    drop_source_layers: int = 0

    # -- observability -----------------------------------------------------
    summary_dir: str = ""  # scalars.jsonl
    profile_dir: str = ""
    profile_steps: int = 10

    # -- early stop / plateau ---------------------------------------------
    early_stop: bool = False
    es_epochs: int = 25
    es_min_delta: float = 0.05
    reduce_lr_on_plateau: bool = False
    plateau_epochs: int = 10
    plateau_reduction: float = 0.1

    # -- decoder -----------------------------------------------------------
    scorer_path: str = ""
    lm_alpha: float = 0.931289039105002
    lm_beta: float = 1.1834137581510284
    beam_width: int = 1024
    export_beam_width: int = 500
    cutoff_prob: float = 1.0
    cutoff_top_n: int = 300
    device_decode: str = "auto"  # auto | full | prune | off

    # -- export ------------------------------------------------------------
    export_dir: str = ""
    export_zip: bool = False
    export_quantize: bool = False
    export_model_name: str = "model"
    export_author_id: str = ""
    export_model_version: str = "0.0.1"
    export_license: str = ""
    export_language: str = ""
    # also write a reference-format .tflite beside the artifact
    # (compat.tflite_export; needs TensorFlow)
    export_tflite: bool = False
    export_file_name: str = "output_graph"
    n_steps: int = 16  # the .tflite graph's chunk length in timesteps

    # -- distribution ------------------------------------------------------
    coordinator_address: str = ""
    num_processes: int = 0  # 0/1 = single-process
    process_id: int = -1
    n_model_parallel: int = 1
    compute_dtype: str = "float32"  # or bfloat16
    fused_lstm: bool = True

    # -- misc --------------------------------------------------------------
    log_level: int = 1
    show_progressbar: bool = True
    report_count: int = 5
    test_output_file: str = ""
    seed: int = 4568

    # derived (not flags)
    alphabet: Optional[Alphabet] = field(default=None, repr=False)

    # -- derivation --------------------------------------------------------

    def __post_init__(self):
        for name, (default, where) in NOT_PORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"--{name} is not ported to stt_tpu_torch yet (ROADMAP.md: {where})"
                )
        if self.device_decode not in DEVICE_DECODE_MODES:
            raise ValueError(
                f"--device_decode takes one of {', '.join(DEVICE_DECODE_MODES)}, "
                f"got {self.device_decode!r}"
            )
        if not self.fused_lstm:
            raise ValueError(
                "--fused_lstm false selects the JAX package's lax.scan; stt_tpu_torch "
                "has no such path and always runs the LSTM in its kernels"
            )
        if self.dropout_rate2 < 0:
            self.dropout_rate2 = self.dropout_rate
        if self.dropout_rate3 < 0:
            self.dropout_rate3 = self.dropout_rate
        if self.dropout_rate5 < 0:
            self.dropout_rate5 = self.dropout_rate
        if self.checkpoint_dir:
            self.save_checkpoint_dir = self.save_checkpoint_dir or self.checkpoint_dir
            self.load_checkpoint_dir = self.load_checkpoint_dir or self.checkpoint_dir

    def resolve_alphabet(self) -> Alphabet:
        if self.alphabet is not None:
            return self.alphabet
        if self.bytes_output_mode:
            self.alphabet = UTF8Alphabet()
        elif self.alphabet_config_path:
            self.alphabet = Alphabet(self.alphabet_config_path)
        elif self.train_files:
            # generated from the training transcripts
            from stt_tpu_torch.data.sources import samples_from_sources

            chars = set()
            for sample in samples_from_sources(self.train_files, labeled=True):
                chars.update(sample.transcript or "")
            self.alphabet = Alphabet().init_from_labels(sorted(chars))
        else:
            raise ValueError(
                "need --alphabet_config_path, --bytes_output_mode, or "
                "--train_files to derive an alphabet"
            )
        return self.alphabet

    @property
    def feature_config(self) -> FeatureConfig:
        return FeatureConfig.from_ms(
            sample_rate=self.audio_sample_rate,
            window_ms=self.feature_win_len,
            step_ms=self.feature_win_step,
        )

    def model_config(self, training: bool = True) -> ModelConfig:
        alphabet = self.resolve_alphabet()
        rates = (
            (self.dropout_rate, self.dropout_rate2, self.dropout_rate3, 0.0, 0.0,
             self.dropout_rate5)
            if training
            else (0.0,) * 6
        )
        return ModelConfig(
            n_hidden=self.n_hidden,
            n_cell_dim=self.n_hidden,
            n_out=alphabet.size + 1,
            relu_clip=self.relu_clip,
            layer_norm=self.layer_norm,
            dropout_rates=rates,
            compute_dtype=self.compute_dtype,
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("alphabet", None)
        return d


_LIST_FIELDS = {"train_files", "dev_files", "test_files", "metrics_files", "augment"}


def parse_flags(argv: Optional[List[str]] = None) -> SttConfig:
    """argparse over every SttConfig field (flag names == field names,
    comma-separated values for list fields; --augment is repeatable)."""
    parser = argparse.ArgumentParser(
        prog="stt_tpu_torch", description="speech-to-text training on an NVIDIA GPU"
    )
    for f in dataclasses.fields(SttConfig):
        if f.name == "alphabet":
            continue
        if f.name in _LIST_FIELDS:
            if f.name == "augment":
                parser.add_argument("--augment", action="append", default=None)
            else:
                parser.add_argument(f"--{f.name}", type=str, default=None)
        elif f.type in ("bool", bool):
            parser.add_argument(
                f"--{f.name}",
                type=lambda v: v.lower() in ("1", "true", "yes"),
                nargs="?",
                const=True,
                default=None,
            )
        else:
            ftype = int if f.type in ("int", int) else (
                float if f.type in ("float", float) else str
            )
            parser.add_argument(f"--{f.name}", type=ftype, default=None)
    args = parser.parse_args(argv)
    kwargs = {}
    for f in dataclasses.fields(SttConfig):
        if f.name == "alphabet":
            continue
        value = getattr(args, f.name, None)
        if value is None:
            continue
        if f.name in _LIST_FIELDS and f.name != "augment":
            value = [v for v in value.split(",") if v]
        kwargs[f.name] = value
    return SttConfig(**kwargs)


def maybe_initialize_distributed(config: SttConfig, device="cuda") -> None:
    """Join the process group when --num_processes > 1 (before anything
    else touches the device; the command lines call it right after parsing
    their flags). --process_id -1 takes the RANK environment variable; the
    collectives' backend follows `device` (`parallel.distributed.initialize`)."""
    if config.num_processes and config.num_processes > 1:
        from stt_tpu_torch.parallel.distributed import initialize

        process_id = config.process_id
        if process_id < 0:
            process_id = int(os.environ.get("RANK", "-1"))
        initialize(
            coordinator_address=config.coordinator_address or None,
            num_processes=config.num_processes,
            process_id=process_id if process_id >= 0 else None,
            device=device,
        )


def initialize_globals_from_cli(argv: Optional[List[str]] = None, device="cuda") -> SttConfig:
    config = parse_flags(argv)
    maybe_initialize_distributed(config, device)
    config.resolve_alphabet()
    return config


# -- leveled logging ---------------------------------------------------------

_LOG_LEVEL = int(os.environ.get("STT_LOG_LEVEL", "1"))


def log_debug(*args):
    if _LOG_LEVEL >= 2:
        print("D", *args, file=sys.stderr)


def log_info(*args):
    if _LOG_LEVEL >= 1:
        print("I", *args)


def log_warn(*args):
    print("W", *args, file=sys.stderr)


def log_error(*args):
    print("E", *args, file=sys.stderr)
