"""Checkpoint management: `last` and `best_dev` savers, retention, the
load order, and drop-layer transfer learning (the counterpart of
`stt_tpu.train.checkpoints`, with the same layout on disk):

  checkpoint_dir/
    last/step_N/state.pt      (max_to_keep retained)
    best_dev/step_N/state.pt
    meta.json                 (tag -> latest step, dev loss of the best)
    config.json               (the run's flags)
    alphabet.txt

`state.pt` is `torch.save` of {"params": the flat JAX-named parameters
("layer_1/w", "lstm/kernel", ...) on the CPU, "opt_state": the Adam state
dict, "step": int}. It is not an orbax checkpoint, and the two packages do
not read each other's checkpoints: weights cross between them through the
exported artifact (`stt_tpu_torch.artifact`). A save writes into
`step_N.tmp-<pid>` and renames it, so a crash mid-save leaves a directory
that every later listing skips.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stt_tpu_torch.train.step import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, checkpoint_dir: str, max_to_keep: int = 5):
        self.dir = os.path.abspath(checkpoint_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    # -- bookkeeping -------------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.dir, "meta.json")

    def _read_meta(self) -> dict:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def _write_meta(self, meta: dict) -> None:
        with open(self._meta_path(), "w") as f:
            json.dump(meta, f, indent=2)

    def _tag_dir(self, tag: str) -> str:
        return os.path.join(self.dir, tag)

    def steps(self, tag: str) -> List[int]:
        tag_dir = self._tag_dir(tag)
        if not os.path.isdir(tag_dir):
            return []
        out = []
        for name in os.listdir(tag_dir):
            suffix = name.split("_", 1)[1] if name.startswith("step_") else ""
            # a crash mid-save leaves step_N.tmp-<pid> behind; skip it
            if suffix.isdigit():
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self, tag: str) -> Optional[int]:
        steps = self.steps(tag)
        return steps[-1] if steps else None

    # -- save/load ---------------------------------------------------------

    def save(self, state: TrainState, tag: str = "last", dev_loss: Optional[float] = None) -> str:
        path = os.path.join(self._tag_dir(tag), f"step_{state.step}")
        tmp = f"{path}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save(
            {
                "params": {k: v.detach().cpu() for k, v in state.params.items()},
                "opt_state": state.optimizer.state_dict(),
                "step": state.step,
            },
            os.path.join(tmp, STATE_FILE),
        )
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        meta = self._read_meta()
        meta[tag] = state.step
        if dev_loss is not None:
            meta[f"{tag}_dev_loss"] = float(dev_loss)
        self._write_meta(meta)
        for old in self.steps(tag)[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self._tag_dir(tag), f"step_{old}"))
        return path

    def read(self, tag: str = "last", step: Optional[int] = None) -> dict:
        """The saved record of `tag` at `step` (the latest when None)."""
        if step is None:
            step = self.latest_step(tag)
        if step is None:
            raise FileNotFoundError(f"no '{tag}' checkpoint in {self.dir}")
        path = os.path.join(self._tag_dir(tag), f"step_{step}", STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, tag: str = "last", step: Optional[int] = None) -> TrainState:
        """Load `tag`'s parameters, optimizer state and step into `state`
        (in place) and return it."""
        saved = self.read(tag, step)
        state.model.load_state_dict(saved["params"])
        state.optimizer.load_state_dict(saved["opt_state"])
        state.step = int(saved["step"])
        return state

    def best_dev_loss(self) -> float:
        return float(self._read_meta().get("best_dev_dev_loss", np.inf))

    # -- side files ----------------------------------------------------------

    def save_run_files(self, config_dict: dict, alphabet_text: str) -> None:
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(config_dict, f, indent=2, default=str)
        with open(os.path.join(self.dir, "alphabet.txt"), "w") as f:
            f.write(alphabet_text)


DROP_ORDER = ("layer_6", "layer_5", "lstm", "layer_3", "layer_2", "layer_1")


def drop_layers(
    params: Dict[str, torch.Tensor], restored: Dict[str, torch.Tensor], drop_source_layers: int
) -> Dict[str, torch.Tensor]:
    """Transfer learning: the restored bottom layers and the fresh top
    `drop_source_layers` layers (dropped in the order layer_6, layer_5,
    lstm, layer_3, layer_2; at most five). Flat JAX-named parameters."""
    dropped = set(DROP_ORDER[: max(0, min(drop_source_layers, 5))])
    return {
        name: params[name] if name.split("/")[0] in dropped else restored[name]
        for name in params
    }


def load_or_init_graph_for_training(
    manager: CheckpointManager,
    state: TrainState,
    load_train: str = "auto",
    drop_source_layers: int = 0,
) -> Tuple[TrainState, str]:
    """Resolve the initial state of a fresh `state`: 'best' / 'last' /
    'init' / 'auto' (auto = best -> last -> init). Returns (state, method).
    With drop_source_layers the optimizer and step stay fresh."""
    order = {
        "auto": ["best_dev", "last", "init"],
        "best": ["best_dev"],
        "last": ["last"],
        "init": ["init"],
    }[load_train]
    for method in order:
        if method == "init":
            return state, "init"
        try:
            saved = manager.read(method)
        except FileNotFoundError:
            continue
        if drop_source_layers > 0:
            fresh = {k: v.detach().cpu() for k, v in state.params.items()}
            state.model.load_state_dict(drop_layers(fresh, saved["params"], drop_source_layers))
            return state, method
        return manager.restore(state, method), method
    raise FileNotFoundError(f"no checkpoint found in {manager.dir} for load mode '{load_train}'")


def load_graph_for_evaluation(
    manager: CheckpointManager, state: TrainState, load_evaluate: str = "auto"
) -> Tuple[TrainState, str]:
    """The evaluation load order: best -> last (never init)."""
    order = {"auto": ["best_dev", "last"], "best": ["best_dev"], "last": ["last"]}[load_evaluate]
    for method in order:
        try:
            return manager.restore(state, method), method
        except FileNotFoundError:
            continue
    raise FileNotFoundError(f"no checkpoint for evaluation in {manager.dir} (tried {order})")
