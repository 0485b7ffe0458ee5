"""Partition-independent checkpointing (the port of
``skycomputing_tpu/runner/hooks_collection/checkpoint_hook.py``).

``before_run`` optionally restores a whole-model checkpoint into the
parameter server and loads every stage's slice from it; after every
``save_interval`` epochs, and at the end of a run cut mid-epoch, the
stages' weights are gathered into the parameter server and written with
``torch.save`` as ``epoch_{n}.pt`` (or ``iter_{n}.pt``).  The store is
layer-indexed, so a checkpoint restores under a different allocation
than it was saved with.

``save_training_state`` also writes ``<checkpoint>.train_state.pt``:
the optimizer state (tagged with the partition it belongs to), the
epoch and iteration counters and the runner's generator state.  On
restore the counters and the generator always follow; the optimizer
state follows only under the same partition — under another it is
rejected, logged, and training resumes with a fresh optimizer state.
The JAX hook's msgpack and orbax formats are not ported.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import torch

from ...registry import HOOKS
from ...telemetry import trace_span
from ...utils import atomic_torch_save
from ..hooks import Hook


@HOOKS.register_module
class CheckpointHook(Hook):
    def __init__(
        self,
        load_checkpoint_from: Optional[str] = None,
        save_path: Optional[str] = None,
        save_interval: Optional[int] = None,
        save_training_state: bool = False,
    ):
        self._load_checkpoint_from = load_checkpoint_from
        self._save_path = save_path
        self._save_interval = save_interval
        self._save_training_state = save_training_state
        self._last_saved_iter = 0
        #: the newest checkpoint this hook wrote
        self.last_saved: Optional[str] = None

    @staticmethod
    def training_state_path(params_path: str) -> str:
        return params_path + ".train_state.pt"

    def before_run(self, runner):
        src = self._load_checkpoint_from
        if not src:
            return
        runner.parameter_server.load_weights_from_file(src)
        runner.model.load_from_parameter_server()
        runner.logger.info(f"restored checkpoint from {src}")

        ts_path = self.training_state_path(src)
        if not os.path.exists(ts_path):
            return
        state = torch.load(ts_path, map_location="cpu", weights_only=True)
        # the counters and the generator do not depend on the partition
        runner.epoch = int(state["epoch"])
        runner.iter = int(state["iter"])
        runner.restore_rng(state["rng"])
        try:
            runner.model.load_optimizer_state(state["optimizer"])
        except ValueError as exc:
            runner.logger.info(
                f"optimizer state not restored ({exc}); resuming at "
                f"epoch={runner.epoch}, iter={runner.iter} with fresh "
                "optimizer state"
            )
            return
        runner.logger.info(
            f"restored training state (epoch={runner.epoch}, "
            f"iter={runner.iter}) from {ts_path}"
        )

    def after_epoch(self, runner):
        if not self._save_path or not self._save_interval:
            return
        if self.every_n_epochs(runner, self._save_interval):
            # runner.epoch already counts the completed epoch
            self._save(runner, f"epoch_{runner.epoch}")

    def after_run(self, runner):
        # a run cut mid-epoch never fires after_epoch for that epoch: keep
        # its weights under an iteration-tagged name
        if not self._save_path or not self._save_interval:
            return
        if runner.aborted:
            # training raised: the live weights are suspect, so the last
            # good checkpoint stays the newest
            runner.logger.info("training aborted; skipping final save")
            return
        if runner.iter > self._last_saved_iter:
            self._save(runner, f"iter_{runner.iter}")

    def _save(self, runner, tag: str) -> None:
        with trace_span("checkpoint", "runner", "lifecycle", {"tag": tag}):
            self._save_traced(runner, tag)

    def _save_traced(self, runner, tag: str) -> None:
        os.makedirs(self._save_path, exist_ok=True)
        runner.model.sync_to_parameter_server()
        path = osp.join(self._save_path, f"{tag}.pt")
        runner.parameter_server.save_weights_to_file(path)
        self._last_saved_iter = runner.iter
        self.last_saved = path
        runner.logger.info(f"saved checkpoint to {path}")
        if self._save_training_state:
            ts_path = self.training_state_path(path)
            atomic_torch_save({
                "optimizer": runner.model.get_optimizer_state(),
                "epoch": runner.epoch,
                "iter": runner.iter,
                "rng": runner.snapshot_rng(),
            }, ts_path)
            runner.logger.info(f"saved training state to {ts_path}")


__all__ = ["CheckpointHook"]
