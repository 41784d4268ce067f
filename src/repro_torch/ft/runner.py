"""Fault-tolerant training runner (port of ``repro.ft.runner``).

  * checkpoint/restart: every ``ckpt_every`` steps, atomic, with the
    optimizer and the data-pipeline state (``checkpoint``), in the
    reference's layout; a restart resumes the exact token stream.
  * node failure: the step is a function of (params, opt, data_state); on
    a failure the runner restores the last checkpoint and continues.
    ``fail_at`` injects one failure at a chosen step to prove the path.
  * elastic scaling: leaves are stored whole, so ``remesh_restore`` puts a
    checkpoint on another device, or one replica on each device of a list.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch import convert
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint


class TrainRunner:
    def __init__(
        self,
        train_step: Callable,  # (params, opt_state, step, batch) -> (params, opt_state, metrics)
        init_state: Callable,  # () -> (params, opt_state)
        next_batch: Callable,  # (DataState) -> (DataState, batch)
        data_init: Callable,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50,
        fail_at: Optional[int] = None,  # failure injection (testing)
    ):
        self.train_step = train_step
        self.init_state = init_state
        self.next_batch = next_batch
        self.data_init = data_init
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.fail_at = fail_at
        self._failed_once = False

    def _save(self, params, opt_state, data_state, step):
        save_checkpoint(self.ckpt_dir, step, convert.bundle_to_tree(params, opt_state, data_state, step))

    def _restore(self, params):
        """(step, params, opt_state, data_state) of the newest checkpoint,
        on the device of ``params`` (an LM of the same config)."""
        dev = next(params.parameters()).device
        _, tree = restore_checkpoint(self.ckpt_dir)
        return convert.bundle_from_tree(tree, params.cfg, dev)

    def run(self, n_steps: int, log_every: int = 10) -> Dict:
        params, opt_state = self.init_state()
        data_state = self.data_init()
        start = 0
        if self.ckpt_dir and latest_step(self.ckpt_dir) is not None:
            start, params, opt_state, data_state = self._restore(params)
            print(f"[ft] resumed from checkpoint at step {start}", flush=True)

        losses = []
        step = start
        while step < n_steps:
            try:
                if self.fail_at is not None and step == self.fail_at and not self._failed_once:
                    self._failed_once = True
                    raise RuntimeError(f"[ft] injected node failure at step {step}")
                data_state, batch = self.next_batch(data_state)
                params, opt_state, metrics = self.train_step(params, opt_state, step, batch)
                loss = float(metrics["loss"])
                losses.append(loss)
                if step % log_every == 0:
                    print(f"[train] step={step} loss={loss:.4f} gnorm={float(metrics['grad_norm']):.3f}", flush=True)
                step += 1
                if self.ckpt_dir and step % self.ckpt_every == 0:
                    self._save(params, opt_state, data_state, step)
            except RuntimeError as e:
                if "injected node failure" not in str(e) or not self.ckpt_dir:
                    raise
                print(f"{e} -> restoring latest checkpoint", flush=True)
                step, params, opt_state, data_state = self._restore(params)
        if self.ckpt_dir:
            self._save(params, opt_state, data_state, step)
        return {"final_step": step, "losses": losses, "params": params, "opt": opt_state}


def remesh_restore(ckpt_dir: str, proto, devices):
    """Elastic scaling: the newest checkpoint on another device, or, for a
    list of devices, one whole replica on each: (step, tree or [tree])."""
    if isinstance(devices, (list, tuple)):
        step, tree = restore_checkpoint(ckpt_dir, proto)
        return step, [convert.map_tree(lambda t, d=d: t.to(d, copy=True), tree) for d in devices]
    return restore_checkpoint(ckpt_dir, proto, device=devices)
