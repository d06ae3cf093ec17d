"""Fault-tolerant train loop of the port: checkpoint/resume and the
straggler watchdog, as a client of the shared fault machinery in
`repro_torch.distributed.faultbank` (`repro.distributed.fault` in
PyTorch):

  * atomic keep-k checkpoints every ``ckpt_every`` steps and at the end,
  * auto-resume from the latest committed checkpoint,
  * deterministic data replay (the pipeline is a pure function of step),
  * straggler watchdog: each step's wall time (the clock stopped once
    the loss is on the host) against a running median
    (`faultbank.StragglerStats`),
  * failure injection for tests (``fail_at``), proving crash → restart →
    bit-exact convergence with the uninterrupted run.

On a mesh (``mesh=``, ``rules=`` default ``make_rules(mesh, "train")``)
the state is placed by `train_state_pspecs`, each batch by
``batch_shardings`` (a dict of `NamedSharding` by batch key, default the
rules' batch spec), and the step is the data-parallel one.
"""
from __future__ import annotations

import time

import torch

from ..checkpoint.manager import latest_step, restore_checkpoint, save_checkpoint
from ..data.pipeline import TokenPipeline
from ..kernels.runtime import resolve_device
from ..nn import init_params, model_decls, param_pspecs
from ..training.train_step import TrainHParams, make_train_step, train_state_init
from .faultbank import SimulatedFailure, StragglerStats
from .placement import device_put, gather
from .sharding import batch_shardings, make_rules, sanitized_shardings

__all__ = ["SimulatedFailure", "StragglerStats", "TrainLoop"]


class TrainLoop:
    """Trains ``cfg`` on ``pipeline``'s batches on ``device`` (``None``:
    the GPU, raising without one), from parameters drawn with a
    ``torch.Generator`` on the device seeded with ``init_key`` — or from
    the latest checkpoint in ``ckpt_dir`` when there is one."""

    def __init__(self, cfg, hp: TrainHParams, pipeline: TokenPipeline,
                 ckpt_dir: str, *, ckpt_every: int = 10, keep: int = 3,
                 mesh=None, rules=None, batch_shardings=None,
                 init_key: int = 0, device=None):
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices.flat[0])
        self.cfg = cfg
        self.hp = hp
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.mesh = mesh
        if mesh is not None and rules is None:
            rules = make_rules(mesh, "train")
        self.rules = rules
        self.batch_shardings = batch_shardings
        self.stragglers = StragglerStats()
        self._step_fn = make_train_step(cfg, hp, mesh, rules)
        gen = torch.Generator(device=self.device).manual_seed(init_key)
        params = init_params(model_decls(cfg), gen, device=self.device)
        if mesh is not None:
            params = device_put(params, sanitized_shardings(
                mesh, param_pspecs(model_decls(cfg), rules), params))
        self.state = train_state_init(params, cfg)
        self.metrics_history: list[dict] = []
        self._maybe_resume()

    def _maybe_resume(self) -> None:
        if latest_step(self.ckpt_dir) is not None:
            self.state, step = restore_checkpoint(self.ckpt_dir, self.state)
            print(f"[fault] resumed from checkpoint at step {step}")

    @property
    def step(self) -> int:
        return int(gather(self.state["step"]))

    def _put(self, batch) -> dict:
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        if self.mesh is None:
            return batch
        sh = self.batch_shardings or batch_shardings(self.mesh, self.rules,
                                                     batch)
        return {k: device_put(v, sh[k]) for k, v in batch.items()}

    def run(self, until_step: int,
            fail_at: int | None = None) -> list[dict]:
        """Run to ``until_step``; raises SimulatedFailure at ``fail_at``
        (before that step commits) when requested by a test."""
        while self.step < until_step:
            step = self.step
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self._put(self.pipeline.global_batch_at(step))
            t0 = time.perf_counter()
            self.state, metrics = self._step_fn(self.state, batch)
            m = {k: float(v) for k, v in metrics.items()}
            slow = self.stragglers.record(time.perf_counter() - t0)
            if slow:
                print(f"[fault] straggling step {step}: "
                      f"{self.stragglers.times[-1]:.3f}s")
            m["step"] = step
            self.metrics_history.append(m)
            new_step = self.step
            if new_step % self.ckpt_every == 0 or new_step == until_step:
                save_checkpoint(self.ckpt_dir, new_step, self.state,
                                keep=self.keep)
        return self.metrics_history
