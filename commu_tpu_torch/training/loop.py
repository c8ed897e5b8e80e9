"""The training loop: dataset, train step, evaluation, checkpoints.

PyTorch counterpart of ``commu_tpu/training/loop.py::Trainer`` on one
device, or on one rank of a data-parallel process group (``..parallel``):
the dataset (``..data``, numpy only), the model in
``model_dtype`` over f32 parameters with a seeded initialization, the train
step with Adam and the Noam schedule, the eval pass, and the reference's log
cadence and best/last/test policy:

- every ``log_interval`` steps, one "Train Step" line with the lr, train
  tokens/s, nll, ppl and the mean grad norm (metrics are read back only
  there, so the device never waits on the host inside the loop);
- every ``eval_interval`` steps a val pass, ``checkpoint_last``, and on
  improvement ``checkpoint_best`` and a test pass;
- ``final_test`` reloads ``checkpoint_best`` and runs the test pass;
- ``maybe_resume`` restores ``checkpoint_last`` (weights, Adam, schedule,
  step);
- with ``profile=True``, a ``torch.profiler`` trace of steps
  [start + 4, start + 10) (``start``: the step training began from, after a
  resume) into ``work_dir/profile/``.

The memory layout follows the model's path: the blocked ring on the kernel
path, the dense shift buffer on the unfused one (training: one per physical
chunk, ``step.init_train_memory``).

Data parallel (a process group of ``world`` ranks): every rank runs the same
packing iterator over the global batch and feeds its own contiguous rows
(``process_batch_slice``), so its XL memory holds only those rows; the base
rate is ``lr / world``; the train step averages the gradients over the
ranks; the eval batch is rounded up to a multiple of ``world`` and the eval
sums are summed over the ranks; the config snapshot, checkpoints and the
profiler trace are rank 0's, behind barriers; ``maybe_resume`` and
``final_test`` load on every rank.
"""
from __future__ import annotations

import logging
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import TrainingConfig
from ..data.dataset import ComMUDataset
from ..vocab.event_tokens import VOCAB_SIZE

from ..models.transformer_xl import TransformerXL, init_memory
from ..parallel import mesh, multihost as mh
from . import checkpoint as ckpt
from .schedule import lr_at
from .step import (init_train_memory, make_eval_step, make_optimizer,
                   make_train_step, resolve_physical_chunks)

logger = logging.getLogger("ComMU")


class Trainer:
    """``data_dir`` holds the reference's ``{input,target}_{split}.npy``.
    Parameters are drawn from ``generator`` (default: seeded with
    ``cfg.train.seed``) on the CPU, so a seed gives the same weights on
    every device; load others with ``trainer.model.load_state_dict``.
    ``work_dir`` (checkpoints and config.yml) is needed by ``train``,
    ``final_test`` and ``maybe_resume`` only.

    The reference's ``Trainer`` takes ``(data_dir, work_dir, cfg,
    num_devices, model_dtype, profile)`` positionally; here ``work_dir``
    and everything after the config are keywords, and a path in the
    config's place is refused.  ``num_devices``: the world size, which must
    be the process group's (one rank a device; None: the group's, 1
    without one).  ``profile``: trace steps [start + 4, start + 10) of
    ``train`` into ``work_dir/profile/`` (rank 0's)."""

    def __init__(self, data_dir: str, cfg: Optional[TrainingConfig] = None,
                 *, device="cuda", model_dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 work_dir: Optional[str] = None, profile: bool = False,
                 num_devices: Optional[int] = None):
        if isinstance(cfg, (str, os.PathLike)):
            raise TypeError(
                f"Trainer(data_dir, cfg, *, work_dir=...): the second "
                f"argument is the TrainingConfig, got the path {cfg!r}; the "
                "reference's positional order (data_dir, work_dir, cfg) "
                "does not apply here: pass work_dir= by keyword")
        self.cfg = cfg or TrainingConfig()
        self.device = torch.device(device)
        self.model_dtype = model_dtype
        self.world = mh.process_count()
        if num_devices is not None and num_devices != self.world:
            raise ValueError(
                f"num_devices={num_devices}, but the process group has "
                f"{self.world} ranks (one a device; see "
                "commu_tpu_torch.parallel)")
        self.is_primary = mh.is_primary()
        tcfg = self.cfg.train
        if tcfg.batch_size % (tcfg.batch_chunk * self.world):
            raise ValueError(
                f"global batch {tcfg.batch_size} must divide into "
                f"batch_chunk x num_devices = {tcfg.batch_chunk} x "
                f"{self.world} chunks")
        self.profile = profile and self.is_primary
        self.dataset = ComMUDataset(data_dir)
        model = TransformerXL(VOCAB_SIZE, self.cfg.model, dtype=model_dtype)
        model.init_parameters(
            generator or torch.Generator().manual_seed(self.cfg.train.seed))
        self.model = model.to(self.device).eval()
        logger.info("#total params = %d",
                    sum(p.numel() for p in self.model.parameters()))
        self.eval_step = make_eval_step(self.model, same_length=True)
        # at least the reference's rows, rounded up to a multiple of the
        # ranks so they split evenly (pad rows add nothing to the sums)
        self.eval_batch = -(-self.cfg.evaluate.batch_size // self.world) \
            * self.world
        self.step = 0
        self.best_val_nll = math.inf
        self.ckpts = None
        if work_dir is not None:
            self.ckpts = ckpt.CheckpointManager(work_dir)
            if self.is_primary:
                ckpt.write_config_snapshot(work_dir, self.cfg)
            mh.sync("config_snapshot")
        self._optimizer = None

    def _train_state(self):
        """(optimizer, scheduler, train step), built on first use."""
        if self._optimizer is None:
            self._optimizer, self._scheduler = make_optimizer(
                self.model, self.cfg, self.world)
            self._train_step = make_train_step(
                self.model, self._optimizer, self._scheduler, self.cfg)
        return self._optimizer, self._scheduler, self._train_step

    def _require_work_dir(self):
        if self.ckpts is None:
            raise ValueError("this needs a Trainer built with work_dir=")
        return self.ckpts

    # ------------------------------------------------------------------
    def maybe_resume(self) -> bool:
        ckpts = self._require_work_dir()
        if not ckpts.has("checkpoint_last"):
            return False
        optimizer, scheduler, _ = self._train_state()
        self.step, self.best_val_nll = ckpts.restore(
            "checkpoint_last", self.model, optimizer, scheduler)
        logger.info("Resumed from step %d (best val nll %.4f)", self.step,
                    self.best_val_nll)
        return True

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def evaluate(self, split: str = "valid") -> tuple[int, float]:
        """(token_count, total_nll) over the split.  Memory is reset at each
        sequence-batch boundary (a fresh zero ring), as the reference's
        ``mems = None`` on ``reset_all_mem``."""
        ecfg, mcfg = self.cfg.evaluate, self.cfg.model
        total_tokens = 0
        nll_parts = []
        memory = None
        rows = self.eval_batch // self.world
        reset = torch.zeros(rows, dtype=torch.bool, device=self.device)
        for batch in self.dataset.eval_iterator(
                self.eval_batch, ecfg.tgt_length, split=split):
            if batch.reset[0] or memory is None:
                memory = init_memory(mcfg.num_layers, rows,
                                     ecfg.mem_length, mcfg.units,
                                     dtype=self.model_dtype,
                                     block_len=ecfg.tgt_length,
                                     device=self.device,
                                     dense=self.model.attn_impl == "xla")
            nll_sum, _, memory = self.eval_step(
                memory, self._feed(batch.inputs), self._feed(batch.targets),
                reset)
            nll_parts.append(nll_sum)
            total_tokens += batch.token_count
        total = torch.stack(nll_parts).double().sum() if nll_parts else \
            torch.zeros((), dtype=torch.float64, device=self.device)
        if self.world > 1:  # each rank summed its own rows
            total = mesh.sum_across(total)
        return total_tokens, float(total)

    # ------------------------------------------------------------------
    def train(self, max_step: Optional[int] = None) -> None:
        ckpts = self._require_work_dir()
        tcfg, mcfg = self.cfg.train, self.cfg.model
        max_step = max_step or tcfg.max_step
        optimizer, scheduler, train_step = self._train_state()
        rows = tcfg.batch_size // self.world  # this rank's rows
        if self.model.attn_impl == "xla":
            memory = init_train_memory(
                mcfg.num_layers, rows, tcfg.mem_length,
                mcfg.units, resolve_physical_chunks(self.cfg),
                dtype=self.model_dtype, device=self.device)
        else:
            memory = init_memory(mcfg.num_layers, rows,
                                 tcfg.mem_length, mcfg.units,
                                 dtype=self.model_dtype,
                                 block_len=tcfg.tgt_length,
                                 device=self.device)
        it = self.dataset.train_iterator(
            tcfg.batch_size, tcfg.tgt_length, shuffle=True, seed=tcfg.seed)
        log_metrics, log_tokens = [], 0
        log_start = time.time()
        # the trace covers steps [start + 4, start + 10): past the first
        # steps' one-time costs, short enough to read
        profile_start, profile_stop = self.step + 4, self.step + 10
        profiler = None
        self.model.train()
        for batch in it:
            if self.step >= max_step:
                break
            if self.profile and self.step == profile_start:
                profiler = self._start_profiler()
            memory, metrics = train_step(
                memory, self._feed(batch.inputs), self._feed(batch.targets),
                self._feed(batch.reset))
            log_metrics.append(metrics)
            log_tokens += batch.token_count
            self.step += 1
            if profiler is not None and self.step == profile_stop:
                self._stop_profiler(profiler, ckpts.work_dir, profile_start)
                profiler = None
            step = self.step

            if step % tcfg.log_interval == 0:
                stacked = {k: torch.stack([m[k] for m in log_metrics])
                           .double().cpu().numpy() for k in log_metrics[0]}
                nll = stacked["nll_sum"].sum() / max(
                    stacked["token_count"].sum(), 1.0)
                elapsed = time.time() - log_start
                logger.info(
                    "Train Step %d/%d, lr=%f, tokens/s=%.1f, nll=%.4f, "
                    "ppl=%.2f, grad norm=%.4f", step, max_step,
                    lr_at(tcfg, step - 1), log_tokens / max(elapsed, 1e-9),
                    nll, math.exp(min(nll, 700.0)),
                    float(np.mean(stacked["grad_norm"])))
                log_metrics, log_tokens = [], 0
                log_start = time.time()

            if step % tcfg.eval_interval == 0:
                t0 = time.time()
                val_tokens, val_nll_sum = self.evaluate("valid")
                val_nll = val_nll_sum / max(val_tokens, 1)
                logger.info("Eval step %d, time=%.1fs, val nll=%.4f, "
                            "val ppl=%.2f", step, time.time() - t0, val_nll,
                            math.exp(min(val_nll, 700.0)))
                if self.is_primary:
                    ckpts.save_last(self.model, optimizer, scheduler, step,
                                    self.best_val_nll)
                if val_nll < self.best_val_nll:
                    self.best_val_nll = val_nll
                    if self.is_primary:
                        ckpts.save_best(self.model, optimizer, scheduler,
                                        step, self.best_val_nll)
                    mh.sync("save_best")
                    t0 = time.time()
                    test_tokens, test_nll_sum = self.evaluate("test")
                    test_nll = test_nll_sum / max(test_tokens, 1)
                    logger.info(
                        "Test step %d, time=%.1fs, test nll=%.4f, "
                        "test ppl=%.2f, #evaluated tokens=%d", step,
                        time.time() - t0, test_nll,
                        math.exp(min(test_nll, 700.0)), test_tokens)
                mh.sync("save_last")
                log_start = time.time()
        if profiler is not None:  # the run ended inside the window
            self._stop_profiler(profiler, ckpts.work_dir, profile_start)
        self.model.eval()
        logger.info("End of training")

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, work_dir, start: int) -> None:
        """Wait for the traced steps' device work, stop the profiler and
        write its Chrome trace of steps [start, self.step) into
        ``work_dir/profile/``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = os.path.join(str(work_dir), "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(out, f"trace_steps_{start}_{self.step}.json"))
        logger.info("profiler trace written to %s", out)

    # ------------------------------------------------------------------
    def final_test(self) -> float:
        """Load checkpoint_best and run the test pass."""
        ckpts = self._require_work_dir()
        if ckpts.has("checkpoint_best"):
            ckpts.restore("checkpoint_best", self.model)
        tokens, nll_sum = self.evaluate("test")
        nll = nll_sum / max(tokens, 1)
        logger.info("End of training | test nll %5.2f | test ppl %9.3f",
                    nll, math.exp(min(nll, 700.0)))
        return nll

    def _feed(self, arr: np.ndarray) -> torch.Tensor:
        """A host batch array on the device: this rank's rows of it."""
        if self.world > 1:
            arr = arr[mh.process_batch_slice(arr.shape[0])]
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, non_blocking=True)
