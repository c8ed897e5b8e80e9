"""The port's data parallelism (``commu_tpu_torch.parallel``) on the CPU,
over gloo.

- ``process_batch_slice`` against ``commu_tpu.parallel.multihost``'s;
- a real 2-rank run (``parallel.spawn``, two processes) of 3 train steps
  at ``tests/_multihost_worker.py::build_tiny_cfg``'s widths, dropout 0, on
  the kernel path: held against the JAX package's manual data-parallel
  step on a 2-device mesh (``shard_map``, explicit ``pmean``; conftest
  gives this process 8 virtual CPU devices) and against the port's own
  one-process step at ``batch_chunk`` x 2 and ``lr`` / 2: ``nll_sum``,
  ``grad_norm`` and every parameter within 1e-5 (f32);
- rank 0 alone writes the config snapshot and the checkpoints;
- ranks draw distinct dropout masks, rank 0 the one-process draw;
- the ``--num_devices`` refusal on a machine with too few CUDA devices;
- ``train --device cpu --num_devices 2`` through the CLI.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.data.dataset import save_corpus
from commu_tpu.models.transformer_xl import TransformerXL as JaxTransformerXL
from commu_tpu.parallel import make_mesh
from commu_tpu.parallel import multihost as jax_mh
from commu_tpu.parallel.mesh import (DATA_AXIS, _train_memory_shardings,
                                     shard_train_step)
from commu_tpu.training.step import create_train_state
from commu_tpu.training.step import init_train_memory as jax_train_memory
from commu_tpu.training.step import make_train_step as jax_make_train_step
from commu_tpu_torch import config as port_config
from commu_tpu_torch import train as train_cli
from commu_tpu_torch.models import draw_dropout, state_dict_from_flax_params
from commu_tpu_torch.parallel import mesh, multihost
from commu_tpu_torch.training import Trainer
from commu_tpu_torch.training.step import step_generator

from _multihost_worker import build_tiny_cfg
from _torch_parallel_worker import run_rank
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

VOCAB = 729
TOL = 1e-5  # f32


def _configs(batch_chunk=2, lr=4e-3):
    """(the JAX config, the port's): build_tiny_cfg's widths on the kernel
    path (the JAX side runs its Pallas kernels in interpret mode), with a
    short warmup so three steps move the weights."""
    jcfg = build_tiny_cfg(8)
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, attn_impl="pallas"),
        train=dataclasses.replace(jcfg.train, batch_chunk=batch_chunk, lr=lr,
                                  warmup_step=2))
    pcfg = port_config.TrainingConfig(
        model=port_config.ModelConfig(**dataclasses.asdict(jcfg.model)),
        train=port_config.TrainConfig(**dataclasses.asdict(jcfg.train)),
        evaluate=port_config.EvaluateConfig(
            **dataclasses.asdict(jcfg.evaluate)))
    return jcfg, pcfg


def _batches(n=3, batch=8, t=16):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        inputs = rng.randint(1, VOCAB, size=(batch, t)).astype(np.int32)
        targets = rng.randint(1, VOCAB, size=(batch, t)).astype(np.int32)
        targets[2, -6:] = 0  # PAD
        reset = np.zeros(batch, dtype=bool)
        reset[5] = i == 2
        out.append((inputs, targets, reset))
    return out


@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 6])
def test_process_batch_slice_matches_the_jax_package(nproc):
    for p in range(nproc):
        assert multihost.process_batch_slice(12, p, nproc) == \
            jax_mh.process_batch_slice(12, p, nproc)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.process_batch_slice(10, 0, 4)
    assert multihost.process_batch_slice(8) == slice(0, 8)  # no group


def _jax_two_device_run(jcfg, batches):
    """The JAX Trainer's path on a 2-device mesh: the manual (shard_map)
    step with its own pmean/psum, over the transposed ring."""
    mesh = make_mesh(2)
    jmodel = JaxTransformerXL(VOCAB, jcfg.model, dtype=jnp.float32)
    state = create_train_state(jax.random.PRNGKey(0), jmodel, jcfg, 2)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    step = shard_train_step(
        jax_make_train_step(jmodel, jcfg, 2, axis_name=DATA_AXIS), mesh,
        transposed=True, manual=True)
    tcfg = jcfg.train
    memory = jax.device_put(
        jax_train_memory(jcfg.model.num_layers, tcfg.batch_size,
                         tcfg.mem_length, jcfg.model.units, 1,
                         transposed=True, block_len=tcfg.tgt_length),
        _train_memory_shardings(mesh, True))
    key = jax.random.PRNGKey(7)
    metrics = []
    for inputs, targets, reset in batches:
        state, memory, m = step(state, memory, inputs, targets, reset, key)
        metrics.append({k: float(v) for k, v in m.items()})
    return params0, metrics, jax.tree_util.tree_map(np.asarray, state.params)


def _port_one_process(pcfg, state_dict, batches, tmp_path):
    out = tmp_path / "one.pt"
    run_rank(0, torch.device("cpu"), pcfg, state_dict, batches, str(out))
    return torch.load(str(out))


def _assert_close_runs(ours, ref, what):
    for i, (a, b) in enumerate(zip(ours["metrics"], ref["metrics"])):
        assert a["token_count"] == b["token_count"], (what, i)
        for name in ("nll_sum", "grad_norm"):
            np.testing.assert_allclose(a[name], b[name], rtol=TOL,
                                       err_msg=f"{what}: {name} step {i}")
    for key, value in ref["state"].items():
        np.testing.assert_allclose(ours["state"][key].numpy(),
                                   np.asarray(value), rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {key}")


def test_two_ranks_match_the_jax_mesh_and_the_one_process_oracle(tmp_path):
    jcfg, pcfg = _configs()
    batches = _batches()
    params0, jax_metrics, jax_params = _jax_two_device_run(jcfg, batches)
    state0 = state_dict_from_flax_params(params0, pcfg.model)

    out = tmp_path / "ranks.pt"
    mesh.spawn(run_rank, 2, "cpu", pcfg, state0, batches, str(out))
    ranks = torch.load(str(out))
    assert ranks["world"] == 2

    jax_run = {"metrics": jax_metrics,
               "state": state_dict_from_flax_params(jax_params, pcfg.model)}
    _assert_close_runs(ranks, jax_run, "2 ranks vs the JAX 2-device mesh")

    # the oracle: one process over the whole batch, every rank's chunks,
    # at the rate each rank takes
    _, oracle_cfg = _configs(batch_chunk=4, lr=2e-3)
    oracle = _port_one_process(oracle_cfg, state0, batches, tmp_path)
    _assert_close_runs(ranks, oracle, "2 ranks vs one process")


def test_ranks_draw_distinct_dropout_masks_and_rank_0_the_one_process_draw():
    _, pcfg = _configs()
    mcfg = dataclasses.replace(pcfg.model, dropout=0.1, attention_dropout=0.1)
    k_len = pcfg.train.mem_length + pcfg.train.tgt_length
    draws = [draw_dropout(step_generator(pcfg.train.seed, 3, rank), mcfg,
                          k_len) for rank in (0, 1)]
    one = draw_dropout(step_generator(pcfg.train.seed, 3), mcfg, k_len)
    assert draws[0].attn_seeds == one.attn_seeds
    assert torch.equal(draws[0].psi_keep, one.psi_keep)
    assert draws[0].attn_seeds != draws[1].attn_seeds
    assert draws[0].ffn_seeds != draws[1].ffn_seeds
    assert not torch.equal(draws[0].psi_keep, draws[1].psi_keep)
    keep = draws[1].psi_keep.float().mean()
    assert abs(float(keep) - 0.9) < 0.02  # still the rate, only other bits


def test_num_devices_beyond_the_cuda_devices_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--num_devices 2: .* 2 CUDA "
                                         "devices, and this machine has 1"):
        mesh.check_device_count(2, "cuda")
    mesh.check_device_count(1, "cuda")
    mesh.check_device_count(4, "cpu")  # CPU ranks need no device


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(1)

    def seqs(n):
        metas = [rng.randint(560, 729, size=11).astype(np.int64)
                 for _ in range(n)]
        events = [rng.randint(2, 560, size=rng.randint(20, 90))
                  .astype(np.int64) for _ in range(n)]
        return metas, events

    d = tmp_path_factory.mktemp("corpus") / "npy"
    save_corpus(d, "train", *seqs(16))
    save_corpus(d, "val", *seqs(6))
    return d


OVERRIDES = ["model.num_layers=2", "model.num_heads=2", "model.units=32",
             "model.inner_size=48", "model.dropout=0.0",
             "model.attention_dropout=0.0", "train.batch_size=4",
             "train.batch_chunk=2", "train.tgt_length=16",
             "train.mem_length=32", "train.warmup_step=2",
             "train.log_interval=2", "train.eval_interval=2",
             "evaluate.batch_size=3", "evaluate.tgt_length=16",
             "evaluate.mem_length=32"]


def test_only_the_primary_rank_writes(corpus, tmp_path, monkeypatch):
    """A rank that is not rank 0 trains, evaluates and passes the barriers,
    but writes neither the config snapshot nor a checkpoint."""
    _, pcfg = _configs()
    cfg = dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, batch_size=4, max_step=2, log_interval=2,
        eval_interval=2), evaluate=dataclasses.replace(
        pcfg.evaluate, batch_size=3))
    synced = []
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    monkeypatch.setattr(multihost, "sync", lambda name="": synced.append(name))
    trainer = Trainer(str(corpus), cfg, device="cpu",
                      model_dtype=torch.float32, work_dir=str(tmp_path / "w"))
    assert not trainer.is_primary and not trainer.profile
    trainer.train()
    assert os.listdir(tmp_path / "w") == []
    assert synced[0] == "config_snapshot" and "save_last" in synced


@pytest.fixture
def comMU_logger():
    """The CLI's configure_logging replaces the "ComMU" logger's handlers
    and stops its propagation; put them back for the tests that follow in
    this process (those that read caplog)."""
    import logging

    logger = logging.getLogger("ComMU")
    saved = (list(logger.handlers), logger.propagate, logger.level)
    yield
    for handler in logger.handlers:
        if handler not in saved[0]:
            handler.close()
    logger.handlers[:] = saved[0]
    logger.propagate, logger.level = saved[1], saved[2]


def test_train_cli_with_two_cpu_ranks(corpus, tmp_path, comMU_logger):
    """``--num_devices 2 --device cpu``: two spawned ranks over gloo, one
    work dir with rank 0's config and checkpoints and a log per rank;
    the trained weights equal those of a one-process run at batch_chunk x
    2 and lr / 2 within 1e-5."""
    flags = ["--data_dir", str(corpus), "--device", "cpu", "--dtype",
             "float32", "--max_step", "4", "--precise_bd"]
    work = train_cli.main(flags + ["--work_dir", str(tmp_path / "dp"),
                                   "--num_devices", "2"]
                          + [a for o in OVERRIDES for a in ("--set", o)])
    assert sorted(os.listdir(work)) == [
        "checkpoint_best.pt", "checkpoint_last.pt", "config.yml",
        "train_rank0.log", "train_rank1.log"]
    text = open(f"{work}/train_rank0.log").read()
    assert "devices=2" in text and "End of training | test nll" in text
    assert "End of training | test nll" in open(
        f"{work}/train_rank1.log").read()
    one = train_cli.main(flags + ["--work_dir", str(tmp_path / "one")]
                         + [a for o in OVERRIDES + ["train.batch_chunk=4",
                                                    "train.lr=0.002"]
                            for a in ("--set", o)])
    ours = torch.load(f"{work}/checkpoint_last.pt")["model"]
    ref = torch.load(f"{one}/checkpoint_last.pt")["model"]
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), value.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=key)
