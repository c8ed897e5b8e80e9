"""The port's forward over the XL memory and its eval step against the JAX
package's kernel path, on the CPU.

The JAX model runs ``attn_impl="pallas"`` (Pallas in interpreter mode) over
``init_memory(..., transposed=True, block_len=T)``, the blocked ring the
eval loop uses; the port runs its plain twins over its own ring.  Windows
go on until the ring has filled and wrapped (R + 2 windows), with reset
rows on the way.  Memories are compared through ``logical_memory_view``
over their valid region only: stale ring slots differ legitimately.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.models.transformer_xl import TransformerXL as JaxTransformerXL
from commu_tpu.models.transformer_xl import Memory as JaxMemory
from commu_tpu.models.transformer_xl import init_memory as jax_init_memory
from commu_tpu.models.transformer_xl import logical_memory_view as jax_view
from commu_tpu.training.step import make_eval_step as jax_make_eval_step
from commu_tpu_torch.models import (TransformerXL, init_memory,
                                    logical_memory_view, memory_from_arrays,
                                    memory_to_arrays,
                                    state_dict_from_flax_params)
from commu_tpu_torch.training import make_eval_step

from test_torch_model import CFG, VOCAB, random_params

PAL_CFG = dataclasses.replace(CFG, attn_impl="pallas")
B, T, R = 3, 8, 4
M = R * T
WINDOWS = R + 2  # fills the ring, then wraps it twice
# f32: the repo's forward tolerance; bf16: bf16 rounding flips at the
# layers' rounding points, carried through three layers
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _models(dtype, seed=2):
    params = random_params(PAL_CFG, VOCAB, seed=seed, weight_std=0.05)
    jmodel = JaxTransformerXL(VOCAB, PAL_CFG, dtype=JDT[dtype])
    model = TransformerXL(VOCAB, PAL_CFG, dtype=TDT[dtype])
    model.load_state_dict(state_dict_from_flax_params(params, PAL_CFG))
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), model.eval()


def _windows(seed):
    """(tokens, targets, reset) per window: a reset row in windows 2 and 4,
    PAD targets in the last window."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(WINDOWS):
        tokens = rng.integers(1, VOCAB, size=(B, T)).astype(np.int32)
        targets = rng.integers(1, VOCAB, size=(B, T)).astype(np.int32)
        if w == WINDOWS - 1:
            targets[1, 3:] = 0
        out.append((tokens, targets, np.array([w == 2, False, w == 4])))
    return out


def _valid(view, count):
    return np.asarray(view, np.float32)[:, :, M - count:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("same_length", [False, True])
def test_forward_over_memory_matches_jax(same_length, dtype):
    jmodel, jparams, model = _models(dtype)
    fwd = jax.jit(functools.partial(jmodel.apply, same_length=same_length,
                                    method=jmodel.forward))
    jmem = jax_init_memory(PAL_CFG.num_layers, B, M, PAL_CFG.units,
                           dtype=JDT[dtype], transposed=True, block_len=T)
    tmem = init_memory(PAL_CFG.num_layers, B, M, PAL_CFG.units,
                       dtype=TDT[dtype], block_len=T)
    tol = TOL[dtype]
    for w, (tokens, _, reset) in enumerate(_windows(0)):
        out, jmem = fwd({"params": jparams}, jnp.asarray(tokens), jmem,
                        jnp.asarray(reset))
        with torch.inference_mode():
            ours, tmem = model(torch.from_numpy(tokens).long(),
                               torch.from_numpy(reset), memory=tmem,
                               same_length=same_length)
        assert ours.shape == (B, T, PAL_CFG.units) and ours.dtype == TDT[dtype]
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(out, np.float32), rtol=tol,
                                   atol=tol, err_msg=f"window {w}")
        assert (tmem.count, tmem.head) == (int(jmem.count), int(jmem.head))
        np.testing.assert_allclose(
            _valid(logical_memory_view(tmem).float(), tmem.count),
            _valid(jax_view(jmem).astype(jnp.float32), tmem.count),
            rtol=tol, atol=tol, err_msg=f"memory after window {w}")
    assert tmem.count == M and tmem.head == (WINDOWS * T) % M


def test_forward_from_a_memory_carried_from_jax():
    """A JAX memory that has wrapped crosses into the port as numpy arrays;
    one more window on each side agrees, and the port's memory crosses back
    with the same fields."""
    jmodel, jparams, model = _models("float32", seed=5)
    fwd = jax.jit(functools.partial(jmodel.apply, same_length=True,
                                    method=jmodel.forward))
    jmem = jax_init_memory(PAL_CFG.num_layers, B, M, PAL_CFG.units,
                           transposed=True, block_len=T)
    windows = _windows(1)
    for tokens, _, reset in windows[:-1]:
        _, jmem = fwd({"params": jparams}, jnp.asarray(tokens), jmem,
                      jnp.asarray(reset))
    tmem = memory_from_arrays(np.asarray(jmem.hidden), jmem.count, jmem.head)
    tokens, _, reset = windows[-1]
    out, jmem = fwd({"params": jparams}, jnp.asarray(tokens), jmem,
                    jnp.asarray(reset))
    with torch.inference_mode():
        ours, tmem = model(torch.from_numpy(tokens).long(),
                           torch.from_numpy(reset), memory=tmem,
                           same_length=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(out), rtol=2e-4,
                               atol=2e-4)
    hidden, count, head = memory_to_arrays(tmem)
    back = JaxMemory(hidden=jnp.asarray(hidden), count=jnp.int32(count),
                     head=jnp.int32(head), transposed=True)
    np.testing.assert_allclose(np.asarray(jax_view(back))[:, :, M - count:],
                               np.asarray(jax_view(jmem))[:, :, M - count:],
                               rtol=2e-4, atol=2e-4)


def test_memory_must_be_in_the_compute_dtype_and_match_the_window():
    _, _, model = _models("float32")
    tokens = torch.ones(B, T, dtype=torch.long)
    with pytest.raises(TypeError):
        model(tokens, memory=init_memory(PAL_CFG.num_layers, B, M,
                                         PAL_CFG.units, dtype=torch.bfloat16,
                                         block_len=T))
    with pytest.raises(ValueError):
        model(tokens[:, :4], memory=init_memory(PAL_CFG.num_layers, B, M,
                                                PAL_CFG.units, block_len=T))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_matches_jax(dtype):
    jmodel, jparams, model = _models(dtype, seed=3)
    jstep = jax.jit(jax_make_eval_step(jmodel, same_length=True))
    step = make_eval_step(model, same_length=True)
    jmem = jax_init_memory(PAL_CFG.num_layers, B, M, PAL_CFG.units,
                           dtype=JDT[dtype], transposed=True, block_len=T)
    tmem = init_memory(PAL_CFG.num_layers, B, M, PAL_CFG.units,
                       dtype=TDT[dtype], block_len=T)
    # bf16 hidden states feed f32 logits: the sum inherits their flips
    rtol = {"float32": 2e-4, "bfloat16": 2e-2}[dtype]
    for w, (tokens, targets, reset) in enumerate(_windows(2)):
        j_nll, j_tok, jmem = jstep(jparams, jmem, jnp.asarray(tokens),
                                   jnp.asarray(targets), jnp.asarray(reset))
        nll, tok, tmem = step(tmem, torch.from_numpy(tokens),
                              torch.from_numpy(targets),
                              torch.from_numpy(reset))
        assert float(tok) == float(j_tok), f"window {w}"
        np.testing.assert_allclose(float(nll), float(j_nll), rtol=rtol,
                                   err_msg=f"window {w}")
    assert float(tok) == B * T - 5  # the PAD targets are not counted
