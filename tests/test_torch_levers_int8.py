"""The reference's two int8 backward levers of its attention kernels in the
port, against the JAX package on the CPU: ``COMMU_INT8_DQ=1`` and
``COMMU_INT8_DK=1`` (``_bwd_stage_b`` :961-973, :995-1007).  Setup and
tolerances as ``tests/test_torch_levers.py`` states them; a gradient that a
lever quantises may miss its tolerance on 1 element in 100 (a rounding tie
of its quantiser: the two sides' ds differ in their last bits), and in bf16
by twice the distance the lever puts between JAX's results (the port
rebuilds P from its f32 scores, JAX from a bf16 checkpoint, so the two ds
differ by bf16 roundings and their quantised copies in many places).

The model-level case mirrors ``tests/test_fused_attention.py:352``: under
both levers the loss equals the default's and every gradient stays within
5% of its largest magnitude, correlated above 0.99; the port under the
levers is within the ops tolerance of the JAX model under them.
"""
import jax
import numpy as np
import pytest
import torch

from commu_tpu_torch.models import state_dict_from_flax_params

from test_torch_levers import INT8, MODES, hold, run_port, set_env
from test_torch_probes import _jax_loss_and_grads, _port_loss_and_grads
from test_torch_train_step import CFG, _full_ring_case, _jax_state, _port_model
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

# the gradients each lever quantises (at the op: over the ring, then over
# the window alone)
AFFECTED = {"int8_dq": ("dq",), "int8_dk": ("dk", "dk_win", "dWk")}


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("lever", sorted(INT8))
def test_int8_lever_matches_jax(monkeypatch, lever, mode, dtype, ring):
    """The forward and every gradient under one int8 lever, at dropout 0.1
    from one seed on both sides; the forward, and every gradient the lever
    does not quantise, equal the port's without the lever bit for bit (dv
    and dWv among them: the reference never changes ds itself)."""
    out, grads = hold(monkeypatch, INT8[lever], mode, dtype, ring,
                      AFFECTED[lever])
    set_env(monkeypatch, MODES[mode])
    base_out, base = run_port(5 + ring, dtype, ring)
    assert torch.equal(out, base_out)
    names = (("dq", "dWk", "dWv", "dk_win", "dv_win", "dW_r", "d r_w_bias",
              "d r_r_bias") if ring else
             ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias"))
    for grad, b, name in zip(grads, base, names):
        assert torch.equal(grad, b) == (name not in AFFECTED[lever]), name


def test_int8_dq_dk_model_gradients(monkeypatch):
    """Both levers at once over the whole model in f32 (a full, wrapped
    ring), as the reference's test runs them."""
    jmodel, state = _jax_state(CFG)
    case = _full_ring_case()
    model = _port_model(state.params, CFG)
    set_env(monkeypatch)
    base_loss, base, _ = _port_loss_and_grads(model, case)
    set_env(monkeypatch, *INT8.values())
    loss, grads, _ = _port_loss_and_grads(model, case)
    assert torch.equal(loss, base_loss)  # the forward is untouched
    moved = 0
    for name, g0 in base.items():
        g0, g1 = g0.double(), grads[name].double()
        scale = max(float(g0.abs().max()), 1e-12)
        assert float((g1 - g0).abs().max()) / scale < 0.05, name
        if g0.numel() > 1 and float(g0.std()) > 0.0:
            corr = float(torch.corrcoef(torch.stack([g0.ravel(),
                                                     g1.ravel()]))[0, 1])
            assert corr > 0.99, (name, corr)
        moved += not torch.equal(g0, g1)
    assert moved > 0
    ref_loss, ref = _jax_loss_and_grads(jmodel, state.params, case)
    ref = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, ref), CFG.model)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    for name, value in grads.items():
        r = ref[name].numpy()
        bound = 1e-4 * np.abs(r) + 1e-5 * float(np.abs(r).max())
        missed = float((np.abs(value.numpy() - r) > bound).mean())
        assert missed <= 0.01, (name, missed)
