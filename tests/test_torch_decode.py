"""The PyTorch port's KV-cache decode against the JAX package's, on the CPU:
prefill, decode_step and commit step by step, and decode against the port's
own full forward (same math, different schedule)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.models import decode as jdecode
from commu_tpu.models.transformer_xl import TransformerXL as JaxTransformerXL
from commu_tpu.ops.fused_ffn import _ln_fwd as jax_ln_fast
from commu_tpu_torch.models import decode as tdecode
from commu_tpu_torch.ops.fused_ffn import _ln as port_ln_fast

from test_torch_model import CFG, TOL, VOCAB, port_model, random_params

G, T, PRIMER = 3, 14, 5


def _setup(seed=0, attn_impl="pallas"):
    cfg = dataclasses.replace(CFG, attn_impl=attn_impl)
    params = random_params(cfg, VOCAB, seed)
    tokens = np.random.default_rng(seed + 10).integers(
        1, VOCAB, size=(G, T)).astype(np.int32)
    return cfg, params, tokens


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("capacity", [16, 128])
def test_decode_matches_jax_step_by_step(capacity):
    """capacity 16 takes the JAX masked-select commit, 128 its cache_append
    branch; the port always commits through cache_append."""
    cfg, params, tokens = _setup()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jmodel = JaxTransformerXL(VOCAB, cfg, dtype=jnp.float32)
    jrel = jdecode.precompute_rel(jparams, cfg, capacity)
    jcache = jdecode.prefill(jmodel, jparams, cfg,
                             jnp.asarray(tokens[:, :PRIMER]),
                             jdecode.init_cache(cfg, G, capacity))

    model = port_model(params, cfg, VOCAB)
    tok = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        rel = tdecode.precompute_rel(model, cfg, capacity)
        for ours, ref in zip(rel, jrel):
            np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-6,
                                       atol=1e-6)
        cache = tdecode.prefill(model, cfg, tok[:, :PRIMER],
                                tdecode.init_cache(cfg, G, capacity))
        np.testing.assert_array_equal(_np(cache.length), _np(jcache.length))
        np.testing.assert_allclose(_np(cache.k), _np(jcache.k), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(_np(cache.v), _np(jcache.v), rtol=TOL,
                                   atol=TOL)

        rng = np.random.default_rng(4)
        for j in range(PRIMER, T):
            jl, jk, jv = jdecode.decode_step(jparams, cfg, jrel,
                                             jnp.asarray(tokens[:, j]), jcache)
            tl, tk, tv = tdecode.decode_step(model, cfg, rel, tok[:, j], cache)
            for ours, ref in ((tl, jl), (tk, jk), (tv, jv)):
                np.testing.assert_allclose(_np(ours), _np(ref), rtol=TOL,
                                           atol=TOL, err_msg=f"step {j}")
            advance = rng.random(G) < 0.7
            jcache = jdecode.commit(jcache, jk, jv, jnp.asarray(advance))
            cache = tdecode.commit(cache, tk, tv, torch.from_numpy(advance))
            np.testing.assert_array_equal(_np(cache.length),
                                          _np(jcache.length))
            np.testing.assert_allclose(_np(cache.k), _np(jcache.k), rtol=TOL,
                                       atol=TOL)


def test_decode_matches_own_forward():
    cfg, params, tokens = _setup(seed=1)
    model = port_model(params, cfg, VOCAB)
    tok = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        full = model.logits(model(tok))                    # [G, T, V]
        rel = tdecode.precompute_rel(model, cfg, T + 2)
        cache = tdecode.prefill(model, cfg, tok[:, :PRIMER],
                                tdecode.init_cache(cfg, G, T + 2))
        advance = torch.ones(G, dtype=torch.bool)
        for j in range(PRIMER, T):
            logits, k_self, v_self = tdecode.decode_step(model, cfg, rel,
                                                         tok[:, j], cache)
            torch.testing.assert_close(logits, full[:, j], rtol=TOL, atol=TOL)
            cache = tdecode.commit(cache, k_self, v_self, advance)
    assert cache.length.tolist() == [T] * G


def test_cache_view_gives_the_same_logits():
    """The sampler's narrower cache views (all lengths below the view
    width) read the same context as the full cache."""
    cfg, params, tokens = _setup(seed=2)
    model = port_model(params, cfg, VOCAB)
    tok = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        rel = tdecode.precompute_rel(model, cfg, 256)
        cache = tdecode.prefill(model, cfg, tok[:, :PRIMER],
                                tdecode.init_cache(cfg, G, 256))
        full, _, _ = tdecode.decode_step(model, cfg, rel, tok[:, PRIMER],
                                         cache)
        view, _, _ = tdecode.decode_step(model, cfg, rel, tok[:, PRIMER],
                                         cache.view(128))
    torch.testing.assert_close(view, full, rtol=1e-6, atol=1e-6)


def test_layer_norm_variants_are_kept_apart():
    """decode_step's LayerNorm is two-pass, the forward's (fused FFN) uses
    the fast variance max(E[x^2] - mean^2, 0).  On rows with a large mean
    the fast form loses the variance to cancellation, the two-pass form does
    not: each must keep its form, and match its JAX counterpart."""
    rng = np.random.default_rng(0)
    g = (1.0 + 0.1 * rng.normal(size=CFG.units)).astype(np.float32)
    b = (0.1 * rng.normal(size=CFG.units)).astype(np.float32)
    x = (3000.0 + rng.normal(size=(4, CFG.units))).astype(np.float32)
    xd = x.astype(np.float64)
    exact = ((xd - xd.mean(-1, keepdims=True))
             / np.sqrt(xd.var(-1, keepdims=True) + 1e-5)) * g + b

    def two_pass(a):
        return tdecode._layer_norm(torch.from_numpy(a), torch.from_numpy(g),
                                   torch.from_numpy(b)).numpy()

    def fast(a):  # [rows, D] through the [B, D, T] fused-block form
        return port_ln_fast(torch.from_numpy(a.T.copy())[None],
                            torch.from_numpy(g), torch.from_numpy(b))[0].T.numpy()

    np.testing.assert_allclose(two_pass(x), exact, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(two_pass(x), np.asarray(jdecode._layer_norm(x, g, b)),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(fast(x) - exact).max() > 1e-2

    y = rng.normal(size=(4, CFG.units)).astype(np.float32)
    ref_fast = np.asarray(jax_ln_fast(jnp.asarray(y.T), jnp.asarray(g)[:, None],
                                      jnp.asarray(b)[:, None])[0]).T
    np.testing.assert_allclose(fast(y), ref_fast, rtol=1e-5, atol=1e-5)
