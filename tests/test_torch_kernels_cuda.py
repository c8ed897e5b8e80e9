"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, so it runs only on a machine with an H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

The shapes go beyond the serving and eval paths' (T across the query and
key tiles, ragged projection and token tiles, other head widths, rows at and
past capacity, a wrapped ring) so the kernels' tiling and masking are
exercised, not only the shapes ``chip_smoke.py`` checks.
"""
import math

import pytest
import torch

from commu_tpu_torch.ops import _build
from commu_tpu_torch.ops import fused_attention as fa
from commu_tpu_torch.ops import dropout, fused_ffn, fused_nll, layout, prng

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(ours, ref, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(ours.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,d_model,t", [
    (1, 10, 500, 1), (3, 10, 500, 9), (2, 2, 32, 17), (2, 4, 128, 200)])
def test_rel_attention_kernel_matches_plain(dev, dtype, b, heads, d_model, t):
    gen = torch.Generator(device=dev).manual_seed(t)
    dh = d_model // heads
    scale = dh ** -0.5

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    q, k, v = (randn(b, heads, dh, t).to(dtype) for _ in range(3))
    w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05), heads).to(dtype)
    rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                   randn(heads, dh, std=0.1), scale, dtype)
    args = (q, rwbs, rrbs, k, v, w_r,
            fa.query_trig_table(t, 0, d_model, dtype, dev),
            fa.key_trig_basis(t, d_model, dtype, dev),
            fa.build_mask_bias(t, 0, 0, 0, True, device=dev),
            (torch.arange(b, device=dev) % 2).int(), scale)
    before = _build.LAUNCHES["rel_attention_fwd"]
    _close(fa.rel_attention_fwd(*args), fa.rel_attention_fwd_plain(*args),
           TOL[dtype])
    assert _build.LAUNCHES["rel_attention_fwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,f,t", [(8, 500, 1000, 11), (3, 32, 48, 1),
                                     (2, 64, 96, 13)])
def test_ffn_block_kernel_matches_plain(dev, dtype, b, d, f, t):
    gen = torch.Generator(device=dev).manual_seed(d + t)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    args = (randn(b, d, t).to(dtype), randn(b, d, t).to(dtype),
            randn(d, f, std=0.1).to(dtype), randn(f, std=0.1),
            randn(f, d, std=0.1).to(dtype), randn(d, std=0.1),
            1.0 + randn(d, std=0.1), randn(d, std=0.1),
            1.0 + randn(d, std=0.1), randn(d, std=0.1))
    _close(fused_ffn.ffn_block_fwd(*args),
           fused_ffn.ffn_block_fwd_plain(*args), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_append_kernel_is_exact_and_in_place(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    l_dim, g, h, dh, m_cap = 3, 6, 4, 7, 130
    k = torch.randn(l_dim, g, h, dh, m_cap, generator=gen, device=dev).to(dtype)
    v = torch.randn(l_dim, g, h, dh, m_cap, generator=gen, device=dev).to(dtype)
    k_self = torch.randn(l_dim, g, h, dh, generator=gen, device=dev)
    v_self = torch.randn(l_dim, g, h, dh, generator=gen, device=dev)
    length = torch.tensor([0, 129, m_cap, m_cap + 5, -1, 64], dtype=torch.int32,
                          device=dev)
    advance = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.bool, device=dev)
    kk, vk, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
    out_k, out_v = layout.cache_append(kk, vk, k_self, v_self, length, advance)
    layout.cache_append_plain(kp, vp, k_self, v_self, length, advance)
    torch.cuda.synchronize()
    assert out_k is kk and out_v is vk
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
    assert torch.equal(kk[:, 2:], k[:, 2:])  # full, past-full, negative, idle


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l1,r,b,d,tb,heads,layer", [
    (7, 16, 10, 500, 128, 10, 3), (3, 4, 3, 32, 8, 2, 0), (4, 3, 2, 72, 40, 4, 3)])
def test_project_mem_kv_kernel_matches_plain(dev, dtype, l1, r, b, d, tb, heads,
                                             layer):
    gen = torch.Generator(device=dev).manual_seed(d + tb)
    mem = torch.randn(l1, r, b, d, tb, generator=gen, device=dev).to(dtype)
    wk, wv = (torch.randn(d, heads, d // heads, generator=gen, device=dev) * 0.05
              for _ in range(2))
    before = _build.LAUNCHES["project_mem_kv"]
    k, v = fa.project_mem_kv(mem, layer, wk, wv)
    assert _build.LAUNCHES["project_mem_kv"] == before + 1
    hd = heads * (d // heads)
    kp, vp = fa.project_mem_kv_plain(mem, layer, wk.reshape(d, hd).to(dtype),
                                     wv.reshape(d, hd).to(dtype))
    _close(k.reshape(kp.shape), kp, TOL[dtype])
    _close(v.reshape(vp.shape), vp, TOL[dtype])


def _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, count, head,
                        same_length):
    gen = torch.Generator(device=dev).manual_seed(count + 7 * head + t)
    dh = d_model // heads
    scale = dh ** -0.5

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    m_cap = r * tb
    q, k_win, v_win = (randn(b, heads, dh, t).to(dtype) for _ in range(3))
    k_mem, v_mem = (randn(b, r, heads, dh, tb).to(dtype) for _ in range(2))
    w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05), heads).to(dtype)
    rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                   randn(heads, dh, std=0.1), scale, dtype)
    psi = fa.ring_psi(fa.key_trig_basis(m_cap + t, d_model, dtype, dev), t,
                      count, head)
    return (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
            fa.query_trig_table(t, m_cap, d_model, dtype, dev), psi,
            fa.build_mask_bias(t, m_cap, count, head, same_length, device=dev),
            (torch.arange(b, device=dev) % 3 == 1).int(), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head,same_length", [
    (10, 10, 500, 128, 16, 128, 0, 0, True),
    (10, 10, 500, 128, 16, 128, 1024, 1024, True),
    (10, 10, 500, 128, 16, 128, 2048, 640, True),
    (3, 2, 32, 8, 4, 8, 16, 16, False),
    (2, 4, 128, 40, 3, 40, 120, 40, False),
    (2, 2, 64, 33, 2, 33, 33, 33, True)])
def test_rel_attention_mem_kernel_matches_plain(dev, dtype, b, heads, d_model,
                                                t, r, tb, count, head,
                                                same_length):
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, count,
                               head, same_length)
    before = _build.LAUNCHES["rel_attention_mem_fwd"]
    out = fa.rel_attention_mem_fwd(*args)
    assert _build.LAUNCHES["rel_attention_mem_fwd"] == before + 1
    _close(out, fa.rel_attention_mem_fwd_plain(*args), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_write_layer_kernel_is_exact_and_in_place(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape in ((7, 16, 10, 500, 128), (3, 4, 3, 31, 7)):
        buf = torch.randn(shape, generator=gen, device=dev).to(dtype)
        rows = torch.randn(shape[2:], generator=gen, device=dev).to(dtype)
        ref = buf.clone()
        layout.ring_write_layer_plain(ref, rows, 2, shape[1] - 1)
        out = layout.ring_write_layer(buf, rows, 2, shape[1] - 1)
        torch.cuda.synchronize()
        assert out is buf and torch.equal(buf, ref)


# the NLL kernels' shapes: the eval and training shapes, T, D and V off the
# 32- and 128-wide tiles (T = 11, 129; D = 32, 500, 1000; V = 50, 729, 1000),
# and a vocabulary past what the first design's shared memory held (D + V >
# 7,263)
NLL_SHAPES = [(3, 32, 11, 50), (2, 1000, 129, 1000), (4, 500, 129, 729),
              (2, 32, 129, 1000), (3, 1000, 11, 50), (2, 512, 40, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,t,v", [(10, 500, 128, 729)] + NLL_SHAPES)
def test_nll_kernel_matches_plain(dev, dtype, b, d, t, v):
    gen = torch.Generator(device=dev).manual_seed(t)
    hidden = torch.randn(b, d, t, generator=gen, device=dev).to(dtype)
    emb = torch.randn(v, d, generator=gen, device=dev) * 0.05
    bias = torch.randn(v, generator=gen, device=dev) * 0.1
    targets = torch.randint(0, v, (b, t), generator=gen, device=dev,
                            dtype=torch.int32)
    targets[0, t // 2:] = 0  # PAD
    targets[1, 0] = v + 3    # out of range: no logit is selected
    targets[1, 1] = v - 1    # the last vocabulary tile's last real row
    before = _build.LAUNCHES["nll_fwd"]
    nll = fused_nll.nll_fwd(hidden, emb, bias, targets)
    assert _build.LAUNCHES["nll_fwd"] == before + 1
    _close(nll, fused_nll.nll_fwd_plain(hidden, emb, bias, targets), 1e-4)
    saved = fused_nll.nll_fwd(hidden, emb, bias, targets, save=True)
    for ours, ref in zip(saved, fused_nll.nll_fwd_plain(hidden, emb, bias,
                                                        targets, save=True)):
        _close(ours, ref, 1e-4)
    again = fused_nll.nll_fwd(hidden, emb, bias, targets, save=True)
    torch.cuda.synchronize()
    assert torch.equal(saved[0], nll)  # save changes no bit of nll
    assert all(torch.equal(x, y) for x, y in zip(saved, again))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 2, 16, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.rel_attention_fwd(q, q, q, q, q, q, q, q, q, q, 0.25)
    # both tensor-core bodies stream their keys and take any T; the wide
    # one takes heads up to 256 wide: 320 is refused
    args, _ = _attention_args(dev, torch.float32, 1, 2, 640, 8, False)
    assert not fa.fwd_on_tensor_cores(320, args[5].shape[2])
    with pytest.raises(ValueError, match="head width"):
        fa.rel_attention_fwd(*args)
    x = torch.zeros(2, 32, 4, device=dev)
    o = x.transpose(1, 2).contiguous().transpose(1, 2)  # non-contiguous
    vec = torch.zeros(32, device=dev)
    with pytest.raises(ValueError):
        fused_ffn.ffn_block_fwd(x, o, torch.zeros(32, 48, device=dev),
                                torch.zeros(48, device=dev),
                                torch.zeros(48, 32, device=dev), *[vec] * 5)


def _close_scaled(ours, ref, tol, name=""):
    """Sums over many terms: rtol ``tol`` and atol ``tol`` of the largest
    reference magnitude."""
    torch.cuda.synchronize()
    ref = ref.float()
    torch.testing.assert_close(ours.float(), ref, rtol=tol,
                               atol=tol * max(float(ref.abs().max()), 1e-30),
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head,same_length", [
    (4, 10, 500, 128, 8, 128, 1024, 256, True),
    (3, 2, 32, 8, 4, 8, 16, 16, False),
    (2, 4, 128, 40, 3, 40, 120, 40, False)])
def test_rel_attention_mem_residual_matches_plain(dev, dtype, b, heads,
                                                  d_model, t, r, tb, count,
                                                  head, same_length):
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, count,
                               head, same_length)
    out, s_res, lse = fa.rel_attention_mem_fwd(*args, save=True)
    ref = fa.rel_attention_mem_fwd_plain(*args, save=True)
    _close(out, ref[0], TOL[dtype])
    # masked scores sit near NEG_INF in both; bf16 rounds phi, so a score
    # moves by a rounding flip of its position term
    live = ref[1] > -1e30
    assert torch.equal(live, s_res > -1e30)
    _close_scaled(s_res[live], ref[1][live], TOL[dtype], "S")
    _close_scaled(lse, ref[2], TOL[dtype], "lse")


def _attention_bwd_args(dev, dtype, b, heads, d_model, t, r, tb, count, head,
                        same_length, layer=1, l1=3):
    (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask, reset,
     scale) = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb,
                                  count, head, same_length)
    gen = torch.Generator(device=dev).manual_seed(b + t)
    mem = torch.randn(l1, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    out, s_res, lse = fa.rel_attention_mem_fwd_plain(
        q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask,
        reset, scale, save=True)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    return (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, layer, w_r,
            trig_a, psi, s_res, lse, out, dout, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head,same_length", [
    (4, 10, 500, 128, 8, 128, 1024, 256, True),
    (4, 10, 500, 128, 8, 128, 0, 0, True),
    (3, 2, 32, 8, 4, 8, 16, 16, False),
    (2, 4, 128, 40, 3, 40, 120, 40, False),
    (2, 2, 64, 33, 2, 33, 33, 33, True)])
def test_rel_attention_mem_bwd_kernel_matches_plain(dev, dtype, b, heads,
                                                    d_model, t, r, tb, count,
                                                    head, same_length):
    args = _attention_bwd_args(dev, dtype, b, heads, d_model, t, r, tb, count,
                               head, same_length)
    before = _build.LAUNCHES["rel_attention_mem_bwd"]
    ours = fa.rel_attention_mem_bwd(*args)
    assert _build.LAUNCHES["rel_attention_mem_bwd"] == before + 1
    ref = fa.rel_attention_mem_bwd_plain(*args)
    names = ("dq", "dk_win", "dv_win", "dWk", "dWv", "dW_r", "d r_w_bias",
             "d r_r_bias")
    for o, p, name in zip(ours, ref, names):
        assert o.shape == p.shape and o.dtype == p.dtype, name
        _close_scaled(o, p, TOL[dtype], name)
    again = fa.rel_attention_mem_bwd(*args)  # fixed-order sums: same bits
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,f,t", [(8, 500, 1000, 128), (3, 32, 48, 1),
                                     (2, 64, 96, 13)])
def test_ffn_block_bwd_kernel_matches_plain(dev, dtype, b, d, f, t):
    gen = torch.Generator(device=dev).manual_seed(d + t + 1)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    w1, w2 = randn(d, f, std=0.05).to(dtype), randn(f, d, std=0.05).to(dtype)
    b1, b2 = randn(f, std=0.1), randn(d, std=0.1)
    g1, be1, g2, be2 = (1.0 + randn(d, std=0.1), randn(d, std=0.1),
                        1.0 + randn(d, std=0.1), randn(d, std=0.1))
    fwd = (randn(b, d, t).to(dtype), randn(b, d, t).to(dtype), w1, b1, w2, b2,
           g1, be1, g2, be2)
    saved = fused_ffn.ffn_block_fwd(*fwd, save=True)
    for o, p in zip(saved, fused_ffn.ffn_block_fwd_plain(*fwd, save=True)):
        _close(o, p, TOL[dtype])
    _, norm1, norm2, h1, stats = fused_ffn.ffn_block_fwd_plain(*fwd, save=True)
    args = (w1, w2, g1, be1, g2, norm1, norm2, h1, stats,
            randn(b, d, t).to(dtype))
    before = _build.LAUNCHES["ffn_block_bwd"]
    ours = fused_ffn.ffn_block_bwd(*args)
    assert _build.LAUNCHES["ffn_block_bwd"] == before + 1
    assert ours[1] is ours[0]  # without dropout do is dx itself
    names = ("dx", "do", "dW1", "db1", "dW2", "db2", "dg1", "dbe1", "dg2",
             "dbe2")
    for o, p, name in zip(ours, fused_ffn.ffn_block_bwd_plain(*args), names):
        assert o.shape == p.shape and o.dtype == p.dtype, name
        _close_scaled(o, p, TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,t,v", [(16, 500, 128, 729)] + NLL_SHAPES)
def test_nll_bwd_kernel_matches_plain(dev, dtype, b, d, t, v):
    gen = torch.Generator(device=dev).manual_seed(t + 1)
    hidden = torch.randn(b, d, t, generator=gen, device=dev).to(dtype)
    emb = torch.randn(v, d, generator=gen, device=dev) * 0.05
    bias = torch.randn(v, generator=gen, device=dev) * 0.1
    targets = torch.randint(0, v, (b, t), generator=gen, device=dev,
                            dtype=torch.int32)
    targets[0, t // 2:] = 0  # PAD: the loss gives them no cotangent
    targets[1, 0] = v + 3    # out of range: no logit is selected
    targets[1, 1] = v - 1    # the last vocabulary tile's last real row
    nll, lse = fused_nll.nll_fwd(hidden, emb, bias, targets, save=True)
    ref_nll, ref_lse = fused_nll.nll_fwd_plain(hidden, emb, bias, targets,
                                               save=True)
    _close(nll, ref_nll, 1e-4)
    _close(lse, ref_lse, 1e-4)
    dnll = torch.randn(b, t, generator=gen, device=dev)
    dnll[0, t // 2:] = 0.0
    args = (hidden, emb, bias, targets, ref_lse, dnll)
    before = _build.LAUNCHES["nll_bwd"]
    ours = fused_nll.nll_bwd(*args)
    assert _build.LAUNCHES["nll_bwd"] == before + 1
    for o, p, name in zip(ours, fused_nll.nll_bwd_plain(*args),
                          ("dh", "d(emb)", "d(bias)")):
        assert o.shape == p.shape and o.dtype == p.dtype, name
        _close_scaled(o, p, TOL[dtype] if name == "dh" else 1e-4, name)
    again = fused_nll.nll_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,t,v", [(32, 500, 128, 729), (3, 32, 11, 50)])
def test_embed_grad_kernel_matches_plain(dev, dtype, b, d, t, v):
    from commu_tpu_torch.ops import embed

    gen = torch.Generator(device=dev).manual_seed(d + t)
    tokens = torch.randint(0, v, (b, t), generator=gen, device=dev,
                           dtype=torch.int32)
    tokens[0, :5] = 0   # PAD inputs count
    tokens[1, :] = 7    # one token many times
    g = torch.randn(b, d, t, generator=gen, device=dev).to(dtype)
    before = _build.LAUNCHES["embed_grad"]
    ours = embed.embed_grad(tokens, g, d ** 0.5, v)
    assert _build.LAUNCHES["embed_grad"] == before + 1
    _close_scaled(ours, embed.embed_grad_plain(tokens, g, d ** 0.5, v), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_grad_kernel_on_a_skewed_batch_is_deterministic(dev, dtype):
    """90% of the positions one token (spread over many chunks), a token
    with no hit (zeros), a token outside [0, V) (adds to no row), and a
    rerun that gives the same bits."""
    from commu_tpu_torch.ops import embed

    gen = torch.Generator(device=dev).manual_seed(90)
    b, d, t, v = 64, 500, 128, 729
    tokens = torch.randint(1, v, (b, t), generator=gen, device=dev,
                           dtype=torch.int32)
    hot = torch.rand(b, t, generator=gen, device=dev) < 0.9
    tokens[hot] = 3
    tokens[tokens == 11] = 12  # 11 has no hit
    g = torch.randn(b, d, t, generator=gen, device=dev).to(dtype)
    ours = embed.embed_grad(tokens, g, d ** 0.5, v)
    again = embed.embed_grad(tokens, g, d ** 0.5, v)
    ref = embed.embed_grad_plain(tokens, g, d ** 0.5, v)
    torch.cuda.synchronize()
    assert torch.equal(ours, again)
    assert not bool(ours[11].any())
    _close_scaled(ours, ref, 1e-4)
    tokens[0, 0] = v + 5
    shifted = embed.embed_grad(tokens, g, d ** 0.5, v)
    ref = embed.embed_grad_plain(tokens.clamp(max=v - 1), g, d ** 0.5, v)
    ref[v - 1] -= g[0, :, 0].float() * d ** 0.5
    _close_scaled(shifted, ref, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l1,r,b,layer", [(7, 16, 10, 3), (3, 8, 256, 2)])
def test_project_mem_kv_kernel_is_deterministic_and_leaves_the_ring(
        dev, dtype, l1, r, b, layer):
    """At the eval shape (B = 10, R = 16) and a training layer (B = 256,
    R = 8): against the twin, the same bits on a rerun, the ring untouched."""
    d, heads, tb = 500, 10, 128
    gen = torch.Generator(device=dev).manual_seed(r + b)
    mem = torch.randn(l1, r, b, d, tb, generator=gen, device=dev).to(dtype)
    before = mem.clone()
    wk, wv = (torch.randn(d, heads, d // heads, generator=gen, device=dev)
              * 0.05 for _ in range(2))
    k, v = fa.project_mem_kv(mem, layer, wk, wv)
    k2, v2 = fa.project_mem_kv(mem, layer, wk, wv)
    torch.cuda.synchronize()
    assert torch.equal(k, k2) and torch.equal(v, v2)
    assert torch.equal(mem, before)
    kp, vp = fa.project_mem_kv_plain(mem, layer, wk.reshape(d, d).to(dtype),
                                     wv.reshape(d, d).to(dtype))
    _close(k.reshape(kp.shape), kp, TOL[dtype])
    _close(v.reshape(vp.shape), vp, TOL[dtype])


# ---- dropout: the in-kernel hash against ops.prng.keep_mask ----------------
# shapes by the branch of the mask plane they take (columns split, rows
# split, no split); seeds near 2^31 wrap the int32 row sums

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("b,d,t", [(256, 500, 128), (3, 6, 256), (4, 7, 9),
                                   (2, 33, 1)])
def test_dropout_bdt_kernel_is_exact(dev, dtype, p, b, d, t):
    gen = torch.Generator(device=dev).manual_seed(b + d + t)
    x = torch.randn(b, d, t, generator=gen, device=dev).to(dtype)
    g = torch.randn(b, d, t, generator=gen, device=dev).to(dtype)
    for seed, salt in ((12345, dropout.SALT_EMB),
                       (2 ** 31 - 3, dropout.SALT_OUT)):
        leaf = x.clone().requires_grad_(True)
        before = _build.LAUNCHES["dropout_bdt"]
        y = dropout.dropout_bdt(leaf, seed, p, salt)
        y.backward(g)
        assert _build.LAUNCHES["dropout_bdt"] == before + 2
        torch.cuda.synchronize()
        assert torch.equal(y.detach(), dropout.dropout_bdt_plain(x, seed, p,
                                                                 salt))
        assert torch.equal(leaf.grad, dropout.dropout_bdt_plain(g, seed, p,
                                                                salt))
    keep = dropout.dropout_bdt_apply(torch.ones_like(x), 7, p, 5) != 0
    want = prng.keep_mask(prng.row_seeds(7, b, 16384, 5 * 512, device=dev),
                          (d, t), p)
    assert torch.equal(keep, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("b,d,f,t", [(8, 500, 1000, 128), (2, 8, 12, 256),
                                     (2, 7, 9, 5), (3, 32, 48, 1)])
def test_ffn_block_dropout_kernels_match_plain(dev, dtype, p, b, d, f, t):
    gen = torch.Generator(device=dev).manual_seed(d + t + 2)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    w1, w2 = randn(d, f, std=0.05).to(dtype), randn(f, d, std=0.05).to(dtype)
    g1, be1, g2, be2 = (1.0 + randn(d, std=0.1), randn(d, std=0.1),
                        1.0 + randn(d, std=0.1), randn(d, std=0.1))
    fwd = (randn(b, d, t).to(dtype), randn(b, d, t).to(dtype), w1,
           randn(f, std=0.1), w2, randn(d, std=0.1), g1, be1, g2, be2)
    drop = dict(seed=2 ** 31 - 7 - 8192, dropout_p=p)
    saved = fused_ffn.ffn_block_fwd(*fwd, save=True, **drop)
    ref = fused_ffn.ffn_block_fwd_plain(*fwd, save=True, **drop)
    for o, r in zip(saved, ref):
        _close(o, r, TOL[dtype])
    _close(fused_ffn.ffn_block_fwd(*fwd, **drop), ref[0], TOL[dtype])
    args = (w1, w2, g1, be1, g2, *ref[1:], randn(b, d, t).to(dtype))
    ours = fused_ffn.ffn_block_bwd(*args, **drop)
    assert ours[1] is not ours[0]
    names = ("dx", "do", "dW1", "db1", "dW2", "db2", "dg1", "dbe1", "dg2",
             "dbe2")
    for o, r, name in zip(ours, fused_ffn.ffn_block_bwd_plain(*args, **drop),
                          names):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        _close_scaled(o, r, TOL[dtype], name)
    # do is dx under mask O, exactly
    keep_o = prng.keep_mask(prng.row_seeds(drop["seed"], b, 8192, 0,
                                           device=dev), (d, t), p)
    assert torch.equal(ours[1] != 0, keep_o & (ours[0] != 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head,same_length", [
    (4, 10, 500, 128, 8, 128, 1024, 256, False),
    (3, 2, 32, 8, 4, 8, 16, 16, True),
    (2, 4, 128, 64, 3, 64, 192, 64, False),
    (2, 2, 64, 33, 2, 33, 33, 33, True)])
def test_rel_attention_mem_dropout_kernels_match_plain(
        dev, dtype, p, b, heads, d_model, t, r, tb, count, head, same_length):
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, count,
                               head, same_length)
    drop = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p)
    out, s_res, lse = fa.rel_attention_mem_fwd(*args, save=True, **drop)
    ref = fa.rel_attention_mem_fwd_plain(*args, save=True, **drop)
    _close(out, ref[0], TOL[dtype])
    _close(fa.rel_attention_mem_fwd(*args, **drop), ref[0], TOL[dtype])
    clean = fa.rel_attention_mem_fwd(*args, save=True)
    torch.cuda.synchronize()
    # the residual holds no mask: S and lse are those of the clean forward
    assert torch.equal(s_res, clean[1]) and torch.equal(lse, clean[2])
    assert not torch.equal(out, clean[0])

    (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, _, _,
     scale) = args
    gen = torch.Generator(device=dev).manual_seed(b + t)
    mem = torch.randn(3, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    bwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, 1, w_r, trig_a,
           psi, ref[1], ref[2], ref[0], dout, scale)
    ours = fa.rel_attention_mem_bwd(*bwd, **drop)
    names = ("dq", "dk_win", "dv_win", "dWk", "dWv", "dW_r", "d r_w_bias",
             "d r_r_bias")
    for o, pl, name in zip(ours, fa.rel_attention_mem_bwd_plain(*bwd, **drop),
                           names):
        assert o.shape == pl.shape and o.dtype == pl.dtype, name
        _close_scaled(o, pl, TOL[dtype], name)
    again = fa.rel_attention_mem_bwd(*bwd, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,d_model,t", [
    (3, 10, 500, 9), (2, 2, 32, 16), (2, 4, 128, 256)])
def test_rel_attention_dropout_kernel_matches_plain(dev, dtype, b, heads,
                                                    d_model, t):
    gen = torch.Generator(device=dev).manual_seed(t + 1)
    dh = d_model // heads
    scale = dh ** -0.5

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    q, k, v = (randn(b, heads, dh, t).to(dtype) for _ in range(3))
    w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05), heads).to(dtype)
    rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                   randn(heads, dh, std=0.1), scale, dtype)
    args = (q, rwbs, rrbs, k, v, w_r,
            fa.query_trig_table(t, 0, d_model, dtype, dev),
            fa.key_trig_basis(t, d_model, dtype, dev),
            fa.build_mask_bias(t, 0, 0, 0, False, device=dev),
            (torch.arange(b, device=dev) % 2).int(), scale)
    for p in (0.1, 0.5):
        _close(fa.rel_attention_fwd(*args, seed=991, dropout_p=p),
               fa.rel_attention_fwd_plain(*args, seed=991, dropout_p=p),
               TOL[dtype])


# ---- the no-memory backward, the projecting forward, the fused-o FFN form
# and the stacked ring write ----------------------------------------------------

def _attention_args(dev, dtype, b, heads, d_model, t, same_length):
    gen = torch.Generator(device=dev).manual_seed(3 * t + b)
    dh = d_model // heads
    scale = dh ** -0.5

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    q, k, v = (randn(b, heads, dh, t).to(dtype) for _ in range(3))
    w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05), heads).to(dtype)
    rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                   randn(heads, dh, std=0.1), scale, dtype)
    dout = randn(b, heads, dh, t).to(dtype)
    return (q, rwbs, rrbs, k, v, w_r,
            fa.query_trig_table(t, 0, d_model, dtype, dev),
            fa.key_trig_basis(t, d_model, dtype, dev),
            fa.build_mask_bias(t, 0, 0, 0, same_length, device=dev),
            (torch.arange(b, device=dev) % 3 == 1).int(), scale), dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,heads,d_model,t,same_length", [
    (4, 10, 500, 128, False), (3, 2, 32, 8, True), (2, 4, 128, 40, False),
    (2, 2, 64, 33, True), (2, 2, 32, 17, False), (2, 4, 128, 256, False),
    (2, 10, 500, 512, False)])
def test_rel_attention_residual_and_bwd_kernels_match_plain(
        dev, dtype, p, b, heads, d_model, t, same_length):
    """T across and off the tiles of both passes (8, 17, 33, 40, 128, 256)
    and past the first forward design's shared memory (512, the window of
    ``train.tgt_length=512``), head widths 16, 32 and 50, every split of the
    mask's plane."""
    args, dout = _attention_args(dev, dtype, b, heads, d_model, t,
                                 same_length)
    drop = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p)
    before = dict(_build.LAUNCHES)
    out, s_res, lse = fa.rel_attention_fwd(*args, save=True, **drop)
    ref = fa.rel_attention_fwd_plain(*args, save=True, **drop)
    _close(out, ref[0], TOL[dtype])
    live = ref[1] > -1e30
    assert torch.equal(live, s_res > -1e30)
    _close_scaled(s_res[live], ref[1][live], TOL[dtype], "S")
    _close_scaled(lse, ref[2], TOL[dtype], "lse")
    # the same output without the residual
    assert torch.equal(fa.rel_attention_fwd(*args, **drop), out)

    q, rwbs, rrbs, k, v, w_r, trig_a, psi, _, _, scale = args
    bwd = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, ref[1], ref[2], ref[0],
           dout, scale)
    ours = fa.rel_attention_bwd(*bwd, **drop)
    assert _build.LAUNCHES["rel_attention_fwd"] == \
        before["rel_attention_fwd"] + 2
    assert _build.LAUNCHES["rel_attention_bwd"] == \
        before["rel_attention_bwd"] + 1
    names = ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias")
    for o, pl, name in zip(ours, fa.rel_attention_bwd_plain(*bwd, **drop),
                           names):
        assert o.shape == pl.shape and o.dtype == pl.dtype, name
        _close_scaled(o, pl, TOL[dtype], name)
    again = fa.rel_attention_bwd(*bwd, **drop)  # fixed-order sums: same bits
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_runs_the_no_memory_kernels(dev, dtype):
    b, heads, d_model, t = 3, 2, 32, 19
    (q, _, _, k, v, w_r, _, psi, _, reset, scale), dout = _attention_args(
        dev, dtype, b, heads, d_model, t, False)
    rwb = torch.randn(heads, d_model // heads, device=dev) * 0.1
    rrb = torch.randn(heads, d_model // heads, device=dev) * 0.1

    def run(device):
        leaves = [x.to(device).clone().requires_grad_(True)
                  for x in (q, k, v, w_r, rwb, rrb)]
        out = fa.attention(*leaves[:4], psi.to(device), *leaves[4:],
                           reset.bool().to(device), d_model=d_model,
                           scale=scale, same_length=True, dropout_p=0.1,
                           dropout_seed=77, train=True)
        out.backward(dout.to(device))
        return [out.detach()] + [x.grad for x in leaves]

    before = dict(_build.LAUNCHES)
    ours = run(dev)
    assert _build.LAUNCHES["rel_attention_fwd"] == \
        before["rel_attention_fwd"] + 1
    assert _build.LAUNCHES["rel_attention_bwd"] == \
        before["rel_attention_bwd"] + 1
    for o, r in zip(ours, run("cpu")):
        _close_scaled(o.cpu(), r, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head,same_length", [
    (4, 10, 500, 128, 8, 128, 1024, 256, False),
    (10, 10, 500, 128, 16, 128, 2048, 640, True),
    (3, 2, 32, 8, 4, 8, 16, 16, True),
    (2, 4, 128, 40, 3, 40, 120, 40, False),
    (2, 2, 64, 33, 2, 33, 33, 33, True),
    (2, 3, 48, 70, 2, 70, 140, 0, False),
    (2, 10, 500, 11, 4, 11, 44, 22, True),
    (2, 10, 500, 200, 2, 200, 400, 200, False),
    (2, 3, 150, 64, 2, 64, 128, 64, True),
    (10, 10, 500, 128, 16, 128, 2048, 640, True),
    (2, 12, 600, 40, 2, 40, 80, 40, False)])
def test_rel_attention_proj_fwd_kernel_matches_plain_and_the_two_kernels(
        dev, dtype, p, b, heads, d_model, t, r, tb, count, head, same_length):
    """Against its twin, and against ``project_mem_kv`` followed by
    ``rel_attention_mem_fwd`` at the same tolerance; two runs give the same
    bits.  Ragged projection tiles (D = 32, 48, 150; Tb = 8, 11, 33, 40,
    70), head widths 16, 32 and 50 (heads 3 and 10 at 50: odd heads' columns
    of Wk start off 16 bytes), T = 11 (one 16-row group of the first query
    tile) and 200 (four query tiles), the eval shape (B = 10, 16 slabs), and
    2F = 600 (12 heads of 50), past the narrow body's widths, on the wide
    form."""
    (q, rwbs, rrbs, _, k_win, _, v_win, w_r, trig_a, psi, mask, reset,
     scale) = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb,
                                  count, head, same_length)
    gen = torch.Generator(device=dev).manual_seed(b + tb)
    l1, layer = 3, 2
    mem = torch.randn(l1, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    dh = d_model // heads
    wk3, wv3 = (torch.randn(d_model, heads, dh, generator=gen, device=dev)
                * 0.05 for _ in range(2))
    drop = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p)
    tail = (k_win, v_win, w_r, trig_a, psi, mask, reset, scale)
    before = dict(_build.LAUNCHES)
    out, k_mem, v_mem, s_res, lse = fa.rel_attention_proj_fwd(
        q, rwbs, rrbs, mem, layer, wk3, wv3, *tail, save=True, **drop)
    assert _build.LAUNCHES["rel_attention_proj_fwd"] == \
        before["rel_attention_proj_fwd"] + 1
    assert _build.LAUNCHES["project_mem_kv"] == before["project_mem_kv"]
    wk, wv = (w.reshape(d_model, heads * dh).to(dtype) for w in (wk3, wv3))
    ref = fa.rel_attention_proj_fwd_plain(q, rwbs, rrbs, mem, layer, wk, wv,
                                          *tail, save=True, **drop)
    _close(out, ref[0], TOL[dtype])
    _close(k_mem, ref[1], TOL[dtype])
    _close(v_mem, ref[2], TOL[dtype])
    live = ref[3] > -1e30
    assert torch.equal(live, s_res > -1e30)
    _close_scaled(s_res[live], ref[3][live], TOL[dtype], "S")
    _close_scaled(lse, ref[4], TOL[dtype], "lse")

    k2, v2 = fa.project_mem_kv(mem, layer, wk3, wv3)
    two = fa.rel_attention_mem_fwd(q, rwbs, rrbs, k2, k_win, v2, v_win, w_r,
                                   trig_a, psi, mask, reset, scale, save=True,
                                   **drop)
    short = fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem, layer, wk3, wv3,
                                      *tail, **drop)
    _close(k_mem, k2, TOL[dtype])
    _close(v_mem, v2, TOL[dtype])
    _close(out, two[0], TOL[dtype])
    _close_scaled(s_res[live], two[1][live], TOL[dtype], "S")
    _close_scaled(lse, two[2], TOL[dtype], "lse")
    assert len(short) == 3 and torch.equal(short[0], out)
    again = fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem, layer, wk3, wv3,
                                      *tail, save=True, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in
               zip((out, k_mem, v_mem, s_res, lse), again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,d,f,t,hd", [
    (8, 500, 1000, 128, 500), (3, 32, 48, 1, 32), (2, 64, 96, 13, 60),
    (2, 16, 8, 5, 24), (2, 7, 9, 256, 6), (2, 500, 1000, 512, 500),
    (2, 500, 1000, 33, 640)])
def test_ffn_block_fused_o_kernels_match_plain(dev, dtype, p, b, d, f, t, hd):
    """The ``wo`` form of both kernels: HD equal to D, below it, above F,
    above D (640 at D = 500), and T = 512."""
    gen = torch.Generator(device=dev).manual_seed(d + t + hd)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    w1, w2 = randn(d, f, std=0.05).to(dtype), randn(f, d, std=0.05).to(dtype)
    wo = randn(hd, d, std=0.1).to(dtype)
    g1, be1, g2, be2 = (1.0 + randn(d, std=0.1), randn(d, std=0.1),
                        1.0 + randn(d, std=0.1), randn(d, std=0.1))
    vec = randn(b, hd, t).to(dtype)
    fwd = (randn(b, d, t).to(dtype), vec, w1, randn(f, std=0.1), w2,
           randn(d, std=0.1), g1, be1, g2, be2)
    drop = dict(seed=2 ** 31 - 7 - 8192, dropout_p=p)
    before = dict(_build.LAUNCHES)
    saved = fused_ffn.ffn_block_fwd(*fwd, save=True, wo=wo, **drop)
    ref = fused_ffn.ffn_block_fwd_plain(*fwd, save=True, wo=wo, **drop)
    for o, r in zip(saved, ref):
        _close(o, r, TOL[dtype])
    _close(fused_ffn.ffn_block_fwd(*fwd, wo=wo, **drop), ref[0], TOL[dtype])
    args = (w1, w2, g1, be1, g2, *ref[1:], randn(b, d, t).to(dtype))
    ours = fused_ffn.ffn_block_bwd(*args, vec=vec, wo=wo, **drop)
    assert _build.LAUNCHES["ffn_block_fused_o_fwd"] == \
        before["ffn_block_fused_o_fwd"] + 2
    assert _build.LAUNCHES["ffn_block_fused_o_bwd"] == \
        before["ffn_block_fused_o_bwd"] + 1
    assert _build.LAUNCHES["ffn_block_fwd"] == before["ffn_block_fwd"]
    assert _build.LAUNCHES["ffn_block_bwd"] == before["ffn_block_bwd"]
    names = ("dx", "dvec", "dW1", "db1", "dW2", "db2", "dg1", "dbe1", "dg2",
             "dbe2", "dWo")
    theirs = fused_ffn.ffn_block_bwd_plain(*args, vec=vec, wo=wo, **drop)
    assert len(ours) == len(theirs) == len(names)
    for o, r, name in zip(ours, theirs, names):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        _close_scaled(o, r, TOL[dtype], name)
    again = fused_ffn.ffn_block_bwd(*args, vec=vec, wo=wo, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,f,t,hd", [(2, 1024, 12288, 24, 1024),
                                        (1, 512, 16384, 8, 512)])
def test_ffn_block_fused_o_at_widths_past_a_blocks_shared_memory(
        dev, dtype, b, d, f, t, hd):
    """Widths whose four token columns of the first design did not fit a
    block's shared memory (D = 1,024 with F = 12,288; F = 16,384), which
    the ``wo`` form refused: both forms of both kernels run them, the tiles
    streaming the depth.  y and the saved outputs sum 12,288-16,384 terms
    on the tensor cores, each depth step added into the f32 sums in
    round-to-nearest (before, the sums stayed in the mma accumulator and
    drifted 3e-4 from the twin at F = 16,384 for y of magnitude 4, held at
    1e-4), so every output is held at tol x max|ref| + tol x |ref|, tol
    1e-5 in f32, as the backward's sums are."""
    tol = 1e-5 if dtype == torch.float32 else TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(d + f)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    w1, w2 = randn(d, f, std=0.05).to(dtype), randn(f, d, std=0.05).to(dtype)
    wo = randn(hd, d, std=0.1).to(dtype)
    vecs = (1.0 + randn(d, std=0.1), randn(d, std=0.1),
            1.0 + randn(d, std=0.1), randn(d, std=0.1))
    x, vec, dy = (randn(b, n, t).to(dtype) for n in (d, hd, d))
    fwd = (x, vec, w1, randn(f, std=0.1), w2, randn(d, std=0.1), *vecs)
    o = torch.matmul(wo.t().float(), vec.float()).to(dtype)
    for wo_, fwd_ in ((wo, fwd), (None, (x, o, *fwd[2:]))):
        saved = fused_ffn.ffn_block_fwd(*fwd_, save=True, wo=wo_)
        ref = fused_ffn.ffn_block_fwd_plain(*fwd_, save=True, wo=wo_)
        for ours, r in zip(saved, ref):
            _close_scaled(ours, r, tol)
        args = (w1, w2, vecs[0], vecs[1], vecs[2], *ref[1:], dy)
        extra = dict(vec=vec, wo=wo) if wo_ is not None else {}
        for ours, r in zip(fused_ffn.ffn_block_bwd(*args, **extra),
                           fused_ffn.ffn_block_bwd_plain(*args, **extra)):
            _close_scaled(ours, r, tol)


def _sums_call(name, *args):
    """One of ``csrc/sums.cu``'s entry points on the current stream."""
    err = getattr(_build.library(), f"commu_{name}")(
        *args, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"{name}: CUDA error {err}"


def _meets_f64(ours, ref, name):
    """A deep f32 sum against the same sum in f64: within 2e-6 of max|ref|,
    and its mean error taken toward each reference value's sign (a sum that
    loses bits toward zero errs against it; a plain mean would not see that,
    the references having both signs) at most a quarter of its mean
    magnitude.  While the sums stayed in the mma accumulator that share was
    0.87 at these shapes; promoted each step it read 0.06-0.12, the
    truncation left inside each step's product (``chip_smoke.py --sums``)."""
    torch.cuda.synchronize()
    err = ours.double() - ref
    top = float(ref.abs().max())
    worst = float(err.abs().max())
    spread = float(err.abs().mean())
    toward = float((err * ref.sign()).mean())
    assert worst <= 2e-6 * top, \
        f"{name}: max abs err {worst:.3e}, max|ref| {top:.3e}"
    assert abs(toward) <= 0.25 * spread, \
        f"{name}: mean error toward the reference's sign {toward:.3e}, " \
        f"mean abs {spread:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["copy", "mma", "wg"])
@pytest.mark.parametrize("m,n,rows,length", [
    (500, 1000, 256, 128),    # #8's dW1: B x T = 32,768 rows
    (500, 500, 256, 1024)])   # #4's dWk: B x M = 262,144 terms
def test_batch_sums_meet_f64(dev, form, m, n, rows, length):
    """reduce.cuh's two batch sums (``reduce_outer_copy``,
    ``reduce_outer_mma``) and wgmma_product.cuh's (``run_dw_sums``, #4's
    dWk / dWv form) in f32 at the depths of the weight gradients, against
    f64 (the bf16 sums stay in the mma accumulator)."""
    gen = torch.Generator(device=dev).manual_seed(m + n + length)
    a = torch.randn(rows, m, length, generator=gen, device=dev)
    b = torch.randn(rows, n, length, generator=gen, device=dev)
    out = torch.empty(m, n, device=dev)
    parts = (1,) if form == "wg" else ()  # the warpgroup form: one A
    nbytes = getattr(_build.library(), f"commu_sum_outer_{form}_workspace")(
        m, n, rows, length, *parts)
    scratch = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=dev)
    _sums_call(f"sum_outer_{form}", 0, a.data_ptr(), b.data_ptr(),
               out.data_ptr(), scratch.data_ptr(), m, n, rows, length, *parts)
    ref = torch.einsum("bmt,bnt->mn", a.double(), b.double())
    _meets_f64(out, ref, f"sum_outer_{form} {m}x{n} over {rows * length}")


@pytest.mark.cuda
def test_tile_product_at_depth_16384_meets_f64(dev):
    """mma_tile.cuh's tile (``tile_product_kernel``) in f32 over a depth of
    16,384, #9's deepest product, against f64."""
    gen = torch.Generator(device=dev).manual_seed(16384)
    kp, mm, tp, b = 16384, 256, 128, 2
    a = torch.randn(kp, mm, generator=gen, device=dev)
    x = torch.randn(b, kp, tp, generator=gen, device=dev)
    out = torch.empty(b, mm, tp, device=dev)
    nbytes = _build.library().commu_tile_product_workspace(0, kp, mm, tp, b)
    scratch = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=dev)
    _sums_call("tile_product", 0, a.data_ptr(), x.data_ptr(), out.data_ptr(),
               scratch.data_ptr(), kp, mm, tp, b)
    ref = torch.einsum("km,bkt->bmt", a.double(), x.double())
    _meets_f64(out, ref, "tile_product over 16,384")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", [
    ((7, 8, 6, 500, 128), 1), ((3, 4, 3, 31, 7), 1), ((3, 2, 5, 31, 7), 2),
    ((4, 3, 2, 16, 8), 0), ((2, 3, 4, 3, 9, 5), 2), ((5, 33, 1), 0)])
def test_ring_write_kernel_is_exact_and_in_place(dev, dtype, shape, axis):
    """Every slab index, the ring dimension first, in the middle and right
    before [D, T]; pieces that are and are not whole 16-byte words."""
    gen = torch.Generator(device=dev).manual_seed(len(shape) + axis)
    buf = torch.randn(shape, generator=gen, device=dev).to(dtype)
    rows_shape = shape[:axis] + shape[axis + 1:]
    before = _build.LAUNCHES["ring_write"]
    for block in range(shape[axis]):
        rows = torch.randn(rows_shape, generator=gen, device=dev).to(dtype)
        ref = buf.clone()
        layout.ring_write_plain(ref, rows, block, axis)
        out = layout.ring_write(buf, rows, block, axis)
        torch.cuda.synchronize()
        assert out is buf and torch.equal(buf, ref)
        assert torch.equal(buf.select(axis, block), rows)
    assert _build.LAUNCHES["ring_write"] == before + shape[axis]


@pytest.mark.cuda
def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    (q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset, scale), dout = \
        _attention_args(dev, torch.float32, 2, 2, 32, 8, False)
    out, s_res, lse = fa.rel_attention_fwd_plain(
        q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset, scale, save=True)
    bwd = [q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse, out, dout]
    with pytest.raises(ValueError):  # a residual of the wrong dtype
        fa.rel_attention_bwd(*bwd[:8], s_res.bfloat16(), *bwd[9:], scale)
    with pytest.raises(ValueError):  # a non-contiguous cotangent
        fa.rel_attention_bwd(*bwd[:11], dout.transpose(2, 3).contiguous()
                             .transpose(2, 3), scale)
    with pytest.raises(ValueError):  # operands on two devices
        fa.rel_attention_bwd(*bwd[:11], dout.cpu(), scale)
    wide = torch.zeros(2, 1, 320, 8, device=dev)  # head width 320 > 256
    with pytest.raises(ValueError):
        fa.rel_attention_bwd(
            wide, torch.zeros(1, 320, 1, device=dev),
            torch.zeros(1, 320, 1, device=dev), wide, wide,
            torch.zeros(1, 320, 256, device=dev),
            torch.zeros(8, 256, device=dev), torch.zeros(256, 8, device=dev),
            torch.zeros(2, 1, 8, 8, device=dev),
            torch.zeros(2, 1, 8, device=dev), wide, wide, 0.1)

    mem = torch.zeros(3, 2, 2, 32, 8, device=dev)
    wk3 = torch.zeros(32, 2, 16, device=dev)
    tail = (k, v, w_r, fa.query_trig_table(8, 16, 32, torch.float32, dev),
            fa.key_trig_basis(24, 32, torch.float32, dev),
            fa.build_mask_bias(8, 16, 16, 0, False, device=dev), reset, scale)
    with pytest.raises(ValueError):  # a layer outside the buffer
        fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem, 3, wk3, wk3, *tail)
    with pytest.raises(TypeError):  # the ring in another dtype than q
        fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem.bfloat16(), 1, wk3, wk3,
                                  *tail)
    with pytest.raises(ValueError):  # psi for another key length
        fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem, 1, wk3, wk3, k, v, w_r,
                                  tail[3], psi, *tail[5:])

    x = torch.zeros(2, 32, 4, device=dev)
    vecs = [torch.zeros(32, device=dev)] * 5
    ffn = (torch.zeros(32, 48, device=dev), torch.zeros(48, device=dev),
           torch.zeros(48, 32, device=dev), *vecs)
    with pytest.raises(ValueError):  # wo's rows are not vec's
        fused_ffn.ffn_block_fwd(x, torch.zeros(2, 20, 4, device=dev), *ffn,
                                wo=torch.zeros(24, 32, device=dev))
    with pytest.raises(ValueError):  # wo without vec
        fused_ffn.ffn_block_bwd(ffn[0], ffn[2], vecs[0], vecs[0], vecs[0], x,
                                x, torch.zeros(2, 48, 4, device=dev),
                                torch.zeros(2, 2, 4, device=dev), x,
                                wo=torch.zeros(24, 32, device=dev))

    buf = torch.zeros(3, 4, 2, 8, 8, device=dev)
    rows = torch.zeros(3, 2, 8, 8, device=dev)
    for bad in ((buf, rows, 4, 1), (buf, rows, 0, 2), (buf, rows, 0, 4),
                (buf, rows.bfloat16(), 0, 1),
                (buf, rows.transpose(0, 1).contiguous().transpose(0, 1), 0,
                 1)):
        with pytest.raises(ValueError):
            layout.ring_write(*bad)
    assert float(buf.abs().sum()) == 0.0


# ---- the fast numerics: 8-bit draws, the int8 BD forward, the int8 dphi
# backward ------------------------------------------------------------------

def _close_int8(ours, ref, tol, name=""):
    """An int8 form against its twin.  The integer sum is exact on both
    sides, but the kernel's float operand (phi, ds) differs from the twin's
    in its last bits, so a value that sits on a rounding tie quantises one
    step apart: all but 2 in 1000 elements (or 8, in a small tensor of sums)
    agree to ``tol`` (rtol, and atol of the largest reference magnitude), and
    none is further off than max(20 tol, 5e-3) of that magnitude."""
    torch.cuda.synchronize()
    ref = ref.float()
    top = max(float(ref.abs().max()), 1e-30)
    err = (ours.float() - ref).abs()
    off = err > tol * (top + ref.abs())
    assert int(off.sum()) <= max(2e-3 * off.numel(), 8), (name, int(off.sum()))
    assert float(err.max()) <= max(20 * tol, 5e-3) * top, (name,
                                                            float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.1, 0.996])
@pytest.mark.parametrize("d,t,branch", [
    (128, 1024, (0, 256, 8)), (500, 128, (1, 125, 8)), (128, 1152, (1, 32, 8)),
    (6, 256, (0, 128, 16)), (6, 1152, (1, 3, 16)), (125, 128, (2, 0, 16))])
def test_eight_bit_masks_in_kernel_equal_keep_mask(dev, p, d, t, branch):
    """Every geometry branch of the 8-bit draw, through the dropout kernel:
    the in-kernel hash (prng.cuh) against ops.prng.keep_mask, bit for bit."""
    assert prng.draw_geometry(d, t, 8) == branch
    b = 5
    x = torch.ones(b, d, t, device=dev)
    for seed in (7, 2 ** 31 - 3):
        before = _build.LAUNCHES["dropout_bdt[bits8]"]
        y = dropout.dropout_bdt_apply(x, seed, p, 5, bits=8)
        assert _build.LAUNCHES["dropout_bdt[bits8]"] == before + 1
        want = prng.keep_mask(prng.row_seeds(seed, b, 16384, 5 * 512,
                                             device=dev), (d, t), p, bits=8)
        torch.cuda.synchronize()
        assert torch.equal(y != 0, want)
        assert torch.equal(y, dropout.dropout_bdt_plain(x, seed, p, 5, 8))
    if p == 0.1 and d * t >= 2 ** 14:
        assert abs(float(want.float().mean()) - (1 - 26 / 256)) < 3e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,f,t", [(8, 500, 1000, 128), (2, 8, 12, 1024),
                                     (2, 7, 9, 5)])
def test_ffn_block_kernels_at_8_bits_match_plain(dev, dtype, b, d, f, t):
    gen = torch.Generator(device=dev).manual_seed(d + t + 3)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    w1, w2 = randn(d, f, std=0.05).to(dtype), randn(f, d, std=0.05).to(dtype)
    g1, be1, g2, be2 = (1.0 + randn(d, std=0.1), randn(d, std=0.1),
                        1.0 + randn(d, std=0.1), randn(d, std=0.1))
    fwd = (randn(b, d, t).to(dtype), randn(b, d, t).to(dtype), w1,
           randn(f, std=0.1), w2, randn(d, std=0.1), g1, be1, g2, be2)
    drop = dict(seed=2 ** 31 - 7 - 8192, dropout_p=0.1, bits=8)
    before = dict(_build.LAUNCHES)
    saved = fused_ffn.ffn_block_fwd(*fwd, save=True, **drop)
    ref = fused_ffn.ffn_block_fwd_plain(*fwd, save=True, **drop)
    for o, r in zip(saved, ref):
        _close(o, r, TOL[dtype])
    wide = fused_ffn.ffn_block_fwd_plain(*fwd, seed=drop["seed"],
                                         dropout_p=0.1, bits=16)
    assert not torch.equal(ref[0], wide)  # other masks than at 16 bits
    args = (w1, w2, g1, be1, g2, *ref[1:], randn(b, d, t).to(dtype))
    ours = fused_ffn.ffn_block_bwd(*args, **drop)
    assert _build.LAUNCHES["ffn_block_fwd[bits8]"] == \
        before["ffn_block_fwd[bits8]"] + 1
    assert _build.LAUNCHES["ffn_block_bwd[bits8]"] == \
        before["ffn_block_bwd[bits8]"] + 1
    for o, r in zip(ours, fused_ffn.ffn_block_bwd_plain(*args, **drop)):
        _close_scaled(o, r, TOL[dtype])
    keep_o = prng.keep_mask(prng.row_seeds(drop["seed"], b, 8192, 0,
                                           device=dev), (d, t), 0.1, bits=8)
    assert torch.equal(ours[1] != 0, keep_o & (ours[0] != 0))


def _ffn_bwd_args(dev, dtype, b, d, f, t, drop, seed):
    """The backward's operands from the plain forward's save outputs."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    w1, w2 = randn(d, f, std=0.05).to(dtype), randn(f, d, std=0.05).to(dtype)
    g1, be1, g2, be2 = (1.0 + randn(d, std=0.1), randn(d, std=0.1),
                        1.0 + randn(d, std=0.1), randn(d, std=0.1))
    fwd = (randn(b, d, t).to(dtype), randn(b, d, t).to(dtype), w1,
           randn(f, std=0.1), w2, randn(d, std=0.1), g1, be1, g2, be2)
    ref = fused_ffn.ffn_block_fwd_plain(*fwd, save=True, **drop)
    return (w1, w2, g1, be1, g2, *ref[1:], randn(b, d, t).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
@pytest.mark.parametrize("b,d,f,t", [(2, 200, 300, 37), (3, 130, 257, 129)])
def test_ffn_block_bwd_kernel_at_tiles_wider_than_one(dev, dtype, p, bits, b,
                                                      d, f, t):
    """D and F wider than one 128-row tile and ragged in it, T past a
    32-column chunk (and past a 128-token tile): every output within
    tolerance of the twin, do under mask O."""
    drop = dict(seed=2 ** 31 - 7 - 8192, dropout_p=p, bits=bits)
    args = _ffn_bwd_args(dev, dtype, b, d, f, t, drop, d + f + t)
    ours = fused_ffn.ffn_block_bwd(*args, **drop)
    names = ("dx", "do", "dW1", "db1", "dW2", "db2", "dg1", "dbe1", "dg2",
             "dbe2")
    for o, r, name in zip(ours, fused_ffn.ffn_block_bwd_plain(*args, **drop),
                          names):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        _close_scaled(o, r, TOL[dtype], name)
    if p:
        keep_o = prng.keep_mask(prng.row_seeds(drop["seed"], b, 8192, 0,
                                               device=dev), (d, t), p,
                                bits=bits)
        assert torch.equal(ours[1] != 0, keep_o & (ours[0] != 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
def test_ffn_block_bwd_kernel_gives_the_same_bits_twice(dev, dtype, p, bits):
    """Fixed-order sums, no float atomics: a second run on the same inputs
    gives every output bit for bit."""
    drop = dict(seed=12345, dropout_p=p, bits=bits)
    args = _ffn_bwd_args(dev, dtype, 16, 500, 1000, 128, drop, 5)
    first = fused_ffn.ffn_block_bwd(*args, **drop)
    again = fused_ffn.ffn_block_bwd(*args, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (3, 4, 3, 31, 7)),    # 651 values: 1,302 bytes
    (torch.float32, (2, 3, 5, 9, 13)),     # 585 values: 2,340 bytes
    (torch.float32, (2, 3, 70, 500, 128)),  # 17.9 MB: > 4,096 x 256 x 16 bytes
    (torch.bfloat16, (3, 2, 140, 500, 128))])
def test_ring_write_layer_kernel_on_ragged_and_wide_slabs(dev, dtype, shape):
    """Slabs that are no whole number of 16-byte words and slabs wider than
    4,096 blocks of 256 threads of 16-byte words: bit-exact, in place, and
    every other slab untouched."""
    gen = torch.Generator(device=dev).manual_seed(shape[2])
    buf = torch.randn(shape, generator=gen, device=dev).to(dtype)
    before = buf.clone()
    rows = torch.randn(shape[2:], generator=gen, device=dev).to(dtype)
    layer, block = shape[0] - 1, shape[1] // 2
    out = layout.ring_write_layer(buf, rows, layer, block)
    torch.cuda.synchronize()
    assert out is buf and torch.equal(buf[layer, block], rows)
    others = torch.ones(shape[:2], dtype=torch.bool, device=dev)
    others[layer, block] = False
    assert torch.equal(buf[others], before[others])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head,same_length", [
    (4, 10, 500, 128, 8, 128, 1024, 256, True),
    (4, 10, 500, 128, 8, 128, 0, 0, True),
    (3, 2, 32, 8, 4, 8, 16, 16, False),
    (2, 4, 128, 40, 3, 40, 120, 40, False),
    (2, 2, 64, 33, 2, 33, 33, 33, True)])
def test_rel_attention_mem_int8_kernels_match_plain(
        dev, dtype, p, b, heads, d_model, t, r, tb, count, head, same_length):
    """The int8 BD forward and the int8 dphi backward over the memory, at 8
    bits of mask, against their twins; K = 99 is no multiple of 4."""
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, count,
                               head, same_length)
    psi = args[9]
    if p > 0.0:  # the positional dropout's scale takes psi above 1
        psi = psi * torch.tensor(1.0 / 0.9, dtype=dtype)
        args = args[:9] + (psi,) + args[10:]
    psi_q = fa.quantize_psi_int8(psi)
    mode = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=8, psi_q=psi_q)
    before = dict(_build.LAUNCHES)
    out, s_res, lse = fa.rel_attention_mem_fwd(*args, save=True, **mode)
    assert _build.LAUNCHES["rel_attention_mem_fwd[int8]"] == \
        before["rel_attention_mem_fwd[int8]"] + 1
    ref = fa.rel_attention_mem_fwd_plain(*args, save=True, **mode)
    exact = fa.rel_attention_mem_fwd_plain(*args, save=True, seed=mode["seed"],
                                           dropout_p=p, bits=8)
    _close_int8(out, ref[0], TOL[dtype], "out")
    live = ref[1] > -1e30
    assert torch.equal(live, s_res > -1e30)
    _close_int8(s_res[live], ref[1][live], TOL[dtype], "S")
    _close_int8(lse, ref[2], TOL[dtype], "lse")
    # it is the int8 form that ran: nearer its twin than the exact scores
    gap = (ref[1][live] - exact[1][live]).abs().mean()
    assert (s_res[live] - ref[1][live]).abs().mean() < 0.25 * gap
    assert torch.equal(fa.rel_attention_mem_fwd(*args, **mode), out)

    (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, _, _,
     scale) = args
    gen = torch.Generator(device=dev).manual_seed(b + t)
    mem = torch.randn(3, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    bwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, 1, w_r, trig_a,
           psi, ref[1], ref[2], ref[0], dout, scale)
    ours = fa.rel_attention_mem_bwd(*bwd, **mode)
    assert _build.LAUNCHES["rel_attention_mem_bwd[int8]"] == \
        before["rel_attention_mem_bwd[int8]"] + 1
    twin = fa.rel_attention_mem_bwd_plain(*bwd, **mode)
    float_form = fa.rel_attention_mem_bwd(*bwd, seed=mode["seed"],
                                          dropout_p=p, bits=8)
    names = ("dq", "dk_win", "dv_win", "dWk", "dWv", "dW_r", "d r_w_bias",
             "d r_r_bias")
    for o, pl, name in zip(ours, twin, names):
        assert o.shape == pl.shape and o.dtype == pl.dtype, name
        _close_int8(o, pl, TOL[dtype], name)
    torch.cuda.synchronize()
    # only dphi is quantised: dk, dv, dWk, dWv and d r_w_bias are the exact
    # form's, bit for bit; dW_r is not
    for i in (1, 2, 3, 4, 6):
        assert torch.equal(ours[i], float_form[i]), names[i]
    assert not torch.equal(ours[5], float_form[5])
    again = fa.rel_attention_mem_bwd(*bwd, **mode)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,heads,d_model,t,same_length", [
    (4, 10, 500, 128, False), (3, 2, 32, 8, True), (2, 2, 64, 33, True),
    (2, 4, 128, 256, False), (2, 10, 500, 512, False)])
def test_rel_attention_int8_kernels_match_plain(dev, dtype, p, b, heads,
                                                d_model, t, same_length):
    """The same two forms over the window alone, up to T = 512 (the window
    of ``train.tgt_length=512``, which only the tensor-core forward
    takes)."""
    args, dout = _attention_args(dev, dtype, b, heads, d_model, t,
                                 same_length)
    psi_q = fa.quantize_psi_int8(args[7])
    mode = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=8, psi_q=psi_q)
    before = dict(_build.LAUNCHES)
    out, s_res, lse = fa.rel_attention_fwd(*args, save=True, **mode)
    ref = fa.rel_attention_fwd_plain(*args, save=True, **mode)
    _close_int8(out, ref[0], TOL[dtype], "out")
    live = ref[1] > -1e30
    assert torch.equal(live, s_res > -1e30)
    _close_int8(s_res[live], ref[1][live], TOL[dtype], "S")
    _close_int8(lse, ref[2], TOL[dtype], "lse")
    q, rwbs, rrbs, k, v, w_r, trig_a, psi, _, _, scale = args
    bwd = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, ref[1], ref[2], ref[0],
           dout, scale)
    ours = fa.rel_attention_bwd(*bwd, **mode)
    assert _build.LAUNCHES["rel_attention_fwd[int8]"] == \
        before["rel_attention_fwd[int8]"] + 1
    assert _build.LAUNCHES["rel_attention_bwd[int8]"] == \
        before["rel_attention_bwd[int8]"] + 1
    float_form = fa.rel_attention_bwd(*bwd, seed=mode["seed"], dropout_p=p,
                                      bits=8)
    names = ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias")
    for o, pl, name in zip(ours, fa.rel_attention_bwd_plain(*bwd, **mode),
                           names):
        assert o.shape == pl.shape and o.dtype == pl.dtype, name
        _close_int8(o, pl, TOL[dtype], name)
    torch.cuda.synchronize()
    for i in (1, 2, 4):
        assert torch.equal(ours[i], float_form[i]), names[i]


@pytest.mark.cuda
def test_proj_fwd_refuses_the_int8_forward(dev, monkeypatch):
    args = _attention_mem_args(dev, torch.float32, 2, 2, 32, 8, 2, 8, 8, 8,
                               False)
    (q, rwbs, rrbs, _, k_win, _, v_win, w_r, trig_a, psi, mask, reset,
     scale) = args
    mem = torch.zeros(2, 2, 2, 32, 8, device=dev)
    wk3 = torch.zeros(32, 2, 16, device=dev)
    monkeypatch.setenv("COMMU_BD_INT8", "1")
    with pytest.raises(NotImplementedError):
        fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem, 0, wk3, wk3, k_win,
                                  v_win, w_r, trig_a, psi, mask, reset, scale)


# ---- the attention backwards' tensor-core passes at ragged shapes ----------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head", [
    (8, 10, 500, 45, 2, 33, 66, 33),   # dh 50, T 45, Tb 33: K 111
    (8, 4, 76, 23, 3, 33, 99, 40),     # dh 19 (no multiple of 8): K 122
    (8, 2, 44, 70, 1, 33, 20, 7)])     # dh 22, T 70 over the 64-query chunk
def test_attention_bwd_kernels_at_ragged_shapes(dev, dtype, form, p, b, heads,
                                                d_model, t, r, tb, count,
                                                head):
    """#4 over a ring of Tb = 33 slabs and #3 over the window alone, with
    head widths, T and K off the MMA tiles (16, 32 and 64) and the 64-key
    tiles of the row maxima, in the float and the int8 dphi form, with and
    without dropout: within the tolerance of the plain twins, two runs
    bit-equal, and the int8 form's dk, dv and content sums bit-equal to the
    float form's.  Eight batch rows: dW_r sums B x T terms, and one ds_q
    rounding tie that kernel and twin break apart moves a whole head's
    plane of it, by less the more terms it sums (the int8 tests above sum
    512)."""
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, count,
                               head, False)
    (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask,
     reset, scale) = args
    drop = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=8)
    mode = dict(drop, psi_q=fa.quantize_psi_int8(psi)) \
        if form == "int8" else drop
    close = _close_int8 if form == "int8" else _close_scaled
    gen = torch.Generator(device=dev).manual_seed(b + t)
    mem = torch.randn(3, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    out, s_res, lse = fa.rel_attention_mem_fwd_plain(*args, save=True, **drop)
    mem_bwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, 1, w_r, trig_a,
               psi, s_res, lse, out, dout, scale)
    win = fa.build_mask_bias(t, 0, 0, 0, False, device=dev)
    win_fwd = (q, rwbs, rrbs, k_win, v_win, w_r,
               fa.query_trig_table(t, 0, d_model, dtype, dev),
               fa.key_trig_basis(t, d_model, dtype, dev), win, reset, scale)
    if form == "int8":
        mode0 = dict(drop, psi_q=fa.quantize_psi_int8(win_fwd[7]))
    else:
        mode0 = drop
    out0, s0, lse0 = fa.rel_attention_fwd_plain(*win_fwd, save=True, **drop)
    win_bwd = win_fwd[:8] + (s0, lse0, out0, dout, scale)
    names_mem = ("dq", "dk_win", "dv_win", "dWk", "dWv", "dW_r", "d r_w_bias",
                 "d r_r_bias")
    names_win = ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias")
    for kernel, plain, bwd, kw, names, exact in (
            (fa.rel_attention_mem_bwd, fa.rel_attention_mem_bwd_plain,
             mem_bwd, mode, names_mem, (1, 2, 3, 4, 6)),
            (fa.rel_attention_bwd, fa.rel_attention_bwd_plain, win_bwd,
             mode0, names_win, (1, 2, 4))):
        ours = kernel(*bwd, **kw)
        for o, pl, name in zip(ours, plain(*bwd, **kw), names):
            assert o.shape == pl.shape and o.dtype == pl.dtype, name
            close(o, pl, TOL[dtype], f"{kernel.__name__} {name}")
        again = kernel(*bwd, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(ours, again))
        if form == "int8":
            float_form = kernel(*bwd, **drop)
            torch.cuda.synchronize()
            for i in exact:
                assert torch.equal(ours[i], float_form[i]), names[i]


# ---- the two forwards on the tensor cores at ragged shapes -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head", [
    (2, 10, 500, 1, 2, 33, 66, 33),    # dh 50, 2F 512, T 1: K 67
    (3, 10, 500, 11, 3, 40, 120, 40),  # T 11 (no whole 16-byte key group)
    (2, 4, 64, 33, 2, 33, 50, 10),     # dh 16, 2F 256: K 99
    (2, 2, 128, 129, 1, 64, 64, 0),    # dh 64, T 129 over three query blocks
    (2, 5, 250, 24, 3, 16, 48, 16)])   # whole 16-byte key groups: cp.async
def test_rel_attention_mem_fwd_at_ragged_shapes(dev, dtype, form, p, bits, b,
                                                heads, d_model, t, r, tb,
                                                count, head):
    """#2 on the tensor cores off its tiles (64 query rows, 64-key tiles of
    two 32-key halves, dh padded to the MMA depth, the plain-load path where
    a key group is no whole 16 bytes), in the float and the int8 BD form,
    with and without dropout at both draw widths: out, S and lse within the
    tolerance of the plain twin (``_close_int8``'s rule in the int8 form),
    the same scores masked, two runs bit-equal."""
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, count,
                               head, True)
    drop = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=bits)
    if form == "int8":
        drop["psi_q"] = fa.quantize_psi_int8(args[9])
    close = _close_int8 if form == "int8" else _close_scaled
    ours = fa.rel_attention_mem_fwd(*args, save=True, **drop)
    ref = fa.rel_attention_mem_fwd_plain(*args, save=True, **drop)
    live = ref[1] > -1e30
    torch.cuda.synchronize()
    assert torch.equal(live, ours[1] > -1e30)
    if form == "int8":
        close(ours[0], ref[0], TOL[dtype], "out")
    else:
        _close(ours[0], ref[0], TOL[dtype])
    close(ours[1][live], ref[1][live], TOL[dtype], "S")
    close(ours[2], ref[2], TOL[dtype], "lse")
    again = fa.rel_attention_mem_fwd(*args, save=True, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
@pytest.mark.parametrize("b,d,f,t", [
    (2, 500, 1000, 1), (3, 130, 257, 11), (2, 200, 300, 33),
    (1, 72, 100, 129)])
def test_ffn_block_fwd_at_ragged_shapes(dev, dtype, p, bits, b, d, f, t):
    """#7 on the tensor cores with D, F and T off the 32-wide padding and the
    128 x 128 tiles: y and the save outputs within the tolerance of the plain
    twin, the saved h1's signs (mask H) those of the twin wherever the value
    is clear of zero, two runs bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(d + f + t)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    fwd = (randn(b, d, t).to(dtype), randn(b, d, t).to(dtype),
           randn(d, f, std=0.05).to(dtype), randn(f, std=0.1),
           randn(f, d, std=0.05).to(dtype), randn(d, std=0.1),
           1.0 + randn(d, std=0.1), randn(d, std=0.1),
           1.0 + randn(d, std=0.1), randn(d, std=0.1))
    drop = dict(seed=977, dropout_p=p, bits=bits)
    ours = fused_ffn.ffn_block_fwd(*fwd, save=True, **drop)
    ref = fused_ffn.ffn_block_fwd_plain(*fwd, save=True, **drop)
    for o, r_ in zip(ours, ref):
        assert o.shape == r_.shape and o.dtype == r_.dtype
        _close(o, r_, TOL[dtype])
    clear = ref[3].float().abs() > 0.05
    assert torch.equal((ours[3].float() < 0)[clear], (ref[3].float() < 0)[clear])
    again = fused_ffn.ffn_block_fwd(*fwd, save=True, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 8)])
@pytest.mark.parametrize("b,heads,d_model,t,r,tb,count,head", [
    (2, 12, 600, 33, 2, 33, 50, 10),   # dh 50, 2F 768: K 99
    (2, 25, 1250, 40, 2, 40, 80, 0),   # dh 50, 2F 1280: the widest at dh 50
    (1, 96, 1536, 8, 2, 8, 16, 16)])   # dh 16, 2F 1536: the widest at all
def test_rel_attention_mem_fwd_past_the_tensor_core_widths(
        dev, dtype, p, bits, b, heads, d_model, t, r, tb, count, head):
    """Both forms at 2F past the narrow body's 512, up to the widest the
    wrapper took at these head widths, run the wide tensor-core body:
    out, S and lse within the tolerance of the plain twin (``_close_int8``'s
    rule in the int8 form), the same scores masked, two runs bit-equal."""
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, count,
                               head, True)
    assert args[7].shape[2] > 512
    drop = dict(seed=12345, dropout_p=p, bits=bits)
    name = _build.form("rel_attention_mem_fwd", thresh=int(p > 0), bits=bits)
    before = _build.LAUNCHES[name]
    ours = fa.rel_attention_mem_fwd(*args, save=True, **drop)
    assert _build.LAUNCHES[name] == before + 1
    ref = fa.rel_attention_mem_fwd_plain(*args, save=True, **drop)
    live = ref[1] > -1e30
    torch.cuda.synchronize()
    assert torch.equal(live, ours[1] > -1e30)
    _close(ours[0], ref[0], TOL[dtype])
    _close_scaled(ours[1][live], ref[1][live], TOL[dtype], "S")
    _close_scaled(ours[2], ref[2], TOL[dtype], "lse")
    again = fa.rel_attention_mem_fwd(*args, save=True, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))
    drop["psi_q"] = fa.quantize_psi_int8(args[9])
    ours = fa.rel_attention_mem_fwd(*args, save=True, **drop)
    ref = fa.rel_attention_mem_fwd_plain(*args, save=True, **drop)
    torch.cuda.synchronize()
    assert torch.equal(live, ours[1] > -1e30)
    for o, r, name in zip(ours, ref, ("out", "S", "lse")):
        _close_int8(o[live] if name == "S" else o,
                    r[live] if name == "S" else r, TOL[dtype], name)


# ---- the no-memory forward on the tensor-core body, its masked-tile skip,
# the FMA body past its widths, and the dropout kernel's words ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
@pytest.mark.parametrize("t", [11, 37, 128, 500, 1024])
def test_rel_attention_fwd_at_model_widths_in_every_form(dev, dtype, form, p,
                                                         bits, t):
    """#1 at ``ModelConfig()``'s widths (dh 50, 2F 512), batch row 1 reset,
    in the float and the int8 BD form, with and without dropout at both draw
    widths, T off the 64-row and 64-key tiles and past the FMA body's
    shared memory (500, 1024): out, the live S and lse within the tolerance
    of the plain twin (``_close_int8``'s rule in the int8 form), the same
    scores masked, one launch under the form's name, two runs bit-equal."""
    args, _ = _attention_args(dev, dtype, 2, 10, 500, t, False)
    assert fa.fwd_on_tensor_cores(50, 512)
    drop = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=bits)
    int8 = form == "int8"
    if int8:
        drop["psi_q"] = fa.quantize_psi_int8(args[7])
    name = _build.form("rel_attention_fwd", int8, int(p > 0), bits)
    before = _build.LAUNCHES[name]
    ours = fa.rel_attention_fwd(*args, save=True, **drop)
    assert _build.LAUNCHES[name] == before + 1
    ref = fa.rel_attention_fwd_plain(*args, save=True, **drop)
    live = ref[1] > -1e30
    torch.cuda.synchronize()
    assert torch.equal(live, ours[1] > -1e30)
    close = _close_int8 if int8 else _close_scaled
    if int8:
        close(ours[0], ref[0], TOL[dtype], "out")
    else:
        _close(ours[0], ref[0], TOL[dtype])
    close(ours[1][live], ref[1][live], TOL[dtype], "S")
    close(ours[2], ref[2], TOL[dtype], "lse")
    again = fa.rel_attention_fwd(*args, save=True, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("t", [128, 200, 1024])
def test_masked_tiles_are_skipped_without_changing_a_bit(dev, dtype, form, p,
                                                         t):
    """The no-memory forward's tensor-core body leaves out a warp's products
    where its 16 rows x 32 keys of a tile are all masked (mask <= -1e30: the
    causal upper triangle).  A mask whose blocked entries sit at -1e29
    instead of NEG_INF blocks the same scores (their exponentials underflow
    to 0 either way) but lets no warp skip: out, lse and the live S of the
    two runs are the same bits, with a reset row."""
    args, _ = _attention_args(dev, dtype, 3, 10, 500, t, False)
    drop = dict(seed=77, dropout_p=p, bits=8)
    if form == "int8":
        drop["psi_q"] = fa.quantize_psi_int8(args[7])
    mask = args[8]
    shallow = torch.where(mask.float() < -1e30, -1e29, 0.0).bfloat16()
    assert bool((shallow.float() < -1e28).any()) and \
        bool((shallow.float() > -1e30).all())
    skipped = fa.rel_attention_fwd(*args, save=True, **drop)
    full = fa.rel_attention_fwd(*args[:8], shallow, *args[9:], save=True,
                                **drop)
    live = mask.float()[args[9].long()][:, None] > -1e30
    live = live.expand_as(skipped[1])
    torch.cuda.synchronize()
    assert torch.equal(skipped[0], full[0])
    assert torch.equal(skipped[2], full[2])
    assert torch.equal(skipped[1][live], full[1][live])
    assert bool((skipped[1][~live] < -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 8)])
@pytest.mark.parametrize("b,heads,d_model,t", [
    (2, 12, 600, 37),   # dh 50, 2F 768
    (2, 2, 160, 33)])   # dh 80, 2F 256
def test_rel_attention_fwd_past_the_tensor_core_widths(dev, dtype, form, p,
                                                       bits, b, heads,
                                                       d_model, t):
    """2F past 512 and heads wider than 64 run the wide tensor-core body:
    out, the live S and lse within the tolerance of the plain twin, the same
    scores masked, one launch, two runs bit-equal."""
    args, _ = _attention_args(dev, dtype, b, heads, d_model, t, False)
    dh, f2 = d_model // heads, args[5].shape[2]
    assert fa.fwd_on_tensor_cores(dh, f2)
    drop = dict(seed=4321, dropout_p=p, bits=bits)
    int8 = form == "int8"
    if int8:
        drop["psi_q"] = fa.quantize_psi_int8(args[7])
    name = _build.form("rel_attention_fwd", int8, int(p > 0), bits)
    before = _build.LAUNCHES[name]
    ours = fa.rel_attention_fwd(*args, save=True, **drop)
    assert _build.LAUNCHES[name] == before + 1
    ref = fa.rel_attention_fwd_plain(*args, save=True, **drop)
    live = ref[1] > -1e30
    torch.cuda.synchronize()
    assert torch.equal(live, ours[1] > -1e30)
    close = _close_int8 if int8 else _close_scaled
    if int8:
        close(ours[0], ref[0], TOL[dtype], "out")
    else:
        _close(ours[0], ref[0], TOL[dtype])
    close(ours[1][live], ref[1][live], TOL[dtype], "S")
    close(ours[2], ref[2], TOL[dtype], "lse")
    again = fa.rel_attention_fwd(*args, save=True, **drop)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("b,d,t,offset", [
    (3, 7, 37, 0),      # uncut plane, one word a thread
    (2, 501, 37, 0),    # odd D, ragged T
    (2, 500, 37, 0),    # rows cut, ragged T
    (2, 500, 128, 0),   # rows cut, 16-byte vectors (ModelConfig())
    (2, 500, 128, 1),   # the same, x off 16 bytes: one word a thread
    (2, 501, 128, 0),   # uncut plane, 16-byte vectors
    (2, 6, 512, 0),     # columns cut at both widths
    (2, 3, 256, 0),     # columns halved (16-bit rule at 8 bits)
    (1, 5, 1, 0)])
def test_dropout_bdt_kernel_at_ragged_shapes_and_both_widths(dev, dtype, bits,
                                                             b, d, t, offset):
    """#13 over every geometry of the drawn plane (columns cut, rows cut,
    uncut) at both draw widths, on the 16-byte path and the one-word path:
    forward and backward equal the plain twin bit for bit, and the kept
    elements are ``keep_mask``'s."""
    gen = torch.Generator(device=dev).manual_seed(b * d + t)
    n = b * d * t
    x = torch.randn(n + offset, generator=gen, device=dev).to(dtype)[
        offset:].view(b, d, t)
    g = torch.randn(b, d, t, generator=gen, device=dev).to(dtype)
    name = _build.form("dropout_bdt", False, 1, bits)
    for seed, salt in ((12345, dropout.SALT_EMB),
                       (2 ** 31 - 3, dropout.SALT_OUT)):
        before = _build.LAUNCHES[name]
        y = dropout.dropout_bdt_apply(x, seed, 0.1, salt, bits)
        assert _build.LAUNCHES[name] == before + 1
        leaf = x.clone().requires_grad_(True)
        dropout.dropout_bdt(leaf, seed, 0.1, salt, bits).backward(g)
        torch.cuda.synchronize()
        assert torch.equal(y, dropout.dropout_bdt_plain(x, seed, 0.1, salt,
                                                        bits))
        assert torch.equal(leaf.grad, dropout.dropout_bdt_plain(g, seed, 0.1,
                                                                salt, bits))
    keep = dropout.dropout_bdt_apply(torch.ones_like(x), 7, 0.1, 5, bits) != 0
    want = prng.keep_mask(prng.row_seeds(7, b, 16384, 5 * 512, device=dev),
                          (d, t), 0.1, bits=bits)
    assert torch.equal(keep, want)


# ---- the wide forms: Transformer-XL's published widths at ComMU's depth ---

# (units, heads): dh 64 with 2F 768, dh 128 with 2F 1024, and the forwards'
# streamed form: dh 256 with 2F 1024, dh 128 with 2F 1536
WIDE = [(768, 12), (1024, 8), (1024, 4), (1536, 12)]


def _close_int8_position(ours, ref, exact, tol, name=""):
    """An int8 backward's position gradient (dq, dW_r, d r_r_bias) against
    its int8 twin: one ds_q rounding tie that kernel and twin break apart
    moves a whole row of dphi, and so a head's plane of dW_r, so the share
    of elements beyond ``tol`` says little (at 2F 768 a plane is 49,152
    elements, and its share holds as the batch grows).  Held instead: the
    mean distance to the int8 twin at most a tenth of the distance between
    the int8 and the exact twin (``test_torch_numerics_modes.py``'s rule),
    and no element beyond max(20 tol, 5e-3) of the largest magnitude."""
    torch.cuda.synchronize()
    ref, exact = ref.float(), exact.float()
    gap = float((ref - exact).abs().mean())
    assert gap > 0.0, name
    err = (ours.float() - ref).abs()
    assert float(err.mean()) <= 0.1 * gap, (name, float(err.mean()), gap)
    top = max(float(ref.abs().max()), 1e-30)
    assert float(err.max()) <= max(20 * tol, 5e-3) * top, (name,
                                                            float(err.max()))


def _close_int8_rows(ours, ref, tol, name=""):
    """The int8 forward's score plane S [B, H, T, K] against its twin's,
    masked entries set aside (NaN-free, both < -1e30 there).  One phi_q
    element that kernel and twin round to different sides of a tie moves
    a whole row of S by psi_q amax / 127^2, so the rows are counted: at most
    1 in 100 rows (or 4) hold an element off by more than ``tol`` (rtol, and
    atol of the largest live magnitude), and no element is further off than
    max(20 tol, 5e-3) of that magnitude.  2F = 1024 at dh = 128 quantises
    twice the values a row that ModelConfig()'s 2F = 512 does, from a u
    summed over 128 head dims."""
    torch.cuda.synchronize()
    live = ref > -1e30
    assert torch.equal(live, ours > -1e30), name
    ref = torch.where(live, ref.float(), 0.0)
    ours = torch.where(live, ours.float(), 0.0)
    top = max(float(ref.abs().max()), 1e-30)
    err = (ours - ref).abs()
    rows_off = (err > tol * (top + ref.abs())).any(dim=-1)
    assert int(rows_off.sum()) <= max(1e-2 * rows_off.numel(), 4), (
        name, int(rows_off.sum()), rows_off.numel())
    assert float(err.max()) <= max(20 * tol, 5e-3) * top, (name,
                                                            float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 8)])
@pytest.mark.parametrize("d_model,heads", WIDE)
def test_attention_kernels_at_the_wide_widths(dev, dtype, form, p, bits,
                                              d_model, heads):
    """#1 and #2 (both forms, with the residual), #3 and #4 (both forms) at
    units 768 with 12 heads and units 1024 with 8 heads, T = 64 and K = 144
    off the 64-key tiles, a reset row, 8 batch rows: within the tolerance
    of the plain twins
    (``_close_int8``'s rule in the int8 forms, ``_close_int8_rows``' for
    their S, ``_close_int8_position``'s for the gradients the int8 dphi
    reaches), one launch each under the form's name, two runs bit-equal."""
    b, t, r, tb = 8, 64, 2, 40
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, 60,
                               20, True)
    (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask,
     reset, scale) = args
    dh, f2 = d_model // heads, w_r.shape[2]
    assert fa.fwd_on_tensor_cores(dh, f2) and f2 == d_model
    int8 = form == "int8"
    drop = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=bits)
    close = _close_int8 if int8 else _close_scaled
    gen = torch.Generator(device=dev).manual_seed(d_model)
    mem = torch.randn(3, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    win_fwd = (q, rwbs, rrbs, k_win, v_win, w_r,
               fa.query_trig_table(t, 0, d_model, dtype, dev),
               fa.key_trig_basis(t, d_model, dtype, dev),
               fa.build_mask_bias(t, 0, 0, 0, True, device=dev), reset, scale)
    for fwd, plain, fargs, bwd, bplain, extra, name in (
            (fa.rel_attention_mem_fwd, fa.rel_attention_mem_fwd_plain, args,
             fa.rel_attention_mem_bwd, fa.rel_attention_mem_bwd_plain,
             (mem, 1), "rel_attention_mem"),
            (fa.rel_attention_fwd, fa.rel_attention_fwd_plain, win_fwd,
             fa.rel_attention_bwd, fa.rel_attention_bwd_plain, (),
             "rel_attention")):
        mode = dict(drop, psi_q=fa.quantize_psi_int8(fargs[-4])) if int8 \
            else drop
        fwd_name = _build.form(f"{name}_fwd", int8, int(p > 0), bits)
        bwd_name = _build.form(f"{name}_bwd", int8, int(p > 0), bits)
        before = dict(_build.LAUNCHES)
        ours = fwd(*fargs, save=True, **mode)
        assert _build.LAUNCHES[fwd_name] == before[fwd_name] + 1
        ref = plain(*fargs, save=True, **mode)
        live = ref[1] > -1e30
        torch.cuda.synchronize()
        assert torch.equal(live, ours[1] > -1e30), name
        if int8:
            close(ours[0], ref[0], TOL[dtype], f"{name} out")
        else:
            _close(ours[0], ref[0], TOL[dtype])
        if int8:
            _close_int8_rows(ours[1], ref[1], TOL[dtype], f"{name} S")
        else:
            close(ours[1][live], ref[1][live], TOL[dtype], f"{name} S")
        close(ours[2], ref[2], TOL[dtype], f"{name} lse")
        again = fwd(*fargs, save=True, **mode)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(ours, again)), name

        # the forward's operands up to psi (mem and the layer after v_win)
        front = fargs[:7] + extra + fargs[7:10] if extra else fargs[:8]
        bargs = front + (ref[1], ref[2], ref[0], dout, scale)
        grads = bwd(*bargs, **mode)
        assert _build.LAUNCHES[bwd_name] == before[bwd_name] + 1
        # the outputs the int8 dphi reaches: dq, dW_r, d r_r_bias
        position = (0, 5, 7) if extra else (0, 3, 5)
        exact = bplain(*bargs, **drop) if int8 else None
        for o, pl, i in zip(grads, bplain(*bargs, **mode), range(9)):
            assert o.shape == pl.shape and o.dtype == pl.dtype, (name, i)
            if int8 and i in position:
                _close_int8_position(o, pl, exact[i], TOL[dtype],
                                     f"{name}_bwd output {i}")
            else:
                close(o, pl, TOL[dtype], f"{name}_bwd output {i}")
        again = bwd(*bargs, **mode)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(grads, again)), name


def _wide_bwd_case(dev, dtype, d_model, heads, r, tb, t, p, bits, int8, b=2):
    """#4's operands over ``r`` slabs of ``tb`` keys (layer 1 of a ring of
    3) or, with ``r`` 0, #3's, at a wide width, with a reset row: the plain
    forward's residual at ``p`` with ``bits``-bit draws (psi_q in the int8
    form) -> (kernel, plain twin, backward operands, mode, the launch's
    name, the outputs the int8 dphi reaches)."""
    args = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb,
                               r * tb, 7 if r else 0, False)
    gen = torch.Generator(device=dev).manual_seed(d_model + t + r)
    dout = torch.randn(args[0].shape, generator=gen, device=dev).to(dtype)
    mode = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=bits)
    if int8:
        mode["psi_q"] = fa.quantize_psi_int8(args[9])
    if r:
        mem = torch.randn(3, r, b, d_model, tb, generator=gen,
                          device=dev).to(dtype)
        res = fa.rel_attention_mem_fwd_plain(*args, save=True, **mode)
        bwd = (*args[:7], mem, 1, *args[7:10], res[1], res[2], res[0], dout,
               args[-1])
        return (fa.rel_attention_mem_bwd, fa.rel_attention_mem_bwd_plain, bwd,
                mode, "rel_attention_mem_bwd", (0, 5, 7))
    win = (*args[:3], args[4], args[6], args[7],
           fa.query_trig_table(t, 0, d_model, dtype, dev),
           fa.key_trig_basis(t, d_model, dtype, dev),
           fa.build_mask_bias(t, 0, 0, 0, False, device=dev), args[11],
           args[12])
    res = fa.rel_attention_fwd_plain(*win, save=True, **mode)
    bwd = (*win[:8], res[1], res[2], res[0], dout, win[-1])
    return (fa.rel_attention_bwd, fa.rel_attention_bwd_plain, bwd, mode,
            "rel_attention_bwd", (0, 3, 5))


# (R slabs of Tb keys, T): a full ring of 8 slabs at T 128, the window alone
# at T 128, and T 100 (no multiple of 64, nor of 8: the passes stage by
# plain loads) over 2 slabs of 50 keys and alone
WIDE_BWD_SHAPES = [(8, 128, 128), (0, 128, 128), (2, 50, 100), (0, 100, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,tb,t", WIDE_BWD_SHAPES)
@pytest.mark.parametrize("d_model,heads", WIDE)
def test_wide_backward_passes_match_their_twins(dev, d_model, heads, r, tb,
                                                t, dtype, form, bits):
    """The wide backward passes (csrc/rel_attention_bwd_wide.cuh: pass A
    past dh 64, dh 256 among them, in one block a key tile; pass B's 2F
    chunks and k ds_c^T as one grid) in #4 and #3 at each wide width, p =
    0.1 at 8 and 16 bits, a reset row: one launch under the form's name,
    every output within the tolerance of the plain twin (the int8 form's by
    ``_close_int8``, the gradients its dphi reaches by
    ``_close_int8_position`` against the exact twin), two runs bit-equal."""
    int8 = form == "int8"
    kernel, plain, bwd, mode, name, position = _wide_bwd_case(
        dev, dtype, d_model, heads, r, tb, t, 0.1, bits, int8)
    launch = _build.form(name, int8, 1, bits)
    before = _build.LAUNCHES[launch]
    ours = kernel(*bwd, **mode)
    assert _build.LAUNCHES[launch] == before + 1
    twin = plain(*bwd, **mode)
    exact = plain(*bwd, **{k: v for k, v in mode.items() if k != "psi_q"}) \
        if int8 else None
    for i, (o, pl) in enumerate(zip(ours, twin)):
        assert o.shape == pl.shape and o.dtype == pl.dtype, (name, i)
        if int8 and i in position:
            _close_int8_position(o, pl, exact[i], TOL[dtype], f"output {i}")
        elif int8:
            _close_int8(o, pl, TOL[dtype], f"output {i}")
        else:
            _close_scaled(o, pl, TOL[dtype], f"output {i}")
    again = kernel(*bwd, **mode)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again)), name


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [8, 0])
def test_wide_backward_lever_form_at_1536(dev, r, dtype, int8):
    """The lever form int8_dq+dk of the wide passes (pass A without dk, pass
    B's raw form without dq, then the int8 dk and dq kernels) at 1536 / 12,
    T 128, in the float and the int8 dphi form, over a full ring of 8 slabs
    and the window alone: dq and dk by ``_close_int8_position``'s rule
    against the twin under the lever, every other output the default form's
    bit for bit."""
    lv = fa.Levers(int8_dq=True, int8_dk=True)
    kernel, plain, bwd, mode, name, _ = _wide_bwd_case(
        dev, dtype, 1536, 12, r, 128, 128, 0.1, 8, int8)
    form = f"{name}[{fa.GRAD_TAGS[lv.int8_grads]}]"
    before = _build.LAUNCHES[form]
    ours = kernel(*bwd, levers=lv, **mode)
    assert _build.LAUNCHES[form] == before + 1
    twin = plain(*bwd, levers=lv, **mode)
    exact = plain(*bwd, seed=mode["seed"], dropout_p=0.1, bits=8)
    default = kernel(*bwd, **mode)
    quantised = (0, 1, 3) if r else (0, 1)
    torch.cuda.synchronize()
    for i, (o, t) in enumerate(zip(ours, twin)):
        if i in quantised:
            _close_int8_position(o, t, exact[i], TOL[dtype], f"output {i}")
        else:
            assert torch.equal(o, default[i]), i


# (R slabs of Tb keys, T, p, bits, save): a full ring of 8 slabs; the
# window alone at T 128, at the serving prefill's T 11 and at T 100 (no
# multiple of 16: plain loads) over 2 slabs of 100; 16-bit draws; p = 0 and
# no residual
WIDE_BODY_CASES = [(8, 128, 128, 0.1, 8, True), (0, 128, 128, 0.1, 8, True),
                   (0, 11, 11, 0.1, 16, True), (2, 100, 100, 0.1, 16, True),
                   (0, 100, 100, 0.0, 16, False)]


def _wide_body_operands(dev, dtype, d_model, heads, r, tb, t, b=4):
    """#2's operands over ``r`` slabs (the window alone, #1's, at r = 0):
    a ring read at a wrapped head, reset rows."""
    if r:
        return _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb,
                                   r * tb, tb, False)
    return _attention_args(dev, dtype, b, heads, d_model, t, False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("d_model,heads", WIDE)
def test_wide_forward_body_at_the_wide_widths(dev, dtype, form, d_model,
                                              heads):
    """The forwards' wide tensor-core body (``rel_attention_fwd_wide.cuh``:
    #2 over a ring, #1 over the window) at each of ``WIDE``, in the float and
    the int8 BD form, over ``WIDE_BODY_CASES``: out, the live S and lse
    within the tolerance of the plain twin (``[wide]``'s rules:
    ``_close_int8``, ``_close_int8_rows`` in the int8 form), the same
    scores masked, one launch under the form's name, and a rerun gives the
    same bits; with the residual off, out is the residual run's."""
    dh = d_model // heads
    int8 = form == "int8"
    for r, tb, t, p, bits, save in WIDE_BODY_CASES:
        args = _wide_body_operands(dev, dtype, d_model, heads, r, tb, t)
        fwd, plain, kernel = (
            (fa.rel_attention_mem_fwd, fa.rel_attention_mem_fwd_plain,
             "rel_attention_mem_fwd") if r else
            (fa.rel_attention_fwd, fa.rel_attention_fwd_plain,
             "rel_attention_fwd"))
        assert fa.fwd_on_tensor_cores(dh, args[-6].shape[2])
        drop = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=bits)
        if int8:
            drop["psi_q"] = fa.quantize_psi_int8(args[-4])
        name = _build.form(kernel, int8, int(p > 0), bits)
        what = f"{kernel} R={r} T={t} p={p} bits={bits}"
        before = _build.LAUNCHES[name]
        ours = fwd(*args, save=True, **drop)
        assert _build.LAUNCHES[name] == before + 1, what
        ref = plain(*args, save=True, **drop)
        live = ref[1] > -1e30
        torch.cuda.synchronize()
        assert torch.equal(live, ours[1] > -1e30), what
        if int8:
            _close_int8(ours[0], ref[0], TOL[dtype], f"{what} out")
            _close_int8_rows(ours[1], ref[1], TOL[dtype], f"{what} S")
            _close_int8(ours[2], ref[2], TOL[dtype], f"{what} lse")
        else:
            _close(ours[0], ref[0], TOL[dtype])
            _close_scaled(ours[1][live], ref[1][live], TOL[dtype], "S")
            _close_scaled(ours[2], ref[2], TOL[dtype], "lse")
        again = fwd(*args, save=True, **drop)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(ours, again)), what
        if not save:
            alone = fwd(*args, **drop)
            torch.cuda.synchronize()
            assert torch.equal(alone, ours[0]), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m_cap", [0, 1024])
def test_wide_forward_body_lever_form_at_1536(dev, dtype, m_cap):
    """One lever form of the wide body at 1536 / 12 (``LEVER_WIDTHS``): the
    clamped softmax with the keep-scale after P v, #1 and #2 over a full
    ring of 8 slabs, against its twin."""
    lv = fa.Levers(clamp=True, defer=True)
    case = _lever_case(dev, dtype, 1536, 12, m_cap, b=2, t=128, tb=128)
    kernel, plain = ((fa.rel_attention_mem_fwd, fa.rel_attention_mem_fwd_plain)
                     if m_cap else
                     (fa.rel_attention_fwd, fa.rel_attention_fwd_plain))
    mode = dict(seed=9, dropout_p=0.1, bits=8, levers=lv)
    name = ("rel_attention_mem_fwd" if m_cap else "rel_attention_fwd") + \
        f"[{fa.SOFT_TAGS[lv.soft]}]"
    before = _build.LAUNCHES[name]
    ours = kernel(*case["fwd"], save=True, **mode)
    ref = plain(*case["fwd"], save=True, **mode)
    assert _build.LAUNCHES[name] == before + 1
    live = ref[1] > -1e30
    torch.cuda.synchronize()
    assert torch.equal(live, ours[1] > -1e30)
    for o, r in ((ours[0], ref[0]), (ours[1][live], ref[1][live]),
                 (ours[2], ref[2])):
        _close(o, r, TOL[dtype])
    assert float(ours[1].max()) <= 60.0


def _proj_case(dev, dtype, d_model, heads, b, t, r, tb):
    """#6's operands at these widths over a ring of ``r`` slabs of ``tb``
    (batch row 1 reset), read at layer 2 -> (args of
    ``rel_attention_proj_fwd`` before the keywords, the same with wk, wv
    [D, H dh] in ``dtype`` for its twin, #2's operands over #5's slabs)."""
    (q, rwbs, rrbs, _, k_win, _, v_win, w_r, trig_a, psi, mask, reset,
     scale) = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb,
                                  r * tb, tb if r > 1 else 0, False)
    gen = torch.Generator(device=dev).manual_seed(b + tb + r)
    mem = torch.randn(3, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    dh = d_model // heads
    wk3, wv3 = (torch.randn(d_model, heads, dh, generator=gen, device=dev)
                * 0.05 for _ in range(2))
    tail = (k_win, v_win, w_r, trig_a, psi, mask, reset, scale)
    wk, wv = (w.reshape(d_model, heads * dh).to(dtype) for w in (wk3, wv3))
    k_mem, v_mem = fa.project_mem_kv(mem, 2, wk3, wv3)
    return ((q, rwbs, rrbs, mem, 2, wk3, wv3, *tail),
            (q, rwbs, rrbs, mem, 2, wk, wv, *tail),
            (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, *tail[2:]))


def _proj_equals_the_pair(ours, pair_args, mode):
    """#6's five outputs are #5 + #2's bits on the same inputs: k_mem and
    v_mem ``project_mem_kv``'s, out, S and lse ``rel_attention_mem_fwd``'s
    over those slabs."""
    two = fa.rel_attention_mem_fwd(*pair_args, save=True, **mode)
    torch.cuda.synchronize()
    for name, x, y in zip(("k_mem", "v_mem", "out", "S", "lse"),
                          (ours[1], ours[2], ours[0], ours[3], ours[4]),
                          (pair_args[3], pair_args[5], *two)):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,heads", WIDE + [(600, 12)])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
@pytest.mark.parametrize("r,t,tb", [(1, 100, 48), (8, 128, 128),
                                    (2, 40, 37)])
def test_proj_fwd_at_the_wide_widths(dev, dtype, d_model, heads, p, bits, r,
                                     t, tb):
    """#6's wide form (#5's tile over the row tiles of [k dims | v dims],
    then #2's wide body), at each wide width and at dh 50 with a 2F of 600
    (no multiple of 128): against its twin within the tolerance, and equal
    to ``project_mem_kv`` + ``rel_attention_mem_fwd`` on the same inputs bit
    for bit; a rerun gives the same bits.  R = 1, 8 (a full ring) and 2; T
    and Tb off the 64-row and 64-key tiles (100, 48, 40); Tb = 37, whose
    rows are no whole 16 bytes (X by plain loads, and plain key loads in
    the attention); dropout off and at 16 and 8 bits; batch row 1 reset."""
    args, plain_args, pair_args = _proj_case(dev, dtype, d_model, heads, 2,
                                             t, r, tb)
    mode = dict(seed=2 ** 31 - 1 - 4096, dropout_p=p, bits=bits)
    name = _build.form("rel_attention_proj_fwd", False, int(p > 0), bits)
    before = dict(_build.LAUNCHES)
    ours = fa.rel_attention_proj_fwd(*args, save=True, **mode)
    assert _build.LAUNCHES[name] == before[name] + 1
    assert _build.LAUNCHES["project_mem_kv"] == before["project_mem_kv"]
    ref = fa.rel_attention_proj_fwd_plain(*plain_args, save=True, **mode)
    for x, y in zip(ours[:3], ref[:3]):
        _close(x, y, TOL[dtype])
    live = ref[3] > -1e30
    assert torch.equal(live, ours[3] > -1e30)
    _close_scaled(ours[3][live], ref[3][live], TOL[dtype], "S")
    _close_scaled(ours[4], ref[4], TOL[dtype], "lse")
    _proj_equals_the_pair(ours, pair_args, mode)
    again = fa.rel_attention_proj_fwd(*args, save=True, **mode)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(ours, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_fwd_wide_lever_form_at_1536(dev, dtype):
    """The lever form clamp+after of #6's wide form at 1536 / 12 over a full
    ring of 8 slabs: against its twin, and #5 + #2's lever form's bits."""
    lv = fa.Levers(clamp=True, defer=True)
    args, plain_args, pair_args = _proj_case(dev, dtype, 1536, 12, 2, 128, 8,
                                             128)
    mode = dict(seed=9, dropout_p=0.1, bits=8, levers=lv)
    name = f"rel_attention_proj_fwd[{fa.SOFT_TAGS[lv.soft]}]"
    before = _build.LAUNCHES[name]
    ours = fa.rel_attention_proj_fwd(*args, save=True, **mode)
    assert _build.LAUNCHES[name] == before + 1
    ref = fa.rel_attention_proj_fwd_plain(*plain_args, save=True, **mode)
    live = ref[3] > -1e30
    torch.cuda.synchronize()
    assert torch.equal(live, ours[3] > -1e30)
    for o, r in ((ours[0], ref[0]), (ours[3][live], ref[3][live]),
                 (ours[4], ref[4])):
        _close(o, r, TOL[dtype])
    assert float(ours[3].max()) <= 60.0
    _proj_equals_the_pair(ours, pair_args, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("d_model,heads", WIDE)
def test_one_train_step_at_the_wide_widths_matches_the_twins(
        dev, monkeypatch, dtype, fast, d_model, heads):
    """One train step of a 2-layer model at each wide width over a ring (B =
    4, T = 32, M = 64, dropout 0) on the card against the same step on the
    CPU (the plain twins), in the exact and the fast numerics: nll_sum and
    grad_norm within rtol 1e-3 in f32 (2e-2 in bf16), every attention
    kernel of the step launched once a layer."""
    from commu_tpu_torch.config import (EvaluateConfig, ModelConfig,
                                        TrainConfig, TrainingConfig)
    from commu_tpu_torch.models import TransformerXL, init_memory
    from commu_tpu_torch.training import make_optimizer, make_train_step

    for name, value in (("COMMU_BD_INT8", "1" if fast else "0"),
                        ("COMMU_BD_INT8_BWD", "1" if fast else "0"),
                        ("COMMU_DROPOUT_BITS", "8" if fast else "16")):
        monkeypatch.setenv(name, value)
    b, t, m = 4, 32, 64
    cfg = TrainingConfig(
        model=ModelConfig(num_layers=2, num_heads=heads, units=d_model,
                          inner_size=3072, dropout=0.0,
                          attention_dropout=0.0),
        train=TrainConfig(batch_size=b, batch_chunk=2, tgt_length=t,
                          mem_length=m, lr=1e-3, warmup_step=0),
        evaluate=EvaluateConfig(batch_size=b, tgt_length=t, mem_length=m))
    rng = torch.Generator().manual_seed(d_model)
    inputs = torch.randint(1, 729, (b, t), generator=rng)
    targets = torch.randint(1, 729, (b, t), generator=rng)
    reset = torch.zeros(b, dtype=torch.bool)
    hidden = torch.randn(3, m // t, b, d_model, t, generator=rng) * 0.5
    results = {}
    for device in ("cpu", dev):
        model = TransformerXL(729, cfg.model, dtype=dtype)
        model.init_parameters(torch.Generator().manual_seed(0))
        model = model.to(device)
        opt, sched = make_optimizer(model, cfg)
        step = make_train_step(model, opt, sched, cfg)
        memory = init_memory(2, b, m, d_model, dtype=dtype, block_len=t,
                             device=device)
        memory.hidden.copy_(hidden.to(device, dtype))
        memory.count = m
        before = dict(_build.LAUNCHES)
        _, metrics = step(memory, inputs.to(device), targets.to(device),
                          reset.to(device))
        results[str(device)] = {k: float(v) for k, v in metrics.items()}
        if device != "cpu":
            for kernel in ("rel_attention_mem_fwd", "rel_attention_mem_bwd"):
                kernel = _build.form(kernel, fast)
                assert _build.LAUNCHES[kernel] == before[kernel] + 2, kernel
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    for key in ("nll_sum", "grad_norm"):
        assert results["cuda"][key] == pytest.approx(results["cpu"][key],
                                                     rel=tol), key


# ---- the lever forms (the reference's COMMU_SOFTMAX=clamp,
# COMMU_DEFER_NORM=1, COMMU_SCALE_HOIST=1, COMMU_INT8_DQ=1, COMMU_INT8_DK=1:
# fused_attention.Levers), each against its twin under the same lever
LEVER_FWD = {"clamp": fa.Levers(clamp=True), "defer": fa.Levers(defer=True),
             "hoist": fa.Levers(hoist=True),
             "clamp+defer": fa.Levers(clamp=True, defer=True)}
LEVER_BWD = {"int8_dq": fa.Levers(int8_dq=True),
             "int8_dk": fa.Levers(int8_dk=True),
             "int8_dq+dk": fa.Levers(int8_dq=True, int8_dk=True)}


def _lever_case(dev, dtype, d_model, heads, m_cap, b=2, t=40, tb=40):
    """Operands of both attentions over ``m_cap`` ring keys (0: the window
    alone), ragged T, a reset row, dropout 0.1 at 8 bits."""
    gen = torch.Generator(device=dev).manual_seed(d_model + m_cap)
    dh = d_model // heads
    scale = dh ** -0.5

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    q, k_win, v_win, dout = (randn(b, heads, dh, t).to(dtype)
                             for _ in range(4))
    w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05), heads).to(dtype)
    rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                   randn(heads, dh, std=0.1), scale, dtype)
    k_len = m_cap + t
    psi = fa.ring_psi(fa.key_trig_basis(k_len, d_model, dtype, dev), t,
                      m_cap, 7 if m_cap else 0)
    trig_a = fa.query_trig_table(t, m_cap, d_model, dtype, dev)
    mask = fa.build_mask_bias(t, m_cap, m_cap, 7 if m_cap else 0, False,
                              device=dev)
    reset = torch.tensor([0, 1], dtype=torch.int32, device=dev)[:b]
    if not m_cap:
        return dict(fwd=(q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi, mask,
                         reset, scale), dout=dout, psi=psi)
    mem = randn(3, m_cap // tb, b, d_model, tb).to(dtype)
    wk, wv = (randn(d_model, heads, dh, std=0.05) for _ in range(2))
    k_mem, v_mem = fa.project_mem_kv(mem, 1, wk, wv)
    return dict(fwd=(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a,
                     psi, mask, reset, scale), dout=dout, psi=psi, mem=mem,
                wk=wk, wv=wv)


LEVER_WIDTHS = [(500, 10), (1536, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,heads", LEVER_WIDTHS)
@pytest.mark.parametrize("m_cap", [0, 80])
@pytest.mark.parametrize("lever", sorted(LEVER_FWD))
def test_forward_lever_forms_match_their_twins(dev, lever, m_cap, d_model,
                                               heads, dtype, fast):
    """#1 (m_cap 0) and #2 under each forward lever, with their residual, in
    the exact mode and over the int8 BD; each launch counted as its form."""
    lv = LEVER_FWD[lever]
    case = _lever_case(dev, dtype, d_model, heads, m_cap)
    kernel, plain = ((fa.rel_attention_mem_fwd, fa.rel_attention_mem_fwd_plain)
                     if m_cap else
                     (fa.rel_attention_fwd, fa.rel_attention_fwd_plain))
    mode = dict(seed=9, dropout_p=0.1, bits=8, levers=lv,
                psi_q=fa.quantize_psi_int8(case["psi"]) if fast else None)
    name = ("rel_attention_mem_fwd" if m_cap else "rel_attention_fwd") + \
        f"[{fa.SOFT_TAGS[lv.soft]}]"
    before = _build.LAUNCHES[name]
    ours = kernel(*case["fwd"], save=True, **mode)
    ref = plain(*case["fwd"], save=True, **mode)
    assert _build.LAUNCHES[name] == before + 1
    live = ref[1] > -1e30
    assert torch.equal(live, ours[1] > -1e30)
    if fast:
        _close_int8(ours[0], ref[0], TOL[dtype], "out")
        _close_int8_rows(ours[1], ref[1], TOL[dtype], "S")
        _close_int8(ours[2], ref[2], TOL[dtype], "lse")
    else:
        for o, r in ((ours[0], ref[0]), (ours[1][live], ref[1][live]),
                     (ours[2], ref[2])):
            _close(o, r, TOL[dtype])
    if lv.clamp:
        assert float(ours[1].max()) <= 60.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,heads", LEVER_WIDTHS)
@pytest.mark.parametrize("lever", sorted(LEVER_FWD))
def test_projecting_forward_lever_forms_match_their_twins(dev, lever, d_model,
                                                          heads, dtype):
    """#6 under each forward lever (exact mode: it has no int8 form)."""
    lv = LEVER_FWD[lever]
    case = _lever_case(dev, dtype, d_model, heads, 80)
    fwd = case["fwd"]
    args = (fwd[0], fwd[1], fwd[2], case["mem"], 1, case["wk"], case["wv"],
            fwd[4], fwd[6], *fwd[7:])
    mode = dict(seed=9, dropout_p=0.1, bits=8, levers=lv)
    name = f"rel_attention_proj_fwd[{fa.SOFT_TAGS[lv.soft]}]"
    before = _build.LAUNCHES[name]
    ours = fa.rel_attention_proj_fwd(*args, save=True, **mode)
    hd = heads * (d_model // heads)
    ref = fa.rel_attention_proj_fwd_plain(
        *args[:5], case["wk"].reshape(d_model, hd).to(dtype),
        case["wv"].reshape(d_model, hd).to(dtype), *args[7:], save=True,
        **mode)
    assert _build.LAUNCHES[name] == before + 1
    live = ref[3] > -1e30
    for o, r in ((ours[0], ref[0]), (ours[3][live], ref[3][live]),
                 (ours[4], ref[4])):
        _close(o, r, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,heads", LEVER_WIDTHS)
@pytest.mark.parametrize("m_cap", [0, 80])
@pytest.mark.parametrize("lever", sorted(LEVER_BWD))
def test_backward_lever_forms_match_their_twins(dev, lever, m_cap, d_model,
                                                heads, dtype, fast):
    """#3 (m_cap 0) and #4 under the int8 dq and dk, with the float and the
    int8 dphi: the gradients a lever quantises held by
    ``_close_int8_position``'s rule (a quantiser's tie moves a whole column
    of dq or dk) against the twin under the lever, the exact twin the one
    with neither int8 product; every other output equal to the default
    form's bit for bit (dv and dWv among them)."""
    lv = LEVER_BWD[lever]
    case = _lever_case(dev, dtype, d_model, heads, m_cap)
    fwd = case["fwd"]
    drop = dict(seed=9, dropout_p=0.1, bits=8,
                psi_q=fa.quantize_psi_int8(case["psi"]) if fast else None)
    if m_cap:
        res = fa.rel_attention_mem_fwd_plain(*fwd, save=True, **drop)
        bwd = (*fwd[:7], case["mem"], 1, *fwd[7:10], res[1], res[2], res[0],
               case["dout"], fwd[-1])
        kernel, plain = fa.rel_attention_mem_bwd, fa.rel_attention_mem_bwd_plain
        name = "rel_attention_mem_bwd"
        moved = {"int8_dq": (0,), "int8_dk": (1, 3)}
    else:
        res = fa.rel_attention_fwd_plain(*fwd, save=True, **drop)
        bwd = (*fwd[:8], res[1], res[2], res[0], case["dout"], fwd[-1])
        kernel, plain = fa.rel_attention_bwd, fa.rel_attention_bwd_plain
        name = "rel_attention_bwd"
        moved = {"int8_dq": (0,), "int8_dk": (1,)}
    form = f"{name}[{fa.GRAD_TAGS[lv.int8_grads]}]"
    before = _build.LAUNCHES[form]
    ours = kernel(*bwd, levers=lv, **drop)
    assert _build.LAUNCHES[form] == before + 1
    twin = plain(*bwd, levers=lv, **drop)
    exact = plain(*bwd, seed=9, dropout_p=0.1, bits=8)
    default = kernel(*bwd, **drop)
    quantised = {i for key, idx in moved.items() if getattr(lv, key)
                 for i in idx}
    torch.cuda.synchronize()
    for i, (o, r) in enumerate(zip(ours, twin)):
        if i in quantised:
            _close_int8_position(o, r, exact[i], TOL[dtype], f"output {i}")
        else:
            assert torch.equal(o, default[i]), i


def _past_the_clamp(case, m_cap, row=5):
    """``case``'s forward operands with scores past the clamp: q 40 times
    larger, so that the scores' spread is about 40 and several in a hundred
    pass 60; and one row whose live scores all lie below -110, where exp
    underflows to 0 in f32: batch row 1 (a reset row: its memory keys are
    masked), head 0, query ``row``, against window keys that share a
    component of 1 in every head dim, the query -30 in each (its content
    score about -30 sqrt(dh))."""
    fwd = list(case["fwd"])
    k_at = 4 if m_cap else 3
    q = fwd[0].float() * 40.0
    q[1, 0, :, row] = -30.0
    k = fwd[k_at].clone()
    k[1, 0] = (1.0 + 0.1 * k[1, 0].float()).to(k.dtype)
    fwd[0], fwd[k_at] = q.to(fwd[0].dtype), k
    return tuple(fwd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,heads", LEVER_WIDTHS)
@pytest.mark.parametrize("form,fast", [("fwd", False), ("fwd", True),
                                       ("mem_fwd", False), ("mem_fwd", True),
                                       ("proj_fwd", False)],
                         ids=["fwd-exact", "fwd-fast", "mem_fwd-exact",
                              "mem_fwd-fast", "proj_fwd-exact"])
@pytest.mark.parametrize("lever", ["clamp", "clamp+defer"])
def test_clamped_forms_past_the_clamp_and_under_it(dev, monkeypatch, lever,
                                                   form, fast, d_model, heads,
                                                   dtype):
    """#1, #2 and #6 under the clamp where it acts: many scores past 60 and
    a row whose live scores all lie below -110.  Against the twin under the
    lever: S and lse as the sums are held (``_close_scaled``: each score
    sums terms 40 times the unit-scale operands', so one whose terms cancel
    carries their error, 4.1e-4 near 0 on the card, where 1e-4 held the
    unit-scale scores; a row's lse carries its scores' error, 2.0e-4 at an
    lse of 0.65); out within the
    stated tolerance of the twin's softmax and P v over the form's own S
    (exp turns that score error into a relative error of out: 2.1e-4 from
    the twin's out at 500 / 10); S at most 60 and at 60 in more
    than 1 in 100 live scores; the underflowing row's out zeros and its lse
    log(1e-30), everything finite; and out far (> 100 tol) from the default
    form's on the same inputs, so a form that kept the row maximum, or lost
    the clamp or the 1e-30 guard, fails."""
    lv = LEVER_FWD[lever]
    m_cap = 0 if form == "fwd" else 80
    case = _lever_case(dev, dtype, d_model, heads, m_cap)
    fwd = _past_the_clamp(case, m_cap)
    if form == "proj_fwd":
        args = (fwd[0], fwd[1], fwd[2], case["mem"], 1, case["wk"],
                case["wv"], fwd[4], fwd[6], *fwd[7:])
        hd = heads * (d_model // heads)
        plain_args = (*args[:5], case["wk"].reshape(d_model, hd).to(dtype),
                      case["wv"].reshape(d_model, hd).to(dtype), *args[7:])

        def kernel(**m):
            r = fa.rel_attention_proj_fwd(*args, save=True, **m)
            return r[0], r[3], r[4]

        def plain(**m):
            r = fa.rel_attention_proj_fwd_plain(*plain_args, save=True, **m)
            return r[0], r[3], r[4]
    else:
        k_fn, p_fn = ((fa.rel_attention_mem_fwd, fa.rel_attention_mem_fwd_plain)
                      if m_cap else
                      (fa.rel_attention_fwd, fa.rel_attention_fwd_plain))

        def kernel(**m):
            return k_fn(*fwd, save=True, **m)

        def plain(**m):
            return p_fn(*fwd, save=True, **m)
    mode = dict(seed=9, dropout_p=0.1, bits=8)
    if fast:
        mode["psi_q"] = fa.quantize_psi_int8(case["psi"])
    ours = kernel(levers=lv, **mode)
    ref = plain(levers=lv, **mode)
    default = kernel(**mode)
    torch.cuda.synchronize()
    live = ref[1] > -1e30
    assert torch.equal(live, ours[1] > -1e30)
    # the data reach both ends of the clamp
    assert float(ref[1][1, 0, 5][live[1, 0, 5]].max()) < -110.0
    clamped = ref[1] == 60.0
    assert int(clamped.sum()) > 0.01 * int(live.sum())
    tol = TOL[dtype]
    if fast:
        _close_int8_rows(ours[1], ref[1], tol, "S")
        _close_int8(ours[2], ref[2], tol, "lse")
    else:
        _close_scaled(ours[1][live], ref[1][live], tol, "S")
        _close_scaled(ours[2], ref[2], tol, "lse")
    monkeypatch.setattr(fa, "_scores_plain", lambda *a, **k: ours[1])
    _close(ours[0], plain(levers=lv, **mode)[0], tol)
    assert float(ours[1].max()) <= 60.0
    assert int((ours[1] == 60.0).sum()) > 0.01 * int(live.sum())
    assert torch.isfinite(ours[0].float()).all()
    assert torch.isfinite(ours[2]).all()
    assert torch.equal(ours[0][1, 0, :, 5].float(),
                       torch.zeros_like(ours[0][1, 0, :, 5].float()))
    assert float(ours[2][1, 0, 5]) == pytest.approx(math.log(1e-30),
                                                    abs=1e-4)
    assert float((ours[0].float() - default[0].float()).abs().max()) \
        > 100 * tol


# ---- the warpgroup product (wgmma_product.cuh): #5 and #4's dWk / dWv ----

@pytest.mark.cuda
@pytest.mark.parametrize("d_model,heads", [(500, 10)] + WIDE)
def test_dw_mem_sums_meet_f64_at_the_widths(dev, d_model, heads):
    """#4's dWk / dWv form of the warpgroup product (``sum_outer_wg``, dk
    and dv as two parts of one launch) at ``ModelConfig()``'s widths and
    Transformer-XL's, over #4's 262,144 terms (B = 256 rows of M = 1,024),
    against f64; a rerun gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(d_model + heads)
    hd = d_model  # H dh
    rows, length = 256, 1024
    a = torch.randn(2, rows, hd, length, generator=gen, device=dev)
    b = torch.randn(rows, d_model, length, generator=gen, device=dev)
    outs = [torch.empty(2, hd, d_model, device=dev) for _ in range(2)]
    nbytes = _build.library().commu_sum_outer_wg_workspace(hd, d_model, rows,
                                                           length, 2)
    scratch = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=dev)
    for out in outs:
        _sums_call("sum_outer_wg", 0, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), scratch.data_ptr(), hd, d_model, rows,
                   length, 2)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    for p in range(2):
        ref = torch.einsum("bmt,bnt->mn", a[p].double(), b.double())
        _meets_f64(outs[0][p], ref,
                   f"sum_outer_wg part {p} {hd}x{d_model} over {rows * length}")


@pytest.mark.cuda
@pytest.mark.parametrize("kp", [512, 2048])
def test_kv_product_meets_f64(dev, kp):
    """#5's form of the warpgroup product (``kv_product``) in f32 at depth
    512 (``ModelConfig()``) and 2,048 (the deepest D the kernels take),
    against f64."""
    gen = torch.Generator(device=dev).manual_seed(kp)
    mm, tp, b = 256, 128, 16
    a = torch.randn(kp, mm, generator=gen, device=dev)
    x = torch.randn(b, kp, tp, generator=gen, device=dev)
    out = torch.empty(b, mm, tp, device=dev)
    nbytes = _build.library().commu_kv_product_workspace(0, kp, mm)
    scratch = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=dev)
    _sums_call("kv_product", 0, a.data_ptr(), x.data_ptr(), out.data_ptr(),
               scratch.data_ptr(), kp, mm, tp, b)
    ref = torch.einsum("km,bkt->bmt", a.double(), x.double())
    _meets_f64(out, ref, f"kv_product over {kp}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kp,terms", [(32, 8), (32, 16), (512, 512),
                                      (1024, 1000)])
def test_warpgroup_product_gives_the_mma_tile_bits(dev, dtype, kp, terms):
    """The probe: the same operands through wgmma (``kv_product``, #5's
    warpgroup product) and through mma.sync (``tile_product``, the tile #6
    projects on) give the same f32 bits, one depth step alone (8 TF32 terms
    with three passes, 16 bf16 terms) and over whole depths, the depth past
    ``terms`` zero.  #6's slabs equal #5's bit for bit on this."""
    gen = torch.Generator(device=dev).manual_seed(kp + terms)
    mm, tp, b = 256, 128, 8
    a = torch.randn(kp, mm, generator=gen, device=dev).to(dtype)
    x = torch.randn(b, kp, tp, generator=gen, device=dev).to(dtype)
    a[terms:] = 0
    code = 0 if dtype == torch.float32 else 1
    outs = []
    for name in ("kv_product", "tile_product"):
        out = torch.full((b, mm, tp), float("nan"), device=dev)
        query = getattr(_build.library(), f"commu_{name}_workspace")
        nbytes = query(code, kp, mm) if name == "kv_product" else \
            query(code, kp, mm, tp, b)
        scratch = torch.empty(max(int(nbytes), 1), dtype=torch.uint8,
                              device=dev)
        _sums_call(name, code, a.data_ptr(), x.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), kp, mm, tp, b)
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0]).all()
    same = outs[0] == outs[1]
    assert bool(same.all()), \
        f"{int((~same).sum())} of {same.numel()} sums differ"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,heads", [(500, 10)] + WIDE)
@pytest.mark.parametrize("r,tb", [(1, 128), (8, 48), (2, 37)])
def test_project_mem_kv_at_the_widths(dev, dtype, d_model, heads, r, tb):
    """#5 on the warpgroup product at ``ModelConfig()``'s widths and
    Transformer-XL's: against its twin at the port's tolerance, a rerun's
    bits, the ring untouched; R = 1, 8 and 2 slabs, Tb = 128, 48 and 37
    (rows of no whole 16 bytes: X by plain loads)."""
    gen = torch.Generator(device=dev).manual_seed(d_model + r + tb)
    b, dh = 3, d_model // heads
    mem = torch.randn(3, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    before = mem.clone()
    wk, wv = (torch.randn(d_model, heads, dh, generator=gen, device=dev)
              * 0.05 for _ in range(2))
    launches = _build.LAUNCHES["project_mem_kv"]
    k, v = fa.project_mem_kv(mem, 2, wk, wv)
    k2, v2 = fa.project_mem_kv(mem, 2, wk, wv)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["project_mem_kv"] == launches + 2
    assert torch.equal(k, k2) and torch.equal(v, v2)
    assert torch.equal(mem, before)
    hd = heads * dh
    kp, vp = fa.project_mem_kv_plain(mem, 2, wk.reshape(d_model, hd).to(dtype),
                                     wv.reshape(d_model, hd).to(dtype))
    _close(k.reshape(kp.shape), kp, TOL[dtype])
    _close(v.reshape(vp.shape), vp, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,rows,length", [(200, 300, 6, 96),
                                             (130, 520, 5, 128)])
def test_dw_sums_in_both_chunk_depths(dev, dtype, m, n, rows, length):
    """``sum_outer_wg`` where each row is 96 t (32-deep chunks) and 128 t
    (bf16's 64-deep chunks), ragged row and column tiles, two parts: against
    f64 of the same operands (bf16: A rounded to bf16 first, as the kernel
    rounds it), within 2e-6 of max|ref| in f32 and 1e-5 in bf16, a rerun's
    bits.  At these 576-640 terms the share of the error toward zero is the
    single steps' (about 0.4, ``--sums``), so it is held over #4's 262,144
    terms by ``test_dw_mem_sums_meet_f64_at_the_widths`` instead."""
    gen = torch.Generator(device=dev).manual_seed(m + length)
    a = torch.randn(2, rows, m, length, generator=gen, device=dev)
    b = torch.randn(rows, n, length, generator=gen, device=dev).to(dtype)
    code = 0 if dtype == torch.float32 else 1
    nbytes = _build.library().commu_sum_outer_wg_workspace(m, n, rows, length, 2)
    scratch = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=dev)
    outs = [torch.empty(2, m, n, device=dev) for _ in range(2)]
    for out in outs:
        _sums_call("sum_outer_wg", code, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), scratch.data_ptr(), m, n, rows, length, 2)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    ref = torch.einsum("pbmt,bnt->pmn", a.to(dtype).double(), b.double())
    err = float((outs[0].double() - ref).abs().max())
    tol = 2e-6 if dtype == torch.float32 else 1e-5
    assert err <= tol * float(ref.abs().max()), err
