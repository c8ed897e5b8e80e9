"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, so it runs only on a machine with an H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

The shapes go beyond the serving and eval paths' (T across the query and
key tiles, ragged projection and token tiles, other head widths, rows at and
past capacity, a wrapped ring) so the kernels' tiling and masking are
exercised, not only the shapes ``chip_smoke.py`` checks.
"""
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
    # both bodies stream their keys and take any T; the FMA body takes
    # heads up to 128 wide: 160 is refused
    args, _ = _attention_args(dev, torch.float32, 1, 2, 320, 8, False)
    assert not fa.fwd_on_tensor_cores(160, args[5].shape[2])
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
    2F = 768 (12 heads of 50), past the tensor-core widths, on the first
    design."""
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
    on the tensor cores, whose f32 accumulation error grows with the depth
    (3e-4 against the twin at F = 16,384 for y of magnitude 4), so every
    output is held at tol x max|ref| + tol x |ref|, as the backward's
    sums are."""
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
            _close_scaled(ours, r, TOL[dtype])
        args = (w1, w2, vecs[0], vecs[1], vecs[2], *ref[1:], dy)
        extra = dict(vec=vec, wo=wo) if wo_ is not None else {}
        for ours, r in zip(fused_ffn.ffn_block_bwd(*args, **extra),
                           fused_ffn.ffn_block_bwd_plain(*args, **extra)):
            _close_scaled(ours, r, TOL[dtype])


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
    wide = torch.zeros(2, 1, 160, 8, device=dev)  # head width 160 > 128
    with pytest.raises(ValueError):
        fa.rel_attention_bwd(
            wide, torch.zeros(1, 160, 1, device=dev),
            torch.zeros(1, 160, 1, device=dev), wide, wide,
            torch.zeros(1, 160, 256, device=dev),
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
    """Both forms at 2F past the tensor-core body's 512, up to the widest
    the wrapper takes at these head widths, run the first design's body:
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
    """2F past 512 and heads wider than 64 run the first design's FMA body:
    out, the live S and lse within the tolerance of the plain twin, the same
    scores masked, one launch, two runs bit-equal."""
    args, _ = _attention_args(dev, dtype, b, heads, d_model, t, False)
    dh, f2 = d_model // heads, args[5].shape[2]
    assert not fa.fwd_on_tensor_cores(dh, f2)
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

# (units, heads): dh 64 with 2F 768, dh 128 with 2F 1024
WIDE = [(768, 12), (1024, 8)]


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
    assert not fa.fwd_on_tensor_cores(dh, f2) and f2 == d_model
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,heads", WIDE)
def test_proj_fwd_at_the_wide_widths(dev, dtype, d_model, heads):
    """#6 at the two wide widths runs its first design (the FMA projection
    in two row tiles of [k dims | v dims], then the wide body): against its
    twin and against ``project_mem_kv`` + ``rel_attention_mem_fwd``."""
    b, t, r, tb = 2, 40, 2, 40
    (q, rwbs, rrbs, _, k_win, _, v_win, w_r, trig_a, psi, mask, reset,
     scale) = _attention_mem_args(dev, dtype, b, heads, d_model, t, r, tb, 80,
                                  40, False)
    gen = torch.Generator(device=dev).manual_seed(b + tb)
    mem = torch.randn(3, r, b, d_model, tb, generator=gen,
                      device=dev).to(dtype)
    dh = d_model // heads
    wk3, wv3 = (torch.randn(d_model, heads, dh, generator=gen, device=dev)
                * 0.05 for _ in range(2))
    tail = (k_win, v_win, w_r, trig_a, psi, mask, reset, scale)
    before = _build.LAUNCHES["rel_attention_proj_fwd"]
    out, k_mem, v_mem, s_res, lse = fa.rel_attention_proj_fwd(
        q, rwbs, rrbs, mem, 2, wk3, wv3, *tail, save=True)
    assert _build.LAUNCHES["rel_attention_proj_fwd"] == before + 1
    wk, wv = (w.reshape(d_model, heads * dh).to(dtype) for w in (wk3, wv3))
    ref = fa.rel_attention_proj_fwd_plain(q, rwbs, rrbs, mem, 2, wk, wv,
                                          *tail, save=True)
    _close(out, ref[0], TOL[dtype])
    _close(k_mem, ref[1], TOL[dtype])
    _close(v_mem, ref[2], TOL[dtype])
    live = ref[3] > -1e30
    assert torch.equal(live, s_res > -1e30)
    _close_scaled(s_res[live], ref[3][live], TOL[dtype], "S")
    _close_scaled(lse, ref[4], TOL[dtype], "lse")
    k2, v2 = fa.project_mem_kv(mem, 2, wk3, wv3)
    two = fa.rel_attention_mem_fwd(q, rwbs, rrbs, k2, k_win, v2, v_win, w_r,
                                   trig_a, psi, mask, reset, scale)
    _close(out, two, TOL[dtype])


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
