"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, so it runs only on a machine with an H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

The shapes go beyond the serving path's (T across the 8-row query tiles and
the 4-token FFN tiles, other head widths, rows at and past capacity) so the
kernels' tiling and masking are exercised, not only the shapes ``chip_smoke.py``
checks.
"""
import pytest
import torch

from commu_tpu_torch.ops import _build
from commu_tpu_torch.ops import fused_attention as fa
from commu_tpu_torch.ops import fused_ffn, layout

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
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 2, 16, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.rel_attention_fwd(q, q, q, q, q, q, q, q, q, q, 0.25)
    x = torch.zeros(2, 32, 4, device=dev)
    o = x.transpose(1, 2).contiguous().transpose(1, 2)  # non-contiguous
    vec = torch.zeros(32, device=dev)
    with pytest.raises(ValueError):
        fused_ffn.ffn_block_fwd(x, o, torch.zeros(32, 48, device=dev),
                                torch.zeros(48, device=dev),
                                torch.zeros(48, 32, device=dev), *[vec] * 5)
