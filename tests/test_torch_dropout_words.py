"""The dropout kernel's mapping from drawn words to elements, on the CPU.

``csrc/dropout_bdt.cu`` gives each thread ``kVec`` consecutive words of the
drawn plane (``prng.draw_geometry``: [D][T / pieces] where the columns are
cut, [D / pieces][T] where the rows are, [D][T] uncut), hashes each word
once and applies its 4 (8-bit) or 2 (16-bit) values to the elements the
word serves.  The kernel cannot run here; its grid and its index arithmetic
are emulated in torch, and must

- cover every element of the [D, T] plane exactly once, and
- give, from the words' values, the keep bits of ``ops/prng.py::keep_mask``

at ``ModelConfig()``'s D = 500, T = 128 (rows cut at both widths), at ragged
shapes (D = 7, T = 37 uncut; D = 500, T = 37; odd D), at the planes whose
columns are cut, at 8 and 16 bits, with the 16-byte vectors of f32 (4 words
a thread) and bf16 (8) and the one-word path.
"""
import pytest
import torch

from commu_tpu_torch.ops import prng

_M32 = 0xFFFFFFFF
_THREADS = 256


def _hash_word(idx, seed):
    """prng.cuh's hash_word on int64 tensors holding uint32 values."""
    x = (idx + ((seed & _M32) * 0x9E3779B9 + 0x85EBCA6B)) & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _kernel_elements(d, t, bits, vec, seed):
    """(element index in the [D, T] plane, the drawn value it compares) of
    every element the kernel's threads touch, in the kernel's order: the
    block (tx, 256 / tx), the grid (word-column tiles, word-row tiles), a
    thread's ``kVec`` words at columns c .. c + kVec - 1, its pieces n at
    r * T + c + n * step."""
    mode, part, width = prng.draw_geometry(d, t, bits)
    wrows = part if mode == 1 else d
    wcols = part if mode == 0 else t
    k_vec = vec if t % vec == 0 and wcols % vec == 0 else 1
    need = -(-wcols // k_vec)
    tx = 1
    while tx < need and tx < _THREADS:
        tx *= 2
    ty = _THREADS // tx
    gx, gy = -(-need // tx), -(-wrows // ty)
    r = torch.arange(gy * ty, dtype=torch.int64)[:, None]
    c = (torch.arange(gx * tx, dtype=torch.int64) * k_vec)[None, :]
    live = (r < wrows) & (c < wcols)
    r, c = r.expand_as(live)[live], c.expand_as(live)[live]
    pieces = 1 if mode == 2 else 32 // width
    step = {0: part, 1: part * t, 2: 0}[mode]
    shift0 = 16 if mode == 2 else 0
    elems, values = [], []
    for v in range(k_vec):
        word = _hash_word(r * wcols + c + v, seed)
        for n in range(pieces):
            elems.append(r * t + c + v + n * step)
            values.append((word >> (shift0 + n * width)) & ((1 << width) - 1))
    return torch.cat(elems), torch.cat(values), width


@pytest.mark.parametrize("vec", [1, 4, 8])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("d,t", [(500, 128), (7, 37), (500, 37), (501, 128),
                                 (6, 512), (3, 256)])
def test_each_element_once_with_keep_masks_bits(d, t, bits, vec):
    seed = 2 ** 31 - 3 + 5 * 512
    elems, values, width = _kernel_elements(d, t, bits, vec, seed)
    assert torch.equal(torch.bincount(elems, minlength=d * t),
                       torch.ones(d * t, dtype=torch.int64))
    for p in (0.1, 0.5):
        thresh = prng.dropout_threshold(p, bits) << (width - bits)
        keep = torch.zeros(d * t, dtype=torch.bool)
        keep[elems] = values >= thresh
        assert torch.equal(keep.view(d, t),
                           prng.keep_mask(seed, (d, t), p, bits=bits))
