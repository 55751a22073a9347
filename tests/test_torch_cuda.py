"""The port's CUDA kernels against their plain versions, on the card
(marked ``cuda``; each test skips itself where there is no card).  No JAX
here, so the file also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.kernels import fused_kv_attn, pack_encode  # noqa: E402


def _args(c, nb):
    return (c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step,
            c.k_buf, c.v_buf, nb, c.buf_len)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _filled_cache(layout, nb_valid, buf_len, device, seed=0):
    spec = TC.CacheSpec(layout=layout, block_size=64, max_seq=64 * 16)
    B, H, D, NB = len(nb_valid), 4, 128, spec.n_blocks
    c = TC.init_layer_cache(spec, B, H, D, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    blocks = [torch.randn((B, H, NB, 64, D), generator=g, device=device).to(torch.bfloat16)
              for _ in range(2)]
    spec.impl.write_blocks(spec, c, torch.arange(NB, device=device)[None].expand(B, NB),
                           *blocks)
    c.k_buf.normal_(generator=g)
    c.v_buf.normal_(generator=g)
    c.n_flushed.copy_(torch.tensor(nb_valid))
    c.buf_len.copy_(torch.tensor(buf_len))
    return spec, c


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "kivi", "raw"])
def test_fetch_kernel_matches_plain_on_card(layout, cuda):
    spec, c = _filled_cache(layout, [16, 9, 1, 0], [0, 63, 17, 5], cuda)
    q = torch.randn((4, 32, 128), device=cuda)
    args = _args(c, torch.clamp(c.n_flushed, max=spec.n_blocks))
    kw = dict(tile=spec.impl.tile_decode(spec, 128), block_size=64)
    got = fused_kv_attn.fused_cache_attention(q, *args, **kw)
    want = fused_kv_attn.plain(q, *args, **kw)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "kivi"])
def test_store_kernel_bit_exact_on_card(layout, cuda):
    spec, c = _filled_cache(layout, [4, 4, 4], [0, 0, 0], cuda)
    kb = torch.randn((3, 4, 1, 64, 128), device=cuda).to(torch.bfloat16)
    vb = torch.randn((3, 4, 1, 64, 128), device=cuda).to(torch.bfloat16)
    slots = torch.tensor([[3], [spec.n_blocks], [0]], dtype=torch.int32, device=cuda)
    names = ("k_store", "k_min", "k_step", "v_store", "v_min", "v_step")
    a = [getattr(c, f).clone() for f in names]
    b = [getattr(c, f).clone() for f in names]
    kw = dict(bits_k=spec.bits_k, bits_v=spec.bits_v, rel_scale_k=spec.rel_scale_k,
              rel_scale_v=spec.rel_scale_v, kivi=spec.impl.kivi_step)
    pack_encode.pack_encode(kb, vb, slots, *a, **kw)
    pack_encode.pack_encode_plain(kb, vb, slots, *b, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs_on_card(cuda):
    spec, c = _filled_cache("packed", [1], [0], cuda)
    q = torch.randn((1, 32, 128), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="fused_kv_attn"):
        fused_kv_attn.fused_cache_attention(
            q, *_args(c, c.n_flushed), tile=spec.impl.tile_decode(spec, 128), block_size=64)
    with pytest.raises(ValueError, match="pack_encode"):
        pack_encode.pack_encode(
            c.k_buf[:, :, None], c.v_buf[:, :, None], torch.zeros((1, 1), device=cuda),
            c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step, bits_k=5,
            bits_v=3, rel_scale_k=0.05, rel_scale_v=0.15, kivi=False)


# The tests/test_kernels.py sweep shapes (odd head_dim 24, G = 3).
GRID = [(1, 1, 1, 32, 16, 8), (2, 2, 3, 96, 32, 16), (1, 4, 2, 64, 64, 16),
        (2, 1, 8, 48, 24, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "kivi", "raw"])
@pytest.mark.parametrize("B,Hkv,G,S,D,T", GRID)
def test_kernels_on_card_match_cpu_path_on_grid(B, Hkv, G, S, D, T, layout, cuda):
    """prefill + appends through the Store kernel on the card give the CPU
    plain path's store bit for bit; the Fetch kernel agrees with the CPU
    plain version within 1e-4."""
    gen = torch.Generator().manual_seed(B * 1000 + S)
    k, v = (torch.randn((B, Hkv, S, D), generator=gen) for _ in range(2))
    spec = TC.CacheSpec(layout=layout, block_size=T, max_seq=2 * S)
    cc, gc = TC.prefill(spec, k, v), TC.prefill(spec, k.to(cuda), v.to(cuda))
    for _ in range(T + 2):
        kn, vn = (torch.randn((B, Hkv, D), generator=gen) for _ in range(2))
        TC.append(cc, kn, vn)
        TC.append(gc, kn.to(cuda), vn.to(cuda))
    for f in TC.LayerKVCache.FIELDS:
        a, b = getattr(cc, f), getattr(gc, f).cpu()
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), f
    q = torch.randn((B, Hkv * G, D), generator=gen)
    want = TC.attend(cc, q, backend="fused")
    got = TC.attend(gc, q.to(cuda), backend="fused").cpu()
    assert float((got - want).abs().max()) <= 1e-4
