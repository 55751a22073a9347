"""The port's CUDA kernels against their plain versions, on the card, dense
and paged (marked ``cuda``).  The file skips as a whole under a PyTorch built
without CUDA, and each test skips itself where there is no card.  No JAX here, so
the file also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if torch.version.cuda is None:
    pytest.skip("this PyTorch build has no CUDA: the CUDA kernels have no CPU mode",
                allow_module_level=True)

from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import pool as TP  # noqa: E402
from repro_torch.core import huffman as TH  # noqa: E402
from repro_torch.core import layouts as TL  # noqa: E402
from repro_torch.kernels import fused_kv_attn, huffman_decode, pack_encode, runtime  # noqa: E402


def _args(c, nb):
    return (c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step,
            c.k_buf, c.v_buf, nb, c.buf_len)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _filled_cache(layout, nb_valid, buf_len, device, seed=0, heads=4, dim=128):
    spec = TC.CacheSpec(layout=layout, block_size=64, max_seq=64 * 16)
    B, H, D, NB = len(nb_valid), heads, dim, spec.n_blocks
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
@pytest.mark.parametrize("layout", ["packed", "kivi", "raw", "huffman"])
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


# Mixtral-8x22B's attention: 48 query heads over 8 KV heads (G = 6), head_dim 128.
MIXTRAL_HKV, MIXTRAL_G = 8, 6


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "kivi", "raw", "huffman"])
def test_fetch_kernel_matches_plain_at_mixtral_shape(layout, cuda):
    spec, c = _filled_cache(layout, [16, 9, 1, 0], [0, 63, 17, 5], cuda, heads=MIXTRAL_HKV)
    q = torch.randn((4, MIXTRAL_HKV * MIXTRAL_G, 128), device=cuda)
    args = _args(c, torch.clamp(c.n_flushed, max=spec.n_blocks))
    kw = dict(tile=spec.impl.tile_decode(spec, 128), block_size=64)
    got = fused_kv_attn.fused_cache_attention(q, *args, **kw)
    want = fused_kv_attn.plain(q, *args, **kw)
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(got, fused_kv_attn.fused_cache_attention(q, *args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "kivi"])
def test_store_kernel_bit_exact_at_mixtral_shape(layout, cuda):
    spec, c = _filled_cache(layout, [4, 4, 4], [0, 0, 0], cuda, heads=MIXTRAL_HKV)
    kb = torch.randn((3, MIXTRAL_HKV, 1, 64, 128), device=cuda).to(torch.bfloat16)
    vb = torch.randn((3, MIXTRAL_HKV, 1, 64, 128), device=cuda).to(torch.bfloat16)
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


ZAMBA_HKV, ZAMBA_G, ZAMBA_D = 32, 1, 112  # Zamba2-7B's shared attention block
STABLELM_HKV, STABLELM_G, STABLELM_D = 8, 4, 160  # StableLM-2-12B: 10 m-tiles of head_dim


def _fetch_at_shape(layout, paged, cuda, hkv, g, d):
    """The Fetch at one model's (Hkv, G, D), dense or paged: within 1e-4 of
    plain, two launches bit-identical."""
    spec, c = _filled_cache(layout, [16, 9, 1, 0], [0, 63, 17, 5], cuda, heads=hkv, dim=d)
    if paged:
        c = _paged(c, spec, cuda)
    q = torch.randn((4, hkv * g, d), device=cuda)
    args = _args(c, torch.clamp(c.n_flushed, max=spec.n_blocks))
    args += (c.page_tab,) if paged else ()
    kw = dict(tile=spec.impl.tile_decode(spec, d), block_size=64)
    runtime.reset_launches()
    got = fused_kv_attn.fused_cache_attention(q, *args, **kw)
    assert sum(runtime.launches.values()) == 1
    want = fused_kv_attn.plain(q, *args, **kw)
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(got, fused_kv_attn.fused_cache_attention(q, *args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("layout", ["packed", "kivi", "raw", "huffman"])
def test_fetch_kernel_matches_plain_at_stablelm_shape(layout, paged, cuda):
    """Head_dim 160 (a warp takes a second m-tile of the P.V product)."""
    _fetch_at_shape(layout, paged, cuda, STABLELM_HKV, STABLELM_G, STABLELM_D)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("layout", ["packed", "kivi", "raw", "huffman"])
def test_fetch_kernel_matches_plain_at_zamba_shape(layout, paged, cuda):
    """One query head a KV head and head_dim 112, dense and paged: within
    1e-4 of plain, two launches bit-identical."""
    spec, c = _filled_cache(layout, [16, 9, 1, 0], [0, 63, 17, 5], cuda, heads=ZAMBA_HKV,
                            dim=ZAMBA_D)
    if paged:
        c = _paged(c, spec, cuda)
    q = torch.randn((4, ZAMBA_HKV * ZAMBA_G, ZAMBA_D), device=cuda)
    args = _args(c, torch.clamp(c.n_flushed, max=spec.n_blocks))
    args += (c.page_tab,) if paged else ()
    kw = dict(tile=spec.impl.tile_decode(spec, ZAMBA_D), block_size=64)
    runtime.reset_launches()
    got = fused_kv_attn.fused_cache_attention(q, *args, **kw)
    assert sum(runtime.launches.values()) == 1
    want = fused_kv_attn.plain(q, *args, **kw)
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(got, fused_kv_attn.fused_cache_attention(q, *args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 15), (4, 16)])
def test_store_kernel_multi_block_at_zamba_shape(B, n, cuda):
    """The full-length prefill's Store call (B 1, a 1000-token prompt's 15
    blocks) and the lockstep engine's (B 4, 16 blocks), float32 blocks at
    head_dim 112: bit-exact against plain, one launch."""
    spec, c = _filled_cache("packed", [0] * B, [0] * B, cuda, heads=ZAMBA_HKV, dim=ZAMBA_D)
    kb = torch.randn((B, ZAMBA_HKV, n, 64, ZAMBA_D), device=cuda)
    vb = torch.randn((B, ZAMBA_HKV, n, 64, ZAMBA_D), device=cuda)
    slots = torch.arange(n, dtype=torch.int32, device=cuda)[None].repeat(B, 1)
    names = ("k_store", "k_min", "k_step", "v_store", "v_min", "v_step")
    a = [getattr(c, f).clone() for f in names]
    b = [getattr(c, f).clone() for f in names]
    kw = dict(bits_k=spec.bits_k, bits_v=spec.bits_v, rel_scale_k=spec.rel_scale_k,
              rel_scale_v=spec.rel_scale_v, kivi=False)
    runtime.reset_launches()
    pack_encode.pack_encode(kb, vb, slots, *a, **kw)
    assert runtime.launches["pack_encode"] == 1
    pack_encode.pack_encode_plain(kb, vb, slots, *b, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


@pytest.mark.cuda
def test_hybrid_and_ssm_servers_on_card(cuda):
    """The zamba2 smoke model served dense and paged (a pool that preempts)
    on the card: equal tokens; each admission's full-length prefill
    launches the Store once a KV cache, and decode runs the Fetch.  The
    mamba2 smoke model launches no kernel."""
    from repro_torch.models import model as TM
    from repro_torch.models import registry as TR
    from repro_torch.serve import scheduler as TS

    cfg = TR.get_smoke_config("zamba2_7b")
    params = TM.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (37, 21, 53, 16)]
    news = (10, 14, 6, 9)
    page_b = sum(TP.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim)
                 for s in TM.cache_specs(cfg, 128))
    out = {}
    for mode, extra in (("dense", {}), ("paged", {"pool_hbm_bytes": 10 * page_b})):
        srv = TS.Server(cfg, params, TS.ServerConfig(max_slots=2, max_seq=128, cache_mode=mode,
                                                     attn_backend="fused", **extra))
        hs = [srv.submit(TS.Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
        runtime.reset_launches()
        srv.run()
        out[mode] = ([h.result().tokens.tolist() for h in hs], dict(runtime.launches),
                     srv.preemptions)
    assert out["paged"][0] == out["dense"][0]
    assert out["paged"][2] >= 1
    L = TM.n_cache_layers(cfg)
    assert out["dense"][1]["fused_kv_attn"] > 0 and out["paged"][1]["fused_kv_attn_paged"] > 0
    assert out["dense"][1]["pack_encode"] % L == 0 and out["dense"][1]["pack_encode"] > 0

    cfg = TR.get_smoke_config("mamba2_1_3b")
    params = TM.init_params(cfg, seed=0, device="cuda")
    srv = TS.Server(cfg, params, TS.ServerConfig(max_slots=2, max_seq=128))
    hs = [srv.submit(TS.Request(prompt=p, max_new_tokens=5)) for p in prompts[:3]]
    runtime.reset_launches()
    srv.run()
    assert [len(h.result().tokens) for h in hs] == [5, 5, 5]
    assert not any(runtime.launches.values())


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs_on_card(cuda):
    spec, c = _filled_cache("packed", [1], [0], cuda)
    q = torch.randn((1, 32, 128), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="fused_kv_attn"):
        fused_kv_attn.fused_cache_attention(
            q, *_args(c, c.n_flushed), tile=spec.impl.tile_decode(spec, 128), block_size=64)
    with pytest.raises(ValueError, match="fused_kv_attn"):  # G = 9: past the kernel's n-tile
        fused_kv_attn.fused_cache_attention(
            torch.randn((1, 36, 128), device=cuda), *_args(c, c.n_flushed),
            tile=spec.impl.tile_decode(spec, 128), block_size=64)
    with pytest.raises(ValueError, match="pack_encode"):
        pack_encode.pack_encode(
            c.k_buf[:, :, None], c.v_buf[:, :, None], torch.zeros((1, 1), device=cuda),
            c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step, bits_k=5,
            bits_v=3, rel_scale_k=0.05, rel_scale_v=0.15, kivi=False)


# The tests/test_kernels.py sweep shapes (odd head_dim 24, G = 3).
GRID = [(1, 1, 1, 32, 16, 8), (2, 2, 3, 96, 32, 16), (1, 4, 2, 64, 64, 16),
        (2, 1, 8, 48, 24, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "kivi", "raw", "huffman"])
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


def _paged(c, spec, device, hole=True, seed=0):
    """Re-house a filled dense cache in a shuffled arena of B*NB + 8 pages,
    with one unassigned entry below row 0's nb_valid."""
    B, NB = c.batch, spec.n_blocks
    g = torch.Generator().manual_seed(seed)
    pages = torch.randperm(B * NB + 8, generator=g)[:B * NB].reshape(B, NB).to(torch.int32)
    if hole:
        pages[0, 3] = -1
    return TP.from_dense(c, B * NB + 8, pages.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "kivi", "raw", "huffman"])
def test_paged_fetch_kernel_matches_plain_on_card(layout, cuda):
    spec, c = _filled_cache(layout, [16, 9, 1, 0], [0, 63, 17, 5], cuda)
    pc = _paged(c, spec, cuda)
    q = torch.randn((4, 32, 128), device=cuda)
    args = _args(pc, torch.clamp(pc.n_flushed, max=spec.n_blocks)) + (pc.page_tab,)
    kw = dict(tile=spec.impl.tile_decode(spec, 128), block_size=64)
    runtime.reset_launches()
    got = fused_kv_attn.fused_cache_attention(q, *args, **kw)
    key = "fused_kv_attn_huffman_paged" if layout == "huffman" else "fused_kv_attn_paged"
    assert runtime.launches[key] == 1 and sum(runtime.launches.values()) == 1
    want = fused_kv_attn.plain(q, *args, **kw)
    assert float((got - want).abs().max()) <= 1e-4
    # without the hole the paged kernel reads what the dense one reads
    full = _paged(c, spec, cuda, hole=False)
    a = fused_kv_attn.fused_cache_attention(
        q, *_args(full, torch.clamp(full.n_flushed, max=spec.n_blocks)), full.page_tab, **kw)
    b = fused_kv_attn.fused_cache_attention(
        q, *_args(c, torch.clamp(c.n_flushed, max=spec.n_blocks)), **kw)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("layout", ["packed", "raw", "huffman"])
def test_fetch_split_rule_on_card(layout, paged, cuda):
    """The Fetch's split rule: each row's output is bit-identical alone and
    beside longer and shorter rows (dense: the row's slice of the stores;
    paged: the shared arena and its table row), and two launches on the same
    inputs give the same bits."""
    spec, c = _filled_cache(layout, [16, 9, 1, 0], [0, 63, 17, 5], cuda, seed=5)
    if paged:
        c = _paged(c, spec, cuda)
    q = torch.randn((4, 32, 128), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6))
    args = _args(c, torch.clamp(c.n_flushed, max=spec.n_blocks)) + (
        (c.page_tab,) if paged else ())
    kw = dict(tile=spec.impl.tile_decode(spec, 128), block_size=64)
    out = fused_kv_attn.fused_cache_attention(q, *args, **kw)
    assert torch.equal(out, fused_kv_attn.fused_cache_attention(q, *args, **kw))
    for r in range(4):
        row = tuple(a if paged and i < 6 else a[r:r + 1] for i, a in enumerate(args))
        assert torch.equal(fused_kv_attn.fused_cache_attention(q[r:r + 1], *row, **kw),
                           out[r:r + 1]), r


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "kivi"])
def test_store_kernel_into_arena_bit_exact_on_card(layout, cuda):
    """Rows flush into arena pages through the page table: bit-exact against
    the plain version; a row that does not flush and a row whose entry is
    unassigned leave the arena untouched."""
    spec, c = _filled_cache(layout, [4, 4, 4, 4], [0, 0, 0, 0], cuda)
    pc = _paged(c, spec, cuda)  # row 0, slot 3 unassigned
    kb = torch.randn((4, 4, 1, 64, 128), device=cuda).to(torch.bfloat16)
    vb = torch.randn((4, 4, 1, 64, 128), device=cuda).to(torch.bfloat16)
    NB, P = spec.n_blocks, pc.k_store.shape[2]
    logical = torch.tensor([[3], [5], [NB], [0]], dtype=torch.int32, device=cuda)
    slots = TP.lookup_slots(pc.page_tab, logical, NB, P).to(torch.int32)
    assert slots[0, 0] == P and slots[2, 0] == P  # unassigned, no flush
    names = TP.STORE_FIELDS
    a = [getattr(pc, f).clone() for f in names]
    b = [getattr(pc, f).clone() for f in names]
    kw = dict(bits_k=spec.bits_k, bits_v=spec.bits_v, rel_scale_k=spec.rel_scale_k,
              rel_scale_v=spec.rel_scale_v, kivi=spec.impl.kivi_step)
    pack_encode.pack_encode(kb, vb, slots, *a, **kw)
    pack_encode.pack_encode_plain(kb, vb, slots, *b, **kw)
    written = [int(slots[1, 0]), int(slots[3, 0])]
    keep = [p for p in range(P) if p not in written]
    for f, x, y, old in zip(names, a, b, (getattr(pc, f) for f in names)):
        bits = (lambda t: t.view(torch.int16)) if x.dtype == torch.bfloat16 else (lambda t: t)
        assert torch.equal(bits(x), bits(y)), f
        assert torch.equal(bits(x[:, :, keep]), bits(old[:, :, keep])), f


@pytest.mark.cuda
def test_paged_server_equals_dense_on_card(cuda):
    """The smoke model served paged (a pool tight enough to preempt) and
    dense on the card: the same greedy tokens, and the paged decode went
    through the paged Fetch kernel and the Store kernel."""
    from repro_torch.models import model as TM
    from repro_torch.models import registry as TR
    from repro_torch.serve import scheduler as TS

    cfg = TR.get_smoke_config("yi_6b")
    params = TM.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 17).astype(np.int32) for _ in range(3)]
    page_b = sum(TP.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim)
                 for s in TM.cache_specs(cfg, 256))
    out = {}
    for mode, extra in (("dense", {}), ("paged", {"pool_hbm_bytes": 5 * page_b})):
        srv = TS.Server(cfg, params, TS.ServerConfig(max_slots=3, max_seq=256, cache_mode=mode,
                                                     attn_backend="fused", **extra))
        hs = [srv.submit(TS.Request(prompt=p, max_new_tokens=10)) for p in prompts]
        runtime.reset_launches()
        srv.run()
        out[mode] = ([h.result().tokens.tolist() for h in hs], dict(runtime.launches),
                     srv.preemptions)
    assert out["paged"][0] == out["dense"][0]
    assert out["paged"][2] >= 1
    assert out["paged"][1]["fused_kv_attn_paged"] > 0 and out["paged"][1]["fused_kv_attn"] == 0
    assert out["paged"][1]["pack_encode"] > 0


@pytest.mark.cuda
def test_prefix_server_equals_noshare_on_card(cuda):
    """Two identical prompts served with the prefix cache on, the second
    after the first decodes: it splices the first's pages (read by both
    rows' Fetch through their page tables), and the tokens equal noshare's
    and each other's; every launch went through the paged kernels."""
    from repro_torch.models import model as TM
    from repro_torch.models import registry as TR
    from repro_torch.serve import scheduler as TS

    cfg = TR.get_smoke_config("yi_6b")
    params = TM.init_params(cfg, seed=0, device="cuda")
    prompt = np.random.default_rng(13).integers(0, cfg.vocab_size, 37).astype(np.int32)
    out = {}
    for mode in ("on", "noshare"):
        srv = TS.Server(cfg, params, TS.ServerConfig(max_slots=2, max_seq=256,
                                                     cache_mode="paged", prefix_cache=mode,
                                                     attn_backend="fused"))
        runtime.reset_launches()
        first = srv.submit(TS.Request(prompt=prompt, max_new_tokens=12))
        while srv.active < 1:
            srv.step()
        second = srv.submit(TS.Request(prompt=prompt, max_new_tokens=12))
        srv.run()
        out[mode] = ([first.result().tokens.tolist(), second.result().tokens.tolist()],
                     dict(runtime.launches), srv.stats()["prefix"])
    (a, b), launches, px = out["on"]
    assert a == b and [a, b] == out["noshare"][0]
    assert px["hits"] == 1 and px["hit_blocks"] == (len(prompt) - 1) // cfg.cache_block
    assert launches["fused_kv_attn_paged"] > 0 and launches["fused_kv_attn"] == 0
    assert launches["pack_encode"] > 0


@pytest.mark.cuda
def test_huffman_fetch_bit_identical_to_packed_on_card(cuda):
    """The same blocks stored packed and huffman (the same codes and
    scales): the Fetch kernel's outputs are bit-identical, dense and paged,
    and the huffman launches count under their own keys."""
    out = {}
    for layout in ("packed", "huffman"):
        spec, c = _filled_cache(layout, [16, 9, 1, 0], [0, 63, 17, 5], cuda, seed=3)
        q = torch.randn((4, 32, 128), device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(4))
        kw = dict(tile=spec.impl.tile_decode(spec, 128), block_size=64)
        pc = _paged(c, spec, cuda)
        runtime.reset_launches()
        out[layout] = (
            fused_kv_attn.fused_cache_attention(q, *_args(c, torch.clamp(c.n_flushed, max=16)),
                                                **kw),
            fused_kv_attn.fused_cache_attention(
                q, *_args(pc, torch.clamp(pc.n_flushed, max=16)), pc.page_tab, **kw))
        if layout == "huffman":
            assert runtime.launches["fused_kv_attn_huffman"] == 1
            assert runtime.launches["fused_kv_attn_huffman_paged"] == 1
    assert torch.equal(out["packed"][0], out["huffman"][0])
    assert torch.equal(out["packed"][1], out["huffman"][1])


def _k_slots(book, device, nblk=8, seed=0):
    """Real huffman K blocks: random bf16 K quantized as the layout does
    (rel_scale 0.05, 5 bits) and encoded with ``book``; -> (codes, payload,
    nbits, slots)."""
    spec = TC.CacheSpec(layout="huffman", block_size=64, max_seq=1024)
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.randn((nblk, 64, 128), generator=g, device=device).to(torch.bfloat16)
    codes = TL.quant_block_minmax(k.float(), 0.05, spec.bits_k, (-2,), False)[0]
    pay_w = spec.impl._slot_words(spec, 128, book)[1]
    payload, nbits, _ = TH.encode_block_torch(codes, *book.encode_tables(device), pay_w)
    return codes, payload, nbits, torch.cat([TL.pack_u16_pairs(nbits), payload], -1)


def _skewed_book():
    hist = np.zeros(256, np.int64)
    hist[:21] = np.logspace(0, 9, 21)[::-1].astype(np.int64)
    return TH.build_codebook(hist)


@pytest.mark.cuda
@pytest.mark.parametrize("skewed", [False, True])
def test_huffman_decode_kernels_match_plain_on_card(skewed, cuda):
    """Kernels 3 and 4 and the slot LUT decode on real K slots, with the
    layout's default K book and a skewed book (2 LUT probes): codes
    bit-exact and lossless, scores within 1e-4; the walk decode also on the
    first 1 and 40 streams of each block."""
    book = _skewed_book() if skewed else TL.default_codebook(21)
    assert book.decode_probes == (2 if skewed else 1)
    codes, payload, nbits, slots = _k_slots(book, cuda)
    tables = book.as_device_tables(cuda)
    max_bits = int(nbits.max())
    runtime.reset_launches()
    got = huffman_decode.huffman_decode(payload, nbits, *tables, 128, max_bits)
    assert torch.equal(got, huffman_decode.huffman_decode_plain(payload, nbits, *tables, 128,
                                                                max_bits))
    assert torch.equal(got, codes)
    g = torch.Generator(device=cuda).manual_seed(1)
    kmn, kst, q = (torch.randn(s, generator=g, device=cuda) for s in ((8, 128), (8, 128), (128,)))
    sc = huffman_decode.huffman_attn_scores(payload, nbits, *tables, kmn, kst.abs(), q,
                                            max_bits, scale=0.125)
    want = huffman_decode.huffman_attn_scores_plain(payload, nbits, *tables, kmn, kst.abs(), q,
                                                    max_bits, scale=0.125)
    assert float((sc - want).abs().max()) <= 1e-4
    kw = dict(block_size=64, head_dim=128, hdr_words=32, probes=book.decode_probes)
    lut = huffman_decode.huffman_lut_decode(slots, book.device_lut(cuda), **kw)
    assert torch.equal(lut, huffman_decode.huffman_lut_decode_plain(
        slots, book.device_lut(cuda), **kw))
    assert torch.equal(lut, codes)
    assert {k: v for k, v in runtime.launches.items() if v} == {
        "huffman_decode": 1, "huffman_attn_scores": 1, "huffman_lut_decode": 1}
    for S in (1, 40):  # the first S streams of each block: the codes' first S rows
        runtime.reset_launches()
        assert torch.equal(huffman_decode.huffman_decode(payload, nbits[:, :S].contiguous(),
                                                         *tables, 128, max_bits), codes[:, :S])
        assert {k: v for k, v in runtime.launches.items() if v} == {"huffman_decode": 1}


@pytest.mark.cuda
def test_huffman_walk_edge_cases_on_card(cuda):
    """A zero-bit stream, a truncated stream and a max_bits cut: the walk
    and the LUT decode on the card equal their plain versions; and both walk
    kernels on ``chip_smoke.walk_edge_cases`` with S of 1, 40 and 100 (edge
    books: the default K and V books, codes past the root-table peek, one
    symbol, a child rewired to the root; edge streams: a zero-bit stream,
    max_bits below nbits, budgets past the payload, random words, more
    symbols than L), one launch a call."""
    book = TL.default_codebook(21)
    _, payload, nbits, _ = _k_slots(book, cuda, nblk=3, seed=5)
    nbits = nbits.clone()
    nbits[0, 5] = 0
    nbits[1, -1] //= 2
    tables = book.as_device_tables(cuda)
    for max_bits in (int(nbits.max()), 300):
        a = huffman_decode.huffman_decode(payload, nbits, *tables, 128, max_bits)
        b = huffman_decode.huffman_decode_plain(payload, nbits, *tables, 128, max_bits)
        assert torch.equal(a, b), max_bits
    slots = torch.cat([TL.pack_u16_pairs(nbits), payload], -1)
    kw = dict(block_size=64, head_dim=128, hdr_words=32, probes=1)
    assert torch.equal(huffman_decode.huffman_lut_decode(slots, book.device_lut(cuda), **kw),
                       huffman_decode.huffman_lut_decode_plain(slots, book.device_lut(cuda),
                                                               **kw))
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    for x in chip_smoke.walk_edge_cases(cuda, streams=(1, 40, 100)):
        args = (x["payload"], x["nbits"], *x["tables"])
        sc_args = (*args, x["kmn"], x["kst"], x["q"], x["max_bits"])
        runtime.reset_launches()
        codes = huffman_decode.huffman_decode(*args, x["L"], x["max_bits"])
        scores = huffman_decode.huffman_attn_scores(*sc_args, scale=x["scale"])
        assert {k: v for k, v in runtime.launches.items() if v} == {
            "huffman_decode": 1, "huffman_attn_scores": 1}, x["name"]
        assert torch.equal(codes, huffman_decode.huffman_decode_plain(*args, x["L"],
                                                                      x["max_bits"])), x["name"]
        want = huffman_decode.huffman_attn_scores_plain(*sc_args, scale=x["scale"])
        assert float((scores - want).abs().max()) <= 1e-4, x["name"]


@pytest.mark.cuda
def test_huffman_server_equals_packed_on_card(cuda):
    """The smoke model served with huffman and packed caches, dense and
    paged: the same greedy tokens; the huffman decode went through the
    huffman Fetch and the chunks through the slot LUT decode."""
    import dataclasses

    from repro_torch.models import model as TM
    from repro_torch.models import registry as TR
    from repro_torch.serve import scheduler as TS

    base = TR.get_smoke_config("yi_6b")
    params = TM.init_params(base, seed=0, device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, base.vocab_size, 17).astype(np.int32) for _ in range(3)]
    toks = {}
    for layout in ("packed", "huffman"):
        cfg = dataclasses.replace(base, cache_layout=layout)
        for mode in ("dense", "paged"):
            srv = TS.Server(cfg, params, TS.ServerConfig(max_slots=3, max_seq=256,
                                                         cache_mode=mode, attn_backend="fused"))
            hs = [srv.submit(TS.Request(prompt=p, max_new_tokens=10)) for p in prompts]
            runtime.reset_launches()
            srv.run()
            toks[layout, mode] = [h.result().tokens.tolist() for h in hs]
            if layout == "huffman":
                key = "fused_kv_attn_huffman" + ("_paged" if mode == "paged" else "")
                assert runtime.launches[key] > 0 and runtime.launches["huffman_lut_decode"] > 0
                assert runtime.launches["fused_kv_attn"] == runtime.launches["pack_encode"] == 0
    assert toks["huffman", "dense"] == toks["packed", "dense"] == toks["huffman", "paged"]


def _book(name):
    """The layout's default K and V books; a 2-probe book with 11-bit codes
    (the multi-symbol table still fits); the skewed 2-probe book (16-bit
    codes: no table, the kernel probes the LUT)."""
    if name in ("K", "V"):
        return TL.default_codebook(21 if name == "K" else 8)
    hist = np.zeros(256, np.int64)
    hist[:21] = np.logspace(0, 3, 21)[::-1].astype(np.int64)
    return TH.build_codebook(hist) if name == "mid" else _skewed_book()


def _edge_slots(book, T, D, device, nblk=6, seed=0):
    """Slots of random codes under ``book`` whose headers hold an empty
    stream, a budget that cuts a codeword and a budget past the payload."""
    spec = TC.CacheSpec(layout="huffman", block_size=T, max_seq=16 * T)
    g = torch.Generator(device=device).manual_seed(seed)
    n = int((book.lengths > 0).sum())
    codes = torch.randint(0, n, (nblk, T, D), generator=g, device=device).to(torch.uint8)
    slots = spec.impl._encode(spec, codes, book)
    hdr = spec.impl._slot_words(spec, D, book)[0]
    nbits = TL.unpack_u16_pairs(slots[:, :hdr], T)
    nbits[0, T // 2] = 0
    nbits[1, -1] = max(int(nbits[1, -1]) - 2, 1)
    nbits[2, -1] += 30000
    slots[:, :hdr] = TL.pack_u16_pairs(nbits)
    return codes, slots, hdr


@pytest.mark.cuda
@pytest.mark.parametrize("T,D", [(64, 128), (8, 24)])
@pytest.mark.parametrize("name", ["K", "V", "mid", "skewed"])
def test_slot_decode_single_and_joint_on_card(name, T, D, cuda):
    """The slot LUT decode kernel through the book's multi-symbol table
    (where it has one) and through its LUT probes, alone and in one launch
    with a second tensor: equal to the plain version on slots with edge
    streams, and lossless on the untouched ones."""
    book, other = _book(name), _book("V")
    codes, slots, hdr = _edge_slots(book, T, D, cuda)
    o_codes, o_slots, o_hdr = _edge_slots(other, T, D, cuda, nblk=5, seed=1)
    kw = dict(block_size=T, head_dim=D)
    want = huffman_decode.huffman_lut_decode_plain(slots, book.device_lut(cuda), hdr_words=hdr,
                                                   probes=book.decode_probes, **kw)
    o_want = huffman_decode.huffman_lut_decode_plain(
        o_slots, other.device_lut(cuda), hdr_words=o_hdr, probes=other.decode_probes, **kw)
    assert torch.equal(want[3:], codes[3:])
    multi = book.device_multi_lut(cuda)
    assert (multi is None) == (name == "skewed")
    runtime.reset_launches()
    for m in {None, multi} if multi is not None else (None,):
        got = huffman_decode.huffman_lut_decode(slots, book.device_lut(cuda), hdr_words=hdr,
                                                probes=book.decode_probes, multi=m, **kw)
        assert torch.equal(got, want), m is None
    a = (slots, book.device_lut(cuda), multi, hdr, book.decode_probes)
    b = (o_slots, other.device_lut(cuda), other.device_multi_lut(cuda), o_hdr,
         other.decode_probes)
    got_a, got_b = huffman_decode.huffman_lut_decode_kv(a, b, **kw)
    assert torch.equal(got_a, want) and torch.equal(got_b, o_want)
    assert runtime.launches["huffman_lut_decode"] == (3 if multi is not None else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D", [(8, 16), (16, 24), (64, 64), (64, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kivi", [False, True])
def test_store_kernel_bit_exact_over_widths_on_card(T, D, dtype, kivi, cuda):
    """The Store kernel against ``pack_encode_plain`` for K and V code widths
    of 1 to 8 bits (codes a word dividing T*D or not), into per-row rings and
    into a shared arena, with constant blocks (step 0): words and bf16 scales
    bit-exact, and dropped rows (no flush, slot -1) leave the stores as they
    were."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(T * D)
    B, H, n = 3, 2, 2
    for bits in range(1, 9):
        bits_v = 9 - bits
        kb = torch.randn((B, H, n, T, D), generator=g, device=cuda).to(dt)
        vb = (3 * torch.randn((B, H, n, T, D), generator=g, device=cuda)).to(dt)
        kb[0, 1, 0] = 0.75  # constant blocks: step 0
        vb[2, 0, 1] = -1.5
        for Bs, NB in ((B, 5), (1, 8)):  # rings; the arena (distinct pages)
            slots = torch.tensor([[1, 3], [NB, -1], [4, 0]] if Bs == B else
                                 [[1, 3], [NB, -1], [5, 0]], dtype=torch.int32, device=cuda)
            cpw_k, cpw_v = 32 // bits, 32 // bits_v
            shapes = ((Bs, H, NB, -(-T * D // cpw_k)), (Bs, H, NB, D), (Bs, H, NB, D),
                      (Bs, H, NB, -(-T * D // cpw_v)), (Bs, H, NB, T), (Bs, H, NB, T))
            old = [torch.randint(-2**31, 2**31 - 1, s, generator=g, device=cuda,
                                 dtype=torch.int32) if i % 3 == 0 else
                   torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
                   for i, s in enumerate(shapes)]
            a = [t.clone() for t in old]
            b = [t.clone() for t in old]
            kw = dict(bits_k=bits, bits_v=bits_v, rel_scale_k=1.0 / (2**bits - 1),
                      rel_scale_v=0.7 / (2**bits_v - 1), kivi=kivi)
            pack_encode.pack_encode(kb, vb, slots, *a, **kw)
            pack_encode.pack_encode_plain(kb, vb, slots, *b, **kw)
            written = {(0 if Bs == 1 else r, int(s)) for r, row in enumerate(slots.tolist())
                       for s in row if 0 <= s < NB}
            for i, (x, y, o) in enumerate(zip(a, b, old)):
                if x.dtype == torch.bfloat16:
                    x, y, o = x.view(torch.int16), y.view(torch.int16), o.view(torch.int16)
                assert torch.equal(x, y), (bits, Bs, i)
                for r in range(Bs):
                    for s in range(NB):
                        if (r, s) not in written:
                            assert torch.equal(x[r, :, s], o[r, :, s]), (bits, Bs, i, r, s)
