"""The decompress-then-attend baseline, the exact-attention oracle, the
smaller helpers of the reference's public surface, and the serving memory
report, held against the reference on the CPU.

The caches are built once in the port and carried bit for bit into the
reference's ``LayerKVCache``, so both packages attend the same stored bits.
``attend_materialized`` rounds its dequantized values through bf16 in both
packages, so port and reference agree within 1e-4; against the port's own
``xla`` and ``fused`` backends, which do not round, the bound is the
reference's between its backends, 5e-3 (``tests/test_backends.py``).
"""

import dataclasses
import typing

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitpack as JB  # noqa: E402
from repro.core import cache as JC  # noqa: E402
from repro.core import huffman as JH  # noqa: E402
from repro.core import layouts as JL  # noqa: E402
from repro.core import policy as JP  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.models import layers as JLY  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import bitpack as TB  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import huffman as TH  # noqa: E402
from repro_torch.core import layouts as TL  # noqa: E402
from repro_torch.core import policy as TP  # noqa: E402
from repro_torch.core import pool as TPOOL  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402
from test_torch_shared import np_params  # noqa: E402

LAYOUTS = ["raw", "packed", "kivi", "huffman"]
B, HKV, G, D, T = 4, 2, 4, 16, 16
NB = 4  # max_seq 64
# Row 0: empty store; row 1: a full buffer; row 2: no buffer; row 3: nothing
# at all (a softmax over NEG_INF logits alone, which only the materialized
# attend and the reference define alike).
N_FLUSHED, BUF_LEN = [0, 3, 2, 0], [7, T, 0, 0]
LIVE_ROWS = [0, 1, 2]

_jmat = jax.jit(JC.attend_materialized)


def to_ref(tc):
    """The port's cache as the reference's ``LayerKVCache``, bit for bit."""
    arrays = {}
    for f in TC.LayerKVCache.FIELDS:
        t = getattr(tc, f)
        if t.dtype == torch.bfloat16:
            a = t.view(torch.int16).numpy().view(jnp.bfloat16)
        elif f in ("k_store", "v_store"):
            a = t.numpy().view(np.uint32)
        else:
            a = t.numpy()
        arrays[f] = jnp.asarray(a)
    return JC.LayerKVCache(**arrays, spec=JC.CacheSpec(**dataclasses.asdict(tc.spec)))


def ragged_cache(layout, rng, b=B, n_flushed=N_FLUSHED, buf_len=BUF_LEN):
    """A dense port cache: 3 blocks of random KV stored (slot 3 never
    written), random buffers, and per-row lengths; and a q."""
    k = rng.normal(size=(b, HKV, 3 * T + 9, D)).astype(np.float32)
    v = rng.normal(size=(b, HKV, 3 * T + 9, D)).astype(np.float32)
    spec = TC.CacheSpec(layout=layout, block_size=T, max_seq=NB * T)
    c = TC.prefill(spec, torch.from_numpy(k), torch.from_numpy(v))
    c.k_buf.copy_(torch.from_numpy(rng.normal(size=c.k_buf.shape).astype(np.float32)))
    c.v_buf.copy_(torch.from_numpy(rng.normal(size=c.v_buf.shape).astype(np.float32)))
    c.n_flushed.copy_(torch.tensor(n_flushed, dtype=torch.int32))
    c.buf_len.copy_(torch.tensor(buf_len, dtype=torch.int32))
    q = rng.normal(size=(b, HKV * G, D)).astype(np.float32)
    return c, q


@pytest.mark.parametrize("layout", LAYOUTS)
def test_attend_materialized_matches_reference(layout, rng):
    """Within 1e-4 of the compiled reference on every row (the empty one
    included), and within 5e-3 of the port's ``xla`` and ``fused``
    backends on the rows that hold a token."""
    tc, q = ragged_cache(layout, rng)
    got = TC.attend_materialized(tc, torch.from_numpy(q))
    assert got.shape == (B, HKV * G, D) and got.dtype == torch.float32
    want = np.asarray(_jmat(to_ref(tc), jnp.asarray(q)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    for backend in ("xla", "fused"):
        other = TC.attend(tc, torch.from_numpy(q), backend=backend)
        np.testing.assert_allclose(got[LIVE_ROWS].numpy(), other[LIVE_ROWS].numpy(),
                                   atol=5e-3, rtol=0, err_msg=backend)


def test_attend_materialized_paged_matches_dense_twin(rng):
    """Packed, re-housed in a shuffled arena: row 0 has an unassigned entry
    above its live blocks, row 1 one below them (it reads the clamped page,
    as in the reference).  Every row within 1e-4 of the reference on the
    same paged cache; rows 0 and 2 bit-identical to the dense twin."""
    dense, q = ragged_cache("packed", rng, b=3, n_flushed=[1, 3, 3], buf_len=[5, 0, T])
    pages = rng.permutation(3 * NB + 2)[:3 * NB].reshape(3, NB).astype(np.int32)
    pages[0, 2] = -1
    pages[1, 1] = -1
    paged = TPOOL.from_dense(dense, 3 * NB + 2, pages)
    tq = torch.from_numpy(q)
    got = TC.attend_materialized(paged, tq)
    twin = TC.attend_materialized(dense, tq)
    assert torch.equal(got[[0, 2]], twin[[0, 2]])
    want = np.asarray(_jmat(to_ref(paged), jnp.asarray(q)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_reference_attend_matches_reference(rng):
    """The oracle over raw K and V, without a window, with one shorter than
    the sequence and with one longer: within 1e-5 of the reference."""
    k = rng.normal(size=(2, 2, 40, D)).astype(np.float32)
    v = rng.normal(size=(2, 2, 40, D)).astype(np.float32)
    q = rng.normal(size=(2, 6, D)).astype(np.float32)
    tk, tv, tq = (torch.from_numpy(x) for x in (k, v, q))
    for window in (None, 16, 64):
        got = TC.reference_attend(tk, tv, tq, window=window)
        want = np.asarray(JC.reference_attend(k, v, q, window=window))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0, err_msg=str(window))
    got = TC.reference_attend(tk, tv, tq, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(JC.reference_attend(k, v, q, scale=0.3)),
                               atol=1e-5, rtol=0)


def _bits(x):
    """Either package's tensor as comparable integers (bf16 as its bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
        return x.view(np.uint32) if x.dtype == np.int32 else x
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def test_surface_helpers_match_reference(rng):
    """Each smaller name of the reference's surface against its counterpart:
    integers bit-exact, floats within 1e-6."""
    # core/bitpack: the numpy oracles
    for bits in (1, 3, 5, 8):
        codes = rng.integers(0, 2**bits, size=(3, 37))
        words = TB.pack_bits_np(codes, bits)
        np.testing.assert_array_equal(words, JB.pack_bits_np(codes, bits))
        np.testing.assert_array_equal(TB.unpack_bits_np(words, bits, 37),
                                      JB.unpack_bits_np(words, bits, 37))
        np.testing.assert_array_equal(TB.unpack_bits_np(words, bits, 37), codes)

    # core/huffman
    assert TH.WORST_BITS_PER_SYMBOL == JH.WORST_BITS_PER_SYMBOL
    hist = rng.integers(0, 50, size=TH.N_SYMBOLS) * (rng.random(TH.N_SYMBOLS) < 0.3)
    tb, jb = TH.build_codebook(hist), JH.build_codebook(hist)
    for h in (hist, rng.integers(0, 9, size=TH.N_SYMBOLS), np.zeros(TH.N_SYMBOLS)):
        assert abs(tb.expected_bits_per_symbol(h) - jb.expected_bits_per_symbol(h)) <= 1e-6
    for a, b in zip(tb.as_encode_tables(), jb.as_encode_tables()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))

    # core/cache
    assert TC.NEG_INF == JC.NEG_INF
    assert all(TC.bits_for_rel_scale(r) == JC.bits_for_rel_scale(r)
               for r in (0.5, 0.15, 0.05, 0.02, 0.004))
    tc, _ = ragged_cache("huffman", rng)
    jc = to_ref(tc)
    np.testing.assert_array_equal(tc.total_len.numpy(), np.asarray(jc.total_len))

    # core/layouts: fused_tile_spec, decode_block, quantize/compress_blocks
    for layout in LAYOUTS:
        spec = TC.CacheSpec(layout=layout, block_size=T, max_seq=NB * T)
        ts = TL.fused_tile_spec(layout, spec, D)
        js = JL.fused_tile_spec(layout, JC.CacheSpec(**dataclasses.asdict(spec)), D)
        assert ts is TL.fused_tile_spec(layout, spec, D) is spec.impl.tile_decode(spec, D)
        assert (ts.k_tile, ts.v_tile, ts.has_scales) == (js.k_tile, js.v_tile, js.has_scales)
    for layout in ("raw", "packed", "huffman"):
        tc, _ = ragged_cache(layout, rng)
        jc = to_ref(tc)
        for n in (0, 2, 3):  # slot 3 was never written
            got = tc.spec.impl.decode_block(tc.spec, tc, n)
            want = jc.spec.impl.decode_block(jc.spec, jc, n)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == torch.float32 or a.dtype == torch.bfloat16
                    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=(layout, n))
    blocks = [rng.normal(size=(2, HKV, 3, T, D)).astype(np.float32) for _ in range(2)]
    for layout in ("packed", "kivi"):
        tspec = TC.CacheSpec(layout=layout, block_size=T)
        jspec = JC.CacheSpec(layout=layout, block_size=T)
        tk, tv = (torch.from_numpy(x) for x in blocks)
        for name in ("quantize_blocks", "compress_blocks"):
            got = getattr(tspec.impl, name)(tspec, tk, tv)
            # compiled, as the reference serves (XLA turns kivi's division
            # by 2^b - 1 into a multiplication by its reciprocal)
            want = jax.jit(lambda k, v, f=getattr(jspec.impl, name): f(jspec, k, v))(*blocks)
            for a, b in zip(got, want):
                a, b = _bits(a), _bits(b)
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=(layout, name))
                else:
                    np.testing.assert_array_equal(a, b, err_msg=(layout, name))

    # core/policy, core/quant, kernels/ref
    ov = TP.LayerOverride(layers=(1,), block_size=16)
    assert TP.CompressionPolicy().uniform == JP.CompressionPolicy().uniform is True
    assert (TP.CompressionPolicy(overrides=(ov,)).uniform
            == JP.CompressionPolicy(overrides=(JP.LayerOverride(layers=(1,), block_size=16),)
                                    ).uniform is False)
    assert typing.get_args(TQ.GranularityK) == typing.get_args(JQ.GranularityK)
    codes = rng.integers(0, 16, size=(3, T, D)).astype(np.uint8)
    for fn, units in (("dequant_k", (3, D)), ("dequant_v", (3, T))):
        mn, st = (rng.normal(size=units).astype(np.float32) for _ in range(2))
        got = getattr(TREF, fn)(torch.from_numpy(codes), torch.from_numpy(mn),
                                torch.from_numpy(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(JREF, fn)(codes, mn, st)),
                                   atol=1e-6, rtol=0, err_msg=fn)

    # models/config, models/layers, data/pipeline, serve/engine
    for arch in JR.ARCHS:
        assert (TR.get_smoke_config(arch).is_attention_free
                == JR.get_smoke_config(arch).is_attention_free), arch
    for name in ("bfloat16", "float32", "float16"):
        assert str(TLY.dtype_of(name)).removeprefix("torch.") == np.dtype(JLY.dtype_of(name)).name
    batch = {"tokens": np.arange(24).reshape(6, 4), "labels": np.arange(24).reshape(6, 4) + 1}
    tcorp = TD.TextCorpus(seq_len=4, global_batch=6, max_bytes=4096)
    jcorp = JD.TextCorpus(seq_len=4, global_batch=6, max_bytes=4096)
    for host in range(3):
        got, want = tcorp.host_shard(batch, host, 3), jcorp.host_shard(batch, host, 3)
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    assert TE.cache_memory_report is TS.cache_memory_report


def _mixed(P, cfg):
    """Layer 0 at the config's block (8), layer 1 at 16 through the plain
    blockwise scan with a 32-token span (``tests/test_torch_policy.py``)."""
    ov = P.LayerOverride(layers=(1,), block_size=16, attn_backend="xla", span_tokens=32)
    return dataclasses.replace(cfg, cache_overrides=(ov,))


def test_memory_report_matches_reference():
    """The whole ``memory_report()`` dict equal to the reference Server's,
    key for key: yi_6b uniform packed, yi_6b under a per-layer policy
    (``per_layer_layouts`` listed) and zamba2_7b (the SSM state's bytes in
    ``total_bytes``)."""
    cases = [(JR.get_smoke_config("yi_6b"), TR.get_smoke_config("yi_6b")),
             (_mixed(JP, JR.get_smoke_config("yi_6b")), _mixed(TP, TR.get_smoke_config("yi_6b"))),
             (JR.get_smoke_config("zamba2_7b"), TR.get_smoke_config("zamba2_7b"))]
    scfg = dict(max_slots=2, max_seq=128)
    reports = []
    for jcfg, tcfg in cases:
        jp = np_params(jcfg, 4)
        want = JS.Server(jcfg, jp, JS.ServerConfig(**scfg)).memory_report()
        tsrv = TS.Server(tcfg, params_from_jax(jp, tcfg, "cpu"), TS.ServerConfig(**scfg),
                         device="cpu")
        got = tsrv.memory_report()
        assert got == want, (tcfg.name, got, want)
        assert got == TS.cache_memory_report(tcfg, tsrv.state)
        reports.append(got)
    assert "per_layer_layouts" not in reports[0]
    assert reports[1]["per_layer_layouts"] == ["packed", "packed"]
    assert reports[2]["total_bytes"] > reports[2]["kv_bytes"]
