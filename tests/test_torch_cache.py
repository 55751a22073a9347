"""The port's dense cache vs the reference's: the Store state (packed words,
bf16 minima and steps, raw blocks, lengths) bit-exact over a run that
crosses flush boundaries, and decode attention within 1e-4.

The reference runs compiled (``jax.jit``), as its server does.  That matters
for the kivi layout: XLA folds the division of the kivi step by the constant
2^b-1 into a multiplication by its float32 reciprocal in compiled code, so
the bytes the reference serves are the compiled ones (eager jnp divides).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JC  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# The tests/test_kernels.py sweep shapes (odd head_dim 24 included).
GRID = [(1, 1, 1, 32, 16, 8), (2, 2, 3, 96, 32, 16), (1, 4, 2, 64, 64, 16),
        (2, 1, 8, 48, 24, 8)]
LAYOUTS = ["packed", "kivi", "raw", "huffman"]

_jprefill = jax.jit(JC.prefill, static_argnums=0)
_jappend = jax.jit(JC.append)
_jattend = jax.jit(JC.attend, static_argnames="backend")


def bits_of(x):
    """A cache tensor of either package as raw bits (uint16 / uint32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
        return x.view(np.uint32) if x.dtype == np.int32 else x
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def assert_same_state(jc, tc):
    for f in TC.LayerKVCache.FIELDS:
        a, b = bits_of(getattr(jc, f)), bits_of(getattr(tc, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f)


def both_prefill(layout, B, Hkv, S, D, T, rng, **spec_kw):
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    js = JC.CacheSpec(layout=layout, block_size=T, max_seq=2 * S, **spec_kw)
    ts = TC.CacheSpec(layout=layout, block_size=T, max_seq=2 * S, **spec_kw)
    return (_jprefill(js, jnp.asarray(k), jnp.asarray(v)),
            TC.prefill(ts, torch.from_numpy(k), torch.from_numpy(v)))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B,Hkv,G,S,D,T", GRID)
def test_prefill_append_store_bit_exact(B, Hkv, G, S, D, T, layout, rng):
    """prefill, then T+2 appends (every row flushes once more): words,
    scales, buffers, n_flushed and buf_len equal the reference's bit for
    bit, and decode attention agrees within 1e-4."""
    jc, tc = both_prefill(layout, B, Hkv, S, D, T, rng)
    assert_same_state(jc, tc)
    for _ in range(T + 2):
        kn = rng.normal(size=(B, Hkv, D)).astype(np.float32)
        vn = rng.normal(size=(B, Hkv, D)).astype(np.float32)
        jc = _jappend(jc, jnp.asarray(kn), jnp.asarray(vn))
        tc = TC.append(tc, torch.from_numpy(kn), torch.from_numpy(vn))
    assert_same_state(jc, tc)
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    want = np.asarray(_jattend(jc, jnp.asarray(q)))
    got = TC.attend(tc, torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("layout", ["packed", "kivi"])
def test_compress_blocks_bit_exact(layout, rng):
    """The port's Store function (``ops.quant_pack``, what ``write_blocks``
    runs) against the reference's ``compress_blocks``, f32 and bf16 inputs:
    words + bf16 scales."""
    js = JC.CacheSpec(layout=layout, block_size=16, max_seq=64)
    ts = TC.CacheSpec(layout=layout, block_size=16, max_seq=64)
    for dt in (np.float32, jnp.bfloat16):
        k = jnp.asarray(rng.normal(size=(2, 2, 3, 16, 24)).astype(np.float32)).astype(dt)
        v = jnp.asarray(rng.normal(size=(2, 2, 3, 16, 24)).astype(np.float32)).astype(dt)
        want = jax.jit(js.impl.compress_blocks, static_argnums=0)(js, k, v)
        tk, tv = (torch.from_numpy(np.array(x, np.float32)).to(
            torch.bfloat16 if dt == jnp.bfloat16 else torch.float32) for x in (k, v))
        got = []
        for x, rel, bits, tok in ((tk, ts.rel_scale_k, ts.bits_k, False),
                                  (tv, ts.rel_scale_v, ts.bits_v, True)):
            got += ops.quant_pack(x.reshape(-1, 16, 24), rel_scale=rel, bits=bits,
                                  token_wise=tok, kivi=ts.impl.kivi_step)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(bits_of(b), bits_of(a).reshape(b.shape))


def test_sliding_window_ring_bit_exact(rng):
    """A window ring wraps: prefill keeps the last NB blocks and appends
    overwrite the oldest slot — the same slots as the reference."""
    jc, tc = both_prefill("packed", 1, 2, 40, 16, 8, rng, window=16)
    for _ in range(9):
        kn = rng.normal(size=(1, 2, 16)).astype(np.float32)
        jc = _jappend(jc, jnp.asarray(kn), jnp.asarray(kn))
        tc = TC.append(tc, torch.from_numpy(kn), torch.from_numpy(kn))
    assert_same_state(jc, tc)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_attend_backends_match_reference(backend, rng):
    """Both port backends (blockwise scan, Fetch plain version) against the
    reference's attend, with an empty-store row and a full-buffer row."""
    jc, tc = both_prefill("packed", 2, 2, 47, 32, 16, rng)
    q = rng.normal(size=(2, 4, 32)).astype(np.float32)
    want = np.asarray(_jattend(jc, jnp.asarray(q)))
    got = TC.attend(tc, torch.from_numpy(q), backend=backend).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    tc.n_flushed[0] = 0
    jc = dataclasses.replace(jc, n_flushed=jc.n_flushed.at[0].set(0))
    want = np.asarray(_jattend(jc, jnp.asarray(q)))
    got = TC.attend(tc, torch.from_numpy(q), backend=backend).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_paged_mode_raises_naming_the_later_slice():
    """Paged mode is served now; what still raises is what the reference
    rejects too: a paged spec without arena pages, and bulk prefill into a
    paged spec (the server fills arenas chunk by chunk)."""
    with pytest.raises(ValueError, match="pool_pages"):
        TC.CacheSpec(mode="paged")
    spec = TC.CacheSpec(mode="paged", pool_pages=4, block_size=8, max_seq=32)
    k = torch.zeros((1, 1, 16, 16))
    with pytest.raises(ValueError, match="from_dense"):
        TC.prefill(spec, k, k)
