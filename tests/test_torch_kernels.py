"""The port's kernel modules on the CPU: the plain versions (what the
wrappers run for CPU tensors) against the reference's oracles and its
Pallas Store kernel.  The CUDA kernels are held against these plain
versions in tests/test_torch_cuda.py and by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JC  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.pack_encode import quant_pack_pallas  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.kernels import fused_kv_attn, ops, runtime  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

_jref = jax.jit(JR.fused_cache_attention_ref, static_argnames=("tile", "block_size"))
GRID = [(1, 1, 1, 32, 16, 8), (2, 2, 3, 96, 32, 16), (1, 4, 2, 64, 64, 16),
        (2, 1, 8, 48, 24, 8)]


def _args(c, nb):
    return (c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step,
            c.k_buf, c.v_buf, nb, c.buf_len)


@pytest.mark.parametrize("layout", ["packed", "kivi", "raw"])
@pytest.mark.parametrize("B,Hkv,G,S,D,T", GRID)
def test_plain_fetch_matches_reference_oracle(B, Hkv, G, S, D, T, layout, rng):
    """The Fetch wrapper on CPU tensors (its plain version) within 1e-4 of
    the reference's ``fused_cache_attention_ref`` on the same store."""
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    js = JC.CacheSpec(layout=layout, block_size=T, max_seq=2 * S)
    ts = TC.CacheSpec(layout=layout, block_size=T, max_seq=2 * S)
    jc = jax.jit(JC.prefill, static_argnums=0)(js, jnp.asarray(k), jnp.asarray(v))
    tc = TC.prefill(ts, torch.from_numpy(k), torch.from_numpy(v))
    want = _jref(
        jnp.asarray(q), *_args(jc, jnp.minimum(jc.n_flushed, js.n_blocks)),
        tile=js.impl.tile_decode(js, D), block_size=T)
    got = fused_kv_attn.fused_cache_attention(
        torch.from_numpy(q), *_args(tc, torch.clamp(tc.n_flushed, max=ts.n_blocks)),
        tile=ts.impl.tile_decode(ts, D), block_size=T)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("token_wise", [False, True])
@pytest.mark.parametrize("NBLK,T,D,bits", [(2, 8, 16, 5), (4, 16, 32, 3), (1, 16, 24, 8)])
def test_plain_store_matches_reference_oracle(NBLK, T, D, bits, token_wise, rng):
    """quant_pack_ref: words bit-exact, float32 minima and steps equal."""
    x = rng.normal(size=(NBLK, T, D)).astype(np.float32)
    jw, jmn, jst = JR.quant_pack_ref(jnp.asarray(x), 0.05, bits, token_wise)
    tw, tmn, tst = TR.quant_pack_ref(torch.from_numpy(x), 0.05, bits, token_wise)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_plain_store_matches_pallas_interpret(rng):
    """The reference's Pallas Store kernel (interpret mode) on one shape:
    the port's ``quant_pack`` returns the same words and the bf16 rounding
    of its float32 scales."""
    x = rng.normal(size=(3, 16, 24)).astype(np.float32)
    for token_wise in (False, True):
        jw, jmn, jst = quant_pack_pallas(jnp.asarray(x), 0.05, 5, token_wise, interpret=True)
        tw, tmn, tst = ops.quant_pack(torch.from_numpy(x), rel_scale=0.05, bits=5,
                                      token_wise=token_wise)
        np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
        for a, b in ((jmn, tmn), (jst, tst)):
            want = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(np.uint16)
            np.testing.assert_array_equal(b.view(torch.int16).numpy().view(np.uint16), want)


def test_store_drop_sentinel_writes_nothing(rng):
    """Rows whose slot is NB (or beyond) keep every store byte."""
    spec = TC.CacheSpec(layout="packed", block_size=8, max_seq=32)
    c = TC.init_layer_cache(spec, 3, 2, 16, device="cpu")
    before = [t.clone() for t in (c.k_store, c.k_min, c.v_store, c.v_step)]
    kb = torch.from_numpy(rng.normal(size=(3, 2, 1, 8, 16)).astype(np.float32))
    slots = torch.tensor([[2], [spec.n_blocks], [spec.n_blocks + 5]])
    spec.impl.write_blocks(spec, c, slots, kb, kb)
    after = (c.k_store, c.k_min, c.v_store, c.v_step)
    for a, b in zip(before, after):
        assert torch.equal(a[1:], b[1:])
        assert not torch.equal(a[0, :, 2], b[0, :, 2])
        assert torch.equal(a[0, :, :2], b[0, :, :2])


def test_build_name_covers_included_headers(tmp_path, monkeypatch):
    """A kernel library's build name hashes its source and every csrc
    header it includes (recursively), so editing a shared header such as
    huffman.cuh rebuilds each library that includes it; no nvcc needed."""
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// not included\n")
    names = [runtime._target("k")[1].name]
    for header, text in (("a.cuh", '#pragma once\n  #include "b.cuh"\nint a;\n'),
                         ("b.cuh", "// b, edited\n")):
        (tmp_path / header).write_text(text)
        names.append(runtime._target("k")[1].name)
    (tmp_path / "c.cuh").write_text("// edited, still not included\n")
    names.append(runtime._target("k")[1].name)
    assert len(set(names[:3])) == 3 and names[3] == names[2]
    assert all(n.startswith("libk-") and n.endswith(".so") for n in names)
    # the shipped sources: both libraries that include huffman.cuh name it
    monkeypatch.undo()
    for name in ("fused_kv_attn", "huffman_decode"):
        src = runtime._target(name)[0].read_text()
        assert '#include "huffman.cuh"' in src, name
