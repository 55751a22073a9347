"""The port's compression pipelines (``repro_torch.core.codec``) and the
straddling / adaptive bit-packing under them against the reference's on the
CPU, bit-exact: fitted codebooks, quantized codes, size reports under every
layout, the Huffman payload words and stream bit counts, the adaptive packed
container, both decodes back to the codes, and the Fig. 3 histogram."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitpack as JB  # noqa: E402
from repro.core import codec as JC  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro_torch.core import bitpack as TB  # noqa: E402
from repro_torch.core import codec as TC  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402


def _u32(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("granularity", ["block", "channel"])
def test_codec_pipelines_bit_exact(granularity, monkeypatch):
    # the reference's packing compiled once instead of op by op (the same ops)
    monkeypatch.setattr(JB, "pack_adaptive", jax.jit(
        JB.pack_adaptive, static_argnames=("capacity_words", "pow2")))
    rng = np.random.default_rng(0)
    k = rng.standard_normal((128, 4, 16)).astype(np.float32)
    v = (rng.standard_normal((128, 4, 16)) * 3).astype(np.float32)
    qc = dict(block_size=32, k_granularity=granularity)
    assert dataclasses.asdict(TQ.QuantConfig(**qc)) == dataclasses.asdict(JQ.QuantConfig(**qc))
    jc, tc = JC.KVCompCodec(JQ.QuantConfig(**qc)), TC.KVCompCodec(TQ.QuantConfig(**qc))
    with pytest.raises(ValueError, match="fit"):
        tc.report_k(tc.quantize_k(torch.as_tensor(k)))
    jc.fit(jnp.asarray(k), jnp.asarray(v))
    tc.fit(torch.as_tensor(k), torch.as_tensor(v))
    for jb, tb in ((jc.book_k, tc.book_k), (jc.book_v, tc.book_v)):
        assert np.array_equal(jb.lengths, tb.lengths)
        assert np.array_equal(jb.codes_lsb, tb.codes_lsb)
    for x, which in ((k, "k"), (v, "v")):
        jq = getattr(jc, f"quantize_{which}")(jnp.asarray(x))
        tq = getattr(tc, f"quantize_{which}")(torch.as_tensor(x))
        assert np.array_equal(np.asarray(jq.codes), tq.codes.numpy())
        for mode in ("huffman", "packed", "kivi", "raw"):
            assert (dataclasses.asdict(getattr(tc, f"report_{which}")(tq, mode))
                    == dataclasses.asdict(getattr(jc, f"report_{which}")(jq, mode))), mode
        jpay, jnb, jshape = jc.encode_huffman(jq, which)
        tpay, tnb, tshape = tc.encode_huffman(tq, which)
        assert tshape == tuple(jshape)
        assert np.array_equal(_u32(jpay), tpay.numpy())
        assert np.array_equal(np.asarray(jnb).astype(np.int64), tnb.numpy())
        # lossless: the decode gives back the quantized codes (the reference's too)
        assert np.array_equal(tc.decode_huffman(tpay, tnb, tshape, which).numpy(),
                              tq.codes.numpy())
        ja, ta = jc.encode_packed(jq), tc.encode_packed(tq)
        assert np.array_equal(_u32(ja.payload), ta.payload.numpy())
        for f in ("offsets", "bits", "nwords"):
            assert np.array_equal(np.asarray(getattr(ja, f)), getattr(ta, f).numpy()), f
        assert int(ta.payload_bits) == int(ja.payload_bits) and ta.meta_bits == ja.meta_bits
        assert np.array_equal(tc.decode_packed(ta, tshape).numpy(), tq.codes.numpy())
        assert np.array_equal(TC.compute_histogram_figure(tq.codes),
                              JC.compute_histogram_figure(jq.codes))


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_bits_bit_exact(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, (5, 37)).astype(np.uint8)
    words = TB.pack_bits(torch.as_tensor(codes), bits)
    assert np.array_equal(_u32(JB.pack_bits(jnp.asarray(codes), bits)), words.numpy())
    assert np.array_equal(TB.unpack_bits(words, bits, 37).numpy(), codes)
    assert TB.packed_words(37, bits) == JB.packed_words(37, bits) == words.shape[-1]


@pytest.mark.parametrize("pow2", [False, True])
def test_pack_adaptive_bit_exact(pow2):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 40, (6, 64)).astype(np.uint8)
    codes[2], codes[3] = 1, 200  # the narrowest and the widest block
    ja = jax.jit(JB.pack_adaptive, static_argnums=(1, 2))(jnp.asarray(codes), 200, pow2)
    ta = TB.pack_adaptive(torch.as_tensor(codes), 200, pow2)
    assert np.array_equal(_u32(ja.payload), ta.payload.numpy())
    assert np.array_equal(np.asarray(ja.bits), ta.bits.numpy())
    assert np.array_equal(TB.unpack_adaptive(ta).numpy(), codes)
    assert np.array_equal(TB.choose_bits(torch.as_tensor(codes), (1,), pow2).numpy(),
                          np.asarray(JB.choose_bits(jnp.asarray(codes), (1,), pow2)))
