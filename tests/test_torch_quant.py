"""The port's offline quantizers (``repro_torch.core.quant``), the layouts'
size accounting and ``api.estimate_ratio``, held against the reference on
the CPU: codes, mins and steps bit-exact against the reference's eager
quantizers (what its ``estimate_ratio`` runs), and ``estimate_ratio``'s
bit totals equal to the reference's for raw, packed, kivi and huffman.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import policy as JP  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import layouts, quant  # noqa: E402
from repro_torch.core.policy import CompressionPolicy  # noqa: E402

LAYOUTS = ["raw", "packed", "kivi", "huffman"]

QUANTIZERS = [
    ("quantize_k_block", (0.05, 64)), ("quantize_k_block", (0.01, 32)),
    ("quantize_k_channel", (0.05,)), ("quantize_v_token", (0.15,)),
    ("quantize_v_token", (0.003,)),  # past 255 levels: the top clips
    ("kivi_quantize_k", (2, 32)), ("kivi_quantize_k", (3, 64)), ("kivi_quantize_k", (4, 32)),
    ("kivi_quantize_v", (2,)), ("kivi_quantize_v", (3,)), ("kivi_quantize_v", (8,)),
]


@pytest.mark.parametrize("fn,args", QUANTIZERS, ids=lambda x: str(x))
def test_quantizers_bit_exact_against_reference_eager(fn, args, rng):
    x = (rng.normal(size=(256, 4, 32)) * rng.uniform(0.1, 4.0, size=(1, 4, 32))
         ).astype(np.float32)
    x[:64, 0, 0] = 1.5  # a constant unit: step 0
    q = getattr(quant, fn)(torch.from_numpy(x), *args)
    jq = getattr(JQ, fn)(jnp.asarray(x), *args)
    assert q.codes.dtype == torch.uint8
    np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(q.minval.numpy(), np.asarray(jq.minval))
    np.testing.assert_array_equal(q.step.numpy(), np.asarray(jq.step))
    np.testing.assert_array_equal(q.dequantize().numpy(), np.asarray(jq.dequantize()))
    assert (q.payload_bits_raw, q.meta_bits) == (jq.payload_bits_raw, jq.meta_bits)
    st, jst = quant.QuantStats.measure(torch.from_numpy(x), q), JQ.QuantStats.measure(x, jq)
    assert st.clip_fraction == jst.clip_fraction
    assert st.max_abs_err == pytest.approx(jst.max_abs_err, abs=1e-6)
    assert st.code_entropy_bits == pytest.approx(jst.code_entropy_bits, rel=1e-5)


def test_quantizer_shape_errors():
    with pytest.raises(ValueError, match="not a multiple"):
        quant.quantize_k_block(torch.zeros(100, 1, 8), 0.05, 64)
    with pytest.raises(ValueError, match="not a multiple"):
        quant.kivi_quantize_k(torch.zeros(100, 1, 8), 2, 32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("which", ["k", "v", "both"])
def test_estimate_ratio_bits_equal_reference(layout, which, rng):
    toks, H, D = 1024, 2, 64
    k = (rng.normal(size=(toks, H, D)) * 2.0).astype(np.float32)
    v = rng.normal(size=(toks, H, D)).astype(np.float32)
    pol = CompressionPolicy(layout=layout, block_size=64)
    jpol = JP.CompressionPolicy(layout=layout, block_size=64)
    kw = dict(k=k if which != "v" else None, v=v if which != "k" else None, which=which)
    got = api.estimate_ratio(**{**kw, "k": None if kw["k"] is None else torch.from_numpy(k),
                                "v": None if kw["v"] is None else torch.from_numpy(v)},
                             policy=pol)
    want = japi.estimate_ratio(**{**kw, "k": None if kw["k"] is None else jnp.asarray(k),
                                  "v": None if kw["v"] is None else jnp.asarray(v)},
                               policy=jpol)
    assert got["layout"] == want["layout"] == layout
    for t in ("k", "v"):
        assert (t in got) == (t in want)
        if t in got:
            assert dataclasses.asdict(got[t]) == dataclasses.asdict(want[t])
            assert got[t].total_bits == want[t].total_bits
    assert got["ratio"] == want["ratio"]


def test_estimate_ratio_orders_layouts_and_checks_arguments(rng):
    toks, H, D = 2048, 2, 64
    k = torch.from_numpy(rng.normal(size=(toks, H, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(toks, H, D)).astype(np.float32))
    r = {lay: api.estimate_ratio(k, v, policy=CompressionPolicy(layout=lay, block_size=64))
         for lay in ("raw", "packed", "huffman")}
    assert r["raw"]["ratio"] == pytest.approx(1.0)
    assert r["packed"]["ratio"] > 1.0
    assert r["huffman"]["ratio"] > r["packed"]["ratio"]
    with pytest.raises(ValueError, match="which must be"):
        api.estimate_ratio(k, v, which="q")
    with pytest.raises(ValueError, match="needs the corresponding"):
        api.estimate_ratio(k, None, which="both")
    with pytest.raises(ValueError, match="fitted codebook"):
        layouts.get_layout("huffman").size_report(
            quant.quantize_v_token(v, 0.15), block_size=64, head_dim=D)
