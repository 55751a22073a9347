"""The port's no-straddle bit-packing vs the reference: words bit-for-bit
(int32 bit patterns read as uint32), for every code width 1..8."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import bitpack as JB  # noqa: E402
from repro_torch.core import bitpack as TB  # noqa: E402


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_unpack_nostraddle_bit_exact(bits, rng):
    L = 77  # not a multiple of any codes-per-word: exercises the padded tail
    codes = rng.integers(0, 2**bits, size=(3, 5, L)).astype(np.uint8)
    jw = np.asarray(JB.pack_nostraddle(jnp.asarray(codes), bits))
    tw = TB.pack_nostraddle(torch.from_numpy(codes), bits)
    assert tw.dtype == torch.int32 and tw.shape[-1] == TB.nostraddle_words(L, bits)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)

    tu = TB.unpack_nostraddle(tw, bits, L).numpy()
    np.testing.assert_array_equal(tu, np.asarray(JB.unpack_nostraddle(jnp.asarray(jw), bits, L)))
    np.testing.assert_array_equal(tu, codes)

    flat = jw.reshape(-1, jw.shape[-1])[0]
    jt = np.asarray(JB.unpack_nostraddle_tile(jnp.asarray(flat), bits, L))
    tt = TB.unpack_nostraddle_tile(torch.from_numpy(flat.view(np.int32).copy()), bits, L).numpy()
    np.testing.assert_array_equal(tt, jt.astype(np.int64))
