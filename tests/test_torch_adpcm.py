"""The port's ADPCM codec against the JAX package's, on the CPU: the
scan-based `decode_torch` bit for bit against `decode_np` and
`decode_jax` (int16 samples and the carried (index, prev)), streamed in
pieces with the state carried, and the copied numpy codec against the
reference's on the same bytes."""

import numpy as np
import pytest
import torch

from supersdr_tpu.ops import adpcm as jad
from supersdr_tpu_torch.ops import adpcm as tad
from supersdr_tpu_torch.ops import scans


def _bytes(n, seed):
    return bytes(np.random.default_rng(seed).integers(0, 256, n,
                                                      dtype=np.uint8))


def _loud_stream(n, seed):
    """ADPCM of a full-scale noisy signal: the sample saturates at both
    rails and the step index at 88 and 0."""
    rng = np.random.default_rng(seed)
    x = np.clip(np.round(rng.normal(size=2 * n) * 30000), -32768, 32767)
    return jad.encode_np(x.astype(np.int16))


@pytest.mark.parametrize("data", ["random", "loud", "one-byte"])
@pytest.mark.parametrize("state0", [(0, 0), (37, -20000), (88, 32767)])
def test_decode_torch_matches_np_and_jax(data, state0):
    b = {"random": _bytes(1500, 1), "loud": _loud_stream(1200, 2),
         "one-byte": _bytes(1, 3)}[data]
    st = jad.AdpcmState(*state0)
    ref = jad.decode_np(b, st)
    got, index, prev = tad.decode_torch(b, *state0, device="cpu")
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (index, prev) == (st.index, st.prev)
    js, ji, jp = jad.decode_jax(np.frombuffer(b, np.uint8), *state0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js))
    assert (index, prev) == (int(ji), int(jp))


def test_decode_torch_streams_with_carried_state():
    b = _loud_stream(2000, 4) + _bytes(777, 5)
    full = jad.decode_np(b)
    parts, index, prev = [], 0, 0
    for lo, hi in [(0, 1), (1, 500), (500, 1999), (1999, len(b))]:
        out, index, prev = tad.decode_torch(
            torch.frombuffer(bytearray(b[lo:hi]), dtype=torch.uint8),
            index, prev)
        parts.append(out.numpy())
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_decode_torch_of_nothing_keeps_the_state():
    out, index, prev = tad.decode_torch(b"", 12, -7, device="cpu")
    assert out.shape == (0,) and (index, prev) == (12, -7)


def test_numpy_codec_matches_reference():
    rng = np.random.default_rng(6)
    x = (8000 * np.sin(2 * np.pi * 440 * np.arange(5001) / 12000)
         + rng.normal(size=5001) * 300).astype(np.int16)
    sj, st = jad.AdpcmState(), tad.AdpcmState()
    enc = tad.encode_np(x, st)
    assert enc == jad.encode_np(x, sj)
    assert (st.index, st.prev) == (sj.index, sj.prev)
    np.testing.assert_array_equal(tad.decode_np(enc), jad.decode_np(enc))
    np.testing.assert_array_equal(tad.STEP_SIZES, jad.STEP_SIZES)
    np.testing.assert_array_equal(tad.INDEX_ADJUST, jad.INDEX_ADJUST)


def test_saturating_add_scan_matches_a_loop():
    """The scan itself: random adds over narrow and wide bounds."""
    rng = np.random.default_rng(7)
    for lo, hi, scale in [(0, 88, 8), (-32768, 32767, 40000), (-3, 5, 2)]:
        a = rng.integers(-scale, scale + 1, size=1001)
        y0 = int(rng.integers(lo, hi + 1))
        want, y = [], y0
        for v in a:
            y = min(max(y + int(v), lo), hi)
            want.append(y)
        got = scans.saturating_add_scan(torch.from_numpy(a), lo, hi, y0)
        np.testing.assert_array_equal(got.numpy(), want)
