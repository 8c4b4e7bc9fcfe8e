"""The port's `ops/spectrum` against the JAX package's, on the CPU, on the
same seeded numpy inputs.

Tolerances:
- FFT power rows: within 1e-3 dB for every bin within 60 dB of its row's
  peak, and in linear power within 2e-6 of the row's peak everywhere.
  Both packages take a float32 FFT (XLA's and pocketfft/cuFFT), each
  ~1e-7 of the row's norm from a float64 FFT; a bin 60 dB and more below
  the peak carries that absolute error as a larger share of itself (a bin
  at −70 dB is off by up to ~0.02 dB in either package against float64).
- the rest (averaging, calibration, scrolling, the scope row, the
  percentiles' dB window): 1e-3 dB, or 1e-4 where the math is
  elementwise on the same input.
- `autolevel` colors: the same integer palette index (the renderer's
  uint8 truncation) in ≥ 99.9 % of pixels and never more than 1 apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.ops import spectrum as jspec
from supersdr_tpu_torch.ops import spectrum as tspec

DB = 1e-3


def _iq(n, seed, fs=12000.0):
    """Tones of several levels (0 to −40 dB) over noise ~57 dB a bin
    below the strongest."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    z = (0.3 * np.exp(2j * np.pi * 1000 * t)
         + 0.03 * np.exp(2j * np.pi * -3100 * t)
         + 0.003 * np.exp(2j * np.pi * 4400.5 * t)
         + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n)))
    return z.astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_rows_close(ref_db, got_db):
    ref_db, got_db = np.asarray(ref_db), np.asarray(got_db)
    assert got_db.shape == ref_db.shape
    peak = ref_db.max(axis=-1, keepdims=True)
    near = ref_db >= peak - 60.0
    assert near.mean() > 0.3
    assert np.abs(got_db - ref_db)[near].max() <= DB
    p_ref, p_got = 10 ** (ref_db / 10), 10 ** (got_db / 10)
    assert (np.abs(p_got - p_ref) / 10 ** (peak / 10)).max() <= 2e-6


@pytest.mark.parametrize("kind", ["hann", "blackman", "rect"])
def test_window_matches_reference(kind):
    np.testing.assert_allclose(
        tspec.spectrum_window(512, kind, device="cpu").numpy(),
        np.asarray(jspec.spectrum_window(512, kind)), rtol=1e-7, atol=0)


@pytest.mark.parametrize("nfft,hop", [(1024, None), (1024, 256), (256, 100)])
def test_waterfall_rows_match_reference(nfft, hop):
    z = _iq(nfft * 40 + 77, 1)
    jw = jspec.spectrum_window(nfft)
    tw = tspec.spectrum_window(nfft, device="cpu")
    ref = jspec.waterfall_rows_db(z, jw, nfft, hop=hop)
    got = tspec.waterfall_rows_db(z, tw, nfft, hop=hop)
    _assert_rows_close(ref, got.numpy())


def test_power_spectrum_and_segment_rows_match_reference():
    """Complex and CX inputs, batched rows; the segmentation of real,
    complex and CX blocks with and without overlap."""
    z = _iq(8 * 512, 2).reshape(2, 4 * 512)
    rows_j = jspec.segment_rows(jnp.asarray(z), 512)
    rows_t = tspec.segment_rows(_t(z), 512)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    w = tspec.spectrum_window(512, "blackman", device="cpu")
    ref = jspec.power_spectrum_db(rows_j, jspec.spectrum_window(512,
                                                                "blackman"),
                                  cal_db=0.0)
    _assert_rows_close(ref, tspec.power_spectrum_db(rows_t, w, 0.0).numpy())
    from supersdr_tpu_torch.ops import cx
    got_cx = tspec.power_spectrum_db(cx.as_cx(rows_t), w, 0.0)
    _assert_rows_close(ref, got_cx.numpy())
    re = z.real.astype(np.float32)
    np.testing.assert_array_equal(
        tspec.segment_rows(_t(re), 256, 96).numpy(),
        np.asarray(jspec.segment_rows(jnp.asarray(re), 256, 96)))
    seg = tspec.segment_rows(cx.as_cx(z), 256, 96)
    np.testing.assert_array_equal(seg.im.numpy(), np.asarray(
        jspec.segment_rows(jnp.asarray(z.imag), 256, 96)))


@pytest.mark.parametrize("n_avg", [1, 3, 10])
def test_time_binned_average_matches_reference(n_avg):
    rng = np.random.default_rng(3)
    db = (rng.normal(size=(2, 37, 64)) * 8 - 90).astype(np.float32)
    np.testing.assert_allclose(
        tspec.time_binned_average(_t(db), n_avg).numpy(),
        np.asarray(jspec.time_binned_average(jnp.asarray(db), n_avg)),
        atol=DB, rtol=0)


def _color_index(color):
    return np.asarray(color).astype(np.uint8).astype(int)


@pytest.mark.parametrize("kw", [
    {}, dict(auto=False), dict(delta_low_db=4.0, delta_high_db=-7.0),
    dict(clip_lowp=20.0, clip_highp=99.0, min_dyn_range=30.0)])
def test_autolevel_matches_reference(kw):
    """Waterfall rows of a real spectrum; colors, dB window and range."""
    z = _iq(1024 * 96, 4)
    db = np.asarray(jspec.waterfall_rows_db(z, jspec.spectrum_window(1024),
                                            1024))
    ref = jspec.autolevel(jnp.asarray(db), **kw)
    got = tspec.autolevel(_t(db), **kw)
    ji, ti = _color_index(ref.color), _color_index(got.color.numpy())
    assert np.mean(ji == ti) >= 0.999
    assert np.abs(ji - ti).max() <= 1
    for f in ("low_db", "high_db", "dyn_range"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=DB,
                                   rtol=0)


def test_autolevel_past_the_quantile_limit():
    """16400 rows of 1024 bins (past the 2^24 elements that
    `torch.quantile` refuses in some versions): the percentiles come from
    a sort, so any row count levels; P40 and P100 as numpy's linear
    percentile."""
    rng = np.random.default_rng(5)
    db = torch.from_numpy((rng.normal(size=(16400, 1024)) * 6 - 100)
                          .astype(np.float32))
    assert db.numel() > 1 << 24
    got = tspec.autolevel(db)
    a = db.numpy()
    sample = slice(None, None, 997)
    np.testing.assert_allclose(got.low_db.numpy()[sample],
                               np.percentile(a[sample], 40.0, axis=-1),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.dyn_range.numpy() >= 40.0, True)
    np.testing.assert_allclose(
        got.high_db.numpy()[sample] - got.low_db.numpy()[sample],
        np.maximum(a[sample].max(-1) - np.percentile(a[sample], 40.0, -1),
                   40.0), atol=1e-3, rtol=0)
    assert got.color.shape == db.shape


def test_kiwi_bytes_scroll_and_scope_match_reference():
    rng = np.random.default_rng(6)
    wf = rng.integers(60, 250, size=(5, 1024)).astype(np.uint8)
    for zoom in (0, 7, 14):
        np.testing.assert_allclose(
            tspec.kiwi_byte_to_db(_t(wf), zoom).numpy(),
            np.asarray(jspec.kiwi_byte_to_db(jnp.asarray(wf), zoom)),
            atol=1e-4, rtol=0)
    hist = rng.uniform(0, 254, size=(20, 64)).astype(np.float32)
    row = rng.uniform(0, 254, size=(64,)).astype(np.float32)
    np.testing.assert_array_equal(
        tspec.scroll(_t(hist), _t(row)).numpy(),
        np.asarray(jspec.scroll(jnp.asarray(hist), jnp.asarray(row))))
    for n_rows in (1, 15):
        np.testing.assert_allclose(
            tspec.spectrum_scope_row(_t(hist), n_rows).numpy(),
            np.asarray(jspec.spectrum_scope_row(jnp.asarray(hist), n_rows)),
            atol=1e-4, rtol=0)
