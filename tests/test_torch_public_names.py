"""The port's public surface against the reference's: every public
top-level name of a reference module has a counterpart of the same name in
the port's module at the same path (`ops/pallas/X` ↔ `ops/cuda/X`), less a
named list of JAX idiom; and each function ported for that runs against its
JAX counterpart on the CPU, on the same seeded numpy inputs.

Tolerances: the numpy design functions and the cumulative max are exact;
the FFT and matmul filters and the channelizer agree to 2e-5 of the
reference's peak (float32 transforms and products of a few thousand
terms, summed in another order)."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.ops import channelizer as jch
from supersdr_tpu.ops import cx as jcx
from supersdr_tpu.ops import fir_matmul as jfm
from supersdr_tpu.ops import firdesign as jfd
from supersdr_tpu.ops import overlap_save as jos
from supersdr_tpu.ops import scans as jsc
from supersdr_tpu_torch.ops import channelizer as tch
from supersdr_tpu_torch.ops import fir_matmul as tfm
from supersdr_tpu_torch.ops import firdesign as tfd
from supersdr_tpu_torch.ops import overlap_save as tos
from supersdr_tpu_torch.ops import scans as tsc

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 2e-5

_SPLIT = ("split-complex helpers: the reference carries complex values as "
          "float pairs because its TPU runtime could not move complex64; "
          "the port's ops take complex64 tensors and torch.fft")
_TRACED = ("the traced half of a jax.jit entry point; the port has no "
           "tracing")
_AXIS = ("a shard_map axis name; the port's shards are a tensor axis "
         "(parallel/mesh.py)")
_SHARDING = "a jax NamedSharding; the port places tensors on one device"
_HLO = ("reads collectives out of lowered HLO on the TPU's ICI; the port "
        "counts bytes as it moves them (collectives.traffic) and takes "
        "link numbers as arguments")
# reference public names with no same-named counterpart, and why
JAX_IDIOM = {
    "ops/adpcm.py": {"decode_jax": "the JAX decoder; the port's is "
                                   "decode_torch"},
    "ops/cx.py": {n: _SPLIT for n in (
        "MAX_DIRECT", "concatenate", "exp_i", "fft", "fft_rotate",
        "fft_supported", "ifft", "ifft_major", "make_dot",
        "resolve_precision", "split", "stack", "swapaxes", "to_complex",
        "to_numpy")},
    "ops/pallas/channelize_fused.py": {
        "STAGEB_2DOT": "the TPU kernel's choice of two dots or three for "
                       "the same stage-B product, read from an environment "
                       "variable; the port's kernel has one form and reads "
                       "no environment variable"},
    "ops/pallas/halo.py": {
        "left_halo_rdma": "the port's halo kernel wrapper is left_halo, "
                          "one entry for both halo impls"},
    "ops/pallas/pfb_fold.py": {
        "pfb_fold_c": "the port's fold kernel wrapper is pfb_fold",
        "channelize_pallas": "the split-complex form of "
                             "channelize_pallas_c, which the port has"},
    "parallel/comm_model.py": {n: _HLO for n in (
        "CollectiveStats", "ICI_ALPHA_S", "collective_bytes_from_hlo",
        "lower_hlo")},
    "parallel/dist_fft.py": {"AXIS": _AXIS},
    "parallel/mesh.py": {n: _SHARDING for n in (
        "chan_sharding", "grid_sharding", "time_sharding")},
    "parallel/pipeline.py": {"AXIS": _AXIS},
    "parallel/sharded_wideband.py": {"AXIS": _AXIS},
    "runtime/wideband.py": {n: _TRACED for n in (
        "process_traced", "process_n_traced", "process_many_traced")},
}


def _defined(tree: ast.Module) -> set:
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _public_names(path: Path, *, imported: bool) -> set:
    """Top-level public names; with `imported`, also those taken in by
    `from … import` (the port re-exports some from elsewhere)."""
    tree = ast.parse(path.read_text())
    names = _defined(tree)
    if imported:
        names |= {a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names}
    return names


def _counterpart(rel: Path) -> Path:
    parts = ("ops", "cuda", *rel.parts[2:]) \
        if rel.parts[:2] == ("ops", "pallas") else rel.parts
    return REPO / "supersdr_tpu_torch" / Path(*parts)


def test_public_names_diff_is_the_named_jax_idiom():
    """Every reference module has a counterpart, and the counterpart
    defines every public name but those listed (with a reason each) in
    JAX_IDIOM; and each listed name is still missing, so the list shrinks
    as names are ported."""
    missing = {}
    for ref in sorted((REPO / "supersdr_tpu").rglob("*.py")):
        rel = ref.relative_to(REPO / "supersdr_tpu")
        port = _counterpart(rel)
        assert port.exists(), f"no counterpart of supersdr_tpu/{rel}"
        gap = _public_names(ref, imported=False) \
            - _public_names(port, imported=True)
        if gap:
            missing[rel.as_posix()] = gap
    assert missing == {k: set(v) for k, v in JAX_IDIOM.items()}
    assert all(reason for v in JAX_IDIOM.values() for reason in v.values())


def _np(z):
    if isinstance(z, jcx.CX):
        return jcx.to_numpy(z)
    if isinstance(z, torch.Tensor):
        return z.numpy()
    return np.asarray(z)


def _close(ref, got):
    ref, got = _np(ref), _np(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL_TOL * float(np.abs(ref).max()))


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def case_freq_response(rng):
    taps = jfd.complex_bandpass_taps(-2000.0, 3000.0, 12000.0, n=65)
    np.testing.assert_array_equal(tfd.freq_response(taps, 256),
                                  jfd.freq_response(taps, 256))


def case_brickwall_mask(rng):
    for args in ((512, 12000.0, 300.0, 2700.0), (1000, 48000.0, -5000.0,
                                                 -100.0, 250.0)):
        np.testing.assert_array_equal(tfd.brickwall_mask(*args),
                                      jfd.brickwall_mask(*args))


def case_polyphase_decompose(rng):
    for n, branches in ((257, 4), (64, 8), (10, 16)):
        taps = rng.normal(size=n)
        np.testing.assert_array_equal(tfd.polyphase_decompose(taps, branches),
                                      jfd.polyphase_decompose(taps, branches))


def case_filter_signal(rng):
    real = jfd.lowpass_taps(1500.0, 12000.0)
    cplx = jfd.complex_bandpass_taps(300.0, 2700.0, 12000.0)
    x_real = rng.normal(size=(3, 5000)).astype(np.float32)
    for taps, x in ((real, x_real), (cplx, x_real),
                    (real, _cplx(rng, 2, 3000))):
        ref = jos.filter_signal(taps, x, block=1024)
        got = tos.filter_signal(taps, x, block=1024, device="cpu")
        assert np.iscomplexobj(got) == np.iscomplexobj(ref)
        _close(ref, got)


def case_overlap_save(rng):
    """Two chained streaming steps, the carry threaded through."""
    taps = jfd.complex_bandpass_taps(-1000.0, 2500.0, 12000.0, n=129)
    plan_j, plan_t = jos.plan_for(512, 129), tos.plan_for(512, 129)
    Hj, Ht = jos.taps_to_freq(plan_j, taps), tos.taps_to_freq(
        plan_t, taps, "cpu")
    cj = ct = _cplx(rng, 2, 128) * 0.1
    for _ in range(2):
        x = _cplx(rng, 2, 512)
        cj, yj = jos.overlap_save(plan_j, Hj, cj, x)
        ct, yt = tos.overlap_save(plan_t, Ht, ct, x)
        _close(yj, yt)
        _close(cj, ct)


def case_overlap_save_c(rng):
    taps = jfd.lowpass_taps_n(2000.0, 12000.0, 33)
    plan_j, plan_t = jos.plan_for(256, 33), tos.plan_for(256, 33)
    H = np.fft.fft(taps, n=plan_j.fft_size).astype(np.complex64)
    carry, x = _cplx(rng, 32), rng.normal(size=256).astype(np.float32)
    cj, yj = jos.overlap_save_c(plan_j, jnp.asarray(H), jnp.asarray(carry),
                                jnp.asarray(x))
    ct, yt = tos.overlap_save_c(plan_t, torch.from_numpy(H),
                                torch.from_numpy(carry), torch.from_numpy(x))
    _close(yj, yt)
    _close(cj, ct)


def case_overlap_save_batch(rng):
    """Short and long overlaps (the slice and the gather forms)."""
    for block, n_taps in ((256, 65), (64, 129)):
        taps = jfd.complex_bandpass_taps(-3000.0, 1000.0, 12000.0, n=n_taps)
        plan_j, plan_t = jos.plan_for(block, n_taps), tos.plan_for(
            block, n_taps)
        head, x = _cplx(rng, 3, n_taps - 1), _cplx(rng, 3, 4, block)
        yj = jos.overlap_save_batch(plan_j, jos.taps_to_freq(plan_j, taps),
                                    head, x)
        yt = tos.overlap_save_batch(
            plan_t, tos.taps_to_freq(plan_t, taps, "cpu"), head, x)
        _close(yj, yt)


def case_channelize(rng):
    """Critical sampling and 2× oversampling (the mixer rotation)."""
    for M, K, osr in ((16, 4, 1), (32, 8, 2)):
        plan_j, proto = jch.design(M, K, osr)
        plan_t, _ = tch.design(M, K, osr)
        carry, x = _cplx(rng, plan_j.history), _cplx(rng, 4 * M)
        cj, yj = jch.channelize(plan_j, jch.taps_matrix(plan_j, proto),
                                carry, x)
        ct, yt = tch.channelize(plan_t, tch.taps_matrix(plan_t, proto,
                                                        "cpu"), carry, x)
        _close(yj, yt)
        _close(cj, ct)


def case_fir_matmul_stream(rng):
    """A chunk that is not a multiple of the block, then one shorter than
    the history."""
    taps = jfd.complex_bandpass_taps(-2500.0, 2500.0, 12000.0, n=257)
    plan_j, plan_t = jfm.plan_for(1000, 257), tfm.plan_for(1000, 257)
    Wj, Wt = jfm.build_w(plan_j, taps), tfm.build_w(plan_t, taps, "cpu")
    cj = ct = _cplx(rng, 2, 256)
    for n in (1000, 100):
        x = _cplx(rng, 2, n)
        cj, yj = jfm.fir_matmul_stream(plan_j, Wj, cj, x)
        ct, yt = tfm.fir_matmul_stream(plan_t, Wt, ct, x)
        _close(yj, yt)
        _close(cj, ct)


def case_blocked_cummax(rng):
    for shape in ((3, 1024), (5, 1000), (128,)):
        s = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(
            tsc.blocked_cummax(torch.from_numpy(s)).numpy(),
            np.asarray(jsc.blocked_cummax(jnp.asarray(s))))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ported_function_matches_the_reference(name):
    CASES[name](np.random.default_rng(11))


def test_filter_signal_runs_on_the_card_unless_asked(monkeypatch):
    """The host convenience still computes on the card by default: with no
    CUDA device and no device given it raises and names the way out."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tos.filter_signal(np.ones(3), np.ones(8), block=8)
