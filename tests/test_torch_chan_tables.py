"""The channelizer kernel's stage-A tables and launch plan, on the CPU.

The kernel reads stage A as two factors, the n1-point DFT W_n1^{j1·k1} and
the twiddle row W_M^{j2·k1} (`channelize_fused._stagea_tables`), where the
plain version and the reference read their product A (`_dif_tables`).
Here: the factors rebuild A; the reference's A still matches the port's
bit for bit; a float64 model of the factored stage A (then stage B) agrees
with the float32 plain version; the tile plan the wrapper mirrors from the
kernel, and the shapes it refuses before anything is built; and the phase
copies of `tools/chan_phases.py` apply to the kernel's source.

Tolerances: each factor is rounded once to float32 (≤ 2^-24 relative a
component, magnitude 1), so their product is within 2e-7 of A's float32
value; the float32 plain version sums 8 fold taps, n1 stage-A terms and
n2 stage-B terms, ~1e-7 relative each, so ≥ 120 dB against float64.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from supersdr_tpu.ops import channelizer as jch
from supersdr_tpu_torch.ops import channelizer as tch
from supersdr_tpu_torch.ops.cuda import channelize_fused as tcf
from supersdr_tpu_torch.tools import chan_phases

# the serial headline, the mesh's, and those of tests/test_torch_channelizer
FACTORINGS = [(2560, 10, 256), (2560, 20, 128), (512, 2, 256),
              (2560, 5, 512), (1024, 4, 256)]


@pytest.mark.parametrize("M,n1,n2", FACTORINGS)
def test_factored_tables_rebuild_the_stage_a_matrix(M, n1, n2):
    dft, tw = (t.numpy().astype(np.float64)
               for t in tcf._stagea_tables(M, n1, n2, "cpu"))
    assert dft.shape == (n1, n1, 2) and tw.shape == (n1, n2, 2)
    d = dft[..., 0] + 1j * dft[..., 1]                  # [j1, k1]
    w = tw[..., 0] + 1j * tw[..., 1]                    # [k1, j2]
    prod = d.T[None, :, :] * w.T[:, :, None]            # [j2, k1, j1]
    Ar, Ai, _, _ = tch._dif_tables(M, n1, n2)
    assert np.abs(prod.real - Ar).max() <= 2e-7
    assert np.abs(prod.imag - Ai).max() <= 2e-7
    assert np.abs(np.abs(d) - 1).max() <= 2e-7
    assert np.abs(np.abs(w) - 1).max() <= 2e-7


@pytest.mark.parametrize("M,n1,n2", [(2560, 20, 128), (2560, 10, 256)])
def test_reference_dif_tables_match_the_ports_factors(M, n1, n2):
    """The reference's A and C2, bit for bit, from the port's factors."""
    d1, tw = tch._dif_factors(M, n1, n2)
    A = d1.T[None, :, :] * tw[:, :, None]
    ref = jch._dif_tables(M, n1, n2)
    np.testing.assert_array_equal(ref[0], A.real.astype(np.float32))
    np.testing.assert_array_equal(ref[1], A.imag.astype(np.float32))
    for a, b in zip(ref, tch._dif_tables(M, n1, n2)):
        np.testing.assert_array_equal(a, b)


def _snr(ref, got):
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-300))


@pytest.mark.parametrize("n1,n2", [(10, 256), (20, 128)])
def test_float64_factored_model_meets_the_plain_version(n1, n2):
    """Fold, then Y = tw·Σ_j1 dft·fold, then stage B, in float64 from the
    float32 factors, against `channelize_fused_plain` (float32, quality
    tier, two shards so the carry heads differ)."""
    M, K, nf, D = n1 * n2, 8, 12, 2
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, D, nf, M)).astype(np.float32) * 0.05
    head = rng.normal(size=(2, D, K - 1, M)).astype(np.float32) * 0.05
    g2 = rng.normal(size=(K, M)).astype(np.float32) * 0.3
    At_r, At_i, c2 = tcf._tables(M, n1, n2, False, "cpu")
    got = tcf.channelize_fused_plain(
        torch.from_numpy(g2), At_r, At_i, c2, *map(torch.from_numpy, head),
        *map(torch.from_numpy, x), n1=n1, n2=n2, in_scale=0.0, bf16_b=False,
        out_dtype=torch.float32)
    dft, tw = (t.numpy().astype(np.float64)
               for t in tcf._stagea_tables(M, n1, n2, "cpu"))
    d = dft[..., 0] + 1j * dft[..., 1]                  # [j1, k1]
    w = tw[..., 0] + 1j * tw[..., 1]                    # [k1, j2]
    seg = np.concatenate([head, x], axis=2).astype(np.float64)
    seg = seg[0] + 1j * seg[1]                          # [D, K−1+nf, M]
    fold = sum(g2[k].astype(np.float64) * seg[:, k:k + nf] for k in range(K))
    f3 = fold.reshape(D, nf, n1, n2)                    # [D, t, j1, j2]
    y = np.einsum("jk,dtjn->dktn", d, f3) * w[None, :, None, :]
    c = c2.numpy().astype(np.float64)
    out = y @ (c[..., 0] + 1j * c[..., 1])              # [D, k1, t, k2]
    for ref, g in ((out.real, got[0]), (out.imag, got[1])):
        assert g.shape == (D, n1, nf, n2)
        assert _snr(ref, g.double().numpy()) >= 120.0


@pytest.mark.parametrize("n1,n2,split,time,T", [
    (10, 256, False, False, 8), (10, 256, True, False, 8),
    (10, 256, False, True, 8), (10, 256, True, True, 8),
    (20, 128, False, False, 8), (20, 128, True, True, 4),
    (12, 256, True, True, 4), (5, 512, True, False, 4),
    (48, 128, True, False, 2), (48, 128, False, True, 0),
    (2, 2048, True, False, 0), (2, 2048, False, False, 8)])
def test_tile_frames(n1, n2, split, time, T):
    assert tcf.tile_frames(n1, n2, split=split, time=time) == T


@pytest.mark.parametrize("n1,n2,bf16_b,factored", [
    (10, 256, True, 467744), (10, 256, False, 729888),
    (20, 128, True, 273536)])
def test_l2_table_bytes(n1, n2, bf16_b, factored):
    """What a block of 8 frames reads of the tables out of L2 at 2560
    channels and 8 taps."""
    assert tcf.l2_table_bytes(2560, 8, n1, n2, 8, bf16_b) == factored


@pytest.mark.parametrize("n1,n2,K,bf16_b,layout,what", [
    (10, 256, 9, True, "raw3", "taps"), (10, 256, 0, True, "raw3", "taps"),
    (48, 128, 8, True, "time", "shared memory"),
    (2, 2048, 8, False, "raw3", "shared memory"),
    (10, 200, 8, True, "raw3", "multiple of 128")])
def test_wrapper_refuses_shapes_before_launch(n1, n2, K, bf16_b, layout,
                                              what, monkeypatch):
    """`_launch` refuses what the kernel cannot take before it loads (or
    builds) the kernel library."""
    def no_load():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(tcf._build, "load", no_load)
    M, nf = n1 * n2, 4
    x = torch.zeros(nf, M)
    head = torch.zeros(max(K - 1, 0), M)
    with pytest.raises(ValueError, match=what):
        tcf._launch(torch.zeros(K, M), None, None, None, head, head, x, x,
                    n1=n1, n2=n2, in_scale=0.0, bf16_b=bf16_b,
                    out_dtype=torch.float32, out_layout=layout)
    assert tcf.check_shape(10, 256, 8, bf16_b=bf16_b,
                           out_layout=layout) == 8


@pytest.mark.parametrize("name", sorted(chan_phases.PHASES))
def test_phase_copies_apply_to_the_source(name, tmp_path):
    """Every copy the tool makes applies to the kernel's source as it
    stands, and changes it; a source with none of a phase's lines stops
    it."""
    out = chan_phases.make_copy(tmp_path, name)
    src = (Path(chan_phases.REPO) / chan_phases.SOURCE).read_text()
    got = (out / chan_phases.SOURCE).read_text()
    assert got != src and (out / "chip_smoke.py").is_file()
    assert not (out / "supersdr_tpu_torch" / "build").exists()
    with pytest.raises(SystemExit):
        chan_phases.apply_phase("int main() {}\n", name)
