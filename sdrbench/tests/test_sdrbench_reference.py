"""The plain reference against the port's plain path (its kernels' plain
versions run on the CPU) at a small size: three consecutive chunks from
the zero state, audio, RSSI and the carried state, both tiers."""

import json

import pytest
import torch

from sdrbench import check, signal, system
from sdrbench import run as R
from sdrbench.reference import pipeline

# the port's plain path against the float64 reference at 512 channels:
# quality computes in float32 (the scans' summation order leaves ~1e-5);
# fast rounds the DFT's operands, the planes and the FIR's operands to
# bf16, which weak channels read as a few % (their level is far below
# the band's, whose rounding they share)
TOL = {"hf2560_am_quality": 2e-4, "hf2560_am_fast": 0.08}


@pytest.mark.parametrize("name", sorted(TOL))
def test_reference_matches_the_port_plain_path(name):
    torch.set_num_threads(4)
    with open(R.BENCH / "configs" / f"{name}.json") as f:
        conf = json.load(f)
    dep = conf["deployment"]
    dep.update(n_chan=512, fs_in=512 * 12000)
    frames = 512
    sig = {"noise_rms": 0.02, "carrier_every": 8,
           "carrier_amp": [2e-4, 2e-2], "mod_depth": [0.3, 0.8],
           "tone_hz": [300.0, 3000.0]}
    cap = signal.make_capture(sig, 512, dep["fs_in"], 3, frames, 5, "cpu")
    prog = system.program(conf, frames, "cpu")
    tables = pipeline.make_tables(dep, "cpu")
    st, rs = prog.init_state(), pipeline.zero_state(tables, "cpu")
    rows = torch.as_tensor(prog.row_bins)
    tol = TOL[name]
    for k in range(3):
        iq = (cap.re[k], cap.im[k])
        st, audio, rssi = prog.step(st, iq)
        rs, r_audio, r_rssi, _ = pipeline.step(tables, rs, *iq, frames)
        assert check.rel_rows(audio.T, r_audio[rows]) < tol
        assert check.abs_max(rssi[:, 0], r_rssi[rows, 0]) < tol
        planes, state = check.state_errs(prog.ref_state(st), rs)
        assert planes < tol and state < tol


def test_blocks_of_any_length_give_one_stream():
    """The reference's state carries exactly: two chunks in one block read
    as two blocks of one."""
    with open(R.BENCH / "configs" / "hf2560_am_fast.json") as f:
        dep = json.load(f)["deployment"]
    dep.update(n_chan=256, fs_in=256 * 12000)
    t = pipeline.make_tables(dep, "cpu")
    g = torch.Generator().manual_seed(1)
    re, im = (torch.randint(-3000, 3000, (2 * 256 * 128,), generator=g,
                            dtype=torch.int16) for _ in range(2))
    one = pipeline.step(t, pipeline.zero_state(t, "cpu"), re, im, 128)
    half = 256 * 128
    s1, a1, r1, _ = pipeline.step(t, pipeline.zero_state(t, "cpu"), re[:half],
                               im[:half], 128)
    s2, a2, r2, _ = pipeline.step(t, s1, re[half:], im[half:], 128)
    assert torch.allclose(one[1], torch.cat([a1, a2], 1), rtol=1e-9,
                          atol=1e-12)
    assert torch.allclose(one[2], torch.cat([r1, r2], 1), atol=1e-9)
    for a, b in zip(one[0][:3], s2[:3]):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12)
    assert one[0].leaves.keys() == s2.leaves.keys()
    for k, a in one[0].leaves.items():
        assert torch.allclose(a, s2.leaves[k], rtol=1e-9, atol=1e-12), k
