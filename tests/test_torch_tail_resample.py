"""The time-major tails' resampler, modelled in numpy, and the tool that
makes copies of it with a phase changed.

In `csrc/chain_tail.cu` (`tail_resample4`) a block of 8 warps resamples 8
channels ×4, register-blocked: thread (warp w, lane 8g + c) owns channel c
and tile samples t = 128·s + 32·g + 4·w + r, r < 4, so one P row serves 4
samples and the window slides in registers. This file repeats that index
arithmetic — the kernel runs only on a CUDA device — and checks that every
(sample, channel) of a tile is resampled once, that a warp's window loads
hit 32 banks (rows with a pad word every 32 samples, row strides ≡ 4 mod
32), and that a warp's stores are 4 rows of 8 channels (32-byte pieces).
"""

from pathlib import Path

import numpy as np
import pytest

from supersdr_tpu_torch.tools import tail_phases

KRS, KCB, KTILE = 4, 8, 256


def skew(t):
    return t + (t >> 5)


def row_stride(n):
    return (n + 27) // 32 * 32 + 4


def owned(tid, s):
    """(channel, first tile sample) of thread tid in step s."""
    c, g, w = tid & 7, tid >> 3 & 3, tid >> 5
    return c, 128 * s + 32 * g + KRS * w


@pytest.mark.parametrize("tlen", [KTILE, 128, 512])
def test_every_sample_and_channel_resampled_once(tlen):
    seen = np.zeros((tlen, KCB), int)
    for s in range(-(-tlen // 128)):
        for tid in range(256):
            c, n0 = owned(tid, s)
            for r in range(KRS):
                if n0 + r < tlen:
                    seen[n0 + r, c] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("per,H", [(9, 32), (33, 64)])
def test_window_loads_hit_32_banks(per, H):
    """Each warp load (fixed step, sample r, tap m) of the window: 32 words
    of the 8 channels' rows in 32 banks."""
    S1 = row_stride(skew(H + KTILE))
    hoff = H - (per - 1)
    for w in range(KCB):
        for r in range(KRS + per - 1):
            banks = set()
            for lane in range(32):
                c, n0 = owned(32 * w + lane, 0)
                banks.add((c * S1 + skew(hoff + n0 + r)) % 32)
            assert len(banks) == 32


def test_a_warps_stores_are_4_rows_of_8_channels():
    for w in range(KCB):
        for r in range(KRS):
            for q in range(4):
                rows = {}
                for lane in range(32):
                    c, n0 = owned(32 * w + lane, 0)
                    rows.setdefault(4 * (n0 + r) + q, set()).add(c)
                assert len(rows) == 4
                assert all(v == set(range(KCB)) for v in rows.values())


@pytest.mark.parametrize("name", sorted(tail_phases.EDITS))
def test_phase_copies_apply_to_the_source(name, tmp_path):
    """Every copy the tool makes applies to the tail source as it stands,
    and changes it."""
    out = tail_phases.make_copy(tmp_path, name)
    src = (Path(tail_phases.REPO) / tail_phases.SOURCE).read_text()
    got = (out / tail_phases.SOURCE).read_text()
    assert got != src
    assert (out / "chip_smoke.py").is_file()
    assert not (out / "supersdr_tpu_torch" / "build").exists()
