"""The wideband's tier facts and planar row order have one owner each, and
every reader of them agrees, on the CPU.

The planar row order is `channelize_fused.planar_order` (row k1·n2 + k2
holds bin k2·n1 + k1); the serial planar tier (`wideband.
audio_channel_order`) and the mesh's (`process.channel_order`, whose real
rows come first) both read it. The in-tail FIR block is
`chain.tail_fir_block`; the chain's parameters (`W_tailpass`), the serial
planar predicate and the mesh's planar tier all decide by it.
"""

import numpy as np
import pytest

from supersdr_tpu_torch.ops.cuda import channelize_fused as tcf
from supersdr_tpu_torch.parallel import sharded_wideband as tsw
from supersdr_tpu_torch.runtime import chain as tchain
from supersdr_tpu_torch.runtime import wideband as twb

HEADLINE = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 16128,
                mode="AM", taps_per=8, n_taps=257, audio_rate=48_000)


def _is_permutation(order: np.ndarray, n: int) -> bool:
    return np.array_equal(np.sort(order), np.arange(n))


@pytest.mark.parametrize("profile", ["fast", "quality"])
def test_the_serial_planar_rows_are_the_planar_order(profile):
    """HEADLINE's serial factoring (10, 256) on either tier."""
    cfg = twb.WidebandConfig(**HEADLINE, **twb.PROFILES[profile])
    facts = twb.tier_facts(cfg)
    assert facts.planar and facts.factors == (10, 256)
    order = tcf.planar_order(2560, 10, 256)
    np.testing.assert_array_equal(twb.audio_channel_order(cfg), order)
    assert _is_permutation(order, 2560)
    # row 1 is bin n1 (plane 0, column 1); row n2 is bin 1 (plane 1)
    assert (order[1], order[256]) == (10, 1)


@pytest.mark.parametrize("d, factors", [(8, (20, 128, 24)),
                                        (4, (20, 128, 20)),
                                        (2, (10, 256, 10))])
def test_the_mesh_planar_rows_are_the_planar_order(d, factors):
    """The mesh's real rows, on the 8-shard padded form and on two shard
    counts with no phantom planes."""
    cfg = twb.WidebandConfig(**HEADLINE, **twb.PROFILES["fast"])
    proc = tsw.build(cfg, tsw.make_mesh(d, device="cpu"))
    assert proc.tier == "planar" and proc.planar_factors == factors
    n1, n2, _ = factors
    order = np.asarray(proc.channel_order)
    np.testing.assert_array_equal(order[:2560],
                                  tcf.planar_order(2560, n1, n2))
    assert _is_permutation(order, 2560)


@pytest.mark.parametrize("n_taps, planar", [(129, True), (33, False)])
def test_the_fir_block_decides_every_reader(n_taps, planar):
    """A passband with an in-tail FIR block runs the planar tiers and gets
    its in-tail taps; 33 taps have none: no in-tail taps, the time-major
    tier on one device and on the mesh."""
    kw = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
              taps_per=4, n_taps=n_taps, mode="AM")
    cfg = twb.WidebandConfig(**kw, **twb.PROFILES["quality"])
    ccfg = cfg.chain_cfg
    block = tchain.tail_fir_block(ccfg)
    assert (block is not None) == planar
    assert block == tchain._tail_plan(ccfg).fir_block
    params = tchain.make_params(ccfg, device="cpu")
    assert (params.W_tailpass is not None) == planar
    assert twb._planar_active(cfg) == twb.tier_facts(cfg).planar == planar
    assert twb.tier_facts(cfg).fused
    assert tsw.plan_mesh(cfg, 2).tier == ("planar" if planar else "tmajor")
