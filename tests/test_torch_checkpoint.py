"""The port's stream checkpoint against the JAX package's, on the CPU.

A checkpoint written by either package resumes in the other: the loaded
state equals the writer's leaf by leaf (by value, in the reference's
`jax.tree.flatten` order), and the stream resumed from it equals, sample
for sample, the same package's stream resumed from the writer's state
handed over in memory (`convert.*_from_jax` one way, `jax.tree.unflatten`
the other). Against the writer's own uninterrupted stream the resumed
audio meets the cross-package bounds of tests/test_torch_chain.py and
tests/test_torch_wideband_chanmajor.py: SNR ≥ 80 dB and, on the chain,
atol 2e-4 (float32 summation order through the DC pole and the AGC).
Within the port, a run checkpointed mid-way is bit-identical to an
uninterrupted one (the reference's own test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu.runtime import checkpoint as jckpt
from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch import convert
from supersdr_tpu_torch.runtime import chain as tchain
from supersdr_tpu_torch.runtime import checkpoint as tckpt
from supersdr_tpu_torch.runtime import wideband as twb

AUDIO_DB = 80.0
CHAIN_ATOL = 2e-4
N_CHUNKS = 4
SPLIT = 2


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _tone_iq(n, fs=12000, seed=0):
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)
    return (np.exp(2j * np.pi * 1000 * t)
            + 0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).astype(np.complex64)


class _Chain:
    """One USB receiver, 4096-sample chunks (the reference's test)."""
    kw = dict(mode="USB", chunk=4096, os_block=4096)

    def __init__(self):
        self.jcfg = jchain.ChainConfig(**self.kw)
        self.tcfg = tchain.ChainConfig(**self.kw)
        self.jparams = jchain.make_params(self.jcfg)
        self.tparams = convert.chain_params_from_jax(self.jparams,
                                                     device="cpu")
        iq = _tone_iq(N_CHUNKS * 4096)
        self.chunks = [iq[i:i + 4096] for i in range(0, iq.size, 4096)]

    def j_init(self):
        return jchain.init_state(self.jcfg)

    def t_init(self):
        return tchain.init_state(self.tcfg, device="cpu")

    def j_step(self, st, blk):
        st, out = jchain.process(self.jcfg, self.jparams, st,
                                 jnp.asarray(blk))
        return st, np.asarray(out.audio)

    def t_step(self, st, blk):
        st, out = tchain.process(self.tcfg, self.tparams, st,
                                 torch.from_numpy(blk))
        return st, out.audio.numpy()

    to_port = staticmethod(convert.chain_state_from_jax)


class _Wideband:
    """The reference's small wideband state: 8 channels at 96 kHz, the
    chan-major tier, 2048 frames a chunk."""
    kw = dict(fs_in=96_000, n_chan=8, chunk_in=16384, mode="AM")

    def __init__(self):
        self.jcfg = jwb.WidebandConfig(**self.kw)
        self.tcfg = twb.WidebandConfig(**self.kw)
        self.jparams = jwb.make_params(self.jcfg)
        self.tparams = convert.params_from_jax(self.jparams, device="cpu")
        rng = np.random.default_rng(3)
        n = N_CHUNKS * 16384
        t = np.arange(n) / 96_000
        iq = (0.3 * (1 + 0.5 * np.sin(2 * np.pi * 400 * t))
              * np.exp(2j * np.pi * 24_000 * t)
              + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n)))
        iq = iq.astype(np.complex64)
        self.chunks = [iq[i:i + 16384] for i in range(0, n, 16384)]

    def j_init(self):
        return jwb.init_state(self.jcfg)

    def t_init(self):
        return twb.init_state(self.tcfg, device="cpu")

    def j_step(self, st, blk):
        st, out = jwb.process(self.jcfg, self.jparams, st, jnp.asarray(blk))
        return st, np.asarray(out.audio)

    def t_step(self, st, blk):
        st, out = twb.process(self.tcfg, self.tparams, st, blk)
        return st, out.audio.numpy()

    to_port = staticmethod(convert.state_from_jax)


KINDS = {"chain": _Chain, "wideband": _Wideband}


def _run(step, st, chunks):
    audio = []
    for blk in chunks:
        st, a = step(st, blk)
        audio.append(a)
    return st, np.concatenate(audio, axis=-1)


def _close_to(kind, ref, got):
    snr = _snr(ref, got)
    assert snr >= AUDIO_DB, snr
    if kind == "chain":
        np.testing.assert_allclose(got, ref, rtol=0, atol=CHAIN_ATOL)


def _assert_leaves_equal(jax_state, port_state):
    """Every leaf by value, in the reference's flatten order: a swapped
    pair of leaves of one shape fails here."""
    j_leaves = [np.asarray(v) for v in jax.tree.leaves(jax_state)]
    t_leaves, _ = tckpt._flatten(port_state)
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(j_leaves, t_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_resume_within_the_port_is_bit_identical(kind, tmp_path):
    k = KINDS[kind]()
    _, straight = _run(k.t_step, k.t_init(), k.chunks)
    st, first = _run(k.t_step, k.t_init(), k.chunks[:SPLIT])
    path = tmp_path / "state.npz"
    tckpt.save_state(path, st, meta={"chunk": SPLIT})
    assert tckpt.checkpoint_meta(path)["chunk"] == SPLIT
    st2 = tckpt.load_state(path, k.t_init())
    _, rest = _run(k.t_step, st2, k.chunks[SPLIT:])
    np.testing.assert_array_equal(np.concatenate([first, rest], axis=-1),
                                  straight)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_checkpoint_resumes_in_the_port(kind, tmp_path):
    k = KINDS[kind]()
    _, j_straight = _run(k.j_step, k.j_init(), k.chunks)
    j_st, _ = _run(k.j_step, k.j_init(), k.chunks[:SPLIT])
    path = tmp_path / "jax.npz"
    jckpt.save_state(path, j_st, meta={"chunk": SPLIT})
    t_st = tckpt.load_state(path, k.t_init())
    assert tckpt.checkpoint_meta(path)["chunk"] == SPLIT
    _assert_leaves_equal(j_st, t_st)
    _, resumed = _run(k.t_step, t_st, k.chunks[SPLIT:])
    _, handed = _run(k.t_step, k.to_port(j_st, device="cpu"),
                     k.chunks[SPLIT:])
    np.testing.assert_array_equal(resumed, handed)
    cut = j_straight.shape[-1] * SPLIT // N_CHUNKS
    _close_to(kind, j_straight[..., cut:], resumed)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_checkpoint_resumes_in_jax(kind, tmp_path):
    k = KINDS[kind]()
    _, t_straight = _run(k.t_step, k.t_init(), k.chunks)
    t_st, _ = _run(k.t_step, k.t_init(), k.chunks[:SPLIT])
    path = tmp_path / "port.npz"
    tckpt.save_state(path, t_st)
    j_st = jckpt.load_state(path, k.j_init())
    _assert_leaves_equal(j_st, t_st)
    _, resumed = _run(k.j_step, j_st, k.chunks[SPLIT:])
    leaves, _ = tckpt._flatten(t_st)
    handed_in = jax.tree.unflatten(jax.tree.structure(k.j_init()),
                                   [jnp.asarray(v) for v in leaves])
    _, handed = _run(k.j_step, handed_in, k.chunks[SPLIT:])
    np.testing.assert_array_equal(resumed, handed)
    cut = t_straight.shape[-1] * SPLIT // N_CHUNKS
    _close_to(kind, t_straight[..., cut:], resumed)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_leaf_order_is_the_reference_order(kind):
    """The port's flatten order is `jax.tree.flatten`'s: after a run every
    leaf holds its own values, so a swapped (re, im) pair or two swapped
    fields of one shape would not compare equal."""
    k = KINDS[kind]()
    j_st, _ = _run(k.j_step, k.j_init(), k.chunks[:1])
    _assert_leaves_equal(j_st, k.to_port(j_st, device="cpu"))


class _Agc:
    def kwargs(self):
        return dict(on=False)


class _Slot:
    """The Receiver attributes `DualChain.refresh` reads."""
    freq_offset_hz, lc, hc, agc = 0.0, 30.0, 3000.0, _Agc()
    squelch_on, squelch_thresh_db, nb_on, nb_thresh = False, -100.0, False, 6.0

    def __init__(self, mode):
        self.radio_mode = mode


def test_none_fields_are_skipped_as_jax_does(tmp_path):
    """ChainParams carries None fields (no in-tail FIR block here): the
    port writes as many leaves as the reference's flatten has, and each
    package loads the other's params, the dual RX's int32 `mode_id`
    included."""
    from supersdr_tpu.runtime import dualrx as jdual
    from supersdr_tpu_torch.runtime import dualrx as tdual
    cfg = dict(mode="USB", chunk=512, os_block=512, n_taps=129)
    jd = jdual.DualChain(jchain.ChainConfig(**cfg))
    td = tdual.DualChain(tchain.ChainConfig(**cfg), device="cpu")
    for d in (jd, td):
        d.refresh([_Slot("USB"), _Slot("CW")], [True, True])
    jp, tp = jd.params, td.params
    assert any(getattr(tp, f) is None for f in tp._fields)
    t_leaves, treedef = tckpt._flatten(tp)
    assert len(t_leaves) == len(jax.tree.leaves(jp))
    assert "W_tailpass=None" in treedef
    path = tmp_path / "params.npz"
    jckpt.save_state(path, jp)
    loaded = tckpt.load_state(path, tp)
    _assert_leaves_equal(jp, loaded)
    assert loaded.mode_id.dtype == torch.int32
    tckpt.save_state(path, loaded)
    back = jckpt.load_state(path, jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shape_mismatch_rejected(tmp_path):
    cfg_a = tchain.ChainConfig(mode="USB", chunk=4096, os_block=4096)
    cfg_b = tchain.ChainConfig(mode="USB", chunk=4096, os_block=4096,
                               n_taps=129)
    p = tmp_path / "s.npz"
    tckpt.save_state(p, tchain.init_state(cfg_a, device="cpu"))
    with pytest.raises(ValueError, match="leaf shape"):
        tckpt.load_state(p, tchain.init_state(cfg_b, device="cpu"))
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_state(p, tchain.init_state(cfg_a, device="cpu").agc)


def test_load_takes_the_template_dtype_and_device(tmp_path):
    """Each leaf is cast to its template leaf's dtype and put on its
    device (here the meta device: no storage, the placement alone)."""
    cfg = tchain.ChainConfig(mode="USB", chunk=512, os_block=512)
    st = tchain.init_state(cfg, (2,), device="cpu")
    p = tmp_path / "s.npz"
    tckpt.save_state(p, st)
    like = tckpt._walk(st, lambda v: v.to(torch.float64))[0]
    got = tckpt.load_state(p, like)
    assert got.agc.peak_db.dtype == torch.float64
    np.testing.assert_array_equal(got.agc.peak_db.numpy(),
                                  st.agc.peak_db.numpy())
    meta = tckpt._walk(st, lambda v: v.to("meta"))[0]
    on_meta = tckpt.load_state(p, meta)
    assert on_meta.os_carry.re.device.type == "meta"
    assert on_meta.os_carry.re.shape == st.os_carry.re.shape


def test_plain_containers_flatten_as_jax_does(tmp_path):
    """Dicts (by sorted key), lists and tuples around NamedTuples, with a
    None inside: the port's leaves are `jax.tree.leaves`' in order, and a
    checkpoint of either loads into the other's structure."""
    rng = np.random.default_rng(5)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((3,), (2, 2), (4,), (1,))]
    t = [torch.from_numpy(a) for a in arrs]
    from supersdr_tpu.ops import cx as jcx
    from supersdr_tpu_torch.ops import cx as tcx
    port = {"zeta": t[0], "alpha": (tcx.CX(t[1], t[2]), None, [t[3]])}
    ref = {"zeta": jnp.asarray(arrs[0]),
           "alpha": (jcx.CX(jnp.asarray(arrs[1]), jnp.asarray(arrs[2])),
                     None, [jnp.asarray(arrs[3])])}
    _assert_leaves_equal(ref, port)
    p = tmp_path / "c.npz"
    tckpt.save_state(p, port)
    back = jckpt.load_state(p, ref)
    _assert_leaves_equal(back, port)
    jckpt.save_state(p, ref)
    _assert_leaves_equal(ref, tckpt.load_state(p, port))
