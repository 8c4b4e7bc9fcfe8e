"""The mesh forms of the port's scans against the JAX package's, on the
CPU: the reference runs `axis_name` scans inside `shard_map` over 8
virtual CPU devices (tests/test_sharded_chain.py's
`test_sharded_scan_primitives` is the model), the port runs them over an
explicit shard axis, [*batch, D, n_local]. Same numpy inputs.

Tolerances: rtol 1e-4, atol 1e-4, the reference's own bound for its
sharded scans against its serial ones (float32, the local scans associate
in another order); `sliding_max` is exact. The cross-shard fold is
sequential in both, and the port's sharded scans also equal its serial
scans on the whole signal to that bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from supersdr_tpu.ops import scans as jscans
from supersdr_tpu_torch.ops import scans as tscans
from supersdr_tpu_torch.parallel import collectives

D, LOCAL = 8, 64
N = D * LOCAL
TOL = dict(rtol=1e-4, atol=1e-4)


def _shard_map(body, *xs):
    mesh = Mesh(np.asarray(jax.devices()), ("t",))
    specs = tuple(P(*([None] * (x.ndim - 1)), "t") for x in xs)
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                                 out_specs=specs[0], check_vma=False))(
        *[jnp.asarray(x) for x in xs])


def _sh(x):
    return torch.from_numpy(x).reshape(*x.shape[:-1], D, LOCAL)


def _flat(t):
    return t.reshape(*t.shape[:-2], -1).numpy()


@pytest.fixture
def ab():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.8, 0.999, (3, N)).astype(np.float32)
    b = rng.normal(size=(3, N)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("y0", [0.5, "per-row"])
def test_linear_scan_mesh(ab, y0):
    a, b = ab
    y0 = np.array([0.5, -1.0, 2.0], np.float32) if y0 == "per-row" else y0
    ref = _shard_map(lambda al, bl: jscans.linear_scan(
        al, bl, jnp.asarray(y0), axis_name="t"), a, b)
    y0t = torch.as_tensor(y0)
    got = tscans.linear_scan(_sh(a), _sh(b), y0t, shard_axis=-2)
    np.testing.assert_allclose(_flat(got), np.asarray(ref), **TOL)
    serial = tscans.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                y0t)
    np.testing.assert_allclose(_flat(got), serial.numpy(), **TOL)


@pytest.mark.parametrize("y0", [-50.0, "per-row"])
def test_maxplus_scan_mesh(ab, y0):
    a, b = ab
    a = -np.abs(a)
    y0 = np.array([-50.0, 3.0, 0.0], np.float32) if y0 == "per-row" else y0
    ref = _shard_map(lambda al, bl: jscans.maxplus_scan(
        al, bl, jnp.asarray(y0), axis_name="t"), a, b)
    y0t = torch.as_tensor(y0)
    got = tscans.maxplus_scan(_sh(a), _sh(b), y0t, shard_axis=-2)
    np.testing.assert_allclose(_flat(got), np.asarray(ref), **TOL)
    serial = tscans.maxplus_scan(torch.from_numpy(a), torch.from_numpy(b),
                                 y0t)
    np.testing.assert_allclose(_flat(got), serial.numpy(), **TOL)


def test_one_pole_mesh(ab):
    _, x = ab
    ref = _shard_map(lambda xl: jscans.one_pole(xl, 0.97, 0.25,
                                                axis_name="t"), x)
    got = tscans.one_pole(_sh(x), 0.97, 0.25, shard_axis=-2)
    np.testing.assert_allclose(_flat(got), np.asarray(ref), **TOL)
    serial = jscans.one_pole(jnp.asarray(x), 0.97, 0.25)
    np.testing.assert_allclose(
        tscans.one_pole(torch.from_numpy(x), 0.97, 0.25).numpy(),
        np.asarray(serial), **TOL)


@pytest.mark.parametrize("window", [2, 48, 64, 65, 200])
def test_sliding_max_mesh_exact(window):
    """The window stays in the shard, reaches one neighbour, or several."""
    rng = np.random.default_rng(window)
    x = rng.normal(size=(2, N)).astype(np.float32)
    ref = jscans.sliding_max(jnp.asarray(x), window)
    got = tscans.sliding_max(_sh(x), window, shard_axis=-2)
    np.testing.assert_array_equal(_flat(got), np.asarray(ref))
    if window - 1 <= LOCAL:    # the reference's mesh form: one hop only
        ref_mesh = _shard_map(lambda xl: jscans.sliding_max(
            xl, window, axis_name="t"), x)
        np.testing.assert_array_equal(_flat(got), np.asarray(ref_mesh))


def test_dc_block_mesh():
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(size=(3, N))).astype(np.float32)
    y0x = np.array([0.3, 0.0, 1.0], np.float32)
    y0y = np.array([-0.2, 0.0, 0.5], np.float32)

    def body(xl):
        return jscans.dc_block(xl, 0.999, jnp.asarray(y0x),
                               jnp.asarray(y0y), axis_name="t")[0]
    ref = _shard_map(body, x)
    got, (lx, ly) = tscans.dc_block(_sh(x), 0.999, torch.from_numpy(y0x),
                                    torch.from_numpy(y0y), shard_axis=-2)
    np.testing.assert_allclose(_flat(got), np.asarray(ref), **TOL)
    serial, (sx, sy) = tscans.dc_block(torch.from_numpy(x), 0.999,
                                       torch.from_numpy(y0x),
                                       torch.from_numpy(y0y))
    np.testing.assert_allclose(_flat(got), serial.numpy(), **TOL)
    # the stream's state is the last shard's
    assert lx.shape == ly.shape == (3, D)
    np.testing.assert_array_equal(lx[:, -1].numpy(), sx.numpy())
    np.testing.assert_allclose(ly[:, -1].numpy(), sy.numpy(), **TOL)


def test_scan_summaries_are_counted():
    """A sharded scan gathers 2·D scalars a row, whatever the block."""
    counts = []
    for local in (16, 256):
        b = torch.zeros(5, D, local)
        collectives.traffic.reset()
        tscans.linear_scan(torch.full_like(b, 0.9), b, 0.0, shard_axis=-2)
        counts.append((collectives.traffic.summary_bytes,
                       collectives.traffic.halo_bytes,
                       collectives.traffic.n_collectives))
    assert counts[0] == counts[1] == (2 * D * 5 * 4, 0, 2)


def test_shard_axis_must_precede_the_scan_axis():
    b = torch.zeros(4, D, 16)
    with pytest.raises(NotImplementedError, match="shard axis"):
        tscans.linear_scan(b, b, 0.0, shard_axis=0)
