"""The port's halo exchange against the JAX package's, on the CPU.

The reference exchanges halos inside `shard_map` over 8 virtual CPU
devices (`ops/scans.left_halo` / `left_context`: `ppermute`, and
`ops/pallas/halo.left_halo_rdma` in interpret mode); the port carries the
time shards on an explicit axis, [*batch, D, n_local]. The same numpy
arrays go through both. A halo is a copy, so every comparison is exact. On
CPU tensors the port's wrapper runs its plain version and counts no
launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from supersdr_tpu.ops import scans as jscans
from supersdr_tpu_torch.ops import scans as tscans
from supersdr_tpu_torch.ops.cuda import halo as thalo
from supersdr_tpu_torch.parallel import collectives

D = 8


def _shard_map(body, x, n_batch_axes):
    """body over the last axis of x, time-sharded on 8 CPU devices."""
    mesh = Mesh(np.asarray(jax.devices()), ("t",))
    spec = P(*([None] * n_batch_axes), "t")
    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))(
            jnp.asarray(x)))


def _x(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.complex64:
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
                ).astype(np.complex64)
    return rng.normal(size=shape).astype(dtype)


def _port_layout(x, local):
    """[*batch, D·local] → the port's [*batch, D, local] tensor."""
    return torch.from_numpy(x).reshape(*x.shape[:-1], D, local)


@pytest.mark.parametrize("n", [1, 16, 64])
@pytest.mark.parametrize("fill", [0.0, -np.inf, 2.5])
@pytest.mark.parametrize("batch,dtype", [((), np.float32),
                                         ((3,), np.float32),
                                         ((2,), np.complex64)])
def test_left_halo_matches_reference(n, fill, batch, dtype):
    local = 64
    x = _x(batch + (D * local,), seed=n, dtype=dtype)
    ref = _shard_map(lambda xl: jscans.left_halo(xl, n, "t", fill=fill), x,
                     len(batch))
    before = thalo.left_halo.launches
    for impl in collectives.HALO_IMPLS:
        got = collectives.left_halo(_port_layout(x, local), n, fill,
                                    impl=impl)
        assert got.shape == batch + (D, n)
        np.testing.assert_array_equal(
            got.numpy().reshape(*batch, D * n), ref)
    np.testing.assert_array_equal(
        thalo.left_halo_plain(_port_layout(x, local), n, fill).numpy(),
        got.numpy())
    assert thalo.left_halo.launches == before      # CPU: the plain version


@pytest.mark.parametrize("n", [16, 64, 100, 128, 200, 700])
@pytest.mark.parametrize("fill", [0.0, -np.inf])
def test_left_context_matches_reference(n, fill):
    """One hop, several hops, and more hops than there are shards."""
    local = 64
    x = _x((2, D * local), seed=n)
    ref = _shard_map(lambda xl: jscans.left_context(xl, n, "t", fill=fill),
                     x, 1)
    got = tscans.left_context(_port_layout(x, local), n, fill)
    assert got.shape == (2, D, n)
    np.testing.assert_array_equal(got.numpy().reshape(2, D * n), ref)


def test_left_halo_matches_rdma_kernel_in_interpret_mode():
    from supersdr_tpu.ops.pallas import halo as jhalo
    local = 64
    x = np.arange(D * local, dtype=np.float32)
    try:
        ref = _shard_map(lambda xl: jhalo.left_halo_rdma(
            xl, 16, "t", interpret=True), x, 0)
    except Exception as e:   # interpret-mode RDMA support varies by version
        pytest.skip(f"pallas interpret-mode RDMA unavailable: {e}")
    got = collectives.left_halo(_port_layout(x, local), 16)
    np.testing.assert_array_equal(got.numpy().reshape(-1), ref)


def test_left_halo_larger_than_block_raises():
    x = torch.zeros(2, D, 64)
    with pytest.raises(ValueError, match="halo larger than local block"):
        collectives.left_halo(x, 65)
    with pytest.raises(ValueError, match="halo larger than local block"):
        _shard_map(lambda xl: jscans.left_halo(xl, 65, "t"),
                   np.zeros((2, D * 64), np.float32), 1)


@pytest.mark.parametrize("hop", [1, 2, 7, 8, 9])
def test_left_halo_hops(hop):
    """Shard s receives from shard s − hop; fill where s < hop."""
    x = torch.from_numpy(_x((3, D, 32), seed=hop))
    got = thalo.left_halo(x, 5, -1.0, hop=hop)
    want = torch.full((3, D, 5), -1.0)
    if hop < D:
        want[:, hop:] = x[:, :D - hop, -5:]
    assert torch.equal(got, want)


def test_left_halo_head0_and_strided_source():
    """head0 lands in shard 0 (instead of the where() the reference runs
    after every exchange); sources are read by strides."""
    base = torch.from_numpy(_x((4, D, 96), seed=3))
    x = base[:, :, ::2]                              # element stride 2
    head = torch.from_numpy(_x((4, 7), seed=4))
    got = thalo.left_halo(x, 7, head0=head)
    want = torch.cat([head[:, None], x[:, :-1, -7:]], dim=1)
    assert torch.equal(got, want)
    xc = torch.from_numpy(_x((4, D, 48), seed=5, dtype=np.complex64))
    hc = torch.from_numpy(_x((4, 7), seed=6, dtype=np.complex64))
    want = torch.cat([hc[:, None], xc[:, :-1, -7:]], dim=1)
    assert torch.equal(thalo.left_halo(xc, 7, head0=hc), want)
    assert torch.equal(thalo.left_halo(xc, 7, head0=(hc.real, hc.imag)),
                       want)
    with pytest.raises(ValueError, match="one hop"):
        thalo.left_halo(x, 7, hop=2, head0=head)


def test_left_halo_int16_pair_in_one_call():
    """An (re, im) pair of int16 planes, as the mesh wideband form sends
    its halos."""
    rng = np.random.default_rng(8)
    re, im = (torch.from_numpy(rng.integers(-3000, 3000, size=(2, D, 40)
                                            ).astype(np.int16))
              for _ in range(2))
    before = collectives.traffic.halo_bytes
    got = collectives.left_halo((re, im), 9)
    assert collectives.traffic.halo_bytes - before == 2 * 9 * 2 * 2
    for g, p in zip(got, (re, im)):
        assert g.dtype == torch.int16
        assert torch.equal(g[:, 1:], p[:, :-1, -9:])
        assert int(g[:, 0].abs().max()) == 0
    with pytest.raises(ValueError, match="int16 fill"):
        thalo.left_halo(re, 9, fill=-np.inf)
    with pytest.raises(ValueError, match="float32, int16 or complex64"):
        thalo.left_halo(re.double(), 9)


def test_left_halo_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        thalo.left_halo(torch.zeros(2, D, 16, device="meta"), 4)


def _emulate_kernel(x, n, fill=0.0, hop=1, head0=None):
    """csrc/halo.cu's address arithmetic, element by element, on CPU
    memory: the pointers, row counts and strides are the ones the wrapper
    hands the kernel (`halo._descs`)."""
    import ctypes
    single = isinstance(x, torch.Tensor)
    xt = [x] if single else list(x)
    ot, ht = thalo._check(xt, n, hop, head0, None, single)
    ctype, esz = ((ctypes.c_int16, 2) if xt[0].dtype == torch.int16
                  else (ctypes.c_float, 4))
    D, n_local = xt[0].shape[-2:]
    xp, R, (x_rs, x_ds, x_es) = thalo._descs(xt, 2)
    op, _, (o_rs, o_ds, o_es) = thalo._descs(ot, 2)
    hp = None
    if ht is not None:
        hp, _, (h_rs, h_es) = thalo._descs(ht, 1)
    fills = thalo._fills(fill, len(xp), xt[0].dtype)

    def at(ptr, off):
        return ctype.from_address(ptr + off * esz)
    for p in range(len(xp)):
        for s in range(D):
            for r in range(R):
                for j in range(n):
                    if s >= hop:
                        v = at(xp[p] + (s - hop) * x_ds * esz,
                               r * x_rs + (n_local - n + j) * x_es).value
                    elif hp is not None:
                        v = at(hp[p], r * h_rs + j * h_es).value
                    else:
                        v = fills[p] if esz == 4 else int(fills[p])
                    at(op[p] + s * o_ds * esz,
                       r * o_rs + j * o_es).value = v
    return ot[0] if single else tuple(ot)


@pytest.mark.parametrize("case", ["f32", "c64-head-pair", "c64-head-c64",
                                  "i16-pair", "strided", "two-batch-axes",
                                  "no-batch", "hop3-fill"])
def test_kernel_address_arithmetic_on_cpu_memory(case):
    """What the wrapper hands the kernel (per-shard pointers, flattened
    rows, element strides, complex planes 4 bytes apart), walked as the
    kernel walks it, gives the plain version's result."""
    kw = {}
    if case == "f32":
        x = torch.from_numpy(_x((3, 4, 12), 1))
        kw = dict(head0=torch.from_numpy(_x((3, 5), 2)))
    elif case == "c64-head-pair":
        x = torch.from_numpy(_x((3, 4, 12), 1, np.complex64))
        kw = dict(head0=(torch.from_numpy(_x((3, 5), 2)),
                         torch.from_numpy(_x((3, 5), 3))))
    elif case == "c64-head-c64":
        x = torch.from_numpy(_x((3, 4, 12), 1, np.complex64))
        kw = dict(head0=torch.from_numpy(_x((3, 5), 2, np.complex64)))
    elif case == "i16-pair":
        x = tuple(torch.from_numpy((_x((3, 4, 12), k) * 1000).astype(
            np.int16)) for k in (1, 2))
        kw = dict(fill=-7.0)
    elif case == "strided":
        x = torch.from_numpy(_x((6, 4, 24), 1))[::2, :, ::2]
    elif case == "two-batch-axes":
        x = torch.from_numpy(_x((2, 3, 4, 12), 1, np.complex64))
    elif case == "no-batch":
        x = torch.from_numpy(_x((4, 12), 1))
    else:
        x = torch.from_numpy(_x((3, 4, 12), 1))
        kw = dict(hop=3, fill=-np.inf)
    got = _emulate_kernel(x, 5, **kw)
    want = thalo.left_halo_plain(x, 5, **kw)
    for g, w in zip(*(([got], [want]) if isinstance(got, torch.Tensor)
                      else (got, want))):
        assert torch.equal(torch.view_as_real(g) if g.is_complex() else g,
                           torch.view_as_real(w) if w.is_complex() else w)


def test_batch_axes_that_do_not_flatten_are_refused():
    x = torch.zeros(4, 6, 4, 12)[:, :2]           # strides (288, 48, 12, 1)
    with pytest.raises(ValueError, match="flatten to one stride"):
        thalo._descs([x], 2)
