"""Package-level properties of the PyTorch port: it imports no JAX, its
kernel wrappers take their plain versions on CPU tensors without counting
a launch, and its kernel build targets sm_90a into a git-ignored
directory."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from supersdr_tpu_torch import _build, convert, device
from supersdr_tpu_torch.control import receiver
from supersdr_tpu_torch.ops import adpcm, channelizer, cx, spectrum
from supersdr_tpu_torch.ops.cuda import chain_tail, channelize_fused
from supersdr_tpu_torch.parallel import (dist_fft, mesh, pipeline,
                                         sharded_chain, sharded_wideband)
from supersdr_tpu_torch.runtime import chain, dualrx, wideband

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("module", [
    "supersdr_tpu_torch", "supersdr_tpu_torch.runtime.wideband",
    "supersdr_tpu_torch.convert", "supersdr_tpu_torch.ops.cuda.chain_tail",
    "supersdr_tpu_torch.ops.cuda.channelize_fused",
    "supersdr_tpu_torch.ops.cuda.pfb_fold",
    "supersdr_tpu_torch.runtime.chain", "supersdr_tpu_torch.ops.scans",
    "supersdr_tpu_torch.ops.squelch", "supersdr_tpu_torch.ops.resample",
    "supersdr_tpu_torch.ops.cuda.halo", "supersdr_tpu_torch.parallel",
    "supersdr_tpu_torch.parallel.mesh",
    "supersdr_tpu_torch.parallel.collectives",
    "supersdr_tpu_torch.parallel.sharded_chain",
    "supersdr_tpu_torch.parallel.comm_model", "supersdr_tpu_torch.device",
    "supersdr_tpu_torch.parallel.sharded_wideband",
    "supersdr_tpu_torch.parallel.dist_fft",
    "supersdr_tpu_torch.parallel.pipeline",
    "supersdr_tpu_torch.parallel.ingest",
    "supersdr_tpu_torch.parallel.dryrun",
    "supersdr_tpu_torch.cli", "supersdr_tpu_torch.apps.kiwi_session",
    "supersdr_tpu_torch.control.receiver", "supersdr_tpu_torch.control.links",
    "supersdr_tpu_torch.control.bandplan",
    "supersdr_tpu_torch.control.panadapter",
    "supersdr_tpu_torch.control.eibi", "supersdr_tpu_torch.control.beacons",
    "supersdr_tpu_torch.runtime.dualrx", "supersdr_tpu_torch.runtime.engine",
    "supersdr_tpu_torch.runtime.governor", "supersdr_tpu_torch.runtime.ring",
    "supersdr_tpu_torch.ops.spectrum", "supersdr_tpu_torch.ops.adpcm",
    "supersdr_tpu_torch.ops.smeter", "supersdr_tpu_torch.ops.passband",
    "supersdr_tpu_torch.native", "supersdr_tpu_torch.io.kiwi_protocol",
    "supersdr_tpu_torch.io.websocket", "supersdr_tpu_torch.io.kiwi_client",
    "supersdr_tpu_torch.io.status", "supersdr_tpu_torch.io.fake_kiwi",
    "supersdr_tpu_torch.io.wav", "supersdr_tpu_torch.io.audio_sink",
    "supersdr_tpu_torch.io.rigctl", "supersdr_tpu_torch.display.colormap",
    "supersdr_tpu_torch.display.png", "supersdr_tpu_torch.display.render"])
def test_imports_without_jax(module):
    """Nothing of JAX, and nothing of the JAX package either."""
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'supersdr_tpu')); "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_wrappers_take_plain_path_on_cpu_without_counting():
    cfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                  chunk_in=512 * 512, taps_per=4,
                                  n_taps=129, **wideband.PROFILES["fast"])
    p = wideband.make_params(cfg, device="cpu")
    c0 = channelize_fused.channelize_fused_raw3.launches
    t0 = chain_tail.chain_tail_fir.launches
    rng = np.random.default_rng(0)
    iq = (rng.normal(size=cfg.chunk_in)
          + 1j * rng.normal(size=cfg.chunk_in)).astype(np.complex64) * 0.05
    _, outs = wideband.process_n(
        cfg, p, wideband.init_state(cfg, device="cpu"), [iq])
    assert outs[0].device.type == "cpu"
    assert bool(torch.isfinite(outs[0]).all())
    assert channelize_fused.channelize_fused_raw3.launches == c0
    assert chain_tail.chain_tail_fir.launches == t0


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    never moved."""
    plan = channelizer.PFBPlan(n_chan=512, taps_per=4, hop=512)
    W = channelizer.taps_matrix(plan, channelizer.design(512, 4)[1],
                                device="meta")
    carry = cx.zeros((plan.history,), device="meta")
    x = cx.zeros((512 * 8,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        channelize_fused.channelize_fused_raw3(
            plan, W, carry, x, factors=(2, 256), bf16_mxu=False,
            out_dtype=torch.float32)


def test_build_targets_sm90a_into_ignored_dir():
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS
    assert _build.FLAGS[_build.FLAGS.index("arch=compute_90a,code=sm_90a")
                        - 1] == "-gencode"
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR
    rel = _build.BUILD_DIR.relative_to(REPO).as_posix() + "/"
    ignored = (REPO / ".gitignore").read_text().split()
    assert rel in ignored
    assert {p.name for p in _build.sources()} == {"channelize_fused.cu",
                                                 "chain_tail.cu",
                                                 "pfb_fold.cu", "halo.cu"}
    # the source hash names the library, so an edited source rebuilds
    assert _build.source_hash() in lib.name


def test_c_signatures_cover_every_entry_point():
    """Every extern "C" entry in csrc/ has declared ctypes argument types,
    one per C parameter."""
    import re
    decls = {}
    for src in _build.sources():
        text = src.read_text()
        body = text[text.index('extern "C" {'):]
        for m in re.finditer(r"^int (\w+)\(([^)]*)\)", body, re.M):
            params = [a for a in m.group(2).split(",") if a.strip()]
            decls[m.group(1)] = len(params)
    assert decls.keys() == _build.SIGNATURES.keys()
    for name, n in decls.items():
        assert len(_build.SIGNATURES[name]) == n, name


def test_package_and_smoke_script_name_no_jax_module():
    """No source of the port, nor the smoke script, imports JAX or the JAX
    package, not even inside a function."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|supersdr_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "supersdr_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 25
    for f in files:
        assert not pat.search(f.read_text()), f


def test_chain_state_matches_tail_rows():
    ccfg = chain.ChainConfig(chunk=512, os_block=512, n_taps=129)
    st = chain.init_state(ccfg, (256,), device="cpu")
    assert st.os_carry.re.shape == (256, 128)
    assert st.interp_carry.shape == (256, ccfg.interp_plan.per - 1)
    assert float(st.agc.peak_db[0]) == -120.0


_SMALL_WB = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
                 taps_per=4, n_taps=129)
_SMALL_CHAIN = dict(chunk=512, os_block=512, n_taps=129)


def _wb_cfg():
    return wideband.WidebandConfig(**_SMALL_WB, **wideband.PROFILES["fast"])


def _numpy_params(kind):
    """A port structure with numpy leaves: what `*_from_jax` is handed
    (any structure of the reference's field names with array leaves)."""
    ccfg = chain.ChainConfig(**_SMALL_CHAIN)
    return convert.to_numpy({
        "chain_params": lambda: chain.make_params(ccfg, device="cpu"),
        "chain_state": lambda: chain.init_state(ccfg, (2,), device="cpu"),
        "params": lambda: wideband.make_params(_wb_cfg(), device="cpu"),
        "state": lambda: wideband.init_state(_wb_cfg(), device="cpu"),
    }[kind]())


# every public constructor that takes `device=None`, as a call of one
# argument: the device
CONSTRUCTORS = {
    "wideband.make_params": lambda d: wideband.make_params(
        _wb_cfg(), device=d).W_pfb,
    "wideband.init_state": lambda d: wideband.init_state(
        _wb_cfg(), device=d).pfb_carry.re,
    "chain.make_params": lambda d: chain.make_params(
        chain.ChainConfig(**_SMALL_CHAIN), device=d).P_interp,
    "chain.init_state": lambda d: chain.init_state(
        chain.ChainConfig(**_SMALL_CHAIN), (2,), device=d).phase,
    "sharded_chain.make_params": lambda d: sharded_chain.make_params(
        chain.ChainConfig(**_SMALL_CHAIN), 2, device=d).P_interp,
    "sharded_chain.init_state": lambda d: sharded_chain.init_state(
        chain.ChainConfig(**_SMALL_CHAIN), 2, device=d).phase,
    "mesh.make_mesh": lambda d: mesh.make_mesh(1, 4, device=d),
    "mesh.time_mesh": lambda d: mesh.time_mesh(4, device=d),
    "sharded_wideband.make_mesh": lambda d: sharded_wideband.make_mesh(
        4, device=d),
    "sharded_wideband.make_params": lambda d: sharded_wideband.make_params(
        _wb_cfg(), device=d).W_pfb,
    "sharded_wideband.init_state": lambda d: sharded_wideband.init_state(
        _wb_cfg(), device=d).pfb_carry.re,
    "dist_fft.make_mesh": lambda d: dist_fft.make_mesh(2, device=d),
    "pipeline.make_mesh": lambda d: pipeline.make_mesh(device=d),
    "convert.chain_params_from_jax": lambda d: convert.chain_params_from_jax(
        _numpy_params("chain_params"), device=d).P_interp,
    "convert.chain_state_from_jax": lambda d: convert.chain_state_from_jax(
        _numpy_params("chain_state"), device=d).phase,
    "convert.params_from_jax": lambda d: convert.params_from_jax(
        _numpy_params("params"), device=d).W_pfb,
    "convert.state_from_jax": lambda d: convert.state_from_jax(
        _numpy_params("state"), device=d).pfb_carry.re,
    "spectrum.spectrum_window": lambda d: spectrum.spectrum_window(
        64, device=d),
    "adpcm.decode_torch": lambda d: adpcm.decode_torch(b"\x17", device=d)[0],
    "receiver.Receiver": lambda d: receiver.Receiver(
        cfg=chain.ChainConfig(**_SMALL_CHAIN), device=d).params.P_interp,
    "dualrx.DualChain": lambda d: dualrx.DualChain(
        chain.ChainConfig(**_SMALL_CHAIN), device=d).state.phase,
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_raise_without_a_card_and_run_on_the_cpu(name,
                                                              monkeypatch):
    """With no CUDA device a constructor given no device raises and names
    the way out; with device="cpu" it builds on the CPU. No silent CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = CONSTRUCTORS[name]
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        make(None)
    got = make("cpu")
    assert torch.device(got.device).type == "cpu"


def test_default_device_is_the_current_card(monkeypatch):
    """None → the current CUDA device with its index explicit; a given
    device is kept; `parallel.mesh.default_device` is the same function."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert device.default_device() == torch.device("cuda", 3)
    assert device.default_device("cuda") == torch.device("cuda", 3)
    assert device.default_device("cuda:1") == torch.device("cuda", 1)
    assert device.default_device("cpu") == torch.device("cpu")
    assert mesh.default_device is device.default_device
