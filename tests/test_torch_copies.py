"""The port's copies of the reference's framework-free modules: each is the
reference's source with its `supersdr_tpu` imports rewritten to
`supersdr_tpu_torch` and the directory dropped from its citations of the
upstream SuperSDR files, and with nothing else changed but the two changes
named below. And the copied native library builds where the port keeps
its builds, safely when several processes build it at once."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

COPIES = ["io/kiwi_protocol", "io/websocket", "io/kiwi_client", "io/status",
          "io/fake_kiwi", "io/wav", "io/audio_sink", "io/rigctl",
          "display/colormap", "display/png", "display/render",
          "control/bandplan", "control/panadapter", "control/eibi",
          "control/beacons", "control/links", "runtime/ring",
          "runtime/governor", "runtime/engine", "native", "ops/passband",
          "control/memories", "control/logbook", "control/dxcluster",
          "control/kiwilist", "control/qrz", "io/gnss"]

_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)supersdr_tpu(?=[.\s])", re.M)
# the docstrings cite the upstream SuperSDR sources by file and line; the
# copies drop the directory those files were read from
_UPSTREAM_DIR = re.compile(r"/\w+/reference/")

# the only changes besides the imports, as (reference text, port text)
CHANGES = {
    # the library builds into the port's ignored build/ directory under a
    # temporary name, then is renamed: concurrent test workers never load
    # a half-written file, nor race the reference's own build
    "native": [
        ("Compiled on demand with g++ (cached next to the source); every "
         "caller\nfalls back to the pure-python/numpy path when the "
         "toolchain or library is\nunavailable, so the framework never "
         "hard-depends on the extension.",
         "Compiled on demand with g++ into the port's git-ignored build/ "
         "directory\n(under a temporary name, then renamed, so concurrent "
         "processes never load\na half-written library; the reference's "
         "build next to the source is left\nalone); every caller falls "
         "back to the pure-python/numpy path when the\ntoolchain or "
         "library is unavailable, so the framework never hard-depends\non "
         "the extension."),
        ("import ctypes\nimport subprocess",
         "import ctypes\nimport os\nimport subprocess"),
        ('_SO = _SRC.with_name("libsdrkit.so")',
         '_SO = Path(__file__).resolve().parent / "build" / "libsdrkit.so"'),
        ('def _build() -> bool:\n    try:\n        subprocess.run(["g++", '
         '"-O3", "-march=native", "-shared", "-fPIC",\n                  '
         '      "-o", str(_SO), str(_SRC)], check=True,\n                  '
         '     capture_output=True, timeout=120)\n        return True\n    '
         'except (OSError, subprocess.SubprocessError):\n        return '
         'False\n',
         'def _build() -> bool:\n    tmp = _SO.with_name(f"{_SO.name}.'
         '{os.getpid()}.tmp")\n    try:\n        _SO.parent.mkdir('
         'parents=True, exist_ok=True)\n        subprocess.run(["g++", '
         '"-O3", "-march=native", "-shared", "-fPIC",\n                  '
         '      "-o", str(tmp), str(_SRC)], check=True,\n                  '
         '     capture_output=True, timeout=120)\n        os.replace(tmp, '
         '_SO)\n        return True\n    except (OSError, '
         'subprocess.SubprocessError):\n        return False\n    '
         'finally:\n        tmp.unlink(missing_ok=True)\n'),
    ],
    # the port ships its own copy of the EIBI schedule (data/eibi.csv,
    # byte-equal to the reference's), which the docstring names
    "control/eibi": [
        ("shipped in supersdr_tpu/data/ (public EIBI schedule data, as the"
         "\n        reference ships it in its repo root)",
         "shipped in supersdr_tpu_torch/data/ (public EIBI schedule data,"
         "\n        as the reference ships it in its repo root)"),
    ],
}


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_the_reference(module):
    ref = (REPO / "supersdr_tpu" / f"{module}.py").read_text()
    port = (REPO / "supersdr_tpu_torch" / f"{module}.py").read_text()
    want = _UPSTREAM_DIR.sub("", _IMPORT.sub(r"\1supersdr_tpu_torch", ref))
    for old, new in CHANGES.get(module, []):
        assert want.count(old) == 1, (module, old)
        want = want.replace(old, new)
    assert port == want


def test_eibi_reads_the_reference_data_file():
    """The port reads its own copy of the reference's data file."""
    from supersdr_tpu_torch.control import eibi
    assert eibi.DEFAULT_EIBI_PATH.resolve() == \
        REPO / "supersdr_tpu_torch" / "data" / "eibi.csv"
    db = eibi.EibiDb(eibi.DEFAULT_EIBI_PATH)
    assert db.loaded and len(db.station_dict) > 1000


def test_eibi_data_is_the_reference_file_byte_for_byte():
    ref = (REPO / "supersdr_tpu" / "data" / "eibi.csv").read_bytes()
    port = (REPO / "supersdr_tpu_torch" / "data" / "eibi.csv").read_bytes()
    assert port == ref


def test_version_is_the_reference_version():
    import supersdr_tpu
    import supersdr_tpu_torch
    from supersdr_tpu_torch import version
    assert supersdr_tpu_torch.__version__ == version.__version__ \
        == supersdr_tpu.__version__
    assert "__version__" in supersdr_tpu_torch.__all__


def test_native_builds_into_the_port_build_dir():
    from supersdr_tpu_torch import _build, native
    assert native._SO.parent == _build.BUILD_DIR
    assert native.available()
    from supersdr_tpu_torch.ops import adpcm
    data = bytes(np.random.default_rng(0).integers(0, 256, 999,
                                                   dtype=np.uint8))
    st_c, st_py = adpcm.AdpcmState(), adpcm.AdpcmState()
    got = native.adpcm_decode(data, st_c)
    ref = np.empty(2 * len(data), np.int16)
    for i, byte in enumerate(data):
        ref[2 * i] = adpcm._decode_nibble(st_py, byte & 0x0F)
        ref[2 * i + 1] = adpcm._decode_nibble(st_py, byte >> 4)
    np.testing.assert_array_equal(got, ref)
    assert (st_c.index, st_c.prev) == (st_py.index, st_py.prev)


def test_concurrent_native_builds_never_load_a_partial_file(tmp_path):
    """Four processes build the library onto one path at once; each loads
    a whole library, and no temporary file is left behind."""
    code = ("import ctypes, sys; from pathlib import Path; "
            "from supersdr_tpu_torch import native; "
            f"native._SO = Path({str(tmp_path)!r}) / 'libsdrkit.so'; "
            "ok = native._build(); lib = ctypes.CDLL(str(native._SO)); "
            "print(ok and hasattr(lib, 'adpcm_decode'))")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=180)[0].strip() for p in procs]
    assert outs == ["True"] * 4
    assert [p.name for p in tmp_path.iterdir()] == ["libsdrkit.so"]
