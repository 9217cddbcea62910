"""The host-only modules the PyTorch port carries from ``xcorr_tpu`` stay
copies: each equals its source once the substitutions declared here are
applied, after its one-line header naming the source. A change to either
side that is not declared here fails, so the copies cannot drift apart
silently.

Also: the port imports no JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_METADATA = [(
    '''def list_versions(as_str: bool = True):
    """Core dependency versions, as string or dict."""
    import jax
    import h5py
    versions = {
        "jax": jax.__version__,''',
    '''def _h5py_version():
    """h5py writes the shards; a machine without it still correlates."""
    import importlib.util
    if importlib.util.find_spec("h5py") is None:
        return "not installed"
    import h5py
    return h5py.__version__


def list_versions(as_str: bool = True):
    """Core dependency versions, as string or dict."""
    import torch
    versions = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),'''), (
    '''        "h5py": h5py.__version__,''',
    '''        "h5py": _h5py_version(),'''),
]

#: the codec's library is built by g++ into the port's build directory,
#: never by ``make`` into the package directory
_MSEED = [(
    '''_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libxcmseed.so")
''',
    '''_DIR = os.path.dirname(os.path.abspath(__file__))
'''), (
    '''def _build():
    subprocess.run(["make", "-C", _DIR, "-s"], check=True)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)''',
    '''def _build():
    """Path of the shared library, built on first use with ``g++`` and
    the flags of ``xcorr_tpu/native/Makefile`` into the port's build
    directory (``ops._build.build_dir()``, git-ignored), never into the
    package; the name carries a hash of ``mseed.cpp``, so an edited
    source rebuilds."""
    import hashlib
    import threading
    from ..ops._build import build_dir
    src = os.path.join(_DIR, "mseed.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    path = build_dir() / f"libxcmseed-{tag}.so"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}"
        subprocess.run([os.environ.get("CXX", "g++"), "-O3", "-Wall",
                        "-fPIC", "-std=c++17", "-shared", "-o", tmp, src],
                       check=True)
        os.replace(tmp, path)
    return str(path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())'''),
]

_SYSMEM_SRC = (ROOT / "xcorr_tpu" / "util" / "sysmem.py").read_text()
#: the heap settings are carried; the JAX compile cache (the module's
#: last function, to its end) and the ``os`` import only it used are not
_SYSMEM = [
    ("import os\n\n", ""),
    ('__all__ = ["malloc_heap_reuse", "enable_persistent_compile_cache"]',
     '__all__ = ["malloc_heap_reuse"]'),
    (_SYSMEM_SRC[_SYSMEM_SRC.index(
        "\n\ndef enable_persistent_compile_cache"):], ""),
]

#: carried module (path under both packages) -> [(old, new), ...]
CARRIED = {
    "ndlabel/__init__.py": [],
    "ndlabel/dataarray.py": [],
    "ndlabel/dataset.py": [],
    "ndlabel/combine.py": [],
    "util/time.py": [],
    "util/receiver.py": [],
    "util/geo.py": [],
    "util/hasher.py": [],
    "util/history.py": [],
    "util/cc.py": [],
    "util/metadata.py": _METADATA,
    "util/sysmem.py": _SYSMEM,
    # the host response division keeps the reference's FFT sizing
    "stream/trace.py": [("from ..ops.fft import next_fast_len",
                         "from ._fftlen import next_fast_len")],
    "stream/inventory.py": [],
    "stream/process.py": [],
    "stream/client.py": [],
    "stream/sds.py": [],
    "stream/duration.py": [],
    "stream/vdms.py": [],
    "stream/running_rms.py": [],
    "stream/fdsn.py": [],
    "native/__init__.py": [],
    "native/mseed.py": _MSEED,
    "io/__init__.py": [],
    "io/netcdf.py": [],
    "io/write.py": [],
    "io/read.py": [],
    "io/filesystem.py": [],
    "io/validate.py": [],
    "io/utils.py": [],
    "core/init.py": [],
    "core/merge.py": [],
    "core/accessors.py": [],
    "core/plot.py": [],
    "signal/unbias.py": [],
    "signal/absolute.py": [],
    "signal/rms.py": [],
    "signal/taper.py": [],
    "signal/trigger.py": [],
    "signal/window.py": [],
    "signal/normalize.py": [],
    "signal/tri.py": [],
}


@pytest.mark.parametrize("module", sorted(CARRIED))
def test_carried_module_is_a_copy(module):
    source = (ROOT / "xcorr_tpu" / module).read_text()
    header, _, copy = (ROOT / "xcorr_tpu_torch" / module).read_text() \
        .partition("\n")
    assert header.startswith(f"# Carried from xcorr_tpu/{module} ")
    for old, new in CARRIED[module]:
        assert source.count(old) == 1, f"substitution source moved: {old!r}"
        source = source.replace(old, new)
    assert copy == source


def test_every_carried_file_is_declared():
    """A file that says it is carried is checked above."""
    found = {str(p.relative_to(ROOT / "xcorr_tpu_torch"))
             for p in (ROOT / "xcorr_tpu_torch").rglob("*.py")
             if p.read_text().startswith("# Carried from ")}
    assert found == set(CARRIED)


def test_port_imports_no_jax(tmp_path):
    """Importing the whole port (every module) loads no jax. The
    subprocess puts the repository root on PYTHONPATH itself: the
    package is not installed."""
    modules = sorted(
        "xcorr_tpu_torch." + str(p.relative_to(ROOT / "xcorr_tpu_torch")
                                 .with_suffix("")).replace(os.sep, ".")
        .removesuffix(".__init__")
        for p in (ROOT / "xcorr_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith('jax'))\n"
            "assert 'xcorr_tpu' not in sys.modules\n"
            "print(len(sys.modules))\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT)] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) > 40


def test_facade_resolves_lazy_names():
    import xcorr_tpu_torch as xt
    from xcorr_tpu_torch.core import lazy
    from xcorr_tpu_torch.core.postprocess import postprocess
    from xcorr_tpu_torch.io import read, write
    assert xt.read is read and xt.write is write
    assert xt.lazy_process is lazy.lazy_process
    assert set(xt.__all__) >= {"init", "process", "read", "write",
                               "lazy_process", "SyntheticClient"}
    assert xt.postprocess is postprocess
