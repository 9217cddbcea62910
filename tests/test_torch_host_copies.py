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

#: HDF5 day files go through the port's codec (``io/hdf5.py``), which
#: rewrites a file it adds to instead of editing it in place; a process
#: decodes each day file once (``stream/_daycache.py``), and a write
#: drops the path's decode
_SDS = [(
    """by the native C++ codec, :mod:`xcorr_tpu.native`); the format is sniffed
from the file's magic bytes on read.""",
    """by the native C++ codec, :mod:`xcorr_tpu_torch.native`); the format is
sniffed from the file's magic bytes on read. A process decodes each day
file once while it is unchanged (:mod:`._daycache`)."""), (
    """from .trace import Stream, Stats, Trace, UTCDateTime
""",
    """from . import _daycache
from .trace import Stream, Stats, Trace, UTCDateTime
"""), (
    """                else:
                    write_dayfile_h5(path, tr)
""",
    """                else:
                    write_dayfile_h5(path, tr)
                _daycache.DAYS.invalidate(path)
"""), (
    '''def read_dayfile(path) -> list:
    """Read one SDS day file, sniffing HDF5 vs miniSEED."""
''',
    '''def read_dayfile(path) -> list:
    """Read one SDS day file: decoded once per process while it is
    unchanged, the Traces the caller's own copies."""
    return _daycache.DAYS.read(path, _decode_dayfile)


def _decode_dayfile(path) -> list:
    """Decode one SDS day file, sniffing HDF5 vs miniSEED."""
'''), (
    """        import h5py

        def _s(v):""",
    """        from ..io import hdf5

        def _s(v):"""), (
    """        with h5py.File(path, "r") as f:
            for name in f:
                a = f[name].attrs""",
    """        with hdf5.File(path, "r") as f:
            for name in f:
                a = f[name].attrs"""), (
    """def _read_dayfile_h5(path):
    import h5py
    traces = []
    with h5py.File(path, "r") as f:""",
    """def _read_dayfile_h5(path):
    from ..io import hdf5
    traces = []
    with hdf5.File(path, "r") as f:"""), (
    """def write_dayfile_h5(path, trace: Trace):
    import h5py
    with h5py.File(path, "a") as f:""",
    """def write_dayfile_h5(path, trace: Trace):
    from ..io import hdf5
    with hdf5.File(path, "a") as f:"""),
]

#: ``remove_response`` takes the inverse response and the pre_filt taper
#: from ``stream/_response.py``, in the carried order of operations
_REMOVE_RESPONSE = [(
    """        from .inventory import flat_response
""",
    """        from ._response import inverse_response
        from .inventory import flat_response
"""), (
    """        freqs = np.fft.rfftfreq(nfft, d=self.stats.delta)
        r = resp.evaluate(freqs, output=output)
        spec = np.fft.rfft(self.data.astype(np.float64), nfft)
        if pre_filt is not None:
            spec *= _cosine_sac_taper(freqs, pre_filt)
        inv_r = _invert_spectrum_water_level(r, water_level)
""",
    """        inv_r, taper = inverse_response(resp, nfft, self.stats.delta,
                                        output, water_level, pre_filt)
        spec = np.fft.rfft(self.data.astype(np.float64), nfft)
        if taper is not None:
            spec *= taper
"""),
]

#: ``remove_response``'s division runs in ``stream/_steps.py``'s
#: ``deconvolve``: the spectrum and the inverse in the fetch thread's
#: arrays, the products in place, its plain version the carried
#: expressions (applied after ``_REMOVE_RESPONSE``)
_DECONVOLVE = [(
    """        spec = np.fft.rfft(self.data.astype(np.float64), nfft)
        if taper is not None:
            spec *= taper
        self.data = np.fft.irfft(spec * inv_r, nfft)[:n]
""",
    """        self.data = _steps.deconvolve(self.data, n, nfft, inv_r, taper)
"""),
]

#: the chain's steps without the copies they make and drop
#: (``stream/_steps.py``: in place only on arrays the chain allocated,
#: each form's plain version the carried expression)
_STEPS = [(
    """        x = self.data.astype(np.float64)
        if type in ("demean", "constant"):
            self.data = x - x.mean()""",
    """        x = _steps.as_float64(self.data)
        if type in ("demean", "constant"):
            self.data = _steps.demean(x)"""), (
    """        if zerophase:
            self.data = sp_signal.sosfiltfilt(sos, self.data.astype(
                np.float64))
        else:
            self.data = sp_signal.sosfilt(sos, self.data.astype(np.float64))
""",
    """        if zerophase:
            self.data = _steps.sosfiltfilt(sos, self.data)
        else:
            self.data = _steps.sosfilt(sos, self.data)
"""), (
    """            self.data = sp_signal.sosfilt(sos, self.data.astype(np.float64))
        self.data = self.data[::factor]""",
    """            self.data = _steps.sosfilt(sos, self.data)
        self.data = _steps.every(self.data, factor)"""), (
    "self.data = self.data / float(sens)",
    "self.data = _steps.divide(self.data, float(sens))"), (
    """            data = np.zeros(npts, dtype=out_dtype)
            for i0, t in zip(spans, traces):
                data[i0:i0 + t.stats.npts] = t.data
""",
    """            data = _steps.merged(traces, spans, npts, out_dtype)
"""),
]

#: the exact window of an archive is read without copying a day file and
#: merged over the window's span alone (``stream/_window.py``), the
#: carried read its plain version there; a fetch and its chain are one
#: scope of ``stream/_steps.py``, and the fetched components that the
#: chain never reads are dropped before it runs (``stream/_live.py``)
_CLIENT = [(
    """from .sds import SDSArchive
""",
    """from ._window import read_window
from .sds import SDSArchive
"""), (
    """            traces = []
            for day in get_dates(start, end):
                st = archive.read(receiver, day)
                traces.extend(st.traces)
            if not traces:
                continue
            st = Stream(traces).merge(method=1, fill_value="interpolate")
            st.trim(start, end)
""",
    """            st = read_window(archive, receiver, start, end)
"""), (
    """from . import process as stream_process
""",
    """from . import _steps
from . import process as stream_process
from ._live import drop_unread
"""), (
    """    def get_processed_waveforms(self, receiver: str, time, operations: dict,""",
    """    @_steps.chained
    def get_processed_waveforms(self, receiver: str, time, operations: dict,"""), (
    """        if not len(st):
            return Stream()

        time = to_datetime(time)""",
    """        if not len(st):
            return Stream()
        st = drop_unread(st, ops_list, cha, inventory)

        time = to_datetime(time)"""),
]

#: the unbias weights of the clipped lags alone (``signal/_unbias.py``),
#: bit-equal to the carried slice of the whole range, its plain version
_UNBIAS = [(
    """from ..util.cc import weight
""", ""), (
    """from ._helpers import get_dim
""",
    """from ._helpers import get_dim
from ._unbias import span_weights
"""), (
    """    w = weight(lag.attrs["npts"], pad=True)[
        lag.attrs["index_min"]: lag.attrs["index_max"]]
""",
    """    w = span_weights(lag.attrs["npts"], lag.attrs["index_min"],
                     lag.attrs["index_max"])
"""),
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
    # the host response division keeps the reference's FFT sizing; the
    # Lanczos interpolation runs in the port's native library, bit-equal
    # to the carried loop, which stays as its plain version; the inverse
    # response comes from a cache by response values and grid
    # (stream/_response.py), its plain version the carried expressions;
    # the steps' forms without their dropped copies (stream/_steps.py),
    # remove_response's division among them
    "stream/trace.py": [("from ..ops.fft import next_fast_len",
                         "from . import _steps\n"
                         "from ._fftlen import next_fast_len\n"
                         "from ._lanczos import lanczos_interp"),
                        ("self.data = _lanczos_interp(self.data.astype(",
                         "self.data = lanczos_interp(self.data.astype("),
                        *_REMOVE_RESPONSE, *_DECONVOLVE, *_STEPS],
    "stream/inventory.py": [],
    "stream/process.py": [],
    "stream/client.py": _CLIENT,
    "stream/sds.py": _SDS,
    "stream/duration.py": [],
    "stream/vdms.py": [],
    "stream/running_rms.py": [],
    "stream/fdsn.py": [],
    "native/__init__.py": [],
    "io/__init__.py": [],
    "io/write.py": [],
    "io/read.py": [],
    "io/filesystem.py": [],
    "io/validate.py": [],
    "io/utils.py": [],
    "core/init.py": [],
    "core/merge.py": [],
    "core/accessors.py": [],
    "core/plot.py": [],
    "signal/unbias.py": _UNBIAS,
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
