"""What the kernel build of the port (``xcorr_tpu_torch/ops/_build.py``)
reads is what an install ships and what the build hash covers: every
``*.cu`` it compiles and every header those include (CPU only, no
``nvcc``)."""
import fnmatch
import re
import shutil
import tomllib
from pathlib import Path

import pytest

from xcorr_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "xcorr_tpu_torch"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _read_by_build():
    """The compiled sources and, transitively, the local headers they
    include."""
    seen, todo = set(), list(_build.sources())
    while todo:
        f = todo.pop().resolve()
        if f in seen:
            continue
        seen.add(f)
        for name in _INCLUDE.findall(f.read_text()):
            inc = f.parent / name
            assert inc.exists(), f"{f.name} includes missing {name}"
            todo.append(inc)
    return sorted(seen)


def test_build_reads_sources_and_headers():
    read = _read_by_build()
    names = {f.name for f in read}
    assert {"fused_corr.cu", "stageb.cu", "fused_corr_acc.cu",
            "fused_corr_full.cu", "gemm_tf32.cu", "row_copy.cuh",
            "fft_reg.cuh", "corr_rows.cuh", "gemm_tf32.cuh"} <= names


def test_every_file_the_build_reads_is_package_data():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["xcorr_tpu_torch"]
    for f in _read_by_build():
        rel = f.relative_to(PKG).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


def test_every_file_the_build_reads_is_hashed():
    hashed = {f.resolve() for f in _build.hashed_files()}
    for f in _read_by_build():
        assert f in hashed, f.name


@pytest.mark.parametrize("name", ["row_copy.cuh", "fft_reg.cuh",
                                  "corr_rows.cuh", "gemm_tf32.cuh",
                                  "stageb.cu"])
def test_editing_a_file_changes_the_library_name(tmp_path, monkeypatch,
                                                 name):
    """An edited header or source gives a new library path, so the stale
    library is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = _build._library_path()
    with open(csrc / name, "a") as f:
        f.write("\n// edited\n")
    assert _build._library_path() != before


def test_build_dir_of_a_checkout_is_its_build():
    assert _build.build_dir(PKG) == ROOT / "build" / "xcorr_tpu_torch"
    assert _build._BUILD == _build.build_dir(PKG)


def test_build_dir_of_an_install_is_the_user_cache(tmp_path, monkeypatch):
    """An installed package (no ``pyproject.toml`` beside it) builds into
    the user's cache, never into ``site-packages``."""
    site = tmp_path / "site-packages"
    (site / "xcorr_tpu_torch").mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert (_build.build_dir(site / "xcorr_tpu_torch")
            == tmp_path / "cache" / "xcorr_tpu_torch")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert (_build.build_dir(site / "xcorr_tpu_torch")
            == tmp_path / "home" / ".cache" / "xcorr_tpu_torch")


def test_every_entry_point_is_declared():
    """Each ``extern "C"`` function of the sources has a ctypes
    signature of the same parameter kinds (p: pointer, i: int)."""
    decl = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
    found = {}
    for f in _build.sources():
        for name, params in decl.findall(f.read_text()):
            found[name] = "".join("p" if "*" in p else "i"
                                  for p in params.split(","))
    assert found == _build._SIGNATURES
