"""The port's ``xcorr-torch-cc`` entry point (``xcorr_tpu_torch.scripts.cc``)
against the JAX package's ``xcorr-cc`` on the CPU: both ``main``s run the
same small miniSEED synthetic archive with ``default_config`` patched
alike to 5 Hz and 1 h windows; the shards must agree (CCFs within 1e-6
abs, the repository's bar; status and offsets exact). Also the CLI's own
options: ``--platform`` and the multi-host options, which raise until the
multi-GPU slice.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch
from xcorr_tpu.scripts import cc as jcc
from xcorr_tpu_torch.scripts import cc as tcc
from xcorr_tpu_torch.scripts import utils as tutils

ROOT = Path(__file__).resolve().parents[1]
FS = 5.0
PAIR = "IM.H03S1..EDH-IU.RAR.10.BHZ"
CHAIN = [
    ("detrend", {"type": "demean"}),
    ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
    ("detrend", {"type": "demean"}),
    ("taper", {"type": "cosine", "max_percentage": 0.05,
               "max_length": 30.0}),
]


def _small(config):
    """``default_config`` at 5 Hz, 1 h windows."""
    def patched(*a, **k):
        init_args, client_args, pairs, times = config(*a, **k)
        init_args.update(sampling_rate=FS, window_length=3600.0,
                         window_overlap=0.5, clip_lag=(0.0, 600.0),
                         preprocess={"EDH": CHAIN, "BHZ": CHAIN})
        return init_args, client_args, pairs, times
    return patched


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """Three days of the pair as miniSEED day files, and an inventory."""
    root = tmp_path_factory.mktemp("cc")
    synth = xcorr_tpu_torch.stream.SyntheticClient(
        sampling_rate=FS, delays={"IM.H03S1..EDH": 0.0,
                                  "IU.RAR.10.BHZ": 4.0},
        source_period=600.0, source_amplitude=20.0)
    sds = xcorr_tpu_torch.stream.SDSArchive(str(root / "sds"),
                                            format="mseed")
    for receiver in ("IM.H03S1..EDH", "IU.RAR.10.BHZ"):
        for day in ("2013-12-31", "2014-01-01", "2014-01-02"):
            tr = synth._synthesize_day(receiver, day)[0]
            tr.data = np.round(1000 * tr.data).astype(np.int32)
            sds.write(xcorr_tpu_torch.stream.Stream([tr]))
    ch = xcorr_tpu_torch.stream.Channel
    inv = str(root / "inventory.json")
    xcorr_tpu_torch.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        ch("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8),
    ]).to_json(inv)
    return root, inv


def test_cc_main_matches_reference(archive, tmp_path, monkeypatch):
    root, inv = archive
    monkeypatch.setattr(jcc, "default_config", _small(jcc.default_config))
    monkeypatch.setattr(tcc, "default_config", _small(tcc.default_config))
    common = ["--sds-root", str(root / "sds"), "--start", "2014-01-01",
              "--end", "2014-01-01", "--pair", PAIR, "--inventory", inv,
              "-n", "2"]
    assert jcc.main(["--root", str(tmp_path / "jax"), *common]) == 0
    assert tcc.main(["--root", str(tmp_path / "port"), *common,
                     "--platform", "cpu"]) == 0
    t = pd.Timestamp("2014-01-01")
    want = xcorr_tpu.read(xcorr_tpu.ncfile(PAIR, t, str(tmp_path / "jax")))
    got = xcorr_tpu.read(xcorr_tpu_torch.ncfile(PAIR, t,
                                                str(tmp_path / "port")))
    assert (got["status"].values == 1).all()
    for name in ("status", "pair_offset", "time_offset", "distance"):
        np.testing.assert_array_equal(got[name].values, want[name].values)
    np.testing.assert_allclose(got["cc"].values, want["cc"].values,
                               rtol=0, atol=1e-6)
    assert got.attrs["title"] == want.attrs["title"]


@pytest.mark.parametrize("option", ["coordinator", ["--num-processes", "2"],
                                    ["--process-id", "0"]],
                         ids=["coordinator", "num-processes", "process-id"])
def test_multi_host_options(option, archive, tmp_path, monkeypatch):
    """``--num-processes`` or ``--process-id`` without a coordinator
    raises ``SystemExit``, as the JAX CLI does; with ``--coordinator``
    ``xcorr-torch-cc`` joins a one-process group and runs to its end."""
    import argparse
    from xcorr_tpu.scripts import utils as jutils
    if option != "coordinator":
        for utils in (tutils, jutils):
            parser = utils.add_common_arguments(argparse.ArgumentParser())
            with pytest.raises(SystemExit, match="require --coordinator"):
                utils.init_compute(parser.parse_args(option))
        return
    import socket
    import torch
    from xcorr_tpu_torch.parallel import distributed
    root, inv = archive
    monkeypatch.setattr(tcc, "default_config", _small(tcc.default_config))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        assert tcc.main([
            "--root", str(tmp_path / "port"), "--sds-root",
            str(root / "sds"), "--start", "2014-01-01", "--end",
            "2014-01-01", "--pair", PAIR, "--inventory", inv, "-n", "2",
            "--platform", "cpu", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "1", "--process-id", "0"]) == 0
        assert torch.distributed.get_world_size() == 1
    finally:
        distributed.shutdown()
    got = xcorr_tpu.read(xcorr_tpu_torch.ncfile(
        PAIR, pd.Timestamp("2014-01-01"), str(tmp_path / "port")))
    assert (got["status"].values == 1).all()


def test_platform_names_the_torch_device():
    import argparse
    parser = tutils.add_common_arguments(argparse.ArgumentParser())
    assert tutils.init_compute(parser.parse_args([]))["device"] == "cuda"
    assert tutils.init_compute(
        parser.parse_args(["--platform", "cpu"]))["device"] == "cpu"
    with pytest.raises(SystemExit):
        parser.parse_args(["--platform", "tpu"])


def test_module_entry_point_help(tmp_path):
    """``python -m xcorr_tpu_torch.scripts.cc --help`` runs without jax
    and says there is no precision setting."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['cc', '--help'];"
         "runpy.run_module('xcorr_tpu_torch.scripts.cc',"
         " run_name='__main__')"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "xcorr-torch-cc" in proc.stdout
    assert "--cc-precision" in proc.stdout
    assert "--platform" in proc.stdout
