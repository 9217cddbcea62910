"""Multi-process campaigns of the port (``xcorr_tpu_torch/parallel/
distributed.py`` and ``lazy_process``'s slice of the campaign), the
counterpart of ``tests/test_distributed.py``: real processes form a
``torch.distributed`` group (gloo) on localhost, on the CPU. The workers
import no JAX (each asserts it).

Every ``communicate`` has a timeout, so a hung group fails the test
instead of holding the suite. The campaign's shards are held to a
one-process run of the same campaign: status and offsets exact, CCFs
within 1e-7 abs (the two runs pack the windows into launches of other
sizes, whose CPU FFTs round differently in the last bits).
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd

import xcorr_tpu_torch as xt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150

_WORKER = textwrap.dedent("""
    import sys
    rank, port = int(sys.argv[1]), sys.argv[2]
    import torch.distributed as dist
    from xcorr_tpu_torch.parallel import distributed, host_slice
    ok = distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                                process_id=rank)
    assert ok, "initialize() returned False with a coordinator"
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    assert distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                                  process_id=rank)   # joined: a no-op
    mine = host_slice(list(range(10)))
    print("SLICE", rank, ",".join(map(str, mine)), flush=True)
    dist.barrier()
    distributed.shutdown()
    assert not dist.is_initialized()
    assert "jax" not in sys.modules and "xcorr_tpu" not in sys.modules
    print("DONE", rank, flush=True)
""")

_CAMPAIGN = textwrap.dedent("""
    import sys
    rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from xcorr_tpu_torch.parallel import distributed
    assert distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                                  process_id=rank)
    sys.path.insert(0, sys.argv[4])
    from test_torch_distributed import campaign
    results = campaign(root)
    print("RESULTS", rank, len(results), all(map(bool, results)),
          flush=True)
    distributed.shutdown()
    assert "jax" not in sys.modules and "xcorr_tpu" not in sys.modules
    print("DONE", rank, flush=True)
""")

PAIRS = ["IM.H03S1..EDH-IM.H03S2..EDH", "IM.H03S1..EDH-IM.H03S3..EDH"]
TIMES = pd.date_range("2014-01-01", periods=2, freq="1D")


def campaign(root):
    """The 2 pairs x 2 days device-engine campaign at 5 Hz, into
    ``root``; returns ``lazy_process``'s results."""
    from xcorr_tpu_torch import lazy_process
    from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient
    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9),
        Channel("IM", "H03S3", "", "EDH", latitude=-33.8, longitude=-79.0),
    ])
    client = SyntheticClient(
        sampling_rate=5.0,
        delays={"IM.H03S1..EDH": 0.0, "IM.H03S2..EDH": 4.0,
                "IM.H03S3..EDH": 9.0},
        source_period=600.0, source_amplitude=20.0)
    ops = [("detrend", {"type": "demean"}),
           ("filter", {"type": "bandpass", "freqmin": 0.3,
                       "freqmax": 2.0}),
           ("taper", {"type": "cosine", "max_percentage": 0.05,
                      "max_length": 30.0})]
    init_args = dict(
        preprocess={"EDH": ops},
        attrs={"institution": "t", "author": "t", "source": "t"},
        sampling_rate=5.0, window_length=3600.0, window_overlap=0.5,
        clip_lag=(-100.0, 100.0), inventory=inv)
    return lazy_process(PAIRS, TIMES, init_args, client, inventory=inv,
                        root=root, verb=0, engine="device", device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, code, *args):
    """Run ``code`` as ranks 0 and 1; returns their outputs, failing on a
    non-zero exit or a timeout."""
    script = tmp_path / "worker.py"
    script.write_text(code)
    # two threads each: the suite runs beside other test processes
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join(
               [ROOT] + [p for p in os.environ.get("PYTHONPATH", "")
                         .split(os.pathsep) if p])}
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), port, *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out}"
        assert f"DONE {rank}" in out, out
    return outs


def test_two_processes_take_disjoint_complete_slices(tmp_path):
    outs = _run_pair(tmp_path, _WORKER)
    slices = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SLICE"):
                _, rank, items = line.split(" ", 2)
                slices[int(rank)] = [int(x) for x in items.split(",") if x]
    assert sorted(slices) == [0, 1]
    assert slices[0] + slices[1] == list(range(10))


def test_two_process_campaign_equals_one_process(tmp_path):
    """Two processes join one group; lazy_process detects it, each takes
    half of the 4 pair-days and writes its shards to the shared root. The
    union is complete, merges, and equals a one-process run's shards."""
    root = str(tmp_path / "cc")
    outs = _run_pair(tmp_path, _CAMPAIGN, root,
                     os.path.dirname(os.path.abspath(__file__)))
    for rank, out in enumerate(outs):
        assert f"RESULTS {rank} 2 True" in out, out
    one = str(tmp_path / "one")
    assert campaign(one) == [True] * 4
    files = [xt.ncfile(p, t, root) for p in PAIRS for t in TIMES]
    assert all(os.path.exists(f) for f in files), files
    for p in PAIRS:
        for t in TIMES:
            got = xt.read(xt.ncfile(p, t, root))
            want = xt.read(xt.ncfile(p, t, one))
            assert (got["status"].values == 1).all()
            for name in ("status", "pair_offset", "time_offset"):
                np.testing.assert_array_equal(got[name].values,
                                              want[name].values)
            np.testing.assert_allclose(got["cc"].values, want["cc"].values,
                                       rtol=0, atol=1e-7)
    ds = xt.merge(files, fast=True)
    assert sorted(np.asarray(ds.coords["pair"].values)) == PAIRS
    assert ds.dims["time"] == 2 * 48
    assert (ds["status"].values == 1).all()
