"""The port's multi-device layer (``xcorr_tpu_torch/parallel/{mesh,batch,
distributed}.py``, ``mesh=`` of the pipeline, the device engine,
``lazy_process`` and the timelapse) and its ``util/profiler`` traces and
``util/sysmem``, against the JAX package on the CPU: logical meshes
(``make_mesh(devices=["cpu"] * k)``) on the port's side, the conftest's
8-device CPU mesh on the JAX side.

Tolerances:

* ``host_slice``, ``pad_to_multiple``, the mesh's row shares and the
  trace parser on the JAX package's fixtures: exact;
* ``sharded_correlate`` against the JAX package's: 5e-7 abs, the bar of
  ``tests/test_torch_cc.py`` for ``correlate``; against the port's
  unsharded ``correlate``: 1e-7 abs (values are O(0.1); a shard of
  another batch size takes other vector lanes of the CPU FFT, measured
  1.5e-8 apart; a one-entry mesh is bit-identical);
* the device engine, the pipeline and ``lazy_process`` with ``mesh=``
  against ``mesh=None``: 1e-7 abs on the CCFs for the same reason,
  status and offsets exact;
* ``correlate_spectrograms``/``timelapse`` with ``mesh=``: the port's
  ``mesh=None`` result exactly, and the JAX package's mesh result within
  the 1e-6 / equal-shift bar of ``tests/test_torch_analysis_rest.py``.
"""
import gzip
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import xcorr_tpu
import xcorr_tpu_torch as xt
from xcorr_tpu.parallel import distributed as jdist
from xcorr_tpu.parallel import mesh as jmesh
from xcorr_tpu.scripts import timelapse as jtl
from xcorr_tpu.util.profiler import parse_device_trace as jparse
from xcorr_tpu_torch.ops.cc import correlate
from xcorr_tpu_torch.parallel import (batch_sharding, device_process,
                                      device_process_bulk, host_slice,
                                      initialize, make_mesh,
                                      sharded_correlate)
from xcorr_tpu_torch.parallel import distributed as tdist
from xcorr_tpu_torch.parallel.mesh import (Mesh, mesh_fingerprint,
                                           pad_to_multiple, split)
from xcorr_tpu_torch.parallel.pipeline import MultiSpanPipeline, Readback
from xcorr_tpu_torch.scripts import timelapse as ttl
from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient
from xcorr_tpu_torch.util import profiler, sysmem

ATOL_JAX = 5e-7
ATOL_SPLIT = 1e-7
FS = 5.0
CHAIN = [("detrend", {"type": "demean"}),
         ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
         ("detrend", {"type": "demean"}),
         ("taper", {"type": "cosine", "max_percentage": 0.05,
                    "max_length": 30.0})]
PAIRS = ["IM.H03S1..EDH-IM.H03S2..EDH", "IM.H03S1..EDH-IM.H03S3..EDH"]
DELAYS = {"IM.H03S1..EDH": 0.0, "IM.H03S2..EDH": 4.0, "IM.H03S3..EDH": 9.0}
ATTRS = {"institution": "t", "author": "t", "source": "t"}


def cpu_mesh(k):
    return make_mesh(devices=["cpu"] * k)


# -- distributed: host_slice, initialize ------------------------------------

@pytest.mark.parametrize("nitems,nproc", [(10, 3), (0, 3), (1, 4), (7, 3),
                                          (5, 5), (13, 8)])
def test_host_slice_equals_jax(nitems, nproc):
    items = [f"item{i}" for i in range(nitems)]
    for pid in range(nproc):
        assert host_slice(items, process_id=pid, num_processes=nproc) == \
            jdist.host_slice(items, process_id=pid, num_processes=nproc)


def test_host_slice_outside_a_group_is_everything():
    assert host_slice(list(range(7))) == list(range(7))


def test_initialize_without_coordinator_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        initialize(num_processes=2)
    tdist.shutdown()   # outside a group: a no-op


def test_initialize_from_torchrun_variables(monkeypatch):
    """``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (what
    ``torchrun`` sets) form the group through ``env://``."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert initialize() is True
        assert torch.distributed.get_world_size() == 1
        assert host_slice(list(range(5))) == list(range(5))
        assert initialize() is True   # joined: a no-op
        with pytest.raises(RuntimeError, match="already in a group"):
            initialize(num_processes=2, process_id=1)
    finally:
        tdist.shutdown()
    assert not torch.distributed.is_initialized()


# -- mesh ------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((5, 3), 0), ((8, 3), 0),
                                        ((2, 7), 1)])
def test_pad_to_multiple_equals_jax(shape, axis):
    x = np.random.default_rng(1).normal(size=shape)
    got, n = pad_to_multiple(x, 4, axis=axis)
    want, m = jmesh.pad_to_multiple(x, 4, axis=axis)
    assert n == m
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_make_mesh_logical_cpu(k):
    mesh = cpu_mesh(k)
    assert mesh.size == k and mesh.shape == (k,)
    assert mesh.axis_names == ("batch",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(2, devices=["cpu"] * 4).size == 2
    # the row shares are host_slice's partition of the rows
    for rows in (0, 5, 16):
        bounds = batch_sharding(mesh, rows)
        assert [list(range(a, b)) for a, b in bounds] == [
            jdist.host_slice(list(range(rows)), p, k) for p in range(k)]
    assert mesh_fingerprint(mesh) == mesh_fingerprint(cpu_mesh(k))


@pytest.mark.parametrize("k, rows", [(1, 5), (3, 2), (4, 0), (8, 5),
                                     (3, 16)])
def test_split_is_batch_sharding_without_empty_shares(k, rows):
    mesh = make_mesh(devices=[f"cpu:{i}" for i in range(k)])
    parts = split(mesh, rows)
    assert all(a < b for _, a, b in parts)
    assert [(a, b) for _, a, b in parts] == [
        (a, b) for a, b in batch_sharding(mesh, rows) if a < b]
    # each share on its own entry's device, the rows covered in order
    assert [d for d, _, _ in parts] == [
        d for d, (a, b) in zip(mesh.devices, batch_sharding(mesh, rows))
        if a < b]
    assert [r for _, a, b in parts for r in range(a, b)] == \
        list(range(rows))


def test_make_mesh_shapes_and_raises(monkeypatch):
    two_d = make_mesh(devices=["cpu"] * 6, axis_names=("a", "b"),
                      shape=(2, 3))
    assert two_d.shape == (2, 3) and two_d.size == 6
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(devices=["cpu"] * 4, axis_names=("a", "b"))
    with pytest.raises(ValueError, match="5 devices asked for"):
        make_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices asked for, 1 CUDA"):
        make_mesh(2)
    with pytest.raises(ValueError, match="only 1 CUDA"):
        make_mesh(devices=["cuda:1"])
    assert make_mesh(devices=["cuda:0"] * 3).size == 3


# -- sharded_correlate -----------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_sharded_correlate(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(5, 300)).astype(np.float32)
    y = (np.roll(x, 7, axis=1)
         + 0.5 * rng.normal(size=(5, 300))).astype(np.float32)
    y[2] = 0.0   # a zero row stays zero
    lags = dict(index_min=200, index_max=420)
    got = sharded_correlate(x, y, mesh=cpu_mesh(k), **lags)
    assert got.shape == (5, 220) and got.dtype == np.float32
    want = np.asarray(xcorr_tpu.parallel.sharded_correlate(x, y, **lags))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    plain = correlate(torch.from_numpy(x), torch.from_numpy(y),
                      **lags).numpy()
    if k == 1:
        np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL_SPLIT)
    assert not got[2].any()
    # tensors in, unbiased weights through
    tens = sharded_correlate(torch.from_numpy(x), torch.from_numpy(y),
                             mesh=cpu_mesh(k), unbiased=True, **lags)
    np.testing.assert_allclose(tens, correlate(
        torch.from_numpy(x), torch.from_numpy(y), unbiased=True,
        **lags).numpy(), rtol=0, atol=ATOL_SPLIT)


def test_sharded_correlate_rejects_bad_shapes():
    with pytest.raises(ValueError, match="one \\(batch, n\\) shape"):
        sharded_correlate(np.zeros((2, 8)), np.zeros((3, 8)),
                          mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="empty batch"):
        sharded_correlate(np.zeros((0, 8)), np.zeros((0, 8)),
                          mesh=cpu_mesh(2))


def test_readback_gathers_shards_in_order():
    shards = [torch.arange(6.0).view(2, 3), torch.arange(6.0, 9.0)[None]]
    rows = []
    host = Readback(shards).wait(lambda h, n: rows.append(n))
    np.testing.assert_array_equal(host, np.arange(9.0).reshape(3, 3))
    assert rows == [3]


# -- the pipeline, the device engine and lazy_process with mesh= -----------

def test_multispan_pipeline_mesh_equals_no_mesh():
    fs, span, npts_raw, npts = 10.0, 30_000, 20_000, 18_000
    rng = np.random.default_rng(3)
    raw_a = rng.normal(size=(2, span)).astype(np.float32)
    raw_b = rng.normal(size=(1, span)).astype(np.float32)
    off_a = [(0, 0), (1, 5000), (0, 10_000), (1, 2000), (0, 7000)]
    off_b = [(0, 0), (0, 3000), (0, 1000), (0, 9000), (0, 4000)]
    ops = CHAIN[:3]
    lags = dict(index_min=npts - 1, index_max=npts - 1 + 400)
    want = MultiSpanPipeline(ops, ops, npts_raw, fs, npts_raw, fs, npts,
                             trim_offset=1000, device="cpu", **lags)(
        raw_a, raw_b, off_a, off_b)
    for k in (2, 3, 8):   # 8 entries for 5 windows: three take none
        pipe = MultiSpanPipeline(ops, ops, npts_raw, fs, npts_raw, fs, npts,
                                 trim_offset=1000, mesh=cpu_mesh(k),
                                 **lags)
        shards = pipe.launch(raw_a, raw_b, off_a, off_b)
        assert len(shards) == min(k, 5)
        got = Readback(shards).wait()
        assert got.shape == want.shape == (5, 400)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_SPLIT)


def inventory():
    return Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9),
        Channel("IM", "H03S3", "", "EDH", latitude=-33.8, longitude=-79.0)])


def client():
    return SyntheticClient(sampling_rate=FS, delays=DELAYS,
                           source_period=600.0, source_amplitude=20.0)


def init_args():
    return dict(preprocess={"EDH": CHAIN}, attrs=ATTRS, sampling_rate=FS,
                window_length=3600.0, window_overlap=0.5,
                clip_lag=(-100.0, 100.0), inventory=inventory())


def days():
    return [xt.init(pair=p, starttime=pd.Timestamp(f"2014-01-0{d}"),
                    endtime=pd.Timestamp(f"2014-01-0{d}T03:00"),
                    **init_args())
            for p in PAIRS for d in (1, 2)]


def assert_like(got, want, atol=ATOL_SPLIT):
    assert (got["status"].values == 1).all()
    for name in ("status", "pair_offset", "time_offset"):
        np.testing.assert_array_equal(got[name].values, want[name].values)
    np.testing.assert_allclose(got["cc"].values, want["cc"].values,
                               rtol=0, atol=atol)


@pytest.mark.parametrize("k", [2, 3])
def test_device_process_bulk_mesh_equals_no_mesh(k):
    want = days()
    fin, fallback = device_process_bulk(want, client(), verb=0,
                                        device="cpu")
    fin()
    got = days()
    fin, fallback = device_process_bulk(got, client(), verb=0,
                                        mesh=cpu_mesh(k))
    assert fallback == []
    fin()
    for g, w in zip(got, want):
        assert_like(g, w)
    one = days()[0]
    device_process(one, client=client(), verb=0, mesh=cpu_mesh(k))
    assert_like(one, want[0])


def test_lazy_process_mesh_equals_no_mesh(tmp_path):
    times = pd.date_range("2014-01-01", periods=2, freq="1D")
    roots = {}
    for name, mesh in (("none", None), ("mesh", cpu_mesh(3))):
        roots[name] = str(tmp_path / name)
        assert all(xt.lazy_process(
            PAIRS, times, init_args(), client(), inventory=inventory(),
            root=roots[name], verb=0, engine="device", days_per_launch=4,
            device="cpu", mesh=mesh))
    for p in PAIRS:
        for t in times:
            assert_like(xt.read(xt.ncfile(p, t, roots["mesh"])),
                        xt.read(xt.ncfile(p, t, roots["none"])))
    with pytest.raises(ValueError, match="engine='device'"):
        xt.lazy_process(PAIRS, times, init_args(), client(),
                        root=str(tmp_path / "host"), verb=0, device="cpu",
                        mesh=cpu_mesh(2))


# -- the timelapse with mesh= ----------------------------------------------

@pytest.mark.parametrize("k,batch", [(2, 64), (3, 4), (8, 4)])
def test_correlate_spectrograms_mesh(k, batch):
    specs = np.random.default_rng(21).uniform(0.0, 1.0, (7, 9, 40)) \
        .astype(np.float32)
    ii, jj = np.triu_indices(specs.shape[0])
    plain = ttl.correlate_spectrograms(specs, ii, jj, batch=batch,
                                       device="cpu")
    got = ttl.correlate_spectrograms(specs, ii, jj, batch=batch,
                                     mesh=cpu_mesh(k))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p)
    pk, df, dl = jtl.correlate_spectrograms(specs, ii, jj, batch=batch,
                                            mesh=xcorr_tpu.parallel
                                            .make_mesh(8))
    np.testing.assert_allclose(got[0], pk, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], df)
    np.testing.assert_array_equal(got[2], dl)


# -- util.profiler: traces -----------------------------------------------

def _write_trace(root, events, name="vm.trace.json.gz"):
    d = os.path.join(str(root), "plugins", "profile", "t1")
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, name), "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(root)


def _meta(pid, pname, threads, label=None):
    evs = [{"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": pname}}]
    if label is not None:
        evs.append({"ph": "M", "name": "process_labels", "pid": pid,
                    "args": {"labels": label}})
    for tid, tname in threads.items():
        evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": tname}})
    return evs


def _jax_fixtures():
    """The fixtures of ``tests/test_profiler_trace.py``."""
    modules = _meta(3, "/device:TPU:0", {2: "XLA Modules", 3: "XLA Ops"})
    modules += _meta(701, "/host:CPU", {9: "python"})
    modules += [{"ph": "X", "pid": 3, "tid": 2, "ts": 10, "dur": 20},
                {"ph": "X", "pid": 3, "tid": 2, "ts": 20, "dur": 20},
                {"ph": "X", "pid": 3, "tid": 3, "ts": 10, "dur": 35},
                {"ph": "X", "pid": 701, "tid": 9, "ts": 0, "dur": 500}]
    ops = _meta(3, "/device:TPU:0", {3: "XLA Ops"})
    ops += [{"ph": "X", "pid": 3, "tid": 3, "ts": 0, "dur": 10},
            {"ph": "X", "pid": 3, "tid": 3, "ts": 100, "dur": 10}]
    host = _meta(701, "/host:CPU", {9: "python"})
    host += [{"ph": "X", "pid": 701, "tid": 9, "ts": 0, "dur": 10}]
    return {"modules": modules, "ops": ops, "host_only": host,
            "missing": None}


@pytest.mark.parametrize("fixture", ["modules", "ops", "host_only",
                                     "missing"])
def test_parse_device_trace_equals_jax_on_its_fixtures(fixture, tmp_path):
    events = _jax_fixtures()[fixture]
    root = str(tmp_path) if events is None else \
        _write_trace(tmp_path, events)
    assert profiler.parse_device_trace(root) == jparse(root)


def _torch_trace():
    """A chrome trace laid out as ``torch.profiler`` writes it on a card
    (lane names read from a trace made on an H100): the host process and
    each card named after the program, the card labelled ``GPU 0``, one
    lane per CUDA stream; host spans and profiler overhead off the card."""
    evs = _meta(118, "python3", {118: "thread 118 (python3)"}, "CPU")
    evs += _meta(0, "python3", {7: "stream 7 ", 13: "stream 13 "},
                 "GPU 0")
    evs += _meta(1, "python3", {}, "GPU 1")
    evs += [
        {"ph": "X", "cat": "cpu_op", "pid": 118, "tid": 118, "ts": 0,
         "dur": 900},
        {"ph": "X", "cat": "cuda_runtime", "pid": 118, "tid": 118,
         "ts": 5, "dur": 3},
        {"ph": "X", "cat": "overhead", "pid": -1, "tid": 0, "ts": 0,
         "dur": 50},
        {"ph": "X", "cat": "Trace", "pid": "Spans",
         "tid": "PyTorch Profiler", "ts": 0, "dur": 1000},
        # stream 7: a kernel, an overlapping one, a memset, a copy
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 100,
         "dur": 40},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 120,
         "dur": 40},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "ts": 200,
         "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 300,
         "dur": 25},
        # stream 13: a readback copy overlapping stream 7's kernel
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 13, "ts": 150,
         "dur": 30},
        {"ph": "f", "cat": "ac2g", "pid": 0, "tid": 7, "ts": 100},
    ]
    return evs


def test_parse_device_trace_reads_torch_stream_lanes(tmp_path):
    out = profiler.parse_device_trace(_write_trace(
        tmp_path, _torch_trace(), "host.1.2.pt.trace.json.gz"))
    # stream 7: [100, 160] + 10 + 25 = 95 us; stream 13: 30 us
    assert out == {"device_busy_s": 125e-6, "launches": 5}
    # the JAX parser looks for the card in the process name and finds none
    assert jparse(str(tmp_path)) is None


def test_parse_device_trace_sums_lanes_where_jax_unions_them(tmp_path):
    """Two lanes busy at once: the port unions each lane and sums them,
    as the JAX docstring promises; the JAX code unions all lanes at once
    (its documented departure, ROADMAP queue 3)."""
    evs = _meta(3, "/device:GPU:0", {1: "XLA Ops", 2: "XLA Ops 2"})
    evs += [{"ph": "X", "pid": 3, "tid": 1, "ts": 0, "dur": 100},
            {"ph": "X", "pid": 3, "tid": 1, "ts": 50, "dur": 100},
            {"ph": "X", "pid": 3, "tid": 2, "ts": 100, "dur": 100}]
    root = _write_trace(tmp_path, evs)
    assert profiler.parse_device_trace(root) == \
        {"device_busy_s": 250e-6, "launches": 3}
    assert jparse(root) == {"device_busy_s": 200e-6, "launches": 3}


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiler.trace(logdir) as prof:
        torch.fft.rfft(torch.ones(64))
    assert any(e.key for e in prof.key_averages())
    names = [n for _, _, ns in os.walk(logdir) for n in ns]
    assert len(names) == 1 and names[0].endswith(".pt.trace.json.gz")
    # no card here: the trace has host lanes only
    assert profiler.parse_device_trace(logdir) is None


def test_device_memory_of_a_cpu_mesh():
    assert profiler.device_memory(cpu_mesh(3)) == {"cpu": None}
    assert profiler.device_memory(Mesh(["cpu"])) == {"cpu": None}


def test_malloc_heap_reuse_is_idempotent():
    first = sysmem.malloc_heap_reuse()
    assert sysmem.malloc_heap_reuse() == first
    assert sysmem._applied == first
