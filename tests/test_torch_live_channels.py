"""The fetched components that a chain never reads are dropped before it
runs (``xcorr_tpu_torch.stream._live``), and nothing else changes.

``live_channels`` is held to what each production chain reads (the BHR
chain reads BH1 and BH2, never BHZ), to R and T chains, to the JAX
package's ``example_process_dict`` and to the chains it may not prune (no
``select``, a callable, an unknown rotation). A BHR-EDH pair-day from a
small miniSEED archive through ``process(device="cpu")`` gives the same
CCF bits pruned and carried, its BHR windows the JAX package's host
chain's, and no operation runs on BHZ though BHZ is fetched. Where a step
would fail on BHZ (no response, a cutoff over its Nyquist) or BHZ is
missing, the window's result and warnings are the carried path's. All
samples come from seeded numpy generators.
"""
import os
import warnings

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch as xt
from xcorr_tpu_torch.native import mseed as tm
from xcorr_tpu_torch.scripts.cc import default_config
from xcorr_tpu_torch.stream import _daycache, _live, _response, _steps
from xcorr_tpu_torch.stream import client as client_mod
from xcorr_tpu_torch.stream import process as proc_mod
from xcorr_tpu_torch.stream import sds as tsds
from xcorr_tpu_torch.stream._live import live_channels

CHAINS = default_config()[0]["preprocess"]
FETCHED = ["BH1", "BH2", "BHZ"]
DAY = pd.Timestamp("2014-01-02")
PAZ = {"poles": [-0.037 + 0.037j, -0.037 - 0.037j], "zeros": [0j, 0j],
       "gain": 1.0, "sensitivity": 2.5e8}
EDH = ("IM", "H03S1", "", "EDH")
BH = ("IU", "RAR", "10")
PAIR = "IM.H03S1..EDH-IU.RAR.10.BHR"


def _chain(base, **swap):
    """``base`` with the operations named in ``swap`` replaced."""
    return [(op, swap[op]) if op in swap else (op, p) for op, p in base]


@pytest.mark.parametrize("chain,channel,want", [
    (CHAINS["BHR"], "BHR", {"BH1", "BH2"}),
    (CHAINS["BHZ"], "BHZ", {"BH1", "BH2", "BHZ"}),
    (CHAINS["EDH"], "EDH", {"BH1", "BH2", "BHZ"}),
    (_chain(CHAINS["BHR"], select={"channel": "BHT"}), "BHT",
     {"BH1", "BH2"}),
    (_chain(CHAINS["BHR"], select={"channel": "BH[RT]"}), "BHR",
     {"BH1", "BH2"}),
    (_chain(CHAINS["BHR"], select={"channel": "BH?"}), "BHR",
     {"BH1", "BH2", "BHZ"}),
    ([op for op in CHAINS["BHR"] if op[0] != "select"], "BHR",
     {"BH1", "BH2", "BHZ"}),
    ([("rotate", {"method": "->ZNE"}), ("select", {"channel": "BHN"})],
     "BHN", {"BH1"}),
    ([op for op in CHAINS["BHR"] if op[1].get("method") != "->ZNE"],
     "BHR", set()),
], ids=["BHR", "BHZ", "EDH", "T", "R_and_T", "wildcard", "no_select",
        "ZNE_only", "no_ZNE"])
def test_live_channels_of_chains(chain, channel, want):
    assert live_channels(chain, channel, FETCHED) == want


def test_live_channels_of_the_example_chains():
    """The JAX package's example chains and the port's production ones
    are the same lists: BHR reads BH1 and BH2, BHZ and EDH read all."""
    ex = xcorr_tpu.stream.process.example_process_dict()
    got = {cha: live_channels(ops, cha, FETCHED) for cha, ops in ex.items()}
    assert got == {"BHR": {"BH1", "BH2"}, "BHZ": set(FETCHED),
                   "EDH": set(FETCHED)}
    assert ex == proc_mod.example_process_dict()


def _rms(st, **kw):
    return st


@pytest.mark.parametrize("op", [
    (_rms, {}), ("running_rms", {}), ("rotate", {"method": "ZNE->LQT"}),
    ("simulate", {}), ("attach_response", {}), ("no_such_operation", {}),
    ("select",), ("select", {"channel": 3})],
    ids=["callable", "running_rms", "unknown_rotation", "simulate",
         "attach_response", "unknown_operation", "malformed",
         "bad_pattern"])
def test_chains_that_keep_everything(op):
    """An operation the walk has no rule for keeps every channel before
    it, so nothing before it is dropped."""
    chain = list(CHAINS["BHR"])
    chain.insert(4, op)
    assert live_channels(chain, "BHR", FETCHED) == set(FETCHED)


def test_the_receivers_own_channel_is_live():
    assert live_channels([("select", {"channel": "BHT"})], "BHR",
                         ["BHR", "BHT", "BHZ"]) == {"BHR", "BHT"}


# ----------------------------------------------------- the pair-day on disk


def _write(root, net, sta, loc, cha, fs, seed, seconds=3600.0):
    """A miniSEED day file of ``seconds`` of seeded int32 counts from
    ``DAY`` midnight, written by the port's encoder."""
    rng = np.random.default_rng(seed)
    data = np.round(1e3 * rng.standard_normal(int(seconds * fs))) \
        .astype(np.int32)
    payload = tm.encode_mseed(xt.stream.Trace(data, xt.stream.Stats(
        network=net, station=sta, location=loc, channel=cha,
        starttime=DAY, sampling_rate=fs)))
    path = tsds.sds_path(str(root), net, sta, loc, cha, DAY)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)


def _archive(root, z_fs=40.0):
    _write(root, *EDH, 250.0, 1)
    for seed, cha in enumerate(("BH1", "BH2", "BHZ"), 2):
        fs = z_fs if cha == "BHZ" else 40.0
        if fs:
            _write(root, *BH, cha, fs, seed)
    return str(root)


def _inventory(pkg, bh=("BHR", "BH1", "BH2", "BHZ")):
    s = pkg.stream
    return s.Inventory([s.Channel(*EDH, latitude=-33.6, longitude=-78.8,
                                  response=s.PAZResponse(sensitivity=1.5e9))]
                       + [s.Channel(*BH, cha, latitude=-21.2,
                                    longitude=-159.8,
                                    response=s.PAZResponse(**PAZ))
                          for cha in bh])


def _dataset(inv):
    return xt.init(pair=PAIR, starttime="2014-01-02T00:10",
                   endtime="2014-01-02T00:20",
                   preprocess={k: CHAINS[k] for k in ("EDH", "BHR")},
                   attrs={"institution": "t", "author": "t", "source": "t"},
                   sampling_rate=50.0, window_length=600.0,
                   window_overlap=0.5, clip_lag=(0.0, 120.0), inventory=inv)


@pytest.fixture(autouse=True)
def fresh_caches():
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()
    yield
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()


@pytest.fixture
def carried(monkeypatch):
    """Puts the carried chain in place: every fetched component, the
    steps' carried expressions."""
    def use():
        monkeypatch.setattr(client_mod, "drop_unread",
                            _live._drop_unread_plain)
        for name in _steps.FORMS:
            monkeypatch.setattr(_steps, name,
                                getattr(_steps, f"_{name}_plain"))
    return use


def _ran_on(monkeypatch):
    """The channels each operation of ``process`` runs on."""
    seen = []
    real = proc_mod.apply_operation

    def spy(*a, **kw):
        seen.append((kw["operation"],
                     sorted(t.stats.channel for t in kw["waveforms"])))
        return real(*a, **kw)
    monkeypatch.setattr(proc_mod, "apply_operation", spy)
    return seen


def _fetched(monkeypatch):
    got = []
    real = client_mod.Client.get_waveforms

    def spy(self, *a, **kw):
        got.append(kw["receiver"])
        return real(self, *a, **kw)
    monkeypatch.setattr(client_mod.Client, "get_waveforms", spy)
    return got


def _process(root, inv):
    ds = _dataset(inv)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xt.process(ds, xt.stream.Client(sds_root=root), inventory=inv,
                   device="cpu", verb=0)
    return ds, [str(w.message) for w in caught]


def test_bhr_pair_day_pruned_and_carried(tmp_path, monkeypatch, carried):
    """The pair-day's CCFs and statuses are the same bits pruned and
    carried; the pruned chain fetched BHZ and ran nothing on it."""
    root = _archive(tmp_path)
    inv = _inventory(xt)
    fetched, ran_on = _fetched(monkeypatch), _ran_on(monkeypatch)
    got, got_warn = _process(root, inv)
    assert {r.split(".")[3] for r in fetched} == {"EDH", "BH1", "BH2",
                                                  "BHZ"}
    assert ran_on and all(
        "BHZ" not in chans for _, chans in ran_on)
    assert ("remove_response", ["BH1", "BH2"]) in ran_on
    carried()
    del ran_on[:]
    want, want_warn = _process(root, inv)
    assert ("remove_response", ["BH1", "BH2", "BHZ"]) in ran_on
    assert (got["status"].values == 1).all()
    assert got["status"].values.tobytes() == want["status"].values.tobytes()
    assert got["cc"].values.tobytes() == want["cc"].values.tobytes()
    assert got_warn == want_warn


def test_bhr_windows_match_the_jax_package(tmp_path):
    """The pruned BHR window is the JAX package's host chain's, bit for
    bit."""
    root = _archive(tmp_path)
    out = {}
    for pkg in (xcorr_tpu, xt):
        client = pkg.stream.Client(sds_root=root)
        out[pkg] = client.get_processed_waveforms(
            "IU.RAR.10.BHR", "2014-01-02T00:15", {"BHR": CHAINS["BHR"]},
            duration=600.0, inventory=_inventory(pkg), sampling_rate=50.0,
            strict=True)
    got, want = out[xt], out[xcorr_tpu]
    assert len(want) == 1 and want[0].stats.channel == "BHR"
    assert len(got) == 1 and got[0].id == want[0].id
    assert got[0].stats.starttime.ns == want[0].stats.starttime.ns
    assert got[0].data.tobytes() == want[0].data.tobytes()


@pytest.mark.parametrize("case", ["z_without_response", "z_at_5_hz",
                                  "z_under_the_highpass", "z_missing"])
def test_failure_cases_give_the_carried_result(case, tmp_path, monkeypatch,
                                               carried):
    """Where a step would raise on BHZ the pruned path drops nothing, so
    the window fails as the carried one does, with the same warning; at
    5 Hz BHZ never reaches the 3 Hz highpass (``select`` removes it
    first) and at 0.08 Hz the 0.05 Hz one raises on it; without BHZ in
    the archive there is nothing to drop."""
    z_fs = {"z_at_5_hz": 5.0, "z_under_the_highpass": 0.08,
            "z_missing": 0}.get(case, 40.0)
    root = _archive(tmp_path, z_fs=z_fs)
    inv = _inventory(xt, ("BHR", "BH1", "BH2") if case ==
                     "z_without_response" else ("BHR", "BH1", "BH2", "BHZ"))
    ran_on = _ran_on(monkeypatch)
    got, got_warn = _process(root, inv)
    pruned = all("BHZ" not in chans for _, chans in ran_on)
    carried()
    want, want_warn = _process(root, inv)
    assert got["status"].values.tobytes() == want["status"].values.tobytes()
    assert got["cc"].values.tobytes() == want["cc"].values.tobytes()
    assert got_warn == want_warn
    failed = case in ("z_without_response", "z_under_the_highpass")
    assert (got["status"].values == (-1 if failed else 1)).all()
    assert pruned == (case == "z_at_5_hz" or case == "z_missing")
    if failed:
        op = "remove_response" if case == "z_without_response" \
            else "filter"
        assert any(f'Failed to execute operation "{op}"' in w
                   for w in got_warn)


def test_drop_unread_keeps_what_it_cannot_check(tmp_path):
    """A dropped trace that would run an unchecked step (here a
    ``decimate`` before the ``select``) or whose samples are not finite
    keeps the whole stream."""
    root = _archive(tmp_path)
    client = xt.stream.Client(sds_root=root)
    st = xt.stream.Stream()
    for cha in FETCHED:
        st += client.get_waveforms(receiver=f"IU.RAR.10.{cha}",
                                   time="2014-01-02T00:15", duration=600.0)
    inv = _inventory(xt)
    chain = CHAINS["BHR"]
    assert [t.stats.channel for t in _live.drop_unread(
        st, chain, "BHR", inv)] == ["BH1", "BH2"]
    assert _live.drop_unread(
        st, [("decimate", {"factor": 2})] + chain, "BHR", inv) is st
    z = st.select(channel="BHZ")[0]
    z.data = z.data.copy()
    z.data[3] = np.nan
    assert _live.drop_unread(st, chain, "BHR", inv) is st
