"""The host fetch's two forms in turns, on the card's machine.

    python3 tools/host_fetch_ab.py [--pairs 10] [--against TREE]
                                   [--plain-forms NAME,...]
    python3 tools/host_fetch_ab.py --campaign 4,8 [--pairs 3]
                                   [--forms process,per-call,per-caller,
                                            uncached]
    python3 tools/host_fetch_ab.py --trio [--pairs 3]
                                   [--forms process,uncached]

Writes ``chip_smoke.py``'s phase 11 miniSEED archive (2 EDH stations at
250 Hz, ``IU.RAR.10.BH1/BH2/BHZ`` at 40 Hz, 5 days), then, ``--pairs``
times, runs each of phase 11's pair kinds through ``xcorr-torch-cc``
(EDH-EDH and BHZ-EDH over 2 pair-days, BHR-EDH over 1) once on the
port's host fetch and chain (the window read, the inverse-response
cache, the chain without the components it never reads, the steps
without their dropped copies) and once on their carried forms
(``chip_smoke.plain_host_path(lanczos=False)``: the copying read, the
response evaluated for every window and component, every fetched
component through the chain, the steps' carried expressions), from
empty day-file and response caches, alternating which form runs first.
With ``--plain-forms``, the plain form swaps only the named forms for
their plain versions and keeps the rest of the port's fetch: those of
``stream/_steps.py`` (``FORMS``) and of ``core/process.py`` (``FORMS``:
``fetch_all``, the fetch pool that outlives the pair-day, whose plain
version is a pool per ``process`` call); ``fetch_all,deconvolve`` runs a
pool per pair-day and ``remove_response``'s carried expressions against
the process's pool and the division in the threads' arrays. Every run
starts on a fetch pool of its own, as a new process would. With
``--against TREE`` (another checkout of the repository, say the parent
commit unpacked by ``git archive``), each run is instead a new process,
in this checkout or in ``TREE``, each building its kernels in its own
``build/`` first, and each run's peak resident set is printed too. Both
forms' shards must be the same bits. Prints the card's name and power
limit, each wall per pair-day, and per pair kind the medians, the second
form's quartile spread and the rounds the first won; the last line is
the walls as JSON. Needs one card; imports no JAX.

With ``--campaign N,...`` the tool instead writes an archive of five EDH
stations (``CAMPAIGN_STATIONS``, phase 11's days) and, ``--pairs``
times, runs ``xcorr-torch-cc`` over the first ``N`` of their EDH pairs
and phase 11's two days, so ``2 N`` pair-days with as many in flight as
the host has cores, once on each fetch form that ``--forms`` names of
``FETCH_FORMS`` (the process's one pool, a pool per ``process`` call, a
pool per calling thread; all by default), each run a new process, the
order turned each round. It prints each run's seconds per pair-day and
peak resident set, then per campaign and form the medians and quartile
spreads, and the rounds the first form won against each other; every
form's shards must be the same bits. The form ``uncached`` runs each
pair's fetch through the client's pair fetch (``core/process.py``
``_pair_windows_plain``), so each receiver's chain runs once per pair
that reads it instead of once per window in the campaign's scope
(``stream/_shared.py``); each run prints the scope's counts too.

With ``--trio`` the campaign is instead phase 11's three pairs
(``chip_smoke.P11_TRIO``: EDH-EDH, BHZ-EDH and BHR-EDH, ``IM.H03S1..EDH``
in all three) over phase 11's first day, on phase 11's archive: the
production mix of EDH and BH chains.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pandas as pd
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def form_modules():
    """The modules whose ``FORMS`` the plain form may swap, by form."""
    modules = [importlib.import_module(f"xcorr_tpu_torch.{m}")
               for m in ("stream._steps", "core.process")]
    return {name: m for m in modules for name in m.FORMS}


@contextlib.contextmanager
def plain_forms(names):
    """The forms ``names`` (``form_modules``) swapped for their plain
    versions while it runs."""
    where = form_modules()
    real = {name: getattr(where[name], name) for name in names}
    for name in names:
        setattr(where[name], name, getattr(where[name], f"_{name}_plain"))
    try:
        yield
    finally:
        for name, form in real.items():
            setattr(where[name], name, form)


def run_cli(pair, days, root, sds, inv_path, plain, names=None):
    """Seconds per pair-day of ``xcorr-torch-cc`` over ``pair``'s
    ``days`` into ``root``, from empty caches, on the carried forms if
    ``plain`` (only the forms ``names`` where given), on a fetch pool of
    its own."""
    from xcorr_tpu_torch.core.process import shutdown_fetch_pool
    from xcorr_tpu_torch.scripts import cc as cc_cli
    from xcorr_tpu_torch.stream import _daycache, _response
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()
    shutdown_fetch_pool()
    if not plain:
        form = contextlib.nullcontext()
    elif names:
        form = plain_forms(names)
    else:
        form = cs.plain_host_path(lanczos=False)
    t0 = time.perf_counter()
    with form:
        rc = cc_cli.main(["--root", root, "--sds-root", sds, "--pair", pair,
                          "--start", f"{days[0]:%F}", "--end",
                          f"{days[-1]:%F}", "--inventory", inv_path])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shutdown_fetch_pool()
    cs.check(rc == 0, f"xcorr-torch-cc returned {rc}")
    return wall / len(days)


#: a run of ``xcorr-torch-cc`` in a new process, in the checkout it
#: names: the card and the kernels made ready first, then ``setup`` (code
#: with ``core.process`` as ``P``), the wall and the process's peak
#: resident set (bytes) printed as JSON
RUN = """
import json, resource, sys, time
sys.path.insert(0, {tree!r})
import importlib
import torch
P = importlib.import_module("xcorr_tpu_torch.core.process")
from xcorr_tpu_torch.ops import _build
from xcorr_tpu_torch.scripts import cc as cc_cli
_build.load()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
{setup}
t0 = time.perf_counter()
rc = cc_cli.main({argv!r})
torch.cuda.synchronize()
wall = time.perf_counter() - t0
try:
    from xcorr_tpu_torch.stream import _shared
    scope = _shared.counts()
except ImportError:
    scope = None
print(json.dumps({{"rc": rc, "wall": wall, "scope": scope,
                  "rss": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss * 1024}}))
"""


def run_tree(tree, pair, days, root, sds, inv_path, rss=None):
    """Seconds per pair-day of ``xcorr-torch-cc`` over ``pair``'s
    ``days`` into ``root``, in a new process of the checkout ``tree``;
    its peak resident set goes to the list ``rss``."""
    argv = ["--root", root, "--sds-root", sds, "--pair", pair, "--start",
            f"{days[0]:%F}", "--end", f"{days[-1]:%F}", "--inventory",
            inv_path]
    env = {k: v for k, v in os.environ.items() if k not in cs.ROUTE_VARS}
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(tree=tree, setup="", argv=argv)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    cs.check(proc.returncode == 0, f"{tree}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    cs.check(out["rc"] == 0, f"{tree}: xcorr-torch-cc returned {out['rc']}")
    if rss is not None:
        rss.append(out["rss"])
    return out["wall"] / len(days)


#: the campaign's EDH stations: phase 11's two and three more of the same
#: hydrophone triads, each with the shared source train
CAMPAIGN_STATIONS = ("IM.H10N1..EDH", "IM.H03S1..EDH", "IM.H10N2..EDH",
                     "IM.H03S2..EDH", "IM.H10N3..EDH")

#: a pool per thread that calls ``process``: each pair-day in flight
#: keeps fetch threads of its own, as a pool per call gives it, and a
#: campaign worker's next pair-day runs on the same threads
CALLER_POOL = """
import threading
from concurrent.futures import ThreadPoolExecutor, wait
mine = threading.local()
def fetch_all(fetch, work, nworkers):
    pool = getattr(mine, "pool", None)
    if pool is None:
        pool = mine.pool = ThreadPoolExecutor(
            max_workers=nworkers, thread_name_prefix="xcorr-fetch")
    futures = [pool.submit(fetch, w) for w in work]
    try:
        return [f.result() for f in futures]
    finally:
        for f in futures:
            f.cancel()
        wait(futures)
P.fetch_all = fetch_all
"""

#: the fetch forms of ``--campaign``, as code that a run executes with
#: ``core.process`` as ``P`` before the CLI: the process's one pool and
#: the campaign's shared windows (the port's), a pool per call, a pool
#: per calling thread, the client's pair fetch without shared windows
FETCH_FORMS = {"process": "", "per-call": "P.fetch_all = P._fetch_all_plain",
               "per-caller": CALLER_POOL,
               "uncached": "P.pair_windows = P._pair_windows_plain"}

def campaign_archive(sds, inv_path):
    """Phase 11's archive days of ``CAMPAIGN_STATIONS`` at 250 Hz raw
    (Steim1 day files), and their inventory."""
    from xcorr_tpu_torch.stream import Channel, Inventory, PAZResponse
    from xcorr_tpu_torch.stream.sds import SDSArchive
    synth = cs.phase11_synth(delays={CAMPAIGN_STATIONS[0]: cs.DELAY})
    archive = SDSArchive(sds, format="mseed")
    for day in cs.P11_ARCHIVE:
        for r in CAMPAIGN_STATIONS:
            archive.write(synth._synthesize_day(r, day))
    Inventory([Channel(*r.split("."), latitude=-30.0 + i,
                       longitude=-78.8 + i,
                       response=PAZResponse(sensitivity=1.5e9))
               for i, r in enumerate(CAMPAIGN_STATIONS)]).to_json(inv_path)


def campaign(sizes, rounds, forms=tuple(FETCH_FORMS), trio=False):
    """``xcorr-torch-cc`` over the first ``n`` EDH pairs of
    ``CAMPAIGN_STATIONS`` and phase 11's two days, for each ``n`` of
    ``sizes`` (with ``trio``, over ``chip_smoke.P11_TRIO`` and phase
    11's first day instead), each run a new process of this checkout on
    each of the ``FETCH_FORMS`` named ``forms``, ``rounds`` times in
    turns; returns the seconds per pair-day, the peak resident sets and
    the scope's counts by campaign and form."""
    import itertools
    import xcorr_tpu_torch as xt
    tmp = tempfile.TemporaryDirectory()
    sds = os.path.join(tmp.name, "sds")
    inv_path = os.path.join(tmp.name, "inventory.json")
    t0 = time.perf_counter()
    days = pd.date_range(*cs.P11_DAYS, freq="1D")
    if trio:
        cs.phase11_inventory(inv_path)
        cs.phase11_archive(sds)
        cases = {"trio": list(cs.P11_TRIO)}
        days = days[:1]
        print(f"phase 11 archive in {time.perf_counter() - t0:.1f} s",
              flush=True)
    else:
        campaign_archive(sds, inv_path)
        print(f"campaign archive: {len(CAMPAIGN_STATIONS)} EDH stations x "
              f"{len(cs.P11_ARCHIVE)} days in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        pairs = ["-".join(p) for p in itertools.combinations(
            CAMPAIGN_STATIONS, 2)]
        cases = {n: pairs[:n] for n in sizes}
    env = {k: v for k, v in os.environ.items() if k not in cs.ROUTE_VARS}
    walls = {n: {f: [] for f in forms} for n in cases}
    rss = {n: {f: [] for f in forms} for n in cases}
    scope = {n: {f: [] for f in forms} for n in cases}
    for i in range(rounds):
        order = forms[::-1] if i % 2 else forms
        for n, cpairs in cases.items():
            argv = ["--sds-root", sds, "--start", f"{days[0]:%F}", "--end",
                    f"{days[-1]:%F}", "--inventory", inv_path]
            for p in cpairs:
                argv += ["--pair", p]
            npd = len(cpairs) * len(days)
            for f in order:
                root = os.path.join(tmp.name, f"{n}-{f}")
                proc = subprocess.run(
                    [sys.executable, "-c", RUN.format(
                        tree=cs.REPO, setup=FETCH_FORMS[f],
                        argv=["--root", root] + argv)],
                    cwd=cs.REPO, env=env, capture_output=True, text=True,
                    timeout=900)
                cs.check(proc.returncode == 0, f"{f}: {proc.stderr[-2000:]}")
                out = json.loads(proc.stdout.strip().splitlines()[-1])
                cs.check(out["rc"] == 0, f"{f}: xcorr-torch-cc returned "
                                         f"{out['rc']}")
                walls[n][f].append(out["wall"] / npd)
                rss[n][f].append(out["rss"])
                scope[n][f].append(out["scope"])
            for p in cpairs:
                for day in days:
                    a, *b = (xt.read(xt.ncfile(
                        p, day, os.path.join(tmp.name, f"{n}-{f}")))
                        for f in forms)
                    cs.check((a["status"].values == 1).all() and all(
                        a[v].values.tobytes() == o[v].values.tobytes()
                        for o in b for v in cs.SHARD_VARS
                        if v in a.variables), f"{p} {day:%F}: the forms' "
                                              "shards differ")
            for f in forms:
                shutil.rmtree(os.path.join(tmp.name, f"{n}-{f}"))
            print(f"round {i + 1} {npd} pair-days, s per pair-day: "
                  + ", ".join(f"{f} {walls[n][f][-1]:.4f} "
                              f"(peak {rss[n][f][-1] / 1e9:.2f} GB; scope "
                              f"{scope_text(scope[n][f][-1])})"
                              for f in order), flush=True)
    tmp.cleanup()
    for n, cpairs in cases.items():
        npd = len(cpairs) * len(days)
        for f in forms:
            w = walls[n][f]
            q = statistics.quantiles(w, n=4) if rounds > 1 else [0, 0, 0]
            print(f"{npd} pair-days ({n}), {f}: median "
                  f"{statistics.median(w):.4f} s per pair-day (quartile "
                  f"spread {q[2] - q[0]:.4f}), peak resident set median "
                  f"{statistics.median(rss[n][f]) / 1e9:.2f} GB", flush=True)
        for f in forms[1:]:
            wins = sum(a < b for a, b in zip(walls[n][forms[0]],
                                             walls[n][f]))
            print(f"{npd} pair-days ({n}): {forms[0]} faster than {f} in "
                  f"{wins} of {rounds} rounds; shards the same bits",
                  flush=True)
    return {"walls": walls, "rss": rss, "scope": scope}


def scope_text(counts):
    """A run's scope counts as text."""
    if counts is None:
        return "none"
    return (f"{counts['chains']} chains, {counts['hits']} hits, "
            f"{counts['waits']} waits, peak "
            f"{counts['peak_bytes'] / 1e9:.2f} GB")


def ab(pairs, against=None, names=None):
    """The turns; returns the walls by pair kind and form."""
    import xcorr_tpu_torch as xt
    tmp = tempfile.TemporaryDirectory()
    sds = os.path.join(tmp.name, "sds")
    inv_path = os.path.join(tmp.name, "inventory.json")
    cs.phase11_inventory(inv_path)
    cs.phase11_archive(sds)
    days = pd.date_range(*cs.P11_DAYS, freq="1D")
    kinds = {"EDH-EDH": (cs.P11_PAIR, days),
             "BHZ-EDH": (cs.P11_BHZ_PAIR, days),
             "BHR-EDH": (cs.P11_BHR_PAIR, days[:1])}
    if against is None:
        forms = ("port", "plain")

        def run(form, pair, kdays, root):
            return run_cli(pair, kdays, root, sds, inv_path,
                           form == "plain", names)
    else:
        trees = {"this": cs.REPO, "against": os.path.abspath(against)}
        forms = tuple(trees)

        def run(form, pair, kdays, root):
            kind = next(k for k, (p, _) in kinds.items() if p == pair)
            return run_tree(trees[form], pair, kdays, root, sds, inv_path,
                            rss[kind][form])
    walls = {k: {f: [] for f in forms} for k in kinds}
    rss = {k: {f: [] for f in forms} for k in kinds}
    for i in range(pairs):
        order = forms[::-1] if i % 2 == 0 else forms
        for kind, (pair, kdays) in kinds.items():
            roots = {f: os.path.join(tmp.name, f"{kind}-{f}") for f in order}
            for f in order:
                walls[kind][f].append(run(f, pair, kdays, roots[f]))
            for day in kdays:
                a, b = (xt.read(xt.ncfile(pair, day, roots[f]))["cc"].values
                        for f in forms)
                cs.check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                         f"{kind} {day:%F}: the forms' shards differ")
            for root in roots.values():
                shutil.rmtree(root)
            print(f"round {i + 1} ({order[0]} first) {kind}: "
                  + ", ".join(f"{f} {walls[kind][f][-1]:.3f} s"
                              for f in order), flush=True)
    tmp.cleanup()
    first, second = forms
    for kind, w in walls.items():
        q = statistics.quantiles(w[second], n=4) if pairs > 1 \
            else [0, 0, 0]
        wins = sum(a < b for a, b in zip(w[first], w[second]))
        print(f"{kind} s per pair-day: {first} median "
              f"{statistics.median(w[first]):.3f}, {second} median "
              f"{statistics.median(w[second]):.3f} (quartile spread "
              f"{q[2] - q[0]:.3f}); {first} faster in {wins} of "
              f"{pairs} rounds; shards the same bits", flush=True)
        if against is not None:
            print(f"{kind} peak resident set per run, GB: " + ", ".join(
                f"{f} median {statistics.median(rss[kind][f]) / 1e9:.2f} "
                f"({min(rss[kind][f]) / 1e9:.2f}-"
                f"{max(rss[kind][f]) / 1e9:.2f})" for f in forms),
                flush=True)
    return walls


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--against", default=None,
                        help="another checkout to run in turns with this")
    parser.add_argument("--plain-forms", default=None,
                        help="comma-separated names of stream/_steps.py's "
                             "and core/process.py's FORMS that the plain "
                             "form swaps, alone")
    parser.add_argument("--campaign", default=None,
                        help="comma-separated numbers of EDH pairs: run "
                             "the CLI over each as a campaign on each "
                             "fetch form instead")
    parser.add_argument("--trio", action="store_true",
                        help="run phase 11's three pairs over its first "
                             "day as one campaign on each fetch form "
                             "instead")
    parser.add_argument("--forms", default=",".join(FETCH_FORMS),
                        help="comma-separated FETCH_FORMS that --campaign "
                             "and --trio run, the first compared with the "
                             "others")
    args = parser.parse_args()
    names = args.plain_forms.split(",") if args.plain_forms else None
    forms = sorted(form_modules())
    cs.check(names is None or set(names) <= set(forms),
             f"--plain-forms: not in {forms}: {names}")
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from xcorr_tpu_torch.ops import _build
    _build.load()
    cs.set_route("corr")
    if args.campaign or args.trio:
        sizes = [int(n) for n in (args.campaign or "0").split(",")]
        forms = tuple(args.forms.split(","))
        cs.check(len(forms) > 1 and set(forms) <= set(FETCH_FORMS),
                 f"--forms: two or more of {sorted(FETCH_FORMS)}")
        print(json.dumps(campaign(sizes, args.pairs, forms, args.trio)))
    else:
        print(json.dumps(ab(args.pairs, args.against, names)))


if __name__ == "__main__":
    main()
