"""The host fetch's two forms in turns, on the card's machine.

    python3 tools/host_fetch_ab.py [--pairs 10] [--against TREE]
                                   [--plain-forms NAME,...]

Writes ``chip_smoke.py``'s phase 11 miniSEED archive (2 EDH stations at
250 Hz, ``IU.RAR.10.BH1/BH2/BHZ`` at 40 Hz, 5 days), then, ``--pairs``
times, runs each of phase 11's pair kinds through ``xcorr-torch-cc``
(EDH-EDH over 2 pair-days, BHZ-EDH and BHR-EDH over 1) once on the
port's host fetch and chain (the window read, the inverse-response
cache, the chain without the components it never reads, the steps
without their dropped copies) and once on their carried forms
(``chip_smoke.plain_host_path(lanczos=False)``: the copying read, the
response evaluated for every window and component, every fetched
component through the chain, the steps' carried expressions), from
empty day-file and response caches, alternating which form runs first.
With ``--plain-forms``, the plain form swaps only the named step forms of
``stream/_steps.py`` (``FORMS``) for their plain versions and keeps the
rest of the port's fetch: ``sosfilt_inplace,window_array`` runs scipy's
loop and a fresh array per window merge against the native loop and the
thread's buffer. With ``--against TREE`` (another checkout of the
repository, say the parent commit unpacked by ``git archive``), each run
is instead a new
process, in this checkout or in ``TREE``, each building its kernels in
its own ``build/`` first. Both forms' shards must be the same bits.
Prints the card's name and power limit, each wall per pair-day, and per
pair kind the medians, the second form's quartile spread and the rounds
the first won; the last line is the walls as JSON. Needs one card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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


@contextlib.contextmanager
def plain_forms(names):
    """The step forms ``names`` of ``stream/_steps.py`` swapped for their
    plain versions while it runs."""
    from xcorr_tpu_torch.stream import _steps
    real = {name: getattr(_steps, name) for name in names}
    for name in names:
        setattr(_steps, name, getattr(_steps, f"_{name}_plain"))
    try:
        yield
    finally:
        for name, form in real.items():
            setattr(_steps, name, form)


def run_cli(pair, days, root, sds, inv_path, plain, names=None):
    """Seconds per pair-day of ``xcorr-torch-cc`` over ``pair``'s
    ``days`` into ``root``, from empty caches, on the carried forms if
    ``plain`` (only the step forms ``names`` where given)."""
    from xcorr_tpu_torch.scripts import cc as cc_cli
    from xcorr_tpu_torch.stream import _daycache, _response
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()
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
    cs.check(rc == 0, f"xcorr-torch-cc returned {rc}")
    return wall / len(days)


#: a run of ``xcorr-torch-cc`` in a new process, in the checkout it
#: names: the card and the kernels made ready first, the wall per
#: pair-day printed as JSON
RUN = """
import json, sys, time
sys.path.insert(0, {tree!r})
import torch
from xcorr_tpu_torch.ops import _build
from xcorr_tpu_torch.scripts import cc as cc_cli
_build.load()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t0 = time.perf_counter()
rc = cc_cli.main({argv!r})
torch.cuda.synchronize()
print(json.dumps({{"rc": rc, "wall": time.perf_counter() - t0}}))
"""


def run_tree(tree, pair, days, root, sds, inv_path):
    """Seconds per pair-day of ``xcorr-torch-cc`` over ``pair``'s
    ``days`` into ``root``, in a new process of the checkout ``tree``."""
    argv = ["--root", root, "--sds-root", sds, "--pair", pair, "--start",
            f"{days[0]:%F}", "--end", f"{days[-1]:%F}", "--inventory",
            inv_path]
    env = {k: v for k, v in os.environ.items() if k not in cs.ROUTE_VARS}
    proc = subprocess.run([sys.executable, "-c",
                           RUN.format(tree=tree, argv=argv)], cwd=tree,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    cs.check(proc.returncode == 0, f"{tree}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    cs.check(out["rc"] == 0, f"{tree}: xcorr-torch-cc returned {out['rc']}")
    return out["wall"] / len(days)


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
             "BHZ-EDH": (cs.P11_BHZ_PAIR, days[:1]),
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
            return run_tree(trees[form], pair, kdays, root, sds, inv_path)
    walls = {k: {f: [] for f in forms} for k in kinds}
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
    return walls


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--against", default=None,
                        help="another checkout to run in turns with this")
    parser.add_argument("--plain-forms", default=None,
                        help="comma-separated names of stream/_steps.py "
                             "FORMS that the plain form swaps, alone")
    args = parser.parse_args()
    from xcorr_tpu_torch.stream import _steps
    names = args.plain_forms.split(",") if args.plain_forms else None
    cs.check(names is None or set(names) <= set(_steps.FORMS),
             f"--plain-forms: not in {_steps.FORMS}: {names}")
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from xcorr_tpu_torch.ops import _build
    _build.load()
    cs.set_route("corr")
    print(json.dumps(ab(args.pairs, args.against, names)))


if __name__ == "__main__":
    main()
