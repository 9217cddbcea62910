"""The multi-device layer on several CUDA cards of one host.

Run from the repository root on a host with two or more cards::

    python3 tools/multicard_check.py

Prints the cards' names and power limits, then, with card 0 left as the
current device throughout:

1. K1, K2 (forward and inverse), K3 and K4 on tensors of every other
   card: each launch counted once, within 1e-5 of its plain version
   (max |diff| / max |plain|), and whether its bits equal the same
   launch's on card 0 (the wrappers make the tensors' card current for
   the launch: the C side sizes its grid and launches on the current
   device);
2. ``parallel.sharded_correlate`` of 16 day-scale windows (24 h at
   50 Hz, 0-9 h lags) over ``make_mesh()``, once per route of the
   four-step path: the route's kernel once per card, the result against
   the unsharded ``correlate`` on card 0;
3. ``device_process_bulk(mesh=make_mesh())`` of ``chip_smoke.py``'s 4
   pair-days of 250 Hz raw data (32 windows): K1 once per card, statuses
   equal and CCFs against the ``mesh=None`` run on card 0;
4. ``correlate_spectrograms(mesh=make_mesh())`` of a seeded stack of 60
   spectrograms against ``mesh=None`` (``chip_smoke.phase9d_timelapse``:
   peaks within 1e-5 relative, shifts equal but for near-ties checked in
   float64);
5. each kernel on card 1 tensors while card 0, the current device, is
   busy with a spin kernel of about half a second: the output's memory
   is filled with NaN beforehand, and the result is read on card 1's
   stream straight after the launch, as any caller on card 1 reads it;
   it must be within 1e-5 of its plain version. The kernels' streams
   are the default stream, whose handle (0) names no card: a launch
   made with card 0 current runs on card 0, reaches card 1's memory
   over peer access and is not ordered with card 1's stream, so this
   check fails without the wrappers' guard;
6. the four-step's sequence-parallel split (``ops.fft4.plan_correlate4(
   stageb='fft', mesh=)``) of 8 day-scale windows on card 1 over
   ``("batch", "seq")`` meshes of every card, shapes (1, 4) and (2, 2)
   on four cards: K2 twice forward and once inverse on each card (one
   seq entry each), the partial pruned inverses summed on each batch
   share's first card, the result gathered onto card 1 and read there
   at once while card 0, the current device and the first share's
   summing card, spins as in step 5; within 1e-6 of the unsplit plan on
   card 1 (bit-identity reported) and of the float64 oracle.

Each comparison reports its max |diff| and whether the bits agree;
CCFs must agree within 1e-6. Exits non-zero on any failure. Last, after
``ok``, step 5 runs again in a fresh process (``--unguarded``) with the
wrappers' ``torch.cuda.device`` made a no-op for the launch, as the
wrappers launched before they had the guard, and prints each result's
error read straight after the launch and again once card 0 has
finished: the fault the guard repairs. ``--step5`` runs step 5 alone,
from the root of any tree of the repository (the package and
``chip_smoke.py`` are imported from the working directory), and exits
non-zero when it fails; ``--step6`` runs step 6 alone. This checks
where the work runs and what it
gives, not how fast: the only times it prints are step 4's, which are
not a benchmark.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def main():
    cs.check(torch.cuda.device_count() >= 2,
             f"{torch.cuda.device_count()} CUDA devices; need 2 or more")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    import xcorr_tpu_torch as xt
    from xcorr_tpu_torch.ops import _build, cc
    from xcorr_tpu_torch.ops import fused_fft as ff
    from xcorr_tpu_torch.parallel import (device_process_bulk, make_mesh,
                                          sharded_correlate)
    from xcorr_tpu_torch.scripts.timelapse import correlate_spectrograms
    _build.load()
    ncard = torch.cuda.device_count()
    mesh = make_mesh()
    print(f"{mesh}", flush=True)

    # 1. every kernel on every other card, card 0 current
    d0 = cs.kernel_inputs(2, 265, 16384, 264, 99, cs.SEED)
    calls, plains = kernel_calls(ff)
    on0 = {k: fn(d0).cpu() for k, fn in calls.items()}
    for i in range(1, ncard):
        di = {k: v.to(f"cuda:{i}") for k, v in d0.items()}
        for name, fn in calls.items():
            ff.reset_launches()
            got = fn(di)
            cs.check(ff.launches[name] == 1, f"{name} on cuda:{i}: "
                                             f"launches {ff.launches}")
            cs.check(got.device == torch.device("cuda", i),
                     f"{name}: result on {got.device}")
            want = plains[name](di)
            rel = float((got - want).abs().max() / want.abs().max())
            cs.check(rel <= cs.K_RTOL, f"{name} on cuda:{i}: {rel}")
            same = torch.equal(got.cpu(), on0[name])
            print(f"[1] {name} on cuda:{i} (current device "
                  f"{torch.cuda.current_device()}): launches 1, rel err "
                  f"{rel:.3e}, bit-identical to cuda:0: {same}",
                  flush=True)
        del di
    cs.check(torch.cuda.current_device() == 0, "the current device moved")

    # 2. sharded_correlate over the cards, once per route
    lags = day_lags(xt)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn((16, cs.N), generator=gen, device="cuda")
    y = torch.roll(x, -int(cs.DELAY * cs.FS), dims=1) + \
        0.5 * torch.randn((16, cs.N), generator=gen, device="cuda")
    for route, (kname, _) in cs.ROUTES.items():
        cs.set_route(route)
        ff.reset_launches()
        got = sharded_correlate(x, y, mesh=mesh, **lags)
        counts = dict(ff.launches)
        cs.check(counts[kname] == ncard and sum(counts.values()) == ncard,
                 f"route {route}: launches {counts}")
        want = cc.correlate(x, y, **lags).cpu().numpy()
        diff = float(np.abs(got - want).max())
        cs.check(diff <= cs.CCF_ATOL, f"route {route}: {diff}")
        print(f"[2] sharded_correlate route {route} over {ncard} cards: "
              f"{kname} launches {counts[kname]}, max |diff| vs "
              f"unsharded on cuda:0 {diff:.3e} (bit-identical: "
              f"{diff == 0.0})", flush=True)
    cs.set_route("corr")
    del x, y

    # 3. the device engine over the cards
    inv, client, days, dataset = cs.engine_setup(xt)
    ref = [dataset(d) for d in days]
    fin, _ = device_process_bulk(ref, client, inventory=inv, verb=0,
                                 device="cuda")
    fin()
    dss = [dataset(d) for d in days]
    ff.reset_launches()
    fin, fallback = device_process_bulk(dss, client, inventory=inv, verb=0,
                                        mesh=mesh)
    fin()
    cs.check(not fallback and ff.launches["fused_corr"] == ncard,
             f"engine: fallback {fallback}, launches {ff.launches}")
    diff, same = 0.0, True
    for d, r in zip(dss, ref):
        cs.check(np.array_equal(d["status"].values, r["status"].values),
                 "engine: statuses differ")
        diff = max(diff, float(np.abs(d["cc"].values
                                      - r["cc"].values).max()))
        same &= bool(np.array_equal(d["cc"].values, r["cc"].values))
    cs.check(diff <= cs.CCF_ATOL, f"engine: {diff}")
    print(f"[3] device_process_bulk(mesh=) of {len(dss)} pair-days over "
          f"{ncard} cards: fused_corr launches {ff.launches['fused_corr']},"
          f" statuses equal, max |CCF diff| vs mesh=None {diff:.3e} "
          f"(bit-identical: {same})", flush=True)

    # 4. the timelapse cells over the cards
    stack = np.random.default_rng(cs.SEED).uniform(
        0.0, 1.0, (60, 61, 720)).astype(np.float32)
    iu, ju = np.triu_indices(60)
    want = correlate_spectrograms(stack, iu, ju, device="cuda")
    cs.phase9d_timelapse(mesh, {"tl_stack": (stack, want,
                                             "a seeded stack")})

    # 5. card 1's launches read at once while card 0 is busy
    step5(calls, plains, d0)

    # 6. the four-step's seq split over the cards
    step6(ff, lags)
    print("ok", flush=True)
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--unguarded"], capture_output=True, text=True,
                         timeout=600)
    print(out.stdout.strip(), flush=True)
    print(f"[5] the unguarded process exited {out.returncode}", flush=True)


def kernel_calls(ff):
    """Each kernel's wrapper and its plain version, by name."""
    calls = {
        "fused_corr": lambda d: ff.fused_corr(d["ax"], d["ay"], d["T"]),
        "stageb_fwd": lambda d: ff.stageb_fwd(d["ax"], d["T"]),
        "stageb_inv": lambda d: ff.stageb_inv(d["ax"], d["ay"], d["T"]),
        "fused_corr_acc": lambda d: ff.fused_corr_acc(
            d["ax"], d["ay"], d["T"], d["wi"]),
        "fused_corr_full": lambda d: ff.fused_corr_full(
            d["vx"], d["vy"], d["w1"], d["T"], d["wi"]),
    }
    plains = {
        "fused_corr": lambda d: ff.fused_corr_plain(d["ax"], d["ay"],
                                                    d["T"]),
        "stageb_fwd": lambda d: ff.stageb_fwd_plain(d["ax"], d["T"]),
        "stageb_inv": lambda d: ff.stageb_inv_plain(d["ax"], d["ay"],
                                                    d["T"]),
        "fused_corr_acc": lambda d: ff.fused_corr_acc_plain(
            d["ax"], d["ay"], d["T"], d["wi"]),
        "fused_corr_full": lambda d: ff.fused_corr_full_plain(
            d["vx"], d["vy"], d["w1"], d["T"], d["wi"]),
    }
    return calls, plains


#: cycles of card 0's spin kernel (about half a second at 1.98 GHz)
SPIN_CYCLES = 1_000_000_000


class NoGuard:
    """``torch.cuda.device`` that leaves the current device as it is."""

    def __init__(self, device):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def busy_card0(calls, plains, d0, guard=True):
    """Each kernel on cuda:1 tensors with card 0 current and spinning;
    returns ``{name: (error read at once, error once card 0 is done)}``
    (max |diff| / max |plain|; NaN where the output was not written yet).
    ``guard=False``: the wrappers' ``torch.cuda.device`` is a no-op
    during the launch."""
    d1 = {k: v.to("cuda:1") for k, v in d0.items()}
    errs = {}
    for name, fn in calls.items():
        want = plains[name](d1)
        torch.cuda.synchronize(1)
        torch.cuda.empty_cache()
        # the only free block of the output's size, for its empty()
        poison = torch.full_like(want, float("nan"))
        del poison
        torch.cuda._sleep(SPIN_CYCLES)   # on card 0, the current device
        real = torch.cuda.device
        if not guard:
            torch.cuda.device = NoGuard
        try:
            got = fn(d1)
        finally:
            torch.cuda.device = real
        at_once = float((got - want).abs().max() / want.abs().max())
        torch.cuda.synchronize(0)
        later = float((got - want).abs().max() / want.abs().max())
        torch.cuda.synchronize(1)
        errs[name] = (at_once, later)
    cs.check(torch.cuda.current_device() == 0, "the current device moved")
    return errs


def step5(calls, plains, d0):
    """Step 5: each kernel right when read at once on card 1."""
    for name, (at_once, later) in busy_card0(calls, plains, d0).items():
        print(f"[5] {name} on cuda:1, card 0 current and busy: rel err "
              f"read at once {at_once:.3e}, after card 0 finished "
              f"{later:.3e}", flush=True)
        cs.check(at_once <= cs.K_RTOL, f"step 5: {name} on cuda:1 read at "
                                       f"once: rel err {at_once}")


def day_lags(xt):
    """The production lag window of a 24 h window at 50 Hz, 0-9 h, as
    keywords."""
    return dict(zip(("index_min", "index_max"), cs.day_lags(xt)))


def step6(ff, lags):
    """Step 6: the 'fft' branch's seq split over every card, read at once
    on card 1 while card 0 spins."""
    from xcorr_tpu_torch.ops import fft4
    from xcorr_tpu_torch.parallel import make_mesh
    ncard = torch.cuda.device_count()
    x, y = (v.to("cuda:1") for v in cs.day_windows(8))
    oracle = cs.day_oracle(x, y, lags["index_min"], lags["index_max"])
    want = fft4.plan_correlate4(cs.N, stageb="fft", **lags)(x, y)
    torch.cuda.synchronize(1)
    shapes = [(1, ncard)] + ([(2, ncard // 2)] if ncard % 2 == 0 else [])
    real = ff._launch
    for shape in shapes:
        mesh = make_mesh(axis_names=("batch", "seq"), shape=shape)
        plan = fft4.plan_correlate4(cs.N, stageb="fft", mesh=mesh, **lags)
        plan(x, y)  # constants on every card
        torch.cuda.synchronize()
        by_card = {}

        def counted(name, device, *args):
            key = (name, str(device))
            by_card[key] = by_card.get(key, 0) + 1
            return real(name, device, *args)
        ff._launch = counted
        torch.cuda._sleep(SPIN_CYCLES)   # on card 0, the current device
        try:
            got = plan(x, y)
        finally:
            ff._launch = real
        diff = float((got - want).abs().max())   # read on card 1 at once
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        per_entry = {"stageb_fwd": 2, "stageb_inv": 1}  # one entry a card
        per_card = {f"cuda:{i}": {n: by_card.get((n, f"cuda:{i}"), 0)
                                  for n in per_entry} for i in range(ncard)}
        cs.check(got.device == torch.device("cuda", 1),
                 f"step 6: result on {got.device}")
        cs.check(all(c == per_entry for c in per_card.values()),
                 f"step 6 {shape}: K2 launches by card {per_card}")
        err = cs.ccf_err(got, oracle)
        cs.check(err <= cs.CCF_ATOL, f"step 6 {shape}: CCF error {err}")
        cs.check(diff <= cs.CCF_ATOL, f"step 6 {shape}: {diff} from the "
                                      "unsplit plan")
        print(f"[6] stageb='fft' over ('batch', 'seq') of {shape}, inputs "
              f"on cuda:1, read at once while card 0 spins: K2 launches by "
              f"card {per_card}; max |split - unsplit| {diff:.3e} "
              f"(bit-identical: {same}); rows 0-1 max abs vs f64 {err:.3e} "
              f"(unsplit {cs.ccf_err(want, oracle):.3e})", flush=True)
    cs.check(torch.cuda.current_device() == 0, "the current device moved")


def setup():
    """The library built and loaded; the wrappers, their plain versions
    and the inputs on card 0."""
    from xcorr_tpu_torch.ops import _build
    from xcorr_tpu_torch.ops import fused_fft as ff
    _build.load()
    calls, plains = kernel_calls(ff)
    return calls, plains, cs.kernel_inputs(2, 265, 16384, 264, 99,
                                           cs.SEED)


def unguarded():
    """``--unguarded``: step 5 with the guard made a no-op, reported."""
    calls, plains, d0 = setup()
    for name, (at_once, later) in busy_card0(calls, plains, d0,
                                             guard=False).items():
        print(f"[5] without the guard, {name} on cuda:1, card 0 current "
              f"and busy: rel err read at once {at_once:.3e}, after card "
              f"0 finished {later:.3e}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--unguarded"]:
        unguarded()
    elif sys.argv[1:] == ["--step5"]:
        cs.check(torch.cuda.device_count() >= 2,
                 f"{torch.cuda.device_count()} CUDA devices; need 2")
        step5(*setup())
        print("ok", flush=True)
    elif sys.argv[1:] == ["--step6"]:
        cs.check(torch.cuda.device_count() >= 2,
                 f"{torch.cuda.device_count()} CUDA devices; need 2")
        import xcorr_tpu_torch as xt
        from xcorr_tpu_torch.ops import fused_fft
        setup()
        step6(fused_fft, day_lags(xt))
        print("ok", flush=True)
    else:
        main()
