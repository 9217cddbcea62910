"""What ``torch.profiler`` names of a ``precision='default'`` call, session
by session, against the bits the call gives, on the card.

    python3 tools/profiler_names_probe.py

On ``chip_smoke.py``'s phase 4 windows (16 seeded day-scale windows) and
the production lag window, for the four-step's ``stageb='matmul'`` and
``'fft'`` branches: the ``'high'`` and ``'default'`` CCFs, whether ten
unprofiled ``'default'`` calls repeat their bits, then 25 profiler
sessions of one ``'default'`` call each. Per session it prints whether
the call's CCFs equal the unprofiled ``'default'`` ones and the
``'high'`` ones, the count of card events named, whether a TF32 GEMM was
named (``chip_smoke.tf32_gemm``) and the GEMMs named. A session whose
call gave the TF32 product's bits but named no TF32 GEMM lost that event.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
import xcorr_tpu_torch as xt  # noqa: E402
from xcorr_tpu_torch.ops import fft4  # noqa: E402

SESSIONS = 25


def main():
    imin, imax = cs.day_lags(xt)
    x, y = cs.day_windows()
    card = torch.autograd.DeviceType.CUDA
    for name in ("matmul", "fft"):
        kw = cs.P10_ROUTES[name]
        hi = fft4.plan_correlate4(cs.N, imin, imax, precision="high", **kw)
        de = fft4.plan_correlate4(cs.N, imin, imax, precision="default",
                                  **kw)
        oh = hi(x, y)
        od = de(x, y)
        base_diff = (oh - od).abs().max().item()
        rep = [torch.equal(de(x, y), od) for _ in range(10)]
        print(name, "high-vs-default", base_diff, "repeats same", all(rep),
              flush=True)
        for n in range(SESSIONS):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                o = de(x, y)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == card]
            names = [e.key for e in events]
            gemms = sorted({k[:50] for k in names if "gemm" in k.lower()})
            print(" ", n, torch.equal(o, od), torch.equal(o, oh),
                  sum(e.count for e in events), any(map(cs.tf32_gemm, names)),
                  gemms, flush=True)
            del o
        del hi, de, oh, od
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
