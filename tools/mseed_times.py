"""Host seconds of the port's miniSEED codec on a 250 Hz day file.

    python3 tools/mseed_times.py [--reps 3] [--threads 8]

Encodes a seeded 21.6 M-sample int32 day at 250 Hz (Steim1, 512-byte
records) in one ``encode_mseed`` call, then reads the bytes back
``--reps`` times through ``read_mseed_bytes`` (the records joined into one
array per run inside the library) and through ``_read_mseed_bytes_plain``
(one Trace per record, joined in Python), and once in ``--threads``
threads at once through each, as the host engine's window fetches read
one day file. Prints the medians and the walls. Host seconds, never a
card figure; imports no JAX; about 2 GB of memory.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from xcorr_tpu_torch.native import mseed  # noqa: E402
from xcorr_tpu_torch.stream import Stats, Trace  # noqa: E402

FS = 250.0
NPTS = int(86400 * FS)


def seconds(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(20140201)
    tr = Trace(np.round(1e3 * rng.standard_normal(NPTS)).astype(np.int32),
               Stats(network="IM", station="H03S1", location="",
                     channel="EDH", starttime="2014-02-01",
                     sampling_rate=FS))
    t0 = time.perf_counter()
    payload = mseed.encode_mseed(tr)
    enc = time.perf_counter() - t0
    print(f"encode_mseed: {NPTS} samples in one call, {len(payload)} "
          f"bytes, {enc:.4f} s")
    (back,) = mseed.read_mseed_bytes(payload)
    if not np.array_equal(back.data, tr.data):
        raise SystemExit("the day does not read back to its samples")
    for name, read in (("read_mseed_bytes", mseed.read_mseed_bytes),
                       ("_read_mseed_bytes_plain",
                        mseed._read_mseed_bytes_plain)):
        one = [seconds(lambda: read(payload)) for _ in range(args.reps)]
        with ThreadPoolExecutor(args.threads) as ex:
            wall = seconds(lambda: list(ex.map(
                read, [payload] * args.threads)))
        print(f"{name}: {statistics.median(one):.4f} s per read (median "
              f"of {args.reps}: {[round(x, 4) for x in one]}); "
              f"{args.threads} reads in {args.threads} threads "
              f"{wall:.4f} s wall")


if __name__ == "__main__":
    main()
