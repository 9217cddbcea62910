"""Smoke run of the PyTorch port (``xcorr_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero and
prints ``FAIL:`` and its reason on stdout and, after the last phase
line, on stderr:

1. the card (``nvidia-smi``), torch, CUDA and the TF32 switches;
2. build the hand-written kernels from ``xcorr_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and, beside the build,
   ``nvcc -Xptxas -v`` of K1, K2, K3 and K4 for the registers, shared
   memory and spills of their row chains (K2's forward and inverse) at
   N2 = 8192 and 16384 and of K3's and K4's split-TF32 product
   (``gemm_tf32.cu``); then the count of TF32
   ``HMMA`` instructions in the built library's SASS (``cuobjdump
   -sass``), on its own line;
3. every kernel against its plain PyTorch version, max |diff| / max
   |plain| <= 1e-5 (K2: 1e-6), with CUDA-event times of both (median of
   20 launches after warm-up) and the card's bound for the same work: K1
   at the device engine's launch shape (32, 2, 265, 16384), at the host
   engine pair-day's shape (8, 2, 265, 16384: n1 = 528), at
   (4, 2, 265, 16384), at the n1 = 1056 shape (8, 2, 529, 8192) and at a
   small one; K3 and K4 at the pair-day's shape of their routes (B = 8,
   H = 265, N2 = 16384, rows_in = 264, rows_out = 99, with the n1 = 528
   plan's own w1, T and wi), at the n1 = 1056 one (B = 8, H = 529,
   N2 = 8192, rows_in = 528, rows_out = 198, that plan's constants) and
   at a small one; K2 (forward and inverse) at the pair-day's shape
   (8, 2, 265, 16384), at the n1 = 1056 one and at the small one, each
   with its bound, its share of it and, for context, ``torch.fft.fft``
   over the same complex rows (less work: no twiddle, no planar layout),
   and the inverse of the forward held to ``fused_corr_plain`` (1e-5 of
   its max). Every kernel runs twice on the same inputs and must give
   the same bits. At the two 8-window K1 shapes,
   K1's phase clock (``xc_fused_corr_phases``): SM cycles per row, phase
   by phase;
4. ``ops.cc.correlate`` on 16 synthetic 24 h windows at 50 Hz
   (n = 4,320,000) with the 0-9 h lag window, once per route of the
   four-step path, each chosen as a user chooses it (no variable: K1;
   ``XCORR_FFT4_FUSED_INV=1``: K3; ``XCORR_FFT4_FULL=1``: K4), each in
   its route's default geometry: only the route's kernel launched, 2
   windows within 1e-6 abs of a float64 numpy oracle, the peak on the
   injected delay, ms per window and peak working memory; the K1 route's
   time split into stage-A product, K1, inverse product and lag slice at
   its default n1 = 528 and at n1 = 1056; the K3 route's into stage-A
   product, K3 and lag slice and the K4 route's into K4 and lag slice, at
   n1 = 528; the monolithic cuFFT route beside them;
5. the slice, once per route after a first (cold) run on the K1 route:
   ``init`` -> ``process(device='cuda')`` of one production-geometry
   pair-day from ``SyntheticClient``: every status 1, all 8 CCF peaks on
   the injected delay, the CCFs within 1e-6 abs of the K1 route's, the
   route's kernel launched and no other; wall seconds and device share.
   On the K1 route also ``write`` -> ``read``, equal;
6. the device engine (``parallel.engine.device_process_bulk`` +
   ``finalize``) at production width: 4 consecutive pair-days of the EDH
   pair, raw 250 Hz through the production EDH chain of
   ``xcorr_tpu/scripts/cc.py:79-91`` (remove_sensitivity, 3-20 Hz
   bandpass, decimate x5, trim, demean, taper) to 50 Hz, 24 h windows,
   0-9 h lags: one launch of 32 windows, run cold then warm. Every status
   1, every peak on the injected delay, K1 launched once and nothing
   else; wall per pair-day, device share (torch.profiler), host->device
   bytes, peak device memory, the stage timer's report and the device
   time of the 8 costliest kernels. Day 1 again
   through the host engine (``process``): CCFs within 1e-6 abs, equal
   offsets. The BHZ chain's device stages (filters, remove_response with
   a PAZ, Lanczos 40 -> 50 Hz) on two day-scale windows of 40 Hz noise,
   float32 on the card against float64 on the CPU, stage by stage; a
   miniSEED round trip through ``SDSArchive(format="mseed")``. The BH
   chains' Lanczos step (40 -> 50 Hz, a = 20) on one buffered 24 h
   window on the host: the native ``lanczos_interp`` bit-identical to
   the carried numpy loop, both timed, then 8 windows in 8 threads. Then
   one BHZ-EDH pair-day, ``IM.H03S1..EDH-IU.RAR.10.BHZ``: the BHZ side
   raw at 40 Hz with a PAZ response through the production BHZ chain of
   ``xcorr_tpu/scripts/cc.py:46-60`` (``remove_response`` in float32 on
   the card), through the device engine, the host engine (timed by
   chain stage) and the host engine on the plain path (the carried
   Lanczos loop): host CCFs bit-identical to the plain path's and within
   1e-6 abs of the device engine's. Then the BHR fallback: one
   ``device_process_bulk`` call of an EDH-EDH pair-day and
   ``IM.H03S1..EDH-IU.RAR.10.BHR`` (BH1, BH2, BHZ
   raw at 40 Hz through the production BHR chain, whose rotations have
   no device stage): the BHR pair-day on the fallback list, the EDH-EDH
   one on the device engine, then the fallback through
   ``process(device='cuda')``: every status 1, every peak on the
   injected delay (the BHR-EDH one plus the lag between the two
   production chains, measured on noise-free arrivals), wall seconds of
   each, the fallback's by chain stage: its BHR chain fetched BHZ and
   ran no operation on it, while the plain path (every fetched
   component, the steps' carried expressions) ran them and gave the
   same CCF bits. Both BH host-engine runs start on a fetch pool of
   their own and print where each chain array came from (no thread
   takes two fresh arrays of a key);
7. the analysis slice on the card. (a) Full lag width: phase 6's 4
   pair-days (32 windows x 1.62 M lags, float32) through ``postprocess``
   (0-9 h lags, the scripts' 3 Hz highpass, no celerity clip) and ``snr``
   (envelope; signal window at the injected delay, noise at 6-9 h), held
   to the same calls on the CPU (``cc`` within 1e-5 of its peak; ``snr``,
   ``s``, ``n`` within 1e-5 relative; ``lag_s_max`` equal), with card ms
   per pair-day for each stage of the chain, and ``postprocess`` alone on
   its port forms (``core/postprocess.py`` ``select``,
   ``signal/_unbias.py`` ``span_weights``) and on their plain forms
   (``_select_plain``, ``_span_weights_plain``: the carried selection of
   ``cc`` whole and the weights of the whole lag range), timed and held
   bit-identical. (b) The campaign at the
   production celerity window: the 8 pairs of ``scripts/cc.py`` for 5
   days (40 pair-days) built with ``init`` at the production geometry and
   filled from a seeded generator (noise plus one arrival at
   distance / 1480 m/s, strong on two runs of windows), one day held at a
   time; per pair ``scripts.snr.pair_snr`` (``postprocess(clim=(1460,
   1500))`` + ``snr(envelope=True)``), then ``combine_by_coords`` over the
   days and ``coincidence_trigger``; per triggered period and pair
   ``scripts.psd.pair_psd`` (``postprocess(time_lim=period)`` +
   ``spectrogram(duration=2.5, padding_factor=4)`` to 20 Hz). All held to
   the same run on the CPU (``snr`` 1e-5 relative, periods identical, PSD
   within 1e-5 of its max), with wall per pair-day on the card and on the
   CPU, the device share (``lost`` where a profiler session saw fewer
   device records than host-side launch calls) and the device
   operations per pair-day, and the
   last day's card wall taken apart: ``postprocess``, ``snr`` and each
   stage of the chain on the clipped lag window; then that day's
   ``pair_snr`` on the card on the port forms and on the plain forms in
   turns (``AB_ROUNDS`` rounds, the order swapped each round), medians and
   spreads per pair-day. In 7a, 7b and 8a-8d every ``postprocess`` call on
   the card (``postprocess_twice``: by whatever name the scripts call it)
   runs again on the plain forms on the same inputs, outside the timed and
   profiled sections, and the two results are held bit-identical
   (``dataset_differences``: variables, coordinates, dtypes, bytes, attrs
   but ``cc``'s ``postprocess`` timestamp), the calls counted per part. The
   Z and R pairs of one
   receiver share a distance, and so do the three array pairs, whose
   arrivals carry the delays of a plane wave (250 deg, 1480 m/s) across
   the H03S triad of ``ARRAY_STATIONS``;
8. the rest of the analysis tier on the card, each part held to the same
   calls on the CPU, with card and CPU wall per unit, the device share
   and the device operations per unit (torch.profiler), and each
   part's ``postprocess`` calls on the card held bit-identical to the
   plain forms (as in phase 7). In 7b's day loop:
   (a) ``scripts.beamform.beamform_datasets`` of the three array pairs
   per day, envelope off and on: ``s_x``, ``s_y``, ``vel``, ``err``
   within 1e-9 relative and ``doa`` within 1e-9 degrees of the CPU's,
   the injected wave within 5 deg and 10% on the event windows;
   (b) ``scripts.plmax.pair_plmax`` of the first day's 8 pair-days with
   the STFT and with the scaleogram: the spectrogram within 1e-5 of its
   max, the peak sets equal but for near-ties, counted; (c)
   ``scripts.swresp.swresp_datasets`` of the two (Z, R) pairs per day:
   ratio and phase within 1e-3 (relative, rad) on the bins where both
   spectra exceed 1e-2 of their max. Then (d) the timelapse of the array
   pairs H10N1-H03S1 and H10N2-H03S2 over 60 days x 4 bands (3-6, 6-9,
   9-12, 12-20 Hz; 2.5 s, padding 4): ``pair_spectrograms`` and
   ``correlate_spectrograms`` of all 14,640 cells on the card, cells/s,
   stack shapes, peak device memory, TL1 and TL2 once per batch, TL2 on
   the route its rows take (``ops.cells.row_plan``; 8d's take the row
   kernel; counts reset just before each stack's run and read just
   after); the CPU makes 12 seeded days' spectrograms per pair (within
   1e-5 of their max) and 64 seeded cells of them per (pair, band)
   (``cc2`` within 1e-5, shifts equal but for near-ties, counted). Then
   the scan route on the main path: the largest stack's first 12 days at
   15,000 lags (nl = 30,000), every cell against the plain form, TL1 and
   the scan once per batch. Then the cells' forms in turns,
   ``TL_AB_ROUNDS`` rounds over the 8 stacks: the form (each spectrogram's
   spectrum once per stack, TL1, cuFFT's column ``ifft`` and TL2's row
   kernel) and ``_correlate_spectrograms_plain``, cells/s on each, device
   ms per batch and share, peak device memory; the form's peaks within
   1e-6 (relative) of the plain form's, shifts equal but for near-ties
   (float64, counted), bit-identical cells counted. The kernels alone at
   the largest stack's first batch of 64 cells: TL1 within 1e-6 of its
   plain version's max (bit-identity reported); the scan its plain
   version's value bits and index on the batch's ``irfft2`` maps, a zero
   map, and a planted tie and planted NaNs; the row kernel's peaks within
   1e-6 (relative) of its plain version's, indices equal but for
   near-ties, a rerun the same bits, a zero input and a planted NaN as
   its plain version; median ms of 20, plain ms, bound, and the row
   kernel's library yardstick (``irfft`` of the kept rows). (e) A
   year-size stack, 365 spectrograms made from the largest stack's 60
   (the widest band of the pair with the longer lag window) by a seeded
   multiplicative perturbation: all 66,795 cells once on each form,
   cells/s, peak device memory, TL1 and TL2 once per batch, every cell
   held to the plain form as above; and the cell bookkeeping at T = 365
   (``fill_cells`` and ``_fill_cells_plain``) timed on the host, the
   Datasets the same bytes;
9. the multi-device layer on the one card, over a logical mesh that
   names ``cuda:0`` twice (so its times are the split's overhead, not a
   multi-card speed). (a) ``parallel.sharded_correlate`` of phase 4's 16
   day-scale windows once per route: the route's kernel once per entry,
   rows 0, 1 and 8 within 1e-6 abs of float64, the difference from the
   unsharded ``correlate`` (bit-identity reported), ms per window both
   ways with the host gather. (b) Phase 6's 4 pair-days through
   ``device_process_bulk(mesh=)`` inside ``util.profiler.trace``: K1
   once per entry, statuses equal and CCFs within 1e-6 of phase 6's warm
   mesh=None run (bit-identity reported), wall, host->device bytes, peak
   memory, ``device_memory``, and ``parse_device_trace``'s busy seconds
   (> 0, <= wall) and device spans beside the profiler's own device
   time. (c) Two worker processes (``chip_smoke.py --worker RANK PORT
   DIR``, each with a timeout) form a gloo group on a free localhost
   port, each runs its ``host_slice`` of the 4 pair-days through
   ``device_process_bulk`` on cuda:0 and writes its CCFs to an ``.npz``;
   their union is held to phase 6's run (1e-6, bit-identity reported).
   (d) ``correlate_spectrograms(mesh=)`` of one (pair, band) stack of
   8d: peaks within 1e-5 relative of 8d's, shifts equal but for
   near-ties, checked in float64 and counted. Then phase 9's launches,
   each count reset before its run, on a line of their own, and its
   command time;
10. the four-step's ``stageb='fft'|'matmul'`` branches (n1 = 576: all
    576 rows, N2 = 16384), ``packed``, their seq split and the
    precision knob at day scale. (a) K2 against its plain version at
    the branch's shapes, (16, 2, 576, 16384) and (16, 2, 288, 16384)
    with T's rows 288-575, within 1e-5 relative, bit-identical reruns,
    times, bounds and cuFFT's time on the same planes; then at the
    pair-day's (8, 2, 265, 16384) with the n1 = 528 plan's constants,
    cuFFT's time beside it too. (b) On phase 4's
    16 windows, ``plan_correlate4(stageb='fft')``, ``'matmul'`` and
    ``'fft'`` with ``packed=True``: within 1e-6 of phase 4's float64
    oracle (packed 1e-5), the peak on the injected delay, K2's launches
    (2 + 1, packed 1 + 1, none for ``'matmul'``), ms per window, peak
    working memory. (c) ``precision='default'`` against ``'high'`` on
    every route (``corr``, ``acc``, ``full``, ``fft``, ``matmul``):
    within 1e-4 of the oracle, ms per window, outputs that differ, TF32
    GEMM kernels (cuBLAS's by name, K3's and K4's one-pass instance) in
    the profiler under ``'default'`` and none under ``'high'``; then
    both TF32 switches as before and a ``'high'`` call within 1e-6.
    (d) ``'fft'`` and ``'matmul'`` over phase 9's logical mesh as
    ``("seq",)`` of 2 and ``("batch", "seq")`` of (1, 2): within 1e-6 of
    unsplit (bit-identity reported), K2 per entry, the split's overhead
    per window; ``stageb='pallas'`` with a mesh raises. (e)
    ``XCORR_CC_PRECISION=default`` through phase 6's 4 pair-days on the
    device engine: K1 once, statuses and peaks as phase 6, CCFs within
    1e-4 of phase 6's warm run, the wall. Then phase 10's launches and
    its command time. 10c reads the kernels' names with
    ``torch.profiler`` in a new process on the same seeded windows
    (``--kernel-names``), over several sessions, and holds that
    process's CCFs to this one's, bit for bit: after minutes of a run,
    a session of the card's torch 2.11 may report none or only some of
    the card's events. ``python3 chip_smoke.py --phase10`` runs phases 1, 2 (the build alone) and 10, with phase
    4's oracle and phase 6's engine run made for it;
11. the production entry point on this machine, archive to shards to
    analysis. A miniSEED SDS archive of ``IM.H10N1..EDH`` and
    ``IM.H03S1..EDH`` (the first ``DELAY`` s late), 250 Hz raw over the
    two pair-days and their windows' reach, and of ``IU.RAR.10.BHZ`` at
    40 Hz carrying the same source train ``DELAY`` s early, each day
    file written whole by ``SDSArchive(format="mseed").write`` (the
    port's linear Steim1 encoder; timed), and phase 6's EDH and BHZ
    inventory as a JSON file. Every
    day file, and a small file of gaps, overlaps and interleaved ids,
    read by the port's run-merging ``read_mseed_bytes`` equal to the
    per-record plain path, bit for bit, with both times.
    ``xcorr_tpu_torch.scripts.cc.main`` (``xcorr-torch-cc``, the
    host engine on ``cuda``) over the two pair-days, the day-file cache
    empty at its start: each distinct day file decoded once (decodes,
    cache hits and decode seconds printed), K1 launched and no
    other kernel, a shard written per pair-day through the port's HDF5
    codec (``io/hdf5.py``: this machine has no HDF5 library). Each shard
    read with ``io.read`` and checked with ``io.validate``: every status
    1, CCFs within 1e-6 abs of an in-memory ``process(device='cuda')``
    of the pair-day (bit-identity reported), every peak on the injected
    delay. ``xcorr_tpu_torch.scripts.snr.main`` over the shards: snr, s
    and n within 1e-5 (relative) of ``pair_snr`` on the in-memory
    datasets, ``lag_s_max`` equal. Then ``xcorr-torch-cc`` over two
    BHZ-EDH pair-days, ``IM.H03S1..EDH-IU.RAR.10.BHZ`` (the BHZ chain's
    response and Lanczos steps on the host), and one BHR-EDH pair-day,
    held as above, their peaks on the delay plus the lag between the EDH
    and BH chains (measured on noise-free arrivals). Each CLI run starts
    on a fetch pool of its own: where each chain array came from (kept
    by its thread or fresh; no thread takes two fresh arrays of a key),
    the pool's threads, the peak resident set. Bytes, write seconds (in
    the campaign) and read seconds per shard, the CLI's wall per pair-day
    of each pair, each chain step's seconds summed over the fetch
    threads; the BHR-EDH pair-day's chain
    fetched BHZ and ran no operation on it. One 250 Hz window alone, in
    one thread, by step, on the carried forms and the port's in turns
    (the same bits), and its window merge by part (allocation, the cast,
    eight at once into fresh and into touched memory, a compute
    control); one 40 Hz window's ``remove_response`` by part (cast,
    ``rfft``, product, ``irfft``) on the carried expressions and the
    port's form, alone and eight at once, the same bits. The SNR CLI
    over the EDH-EDH shards on the codec's read forms (the chunked read
    into one array on the read pool, ``io/hdf5_chunks.py``) and on their
    plain versions (``io/hdf5.py`` ``_read_chunked_plain``,
    ``_getitem_plain``) in turns, ``P11_READ_ROUNDS`` rounds: wall per
    pair-day, the reads' seconds, bytes inflated per shard, the peak
    resident set; every SNR file within 1e-5 of ``pair_snr`` in memory
    and all of them the same bits; then one shard's read alone by part
    (the chunks' bytes, inflate serial and on the read pool's threads,
    unshuffle, the whole read on each form, the kept block as a slice
    read). h5py must not be imported.
    ``python3 chip_smoke.py --phase11`` runs phases 1, 2 (the build
    alone) and 11;
12. files that other HDF5 writers make, read on this machine without
    h5py: every fixture of ``tests/fixtures_torch/hdf5`` (netCDF-C's
    layout, each version-4 chunk index, fletcher32, lzf, szip,
    scaleoffset, nbit, a skipped optional filter, 4-byte offsets,
    virtual datasets, an external link, external storage, region
    references, bitfield and opaque data, null dataspaces, and an xcorr
    shard the JAX package wrote under netCDF-C's file settings, all made
    by ``tools/make_hdf5_fixtures.py``) read by ``io.netcdf.from_netcdf``
    with the fixture directory as the working directory, to the sha256
    of the view the JAX package reads (``expected.json``; the exception
    type where its read raised), with and without ``header_only``, with
    the read time per file; the native filter decoders built from this
    checkout's ``native/h5filters.cpp``; the shard read and validated
    with its hashes; ``xcorr-torch-snr`` over it on the card within 1e-5
    (relative) of the port's ``pair_snr`` on the CPU, recorded in
    ``expected.json``; each chunked dataset of the fixtures read by
    seeded basic slices on the port's slice read and on the plain one (a
    whole read, then numpy's index), the same bits or the same raise;
    h5py must not be imported. No kernel runs.
    ``python3 chip_smoke.py --phase12`` runs phases 1 and 12.

The line before the last is the kernels' JSON record (K1's launches from
phase 6, K2's from phase 10b's ``'fft'`` call, K3's and K4's from their
route's phase-5 pair-day; K2's times, bounds and cuFFT's time from 10a
at H = 576; TL1's and TL2's launches from 8d's main-path runs, their
times and bounds from 8d's widest batch; TL2's count is one per call,
each call two CUDA launches: its segments, then their join); the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import contextlib
import hashlib
import importlib
import inspect
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import pandas as pd
import torch

FS = 50.0
WINDOW = 86400.0
N = int(WINDOW * FS)                 # 4,320,000 samples per window
CLIP_LAG = (0.0, 9 * 3600.0)
DELAY = 4.0                          # s, injected on the first receiver
PAIR = "IM.H03S1..EDH-IM.H03S2..EDH"
K_RTOL = 1e-5                        # kernel vs plain: max|diff| / max|plain|
K2_RTOL = 1e-6                       # the same for K2's launches
CCF_ATOL = 1e-6                      # normalized CCF vs float64 oracle
SEED = 20140201
#: the EDH preprocess chain of the production benchmark
EDH = [("detrend", {"type": "demean"}),
       ("filter", {"type": "highpass", "freq": 0.05}),
       ("detrend", {"type": "demean"}),
       ("taper", {"type": "cosine", "max_percentage": 0.05,
                  "max_length": 30.0})]
#: route of the four-step path -> (kernel it launches, environment)
ROUTES = {"corr": ("fused_corr", {}),
          "acc": ("fused_corr_acc", {"XCORR_FFT4_FUSED_INV": "1"}),
          "full": ("fused_corr_full", {"XCORR_FFT4_FULL": "1"})}
ROUTE_VARS = ("XCORR_FFT4_FULL", "XCORR_FFT4_FUSED_INV")
#: one H100 SXM's published peaks: HBM bytes/s, float32 FLOP/s outside
#: the tensor cores, dense TF32 FLOP/s on the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
#: the TPU kernel body each kernel replaces
REPLACES = {
    "fused_corr": "xcorr_tpu/ops/pallas_fft.py:446",
    "stageb_fwd": "xcorr_tpu/ops/pallas_fft.py:407",
    "stageb_inv": "xcorr_tpu/ops/pallas_fft.py:415",
    "fused_corr_acc": "xcorr_tpu/ops/pallas_fft.py:535",
    "fused_corr_full": "xcorr_tpu/ops/pallas_fft.py:684",
}
#: the timelapse's cell kernels (ops/cells.py: TL1; TL2's scan and its
#: row kernel), which replace no pallas_call: the JAX package fuses a
#: batch of cells in XLA
TL_KERNELS = ("gather_product", "circular_argmax", "inverse_argmax")
REPLACES.update(dict.fromkeys(
    TL_KERNELS, "xcorr_tpu/scripts/timelapse.py:86 (_corr_step, fused by "
                "XLA; no pallas_call)"))
SOURCES = {
    "gather_product": "xcorr_tpu_torch/csrc/cells.cu",
    "circular_argmax": "xcorr_tpu_torch/csrc/cells.cu",
    "inverse_argmax": "xcorr_tpu_torch/csrc/cells.cu",
    "fused_corr": "xcorr_tpu_torch/csrc/fused_corr.cu",
    "stageb_fwd": "xcorr_tpu_torch/csrc/stageb.cu",
    "stageb_inv": "xcorr_tpu_torch/csrc/stageb.cu",
    "fused_corr_acc": "xcorr_tpu_torch/csrc/fused_corr_acc.cu",
    "fused_corr_full": "xcorr_tpu_torch/csrc/fused_corr_full.cu",
}


#: the last phase line printed, which a failure repeats on stderr
_last_phase = ["(before phase 1)"]


def fail(msg):
    """Print the failure on stdout, and on stderr after the last phase
    line (a caller that keeps only the end of stderr still reads where
    and why), then exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"after: {_last_phase[0]}\nFAIL: {msg}", file=sys.stderr,
          flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase(i, msg):
    _last_phase[0] = f"[phase {i}] {msg}"
    print(_last_phase[0], flush=True)


def set_route(route):
    """Set the route's environment variables as a user would."""
    for var in ROUTE_VARS:
        os.environ.pop(var, None)
    os.environ.update(ROUTES[route][1])


def median_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn()`` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(in_bytes, out_bytes, flops, product_flops=0.0):
    """Least time (ms) of the work on the card, what bounds it, and the
    older float32 form of the bound (ms). The least time is the largest
    of three: each input read once and each output written once at the
    HBM rate; the transforms' float32 operations (``flops``) at the CUDA
    cores' peak; the matrix products' operations (``product_flops``) as
    three TF32 passes at the tensor cores' peak, as accurate as float32
    and counted so whatever implements them. The float32 form puts the
    products at the CUDA cores' peak too."""
    t_bytes = (in_bytes + out_bytes) / HBM_BPS
    t_ops = max(flops / FP32_FLOPS, 3 * product_flops / TF32_FLOPS)
    t_fp32 = max(t_bytes, (flops + product_flops) / FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", t_fp32 * 1e3)


def stageb_flops(B, H, N2):
    """Operations of K1 over B*H rows: three length-N2 complex FFTs
    (5 N log2 N each) and four complex products per element plus the
    scale."""
    return B * H * (3 * 5 * N2 * math.log2(N2) + 26 * N2)


def kernel_inputs(B, H, N2, rows_in, rows_out, seed, consts=None):
    """Seeded stage-A-like planes, windows and (unless the plan's
    ``(w1, wi, T)`` are given) constants of the right shapes, on the
    card."""
    rng = np.random.default_rng(seed)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    d = {"ax": cu(rng.standard_normal((B, 2, H, N2), np.float32)),
         "ay": cu(rng.standard_normal((B, 2, H, N2), np.float32)),
         "vx": cu(rng.standard_normal((B, rows_in, N2), np.float32)),
         "vy": cu(rng.standard_normal((B, rows_in, N2), np.float32))}
    if consts is None:
        ph = rng.uniform(0.0, 2 * np.pi, size=(H, N2))
        d["T"] = cu(np.stack([np.cos(ph), np.sin(ph)]))
        d["w1"] = cu(rng.standard_normal((2 * H, rows_in)) / rows_in ** .5)
        d["wi"] = cu(rng.standard_normal((rows_out, 2 * H)) / H ** .5)
    else:
        d["w1"], d["wi"], d["T"] = consts
    return d


#: the phases of K1's phase clock (csrc/fused_corr.cu: tick)
K1_PHASES = ("x in", "x*T", "forward x", "y in, half y*T", "half y*T",
             "forward y, cross", "inverse", "conj T, out")


def k1_phase_clock(fn, ff, d, shape):
    """K1's SM cycles per row, phase by phase, from its phase-clock entry
    point ``fn`` (``xc_fused_corr_phases``) on the inputs ``d``."""
    B, _, H, N2 = shape
    out = torch.empty_like(d["ax"])
    tw = ff._k1_twiddles(N2, out.device)
    clock = torch.zeros(B * H * 8, dtype=torch.int64, device="cuda")

    def run():
        rc = fn(d["ax"].data_ptr(), d["ay"].data_ptr(), d["T"].data_ptr(),
                tw.data_ptr(), out.data_ptr(), B, H, N2,
                N2.bit_length() - 1, torch.cuda.current_stream().cuda_stream,
                clock.data_ptr())
        check(rc == 0, f"K1 phase clock launch failed: CUDA error {rc}")

    clock_ms = median_ms(run)  # what the clock costs, beside K1's time
    clock.zero_()
    run()
    torch.cuda.synchronize()
    per_row = clock.view(-1, 8).sum(0).double().cpu().numpy() / (B * H)
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()
    phase(3, f"fused_corr {shape} phase clock, SM cycles per row: "
             + ", ".join(f"{k} {v:.0f}" for k, v in zip(K1_PHASES, per_row))
             + f"; all {per_row.sum():.0f}; {B * H} rows; SM clock {sm}; "
               f"the clocked kernel takes {clock_ms:.4f} ms")


def hold(ff, name, label, args, rerun=False, rtol=K_RTOL, tag=3):
    """One kernel against its plain version: error (at most ``rtol`` of
    the plain version's max), times, output; with ``rerun``, a second
    launch on the same inputs must give the same bits. Reported as phase
    ``tag``."""
    fn, plain = getattr(ff, name), getattr(ff, name + "_plain")
    got = fn(*args)
    if rerun:
        check(torch.equal(got, fn(*args)),
              f"{name} {label}: two launches differ")
    torch.cuda.synchronize()
    want = plain(*args)
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    ms = median_ms(lambda: fn(*args))
    plain_ms = median_ms(lambda: plain(*args))
    phase(tag, f"{name} {label}: max_abs_err {err:.3e} rel {rel:.3e} "
               f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    check(rel <= rtol, f"{name} {label} rel err {rel} > {rtol}")
    return got, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase3_k2(ff, label, ax, ay, T, rtol=K2_RTOL, library=False, tag=3):
    """K2's two launches against their plain versions at one shape
    (within ``rtol``, bit-identical reruns), with their bounds and, for
    context, ``torch.fft.fft`` over the same complex rows; the inverse
    of the forward held to ``fused_corr_plain``. With ``library``, each
    launch's cuFFT yardstick on the same planes, in its record as
    ``library_ms``: ``torch.fft.fft`` of ``a·T`` (formed beforehand) for
    the forward, and for the inverse the cross spectrum of the two
    natural-order spectra plus ``torch.fft.ifft`` (the conjugate twiddle
    left out). Returns each launch's record."""
    B, _, Hs, N2s = ax.shape
    fft = 5 * N2s * math.log2(N2s)
    rec = {}
    f, rec["stageb_fwd"] = hold(ff, "stageb_fwd", label, (ax, T),
                                rerun=True, rtol=rtol, tag=tag)
    g = ff.stageb_fwd(ay, T)
    c, rec["stageb_inv"] = hold(ff, "stageb_inv", label, (f, g, T),
                                rerun=True, rtol=rtol, tag=tag)
    rows = torch.complex(ax[:, 0], ax[:, 1])
    fft_ms = median_ms(lambda: torch.fft.fft(rows, dim=-1))
    if library:
        t = torch.complex(T[0], T[1])
        rows *= t
        rec["stageb_fwd"]["library_ms"] = median_ms(
            lambda: torch.fft.fft(rows, dim=-1))
        fx = torch.fft.fft(rows, dim=-1)
        fy = torch.fft.fft(torch.complex(ay[:, 0], ay[:, 1]) * t, dim=-1)
        rec["stageb_inv"]["library_ms"] = median_ms(
            lambda: torch.fft.ifft(fx * fy.conj(), dim=-1))
        del fx, fy, t
    del rows
    for name, in_bytes, ops in [
            ("stageb_fwd", nbytes(ax, T), B * Hs * (fft + 6 * N2s)),
            ("stageb_inv", nbytes(f, g, T), B * Hs * (fft + 14 * N2s))]:
        r = rec[name]
        r["bound_ms"], r["bound_by"], _ = bound(in_bytes, nbytes(ax), ops)
        lib = (f"; cuFFT on the same planes {r['library_ms']:.4f} ms"
               if library else "")
        phase(tag, f"{name} {label}: bound {r['bound_ms']:.4f} ms by "
                   f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% "
                   f"of bound), two launches bit-identical; torch.fft.fft "
                   f"over the same {B * Hs} complex rows {fft_ms:.4f} ms"
                   + lib)
    want = ff.fused_corr_plain(ax, ay, T)
    err = ((c - want).abs().max() / want.abs().max()).item()
    same = torch.equal(c, ff.fused_corr(ax, ay, T))
    phase(tag, f"stageb_inv of stageb_fwd {label}: {err:.3e} of max "
               f"|fused_corr_plain| (bar {K_RTOL}); bit-identical to "
               f"fused_corr: {same}")
    check(err <= K_RTOL, f"K2 {label}: inverse of the forward {err} from "
                         f"fused_corr_plain > {K_RTOL}")
    return rec


def phase3_kernels(ff, plan, plan_1056, clock_fn):
    """Every kernel against its plain version; returns the pair-day
    shape's record per kernel. ``plan`` is the n1 = 528 plan every route
    takes, ``plan_1056`` the n1 = 1056 one (rows of 8192), ``clock_fn``
    K1's phase-clock entry point."""
    rec = {}
    H, N2, rows_in, rows_out = plan.half, plan.N2, plan.rows_in, \
        plan.rows_out
    H8, N28, rows_in8, rows_out8 = plan_1056.half, plan_1056.N2, \
        plan_1056.rows_in, plan_1056.rows_out
    # K1: the device engine's launch (32 windows) first, the record keeps
    # it; then the host engine's pair-day (8 windows)
    for shape in [(32, 2, H, N2), (8, 2, H, N2), (4, 2, H, N2),
                  (8, 2, H8, N28), (2, 2, 24, 256)]:
        d = kernel_inputs(shape[0], shape[2], shape[3], 8, 5, SEED)
        _, r = hold(ff, "fused_corr", shape, (d["ax"], d["ay"], d["T"]),
                    rerun=True)
        B = shape[0]
        r["bound_ms"], r["bound_by"], _ = bound(
            nbytes(d["ax"], d["ay"], d["T"]), nbytes(d["ax"]),
            stageb_flops(B, shape[2], shape[3]))
        phase(3, f"fused_corr {shape}: bound {r['bound_ms']:.4f} ms by "
                 f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% "
                 f"of bound), two launches bit-identical")
        if B == 8:
            k1_phase_clock(clock_fn, ff, d, shape)
        rec.setdefault("fused_corr", r)
        del d
    # K2, K3 and K4 at their pair-day's shape with the plan's constants,
    # then at the n1 = 1056 one and a small one
    for B, Hs, N2s, ri, ro, consts in [
            (8, H, N2, rows_in, rows_out, plan.device_consts("cuda")),
            (8, H8, N28, rows_in8, rows_out8,
             plan_1056.device_consts("cuda")),
            (2, 24, 256, 8, 5, None)]:
        d = kernel_inputs(B, Hs, N2s, ri, ro, SEED, consts)
        label = f"B={B} H={Hs} N2={N2s} rows_in={ri} rows_out={ro}"
        ax, ay, T, w1, wi, vx, vy = (d[k] for k in (
            "ax", "ay", "T", "w1", "wi", "vx", "vy"))
        out_rows = B * ro * N2s * 4
        k1_ops = stageb_flops(B, Hs, N2s)
        inv_ops = 2 * B * ro * 2 * Hs * N2s
        a_ops = 2 * 2 * B * 2 * Hs * ri * N2s
        rec.update({k: v for k, v in phase3_k2(ff, label, ax, ay, T).items()
                    if k not in rec})
        for name, args, in_bytes, ops, prods in [
                ("fused_corr_acc", (ax, ay, T, wi), nbytes(ax, ay, T, wi),
                 k1_ops, inv_ops),
                ("fused_corr_full", (vx, vy, w1, T, wi),
                 nbytes(vx, vy, w1, T, wi), k1_ops, a_ops + inv_ops)]:
            _, r = hold(ff, name, label, args, rerun=True)
            r["bound_ms"], r["bound_by"], fp32 = bound(
                in_bytes, out_rows, ops, prods)
            phase(3, f"{name} {label}: bound {r['bound_ms']:.4f} ms by "
                     f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}"
                     f"% of bound; float32 form {fp32:.4f} ms, "
                     f"{100 * fp32 / r['ms']:.1f}%), two launches "
                     f"bit-identical")
            rec.setdefault(name, r)
        del d, ax, ay, vx, vy
    for name, r in rec.items():
        phase(3, f"{name} at the pair-day shape: {r['ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
                 f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound)")
    torch.cuda.empty_cache()
    return rec


#: translation units whose ``nvcc -Xptxas -v`` phase 2 reports, by the
#: kernel they hold: the row chain of K1, K3 and K4 (one copy each, from
#: csrc/corr_rows.cuh), K2's two launches and K3's and K4's split-TF32
#: product
PTXAS_UNITS = {"K1": "fused_corr.cu", "K2": "stageb.cu",
               "K3": "fused_corr_acc.cu", "K4": "fused_corr_full.cu",
               "K3/K4 product": "gemm_tf32.cu"}
#: gemm_tf32.cu's dynamic shared memory: two stages of two (hi, lo)
#: 128 x (32 + 4) A tiles and a 32 x (128 + 8) B tile, float32
GEMM_SMEM = 2 * (2 * 128 * 36 + 32 * 136) * 4


def ptxas_entries(report):
    """``{mangled entry: (registers, spill line)}`` from ``nvcc -Xptxas
    -v``."""
    out, name, frame = {}, None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, frame = m.group(1), ""
        elif name and "spill" in ln:
            frame = ln.strip()
        elif name and "Used" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            out[name] = (regs, frame)
            name = None
    return out


def ptxas_summary(unit, report, ff):
    """Lines for one unit: the row chain's instances without the phase
    clock (K2: its forward and its inverse) at N2 = 8192 and 16384
    (registers, spills, the block's dynamic shared memory: a row, pass
    twiddles, exchange buffer), or the product's four instances (B in
    16-byte copies, as at the pair-day's shapes, or in 4-byte ones;
    three TF32 passes or one)."""
    lines = []
    for name, (regs, frame) in sorted(ptxas_entries(report).items()):
        m = re.search(r"(fused_corr|stageb)_kernelILi(\d+)ELb([01])E", name)
        if m and int(m.group(2)) in (13, 14) and (
                m.group(1) == "stageb" or m.group(3) == "0"):
            n = 1 << int(m.group(2))
            what = {"fused_corr": "rows", "stageb": ("fwd", "inv")[
                int(m.group(3))] + " rows"}[m.group(1)]
            smem = 8 * n + 8 * len(ff._k1_twiddles(n, "cpu")) \
                + 4 * (n + n // 32)
            lines.append(f"{what}, N2 = {n}: {regs} registers, {frame}, "
                         f"{smem} bytes of dynamic shared memory")
        m = re.search(r"gemm_tf32_kernelILb([01])ELi([13])E", name)
        if m:
            copies = "16-byte" if m.group(1) == "1" else "4-byte"
            lines.append(f"product, B in {copies} copies, {m.group(2)} "
                         f"TF32 pass(es): {regs} registers, {frame}, "
                         f"{GEMM_SMEM} bytes of dynamic shared memory")
    check(len(lines) == (4 if unit in ("K2", "K3/K4 product") else 2),
          f"ptxas report of {unit}: {lines}")
    return lines


def tf32_hmma(path, nvcc):
    """TF32 ``HMMA`` instructions per function in the SASS of the library
    at ``path`` (``cuobjdump -sass``, beside ``nvcc``), and the distinct
    HMMA forms."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, forms, fn = {}, set(), None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\b(HMMA\S*)", ln)
        if m and fn:
            forms.add(m.group(1))
            if "TF32" in m.group(1):
                counts[fn] = counts.get(fn, 0) + 1
    return counts, sorted(forms)


def f64_oracle(x, y, imin, imax):
    """Normalized CCF on the lag window, float64 numpy rfft."""
    n = x.shape[-1]
    nfft = 1 << (2 * n - 2).bit_length()
    r = np.fft.irfft(np.fft.rfft(x, nfft) * np.conj(np.fft.rfft(y, nfft)),
                     nfft)
    idx = (np.arange(imin, imax) - (n - 1)) % nfft
    return r[idx] / (np.linalg.norm(x) * np.linalg.norm(y))


def day_windows(B=16):
    """Phase 4's ``B`` seeded day-scale windows on the card: noise ``x``
    and ``y``, its copy ``DELAY`` earlier plus half as much noise."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((B, N), generator=gen, device="cuda")
    y = torch.roll(x, -int(DELAY * FS), dims=1) + \
        0.5 * torch.randn((B, N), generator=gen, device="cuda")
    return x, y


def day_oracle(x, y, imin, imax):
    """The float64 oracle of the first two windows."""
    xh = x[:2].double().cpu().numpy()
    yh = y[:2].double().cpu().numpy()
    return [f64_oracle(xh[i], yh[i], imin, imax) for i in range(2)]


def phase4_correlate(ff, cc, fft4, imin, imax):
    """Day-scale correlate, once per route; the K1 route's split at its
    default geometry and at n1 = 1056. Returns the float64 oracle of the
    first two windows."""
    B = 16
    x, y = day_windows(B)
    shift = int(DELAY * FS)
    oracle = day_oracle(x, y, imin, imax)

    def corr():
        return cc.correlate(x, y, index_min=imin, index_max=imax)

    per_window = {}
    for route, (kname, _) in ROUTES.items():
        set_route(route)
        ff.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = corr()
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        counts = dict(ff.launches)
        check(counts[kname] == 1 and sum(counts.values()) == 1,
              f"route {route}: correlate launched {counts}, expected "
              f"{kname} once")
        check(tuple(out.shape) == (B, imax - imin), f"shape {out.shape}")
        check(bool(torch.isfinite(out).all()), "non-finite CCF")
        oh = out[:2].double().cpu().numpy()
        err = max(float(np.abs(oh[i] - oracle[i]).max()) for i in range(2))
        check(err <= CCF_ATOL, f"route {route}: CCF error {err} > "
                               f"{CCF_ATOL}")
        peak = int(out[0].argmax()) + imin - (N - 1)
        check(peak == shift, f"route {route}: peak at lag {peak} samples, "
                             f"expected {shift}")
        t_all = median_ms(corr, 10)
        per_window[route] = t_all / B
        phase(4, f"route {route} ({kname}): correlate {B} x {N} lags "
                 f"[{imin}, {imax}) ({imax - imin} per row): max abs vs "
                 f"f64 {err:.3e}, peak working memory {peak_gb:.2f} GB, "
                 f"{t_all / B:.4f} ms per window")
        del out

    set_route("corr")
    t_mono = median_ms(lambda: cc.correlate(x, y, index_min=imin,
                                            index_max=imax,
                                            method="monolithic"), 10)
    # the K1 route split at its default geometry, then at n1 = 1056: what
    # the geometry brought apart from what the kernel brought
    for n1 in (None, 1056):
        plan = fft4.plan_correlate4(N, imin, imax, n1=n1, normalize=True,
                                    route="corr")
        w1, wi, t = plan.device_consts(x.device)
        ax, ay = plan.stage_a(x, w1), plan.stage_a(y, w1)
        c = ff.fused_corr(ax, ay, t)
        flat = plan.inverse(c, wi)
        err = max(float(np.abs(_finish(fft4, plan, flat, x, y)[i]
                               - oracle[i]).max()) for i in range(2))
        check(err <= CCF_ATOL, f"route corr n1={plan.N1}: CCF error {err}")
        t_a = median_ms(lambda: (plan.stage_a(x, w1), plan.stage_a(y, w1)),
                        10)
        t_k = median_ms(lambda: ff.fused_corr(ax, ay, t), 10)
        t_i = median_ms(lambda: plan.inverse(c, wi), 10)
        t_s = median_ms(lambda: fft4._finish_ccf(flat, x, y, plan.segs_flat,
                                                 True), 10)
        t_p = median_ms(lambda: plan(x, y), 10)
        phase(4, f"route corr, ms per window (B={B}, N1={plan.N1}, "
                 f"N2={plan.N2}, H={plan.half}, rows_in={plan.rows_in}, "
                 f"rows_out={plan.rows_out}): stage-A {t_a / B:.4f}, K1 "
                 f"{t_k / B:.4f}, inverse {t_i / B:.4f}, lag slice+norm "
                 f"{t_s / B:.4f}; whole plan {t_p / B:.4f}; max abs vs f64 "
                 f"{err:.3e}; monolithic cuFFT {t_mono / B:.4f}")
        del ax, ay, c, flat
    # the K3 and K4 routes split at their default geometry
    plan = fft4.plan_correlate4(N, imin, imax, normalize=True, route="acc")
    w1, wi, t = plan.device_consts(x.device)
    ax, ay = plan.stage_a(x, w1), plan.stage_a(y, w1)
    vx, vy = plan.padded(x), plan.padded(y)
    flat = ff.fused_corr_acc(ax, ay, t, wi).view(B, -1)
    t_a = median_ms(lambda: (plan.stage_a(x, w1), plan.stage_a(y, w1)), 10)
    t_k3 = median_ms(lambda: ff.fused_corr_acc(ax, ay, t, wi), 10)
    t_k4 = median_ms(lambda: ff.fused_corr_full(vx, vy, w1, t, wi), 10)
    t_s = median_ms(lambda: fft4._finish_ccf(flat, x, y, plan.segs_flat,
                                             True), 10)
    phase(4, f"ms per window (B={B}, N1={plan.N1}, N2={plan.N2}, "
             f"H={plan.half}, rows_in={plan.rows_in}, rows_out="
             f"{plan.rows_out}): route acc = stage-A {t_a / B:.4f} + K3 "
             f"{t_k3 / B:.4f} + lag slice+norm {t_s / B:.4f}, correlate "
             f"{per_window['acc']:.4f}; route full = K4 {t_k4 / B:.4f} + "
             f"lag slice+norm {t_s / B:.4f}, correlate "
             f"{per_window['full']:.4f}; route corr correlate "
             f"{per_window['corr']:.4f}")
    del x, y, ax, ay, vx, vy, flat
    torch.cuda.empty_cache()
    return oracle


def _finish(fft4, plan, flat, x, y):
    """The first two windows' normalized CCFs of a split run, float64."""
    return fft4._finish_ccf(flat[:2], x[:2], y[:2], plan.segs_flat,
                            True).double().cpu().numpy()


def phase5_pair_days(xt, ff):
    """One production-geometry pair-day through process per route;
    returns each kernel's launches on its route's path. K2 is on no
    kernel route (it is the 'fft' branch's, phase 10): every run below
    checks that it launched no time."""
    from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient
    from torch.profiler import ProfilerActivity, profile
    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9),
    ])
    client = SyntheticClient(
        sampling_rate=FS,
        delays={"IM.H03S1..EDH": DELAY, "IM.H03S2..EDH": 0.0},
        source_period=600.0, source_amplitude=20.0)
    launches, ref = dict.fromkeys(ff.KERNELS, 0), None
    # the first pair-day of the process also pays one-time set-up (the
    # profiler's start, first calls into scipy and torch); it runs on
    # the K1 route and is reported apart
    for run, route in enumerate(["corr", *ROUTES]):
        kname = ROUTES[route][0]
        label = f"route {route}" + (" (first, cold)" if run == 0 else "")
        set_route(route)
        ds = xt.init(pair=PAIR, starttime="2014-02-01",
                     endtime="2014-02-02", preprocess={"EDH": EDH},
                     attrs={"institution": "smoke", "author": "smoke",
                            "source": "SyntheticClient"},
                     sampling_rate=FS, window_length=WINDOW,
                     window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                     inventory=inv)
        nwin = ds.dims["time"]
        check(nwin == 8, f"{nwin} windows per pair-day, expected 8")
        ff.reset_launches()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            xt.process(ds, client, device="cuda", verb=0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ff.launches)
        check(counts[kname] > 0, f"{label}: process never launched {kname}")
        others = {k: v for k, v in counts.items() if k != kname and v}
        check(not others, f"{label}: process also launched {others}")
        launches[kname] = counts[kname]
        status = ds["status"].values
        check(bool((status == 1).all()), f"status {status.tolist()}")
        ccv = ds["cc"].values
        check(bool(np.isfinite(ccv).all()), "non-finite CCF in the dataset")
        lag = ds.coords["lag"].values
        peaks = [float(lag[int(np.argmax(ccv[0, i]))]) for i in range(nwin)]
        check(all(abs(p - DELAY) < 1.0 / FS + 1e-9 for p in peaks),
              f"{label}: CCF peaks {peaks} s, injected delay {DELAY} s")
        if ref is None:
            ref = ccv
        diff = float(np.abs(ccv - ref).max())
        check(diff <= CCF_ATOL, f"{label}: CCFs differ from the K1 "
                                f"route's by {diff} > {CCF_ATOL}")
        dev = sum(e.self_device_time_total for e in prof.key_averages()) \
            / 1e3
        share = f"{dev / 1e3 / wall:.4f}" if dev > 0 else "not measured"
        phase(5, f"{label}: pair-day {nwin} windows x "
                 f"{ccv.shape[-1]} lags: {wall:.2f} s wall, device "
                 f"{dev:.1f} ms, device share {share}, {kname} launches "
                 f"{counts[kname]}, max |CCF - K1 route| {diff:.3e}, peaks "
                 f"at {sorted(set(peaks))} s")
        if run != 1:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            path = xt.write(ds, os.path.join(tmp, "shard.nc"), verb=0)
            back = xt.read(path)
            check(back is not None, "read returned None")
            check(np.array_equal(back["cc"].values, ccv),
                  "read != written")
            check(bool((back["status"].values == 1).all()),
                  "read status")
        phase(5, "write -> read round trip equal")
    set_route("corr")
    return launches


#: the production EDH chain of xcorr_tpu/scripts/cc.py:79-91 (the
#: hydrophones' raw 250 Hz -> 50 Hz)
EDH_PROD = [("merge", {"method": 1, "fill_value": "interpolate",
                       "interpolation_samples": 0}),
            ("detrend", {"type": "demean"}),
            ("remove_sensitivity", {}),
            ("filter", {"type": "bandpass", "freqmin": 3., "freqmax": 20.}),
            ("decimate", {"factor": 5}),
            ("trim", {}),
            ("detrend", {"type": "demean"}),
            ("taper", {"type": "cosine", "max_percentage": 0.05,
                       "max_length": 30.})]
#: the device stages of the BHZ chain (xcorr_tpu/scripts/cc.py:46-60),
#: held stage by stage at 40 Hz raw
BHZ_STAGES = [("filter", {"type": "highpass", "freq": .05}),
              ("detrend", {"type": "demean"}),
              ("remove_response", {"output": "VEL"}),
              ("filter", {"type": "highpass", "freq": 3.}),
              ("interpolate", {"sampling_rate": 50, "method": "lanczos",
                               "a": 20}),
              ("filter", {"type": "lowpass", "freq": 20.}),
              ("detrend", {"type": "demean"}),
              ("taper", {"type": "cosine", "max_percentage": 0.05,
                         "max_length": 30.})]
RAW_FS = 250.0
ENGINE_DAYS = 4


def engine_setup(xt):
    """Phase 6's pair-days: ``(inventory, client, days, dataset)``, where
    ``dataset(day)`` is the EDH pair's production-geometry dataset of the
    day, its data 250 Hz raw from the seeded client."""
    from xcorr_tpu_torch.stream import (Channel, Inventory, PAZResponse,
                                        SyntheticClient)
    resp = PAZResponse(sensitivity=1.5e9)
    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8,
                response=resp),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9,
                response=resp)])
    client = SyntheticClient(
        sampling_rate=RAW_FS,
        delays={"IM.H03S1..EDH": DELAY, "IM.H03S2..EDH": 0.0},
        source_period=600.0, source_amplitude=20.0)
    days = [np.datetime64("2014-02-01") + np.timedelta64(i, "D")
            for i in range(ENGINE_DAYS)]

    def dataset(day):
        return xt.init(pair=PAIR, starttime=str(day),
                       endtime=str(day + np.timedelta64(1, "D")),
                       preprocess={"EDH": EDH_PROD},
                       attrs={"institution": "smoke", "author": "smoke",
                              "source": "SyntheticClient"},
                       sampling_rate=FS, window_length=WINDOW,
                       window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                       inventory=inv)
    return inv, client, days, dataset


def phase6_device_engine(xt, ff):
    """The device engine at production width: 4 consecutive pair-days of
    the EDH pair at 250 Hz raw through ``device_process_bulk`` +
    ``finalize`` (one launch of 32 windows), then day 1 through the host
    engine; the BHZ chain's stages against float64 on the CPU; a miniSEED
    round trip; a BHZ-EDH pair-day on both engines. Returns K1's launches
    on the engine's run, the warm run's 4 datasets and its wall
    seconds."""
    from torch.profiler import ProfilerActivity, profile
    from xcorr_tpu_torch.parallel.engine import device_process_bulk
    from xcorr_tpu_torch.stream import PAZResponse, Stream
    from xcorr_tpu_torch.stream.compile import compile_operations
    from xcorr_tpu_torch.util.profiler import StageTimer
    inv, client, days, dataset = engine_setup(xt)
    resp = inv.channels[0].response

    k1 = 0
    for run in ("first, cold", "warm"):
        dss = [dataset(d) for d in days]
        nwin = sum(d.dims["time"] for d in dss)
        check(nwin == 32, f"{nwin} windows in {ENGINE_DAYS} pair-days")
        timer = StageTimer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ff.reset_launches()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            finalize, fallback = device_process_bulk(
                dss, client, inventory=inv, timer=timer, verb=0,
                device="cuda")
            finalize()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ff.launches)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        check(not fallback, f"device engine fell back: {fallback}")
        check(counts["fused_corr"] == 1 and sum(counts.values()) == 1,
              f"engine launched {counts}, expected fused_corr once for "
              f"one pack of 32 windows")
        k1, warm_wall = counts["fused_corr"], wall
        for d in dss:
            status = d["status"].values
            check(bool((status == 1).all()), f"status {status.tolist()}")
            ccv = d["cc"].values
            check(bool(np.isfinite(ccv).all()), "non-finite CCF")
            lag = d.coords["lag"].values
            peaks = [float(lag[int(np.argmax(ccv[0, i]))])
                     for i in range(ccv.shape[1])]
            check(all(abs(p - DELAY) < 1.0 / FS + 1e-9 for p in peaks),
                  f"engine CCF peaks {peaks} s, injected {DELAY} s")
        dev = sum(e.self_device_time_total for e in prof.key_averages()) \
            / 1e3
        share = f"{dev / 1e3 / wall:.4f}" if dev > 0 else "not measured"
        h2d = timer.as_dict()["device-dispatch"].get("GB", 0.0)
        phase(6, f"device engine ({run}): {ENGINE_DAYS} pair-days, {nwin} "
                 f"windows, 250 Hz raw -> 50 Hz, 1 launch of K1: "
                 f"{wall:.2f} s wall, {wall / ENGINE_DAYS:.3f} s per "
                 f"pair-day, device {dev:.1f} ms, device share {share}, "
                 f"host->device {h2d:.3f} GB, peak device memory "
                 f"{peak_gb:.2f} GB above {base / 1e9:.2f}; launches "
                 f"{counts}")
        for line in timer.report().splitlines():
            phase(6, f"  {line.strip()}")
        top = sorted((e for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)[:8]
        phase(6, "  device time by kernel, ms (calls): " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} "
            f"({e.count})" for e in top))

    # day 1 through the host engine on the card, same client
    host = dataset(days[0])
    t0 = time.perf_counter()
    xt.process(host, client, inventory=inv, device="cuda", verb=0)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    check(bool((host["status"].values == 1).all()), "host engine status")
    diff = float(np.abs(dss[0]["cc"].values - host["cc"].values).max())
    check(diff <= CCF_ATOL, f"device engine vs host engine: {diff} > "
                            f"{CCF_ATOL}")
    for var in ("pair_offset", "time_offset"):
        check(np.array_equal(dss[0][var].values, host[var].values),
              f"{var} differs between the engines")
    phase(6, f"day 1: device engine vs host engine (process, "
             f"{host_wall:.2f} s wall): max |CCF diff| {diff:.3e} "
             f"(bar {CCF_ATOL}), pair_offset and time_offset equal")

    # the BHZ chain's device stages on two day-scale windows of 40 Hz
    # noise, float32 on the card against float64 on the CPU
    fs, n = 40.0, int(round((WINDOW * 1.1) * 40.0))
    paz = PAZResponse(poles=[-0.037 + 0.037j, -0.037 - 0.037j],
                      zeros=[0j, 0j], gain=1.0, sensitivity=2.5e8)
    x = np.random.default_rng(SEED).standard_normal((2, n)) * 1e3
    errs = []
    for op in BHZ_STAGES:
        fn, n_out, fs_out = compile_operations([op], x.shape[-1], fs,
                                               response=paz)
        want = fn(torch.from_numpy(x)).numpy()
        got = fn(torch.from_numpy(x).float().cuda()).cpu().double().numpy()
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        errs.append(f"{op[0]}({op[1].get('type', op[1].get('output', ''))}"
                    f" {fs:g} Hz) {rel:.2e}")
        x, fs = want, fs_out
    phase(6, "BHZ chain stage by stage, 2 windows, float32 card vs "
             "float64 CPU, max rel err: " + "; ".join(errs))

    # miniSEED through the SDS archive on this machine
    from xcorr_tpu_torch.stream import Stats, Trace
    from xcorr_tpu_torch.stream.sds import SDSArchive
    rng = np.random.default_rng(SEED)
    tr = Trace(np.round(1e4 * rng.standard_normal(int(86400 * FS)))
               .astype(np.int32),
               Stats(network="IM", station="H03S1", location="",
                     channel="EDH", starttime="2014-02-01T00:00:00",
                     sampling_rate=FS))
    with tempfile.TemporaryDirectory() as tmp:
        archive = SDSArchive(tmp, format="mseed")
        archive.write(Stream([tr]))
        back = archive.read(tr.id, "2014-02-01T12:00:00")
        cov = archive.coverage(tr.id, "2014-02-01T12:00:00")
    check(len(back) == 1 and np.array_equal(back[0].data, tr.data),
          "miniSEED round trip differs")
    check(sum(s[2] for s in cov) == tr.stats.npts, f"coverage {cov[:2]}")
    phase(6, f"miniSEED SDS round trip of {tr.stats.npts} samples equal; "
             f"header scan covers them in {len(cov)} records")
    phase6_lanczos()
    bhz_pair_day(xt, ff, resp, paz)
    bhr_fallback(xt, ff, resp, paz)
    return k1, dss, warm_wall


#: the BH chains' Lanczos step (``scripts/cc.py``: 40 Hz raw to 50 Hz,
#: a = 20)
BH_FS = 40.0
LANCZOS_A = 20


def phase6_lanczos():
    """The BH chains' Lanczos step on one buffered 24 h window (40 Hz,
    3,801,600 samples, to 50 Hz), on this machine's host: the port's
    native ``lanczos_interp`` against the carried numpy loop it replaces
    (``stream/trace.py`` ``_lanczos_interp``, its plain version), bit
    for bit, with both times; then 8 such windows in 8 threads, as the
    host engine's 8 fetch threads run them."""
    from concurrent.futures import ThreadPoolExecutor
    from xcorr_tpu_torch.stream import _lanczos
    from xcorr_tpu_torch.stream.trace import _lanczos_interp
    n = int(round(WINDOW * 1.1 * BH_FS))
    npts = int(np.floor((n - 1) / BH_FS * FS)) + 1
    # Trace.interpolate's positions, starttime unchanged
    pos = (0.0 + np.arange(npts) / FS) * BH_FS
    xs = [np.random.default_rng(SEED + i).standard_normal(n) * 1e3
          for i in range(8)]
    t0 = time.perf_counter()
    _lanczos._load()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = _lanczos.lanczos_interp(xs[0], pos, LANCZOS_A)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = _lanczos_interp(xs[0], pos, LANCZOS_A)
    plain_s = time.perf_counter() - t0
    check(got.tobytes() == want.tobytes(),
          f"lanczos_interp differs from the carried loop: max |diff| "
          f"{float(np.abs(got - want).max())}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda x: _lanczos.lanczos_interp(x, pos, LANCZOS_A),
                    xs))
    threads_s = time.perf_counter() - t0
    phase(6, f"Lanczos {BH_FS:g} -> {FS:g} Hz (a = {LANCZOS_A}) of one "
             f"buffered 24 h window ({n} -> {npts} samples) on the host: "
             f"native lanczos_interp {fast_s:.3f} s, the carried numpy "
             f"loop {plain_s:.3f} s ({plain_s / fast_s:.1f}x), "
             f"bit-identical; 8 windows in 8 threads {threads_s:.3f} s; "
             f"library loaded (built if new) in {load_s:.2f} s")


class Stages(dict):
    """``chain_stages``' record: seconds by (channel, operation); per
    chain channel the channels its operations ran on (``ran_on``) and the
    channels it fetched (``fetched``)."""

    def __init__(self):
        super().__init__()
        self.ran_on, self.fetched = {}, {}


def thread_faults():
    """Minor page faults this thread has taken."""
    import resource
    return resource.getrusage(resource.RUSAGE_THREAD).ru_minflt


@contextlib.contextmanager
def chain_stages():
    """Seconds of the host chain while it runs, summed over the fetch
    threads: per (channel, operation) of ``stream.process``, the reads
    (``Client.get_waveforms``), the window merges inside them
    (``_window.merge_window``) and each receiver's whole fetch
    (``Client.get_processed_waveforms``), keyed by the channel the fetch
    asked for, and per channel the wall seconds from its first fetch's
    start to its last fetch's end (``"wall"``), which the threads' sums
    overlap. Also the channels each chain's operations ran on and the
    channels each fetched. Yields the :class:`Stages` it fills."""
    from xcorr_tpu_torch.stream import _window
    from xcorr_tpu_torch.stream import process as proc_mod
    from xcorr_tpu_torch.stream.client import Client
    acc, lock, local = Stages(), threading.Lock(), threading.local()
    spans = {}
    real = (proc_mod.apply_operation, Client.get_waveforms,
            Client.get_processed_waveforms, _window.merge_window)

    def add(key, seconds):
        with lock:
            acc[key] = acc.get(key, 0.0) + seconds

    def timed(fn, label):
        def call(*a, **kw):
            cha = getattr(local, "cha", "?")
            if label is None:
                ws = kw.get("waveforms")
                with lock:
                    acc.ran_on.setdefault(cha, set()).update(
                        t.stats.channel for t in getattr(ws, "traces",
                                                         [ws]))
            elif label == "read":
                receiver = kw.get("receiver") or a[1]
                with lock:
                    acc.fetched.setdefault(cha, set()).add(
                        receiver.split(".")[3])
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                op = kw.get("operation") if label is None else label
                add((cha, op), time.perf_counter() - t0)
        return call

    def fetch(self, receiver, *a, **kw):
        cha = local.cha = receiver.split(".")[3]
        t0 = time.perf_counter()
        try:
            return timed(real[2], "fetch")(self, receiver, *a, **kw)
        finally:
            t1 = time.perf_counter()
            with lock:
                lo, hi = spans.get(cha, (t0, t1))
                spans[cha] = (min(lo, t0), max(hi, t1))

    proc_mod.apply_operation = timed(real[0], None)
    Client.get_waveforms = timed(real[1], "read")
    Client.get_processed_waveforms = fetch
    _window.merge_window = timed(real[3], "window merge")
    try:
        yield acc
    finally:
        (proc_mod.apply_operation, Client.get_waveforms,
         Client.get_processed_waveforms, _window.merge_window) = real
        acc.update({(cha, "wall"): hi - lo
                    for cha, (lo, hi) in spans.items()})


def stage_report(acc):
    """``chain_stages``' seconds as text, per channel: the whole fetch
    summed over the threads and the threads' wall, then its parts in
    falling order (an operation that runs twice in a chain is summed;
    the window merge is a part of the read), and the channels the chain
    fetched and ran on."""
    parts = []
    for cha in sorted({c for c, _ in acc}):
        mine = {op: v for (c, op), v in acc.items() if c == cha}
        total = mine.pop("fetch", 0.0)
        wall = mine.pop("wall", 0.0)
        rest = total - sum(v for op, v in mine.items()
                           if op != "window merge")
        parts.append(
            f"{cha} fetch {total:.2f} s in {wall:.2f} s of the fetch "
            f"threads' wall = " + ", ".join(
                f"{op} {v:.2f}" for op, v in sorted(
                    mine.items(), key=lambda kv: -kv[1]))
            + f", other {rest:.2f}; fetched "
            f"{sorted(acc.fetched.get(cha, ()))}, ran on "
            f"{sorted(acc.ran_on.get(cha, ()))}")
    return "; ".join(parts)


def check_unread_z(stages, label):
    """The BHR chain fetched BHZ and ran no operation on it."""
    check("BHZ" in stages.fetched.get("BHR", ()),
          f"{label}: BHZ not fetched ({stages.fetched})")
    check("BHZ" not in stages.ran_on.get("BHR", ()),
          f"{label}: the BHR chain ran on {sorted(stages.ran_on['BHR'])}")


@contextlib.contextmanager
def window_arrays():
    """Where each array that the host chain's forms took inside a chain
    came from while it runs (``stream/_steps.py``: ``buffer``, which the
    window merge's ``window_array`` and ``deconvolve``'s inverse call,
    and ``scratch``, ``deconvolve``'s spectrum): an array the thread kept
    (``"thread"``) or a fresh one (``"fresh"``). Yields the list of
    (thread, key, bytes, how, pool) it fills, a thread being a number of
    its own (an ended thread's ident may go to a new thread, which keeps
    nothing yet), a key ``_steps``' own (shape, dtype and the array's
    rank among the chain's of that shape and dtype, or ``"scratch"``) and
    ``pool`` whether the thread is one of the host engine's fetch pool
    (``core/process.py``; the CLI's preprocess check runs its chains on
    threads of its own); the wrappers keep no reference to the arrays
    once they return."""
    from xcorr_tpu_torch.stream import _steps
    real, seen, lock = (_steps.buffer, _steps.scratch), [], threading.Lock()
    local, numbers = threading.local(), itertools.count()

    def kept_ids():
        kept = getattr(_steps._local, "kept", None) or {}
        return {id(a) for a in kept.values()}

    def record(key, out, mine):
        pool = threading.current_thread().name.startswith("xcorr-fetch")
        with lock:
            if not hasattr(local, "number"):
                local.number = next(numbers)
            seen.append((local.number, key, out.nbytes,
                         "thread" if id(out) in mine else "fresh", pool))

    def buffer(shape, dtype):
        mine = kept_ids()
        out = real[0](shape, dtype)
        keys = getattr(_steps._local, "keys", None)
        if keys is not None:
            record(keys[-1], out, mine)
        return out

    @contextlib.contextmanager
    def scratch(shape, dtype):
        mine = kept_ids()
        with real[1](shape, dtype) as out:
            if getattr(_steps._local, "taken", None) is not None:
                record((tuple(shape), np.dtype(dtype).str, "scratch"), out,
                       mine)
            yield out

    _steps.buffer, _steps.scratch = buffer, scratch
    try:
        yield seen
    finally:
        _steps.buffer, _steps.scratch = real


def window_array_report(seen):
    """``window_arrays``' record as text, per key in falling size, and
    the most fresh arrays one thread took of one key; the threads that
    took arrays, and what they keep if each kept one array per key it
    took (the bytes of each thread's keys, summed)."""
    parts, most, held = [], 0, {}
    keys = sorted({(b, k) for _, k, b, _, _ in seen},
                  key=lambda bk: (-bk[0], str(bk[1])))
    for nbytes, key in keys:
        rows = [(t, how) for t, k, b, how, _ in seen
                if k == key and b == nbytes]
        fresh = {}
        for t, how in rows:
            fresh[t] = fresh.get(t, 0) + (how == "fresh")
            held[t] = held.get(t, 0)
        for t in fresh:
            held[t] += nbytes
        most = max(most, max(fresh.values()))
        rank = "scratch" if key[2] == "scratch" else f"#{key[2]}"
        parts.append(
            f"{len(rows)} of {nbytes / 1e6:.1f} MB ({key[1]} {rank}) in "
            f"{len(fresh)} threads: "
            + ", ".join(f"{sum(h == how for _, h in rows)} {label}"
                        for how, label in (
                            ("thread", "kept by the thread"),
                            ("fresh", "fresh")))
            + f" (at most {max(fresh.values())} fresh per thread)")
    if not parts:
        return "no array taken in a chain", 0
    per = sorted(held.values())
    pool = len({t for t, _, _, _, p in seen if p})
    return ("; ".join(parts) + f"; {len(held)} threads took arrays "
            f"({pool} of the fetch pool), one per key "
            f"{per[0] / 1e6:.1f}-{per[-1] / 1e6:.1f} MB a thread, "
            f"{sum(per) / 1e9:.2f} GB in all"), most


def pool_fresh(seen):
    """The fresh arrays that the fetch pool's threads took in
    ``window_arrays``' record, by size, and the pool threads that took
    any."""
    out = {}
    for _, _, b, how, pool in seen:
        if pool and how == "fresh":
            out[b] = out.get(b, 0) + 1
    return out, len({t for t, _, _, _, p in seen if p})


def pool_threads():
    """The threads of the host engine's fetch pool (``core/process.py``),
    0 where there is none."""
    from xcorr_tpu_torch.core.process import _POOL
    return len(_POOL._threads) if _POOL is not None else 0


@contextlib.contextmanager
def peak_rss(every=0.02):
    """This process's resident set while it runs: at its start and the
    largest of samples every ``every`` s (``VmRSS`` of
    ``/proc/self/status``, bytes). Yields the dict it fills (``start``,
    ``peak``; None where the file is missing)."""
    def rss():
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) * 1024
        except OSError:
            return None

    out = {"start": rss(), "peak": rss()}
    done = threading.Event()

    def sample():
        while not done.wait(every):
            now = rss()
            if now is not None and now > (out["peak"] or 0):
                out["peak"] = now

    watcher = threading.Thread(target=sample, daemon=True)
    watcher.start()
    try:
        yield out
    finally:
        done.set()
        watcher.join()


@contextlib.contextmanager
def plain_host_path(lanczos=True):
    """The host fetch's carried forms while it runs, its plain path: the
    copying read of an archive's window (``stream/_window.py``
    ``_read_window_plain``: each day file copied out of the cache, merged
    over their union, then trimmed), the inverse response evaluated anew
    for every window and component (``stream/_response.py``
    ``_inverse_response_plain``), the chain over every fetched component
    (``stream/_live.py`` ``_drop_unread_plain``), the steps' carried
    expressions (``stream/_steps.py``: each form's ``_<name>_plain``,
    among them scipy's ``sosfilt`` loop for the native one and a fresh
    array for each window's merge in place of the thread's buffer, and
    ``remove_response``'s carried expressions), a fetch pool per
    ``process`` call and the client's pair fetch, uncached
    (``core/process.py`` ``_fetch_all_plain``, ``_pair_windows_plain``)
    and, with ``lanczos``, the carried numpy Lanczos loop
    (``stream/trace.py`` ``_lanczos_interp``)."""
    from xcorr_tpu_torch.stream import _live, _response, _steps, _window
    from xcorr_tpu_torch.stream import client as client_mod
    from xcorr_tpu_torch.stream import trace as trace_mod
    process_mod = importlib.import_module("xcorr_tpu_torch.core.process")
    real = (client_mod.read_window, _response.inverse_response,
            trace_mod.lanczos_interp, client_mod.drop_unread,
            process_mod.fetch_all, process_mod.pair_windows)
    forms = {name: getattr(_steps, name) for name in _steps.FORMS}
    process_mod.fetch_all = process_mod._fetch_all_plain
    process_mod.pair_windows = process_mod._pair_windows_plain
    client_mod.read_window = _window._read_window_plain
    _response.inverse_response = _response._inverse_response_plain
    client_mod.drop_unread = _live._drop_unread_plain
    for name in _steps.FORMS:
        setattr(_steps, name, getattr(_steps, f"_{name}_plain"))
    if lanczos:
        trace_mod.lanczos_interp = trace_mod._lanczos_interp
    try:
        yield
    finally:
        (client_mod.read_window, _response.inverse_response,
         trace_mod.lanczos_interp, client_mod.drop_unread,
         process_mod.fetch_all, process_mod.pair_windows) = real
        for name, form in forms.items():
            setattr(_steps, name, form)


BHZ_PAIR = "IM.H03S1..EDH-IU.RAR.10.BHZ"


def bhz_pair_day(xt, ff, edh_resp, paz):
    """One BHZ-EDH pair-day through the device engine and the host engine
    on the card: the EDH side raw at 250 Hz, the BHZ side raw at 40 Hz
    with ``paz`` through the production BHZ chain (``remove_response`` in
    float32 on the card). The synthetic source trains of the two raw rates
    are not aligned, so the CCFs are noise: the check is the two engines'
    agreement."""
    from xcorr_tpu_torch.parallel.engine import device_process_bulk
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient

    class ClientByChannel(SyntheticClient):
        """SyntheticClient with the BHZ channels raw at 40 Hz."""

        def __init__(self, **kw):
            super().__init__(sampling_rate=RAW_FS, **kw)
            self.bhz = SyntheticClient(sampling_rate=40.0, **kw)

        def _synthesize_day(self, receiver, date):
            if receiver.endswith(".BHZ"):
                return self.bhz._synthesize_day(receiver, date)
            return super()._synthesize_day(receiver, date)

    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8,
                response=edh_resp),
        Channel("IU", "RAR", "10", "BHZ", latitude=-21.2,
                longitude=-159.8, response=paz)])
    client = ClientByChannel(delays={"IM.H03S1..EDH": DELAY},
                             source_period=600.0, source_amplitude=20.0)
    chains = default_config()[0]["preprocess"]

    def dataset():
        return xt.init(pair=BHZ_PAIR, starttime="2014-02-01",
                       endtime="2014-02-02",
                       preprocess={"EDH": chains["EDH"],
                                   "BHZ": chains["BHZ"]},
                       attrs={"institution": "smoke", "author": "smoke",
                              "source": "SyntheticClient"},
                       sampling_rate=FS, window_length=WINDOW,
                       window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                       inventory=inv)

    dev = dataset()
    ff.reset_launches()
    t0 = time.perf_counter()
    finalize, fallback = device_process_bulk([dev], client, inventory=inv,
                                             verb=0, device="cuda")
    finalize()
    torch.cuda.synchronize()
    dev_wall = time.perf_counter() - t0
    check(not fallback, f"BHZ-EDH: device engine fell back: {fallback}")
    check(ff.launches["fused_corr"] == 1, f"BHZ-EDH: {ff.launches}")
    from xcorr_tpu_torch.core.process import shutdown_fetch_pool
    from xcorr_tpu_torch.stream import _response
    host = dataset()
    _response.RESPONSES.clear()
    shutdown_fetch_pool()
    with chain_stages() as stages, window_arrays() as arrays:
        t0 = time.perf_counter()
        xt.process(host, client, inventory=inv, device="cuda", verb=0)
        torch.cuda.synchronize()
        host_wall = time.perf_counter() - t0
    arrays, most = window_array_report(arrays)
    check(most <= 1, f"BHZ-EDH: a fetch thread took {most} fresh arrays "
                     f"of one key: {arrays}")
    threads = pool_threads()
    shutdown_fetch_pool()
    # the same pair-day on the plain path
    plain = dataset()
    with plain_host_path(), chain_stages() as plain_stages:
        t0 = time.perf_counter()
        xt.process(plain, client, inventory=inv, device="cuda", verb=0)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    for name, d in (("device", dev), ("host", host), ("plain", plain)):
        check(bool((d["status"].values == 1).all()),
              f"BHZ-EDH {name} engine status {d['status'].values.tolist()}")
        check(bool(np.isfinite(d["cc"].values).all()),
              f"BHZ-EDH {name} engine: non-finite CCF")
    a, b = dev["cc"].values, host["cc"].values
    diff = float(np.abs(a - b).max())
    same = np.array_equal(host["cc"].values, plain["cc"].values)
    phase(6, f"BHZ-EDH pair-day {BHZ_PAIR} (BHZ 40 Hz raw, PAZ, the "
             f"production BHZ chain): device engine {dev_wall:.2f} s, host "
             f"engine {host_wall:.2f} s, host engine on the plain path "
             f"(the copying read, the uncached inverse response, the "
             f"carried numpy Lanczos loop) {plain_wall:.2f} s; host "
             f"engine CCFs bit-identical to the plain path's: {same}; max "
             f"|CCF diff| device vs host {diff:.3e} (bar {CCF_ATOL}), max "
             f"|CCF| {float(np.abs(b).max()):.3e}, rms diff "
             f"{float(np.sqrt(np.mean((a - b) ** 2))):.3e}")
    phase(6, f"BHZ-EDH host engine by chain stage, s summed over its fetch "
             f"threads: {stage_report(stages)}")
    phase(6, f"BHZ-EDH host engine's arrays (a fetch pool of {threads} "
             f"threads): {arrays}")
    phase(6, f"BHZ-EDH host engine on the plain path by chain stage: "
             f"{stage_report(plain_stages)}")
    check(same, "BHZ-EDH: the host engine's CCFs differ from the plain "
                "path's")
    check(diff <= CCF_ATOL, f"BHZ-EDH: device engine vs host engine "
                            f"{diff} > {CCF_ATOL}")


def peak_lag(a, b):
    """Lag (s) of the peak of the full cross-correlation of two 50 Hz
    chain outputs, over their common length."""
    n = min(a.size, b.size)
    c = np.fft.irfft(np.fft.rfft(a[:n], 2 * n)
                     * np.conj(np.fft.rfft(b[:n], 2 * n)))
    k = int(np.argmax(c))
    return (k if k < n else k - 2 * n) / FS


BHR_PAIR = "IM.H03S1..EDH-IU.RAR.10.BHR"
#: the back azimuth of the production BHR chain's NE->RT rotation
#: (xcorr_tpu/scripts/cc.py:66)
BHR_BAZ = 250.39


def bhr_fallback(xt, ff, edh_resp, paz):
    """One BHR-EDH pair-day, ``IM.H03S1..EDH-IU.RAR.10.BHR``, through the
    production BHR chain (``xcorr_tpu/scripts/cc.py:61-76``: response
    removed, ``->ZNE`` and ``NE->RT`` rotations, ``select``, filters and
    the Lanczos 40 -> 50 Hz interpolation), in one ``device_process_bulk``
    call with an EDH-EDH pair-day of ``PAIR``. The rotations have no
    device stage, so the BHR pair-day must come back on the fallback list
    while the EDH-EDH one runs on the device engine (K1 once); then the
    fallback runs through ``process(..., device="cuda")`` as the device
    engine's batch driver runs it (``core/lazy.py``: ``_device_bulk_run``).
    It runs once more on the plain path of the read and the response
    (``plain_host_path(lanczos=False)``), whose CCFs must be the same
    bits.
    The data: every receiver gets its own noise and one source train,
    placed in seconds, so raw rates of 250 Hz (EDH) and 40 Hz (BH1, BH2,
    BHZ) carry the same arrivals; the horizontals carry the source as the
    radial component of ``BHR_BAZ``. The EDH-EDH pair-day peaks at the
    delay injected on ``IM.H03S1..EDH``; the BHR-EDH one at that delay
    plus the lag between the two production chains, which the EDH
    chain's causal anti-alias filter of its decimation (the reference's,
    as in obspy) sets: measured here on the host by running both chains
    on the same arrivals without noise."""
    import zlib
    from xcorr_tpu_torch.parallel.engine import device_process_bulk
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.stream import (Channel, Inventory, Stats, Stream,
                                        SyntheticClient, Trace)
    from xcorr_tpu_torch.stream.process import process as run_chain

    baz = math.radians(BHR_BAZ)
    gain = {"1": -math.cos(baz), "2": -math.sin(baz), "Z": 0.0}

    class ArrivalClient(SyntheticClient):
        """Noise plus a shared Ricker train, rate by channel."""

        def _synthesize_day(self, receiver, date):
            date = pd.Timestamp(date).normalize()
            net, sta, loc, cha = receiver.split(".")
            fs = 40.0 if cha.startswith("BH") else RAW_FS
            day = date.strftime("%Y%j")
            rng = np.random.default_rng(zlib.crc32(f"{receiver}{day}"
                                                   .encode()))
            data = (self.noise_amplitude * rng.standard_normal(
                int(86400 * fs))).astype(np.float32)
            onsets = np.random.default_rng(zlib.crc32(day.encode())) \
                .uniform(60.0, 540.0, 144) + 600.0 * np.arange(144)
            weight = 1.0 if cha == "EDH" else gain[cha[-1]]
            for t0 in onsets + self._delay_of(receiver):
                i = np.arange(int((t0 - 1.0) * fs), int((t0 + 1.0) * fs))
                a = (np.pi * 4.0 * (i / fs - t0)) ** 2
                data[i] += weight * 20.0 * (1 - 2 * a) * np.exp(-a)
            stats = Stats(network=net, station=sta, location=loc,
                          channel=cha, starttime=date, sampling_rate=fs)
            return Stream([Trace(data, stats)])

    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8,
                response=edh_resp),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9,
                response=edh_resp)] + [
        Channel("IU", "RAR", "10", cha, latitude=-21.2, longitude=-159.8,
                response=paz) for cha in ("BHR", "BH1", "BH2", "BHZ")])
    client = ArrivalClient(delays={"IM.H03S1..EDH": DELAY})
    chains = default_config()[0]["preprocess"]

    def dataset(pair):
        return xt.init(pair=pair, starttime="2014-02-01",
                       endtime="2014-02-02",
                       preprocess={k: chains[k] for k in ("EDH", "BHR")},
                       attrs={"institution": "smoke", "author": "smoke",
                              "source": "seeded generator"},
                       sampling_rate=FS, window_length=WINDOW,
                       window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                       inventory=inv)

    def chain_lag(hours=4):
        """Lag (s) of the CCF peak of the EDH and BHR chains' outputs for
        the same noise-free arrivals, the first `hours` of a day."""
        quiet = ArrivalClient(noise_amplitude=0.0)

        def chain(cha, receivers):
            traces = [quiet._synthesize_day(r, "2014-02-01")[0]
                      for r in receivers]
            for tr in traces:
                tr.data = tr.data[:int(hours * 3600
                                       * tr.stats.sampling_rate)]
                tr.stats.npts = tr.data.size
            ops = [o for o in chains[cha] if o[0] not in ("merge", "trim")]
            out = run_chain(Stream(traces), ops, inventory=inv)
            return out.select(channel=cha)[0].data

        return peak_lag(chain("EDH", ["IM.H03S1..EDH"]),
                        chain("BHR", [f"IU.RAR.10.BH{c}" for c in "12Z"]))

    def held(d, label, want):
        status = d["status"].values
        check(bool((status == 1).all()), f"{label}: status "
                                         f"{status.tolist()}")
        ccv = d["cc"].values
        check(bool(np.isfinite(ccv).all()), f"{label}: non-finite CCF")
        lag = d.coords["lag"].values
        peaks = [float(lag[int(np.argmax(ccv[0, i]))])
                 for i in range(ccv.shape[1])]
        check(all(abs(p - want) < 1.0 / FS + 1e-9 for p in peaks),
              f"{label}: CCF peaks {peaks} s, expected {want} s")
        return sorted(set(peaks))

    edh, bhr = dataset(PAIR), dataset(BHR_PAIR)
    ff.reset_launches()
    t0 = time.perf_counter()
    finalize, fallback = device_process_bulk([edh, bhr], client,
                                             inventory=inv, verb=0,
                                             device="cuda")
    finalize()
    torch.cuda.synchronize()
    dev_wall = time.perf_counter() - t0
    check(len(fallback) == 1 and fallback[0] is bhr,
          f"fallback list {[d.pair.values.tolist() for d in fallback]}, "
          f"expected the BHR pair-day alone")
    counts = dict(ff.launches)
    check(counts["fused_corr"] == 1 and sum(counts.values()) == 1,
          f"EDH-EDH pair-day beside BHR launched {counts}")
    edh_peaks = held(edh, "EDH-EDH beside BHR (device engine)", DELAY)
    check(bool((bhr["status"].values == 0).all()),
          "the device engine touched the BHR pair-day")
    from xcorr_tpu_torch.core.process import shutdown_fetch_pool
    from xcorr_tpu_torch.stream import _response
    _response.RESPONSES.clear()
    shutdown_fetch_pool()
    with chain_stages() as stages, window_arrays() as arrays:
        t0 = time.perf_counter()
        xt.process(bhr, client=client, inventory=inv, retry_missing=True,
                   verb=0, device="cuda")
        torch.cuda.synchronize()
        host_wall = time.perf_counter() - t0
    arrays, most = window_array_report(arrays)
    check(most <= 1, f"BHR fallback: a fetch thread took {most} fresh "
                     f"arrays of one key: {arrays}")
    threads = pool_threads()
    shutdown_fetch_pool()
    # the same pair-day on the plain path of the read and the response
    plain = dataset(BHR_PAIR)
    with plain_host_path(lanczos=False), chain_stages() as plain_stages:
        t0 = time.perf_counter()
        xt.process(plain, client=client, inventory=inv, verb=0,
                   device="cuda")
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    same = bhr["cc"].values.tobytes() == plain["cc"].values.tobytes()
    check(same, "BHR-EDH: the host engine's CCFs differ from the plain "
                "path's")
    check_unread_z(stages, "BHR fallback")
    check("BHZ" in plain_stages.ran_on.get("BHR", ()),
          "BHR fallback: the plain path ran no step on BHZ")
    lag = chain_lag()
    bhr_peaks = held(bhr, "BHR-EDH fallback (host engine)", DELAY + lag)
    phase(6, f"BHR fallback: one device_process_bulk call of {PAIR} and "
             f"{BHR_PAIR} (BH1/BH2/BHZ raw at 40 Hz, PAZ, the production "
             f"BHR chain): {dev_wall:.2f} s, fallback list [{BHR_PAIR}], "
             f"EDH-EDH on the device engine (launches {counts}), status "
             f"1, peaks at {edh_peaks} s; the fallback through process("
             f"device='cuda') {host_wall:.2f} s, status 1 on all "
             f"{bhr.dims['time']} windows, peaks at {bhr_peaks} s "
             f"(injected {DELAY} s, plus {lag:.2f} s between the EDH and "
             f"BHR chains for noise-free arrivals)")
    phase(6, f"BHR fallback by chain stage, s summed over its fetch "
             f"threads: {stage_report(stages)}")
    phase(6, f"BHR fallback's arrays (a fetch pool of {threads} threads): "
             f"{arrays}")
    phase(6, f"BHR-EDH host engine on the plain path of the read and the "
             f"response (the copying read, the uncached inverse response; "
             f"the native Lanczos step) {plain_wall:.2f} s, CCFs "
             f"bit-identical to the fallback's: {same}; by chain stage: "
             f"{stage_report(plain_stages)}")


#: the analysis scripts' postprocess filter and celerity window
HIGHPASS = {"frequency": 3.0, "btype": "highpass", "order": 2}
CELERITY = (1460.0, 1500.0)
P7_TOL = 1e-5            # card vs CPU: relative, or of the peak
ANALYSIS_ATTRS = {"institution": "smoke", "author": "smoke",
                  "source": "seeded generator"}


def device_profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


#: the host-side records of the CUDA runtime's and driver's calls that put
#: an operation on the card
LAUNCH_CALL = re.compile(
    r"^cuda?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")


def device_ops(prof):
    """(device ms, kernels, copies, launched, missing) of a profiled run:
    the card's own records of the session; the operations the call put on
    the card, as the session's host-side records of the runtime's and
    driver's launch, copy and set calls count them; and how many more
    such calls than device records there are. A session with a missing
    record lost device events (the card's torch 2.11 profiler does in a
    long process): its device ms and share are not to be read
    (``share_text``)."""
    from torch.autograd import DeviceType
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    launched = sum(e.device_type == DeviceType.CPU
                   and LAUNCH_CALL.match(e.name) is not None
                   for e in events)
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
    return (sum(e.time_range.elapsed_us() for e in dev) / 1e3,
            len(dev) - copies, copies, launched,
            max(launched - len(dev), 0))


def share_text(dev_ms, wall, lost):
    """A device share as printed: ``lost`` where a session lost device
    events (``device_ops``), never the low number such a session gives."""
    if lost:
        return (f"lost ({lost} profiler sessions saw fewer device "
                f"operations than their calls launched)")
    return f"{dev_ms / 1e3 / wall:.4f}" if dev_ms > 0 else "not measured"


def timed(fn):
    """``(fn(), wall seconds)``, the device synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_err(got, want, peak=False):
    """max |got - want| over max |want| (``peak``), else elementwise
    relative."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if peak:
        return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))
    return float(np.nanmax(np.abs(got - want) / np.abs(want)))


def hold_snr(got, want, label):
    """An SNR dataset on the card against the CPU's; returns the worst
    relative error."""
    err = max(rel_err(got[k].values, want[k].values) for k in
              ("snr", "s", "n"))
    check(err <= P7_TOL, f"{label}: snr/s/n relative error {err}")
    check(np.array_equal(got["lag_s_max"].values, want["lag_s_max"].values),
          f"{label}: lag_s_max differs")
    return err


def stage_ms(cc, delay):
    """``[(stage, ms)]``: the warm wall on the card of each stage of
    postprocess's chain after its selection, each stage fed the previous
    one's output, and of the envelope that ``snr`` takes of the result.
    Each wall holds the stage's host work and its copies."""
    stages = [
        ("unbias", lambda x: x.signal.unbias()),
        ("demean", lambda x: x.signal.demean(device="cuda")),
        ("taper 5 s", lambda x: x.signal.taper(max_length=5.0)),
        ("timeshift", lambda x: x.signal.timeshift(
            delay=delay, dim="lag", fast=True, device="cuda")),
        ("filter", lambda x: x.signal.filter(**HIGHPASS, device="cuda")),
        ("taper 1.5 s", lambda x: x.signal.taper(max_length=1.5)),
        ("hilbert (snr)", lambda x: x.signal.hilbert(device="cuda")),
    ]
    ms = []
    for name, fn in stages:
        y, t = timed(lambda: fn(cc))
        ms.append((name, 1e3 * t))
        if name != "hilbert (snr)":
            cc = y
    return ms


@contextlib.contextmanager
def plain_postprocess():
    """``postprocess``'s carried host stages while it runs, its plain
    path: the selection over whole variables (``core/postprocess.py``
    ``_select_plain``: ``Dataset.where`` of ``cc`` whole, then
    ``cc.where`` of the lags) and ``unbias``'s weights over the whole lag
    range (``signal/_unbias.py`` ``_span_weights_plain``)."""
    from xcorr_tpu_torch.signal import _unbias
    post = importlib.import_module("xcorr_tpu_torch.core.postprocess")
    unbias = importlib.import_module("xcorr_tpu_torch.signal.unbias")
    real = {name: getattr(post, name) for name in post.FORMS}
    weights = unbias.span_weights
    for name in post.FORMS:
        setattr(post, name, getattr(post, f"_{name}_plain"))
    unbias.span_weights = _unbias._span_weights_plain
    try:
        yield
    finally:
        for name, form in real.items():
            setattr(post, name, form)
        unbias.span_weights = weights


def same_value(a, b):
    """``a`` and ``b`` equal bit for bit: arrays by dtype, shape and
    bytes (NaN by its bits), containers item by item in order."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (type(a) is type(b) and list(a) == list(b)
                and all(same_value(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_value(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape):
            return False
        if a.dtype == object:
            return a.tolist() == b.tolist()
        return (np.ascontiguousarray(a).tobytes()
                == np.ascontiguousarray(b).tobytes())
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return type(a) is type(b) and a == b


def dataset_differences(a, b):
    """Where two postprocessed datasets differ (empty where they are
    equal): the order of coordinates and variables, the attrs and
    encoding, and each array's name, dims, dtype, bytes, attrs and
    coordinates; ``cc``'s ``postprocess`` timestamp aside."""
    out = []

    def array(key, x, y, skip=()):
        if x.name != y.name or x.dims != y.dims:
            out.append(f"{key} name or dims")
        if not same_value(x.data, y.data):
            out.append(f"{key} data")
        if not same_value({k: v for k, v in x.attrs.items() if k not in skip},
                          {k: v for k, v in y.attrs.items() if k not in skip}):
            out.append(f"{key} attrs")
        if list(x._coords) != list(y._coords):
            out.append(f"{key} coordinates")
        for k in x._coords:
            if k in y._coords:
                array(f"{key}.{k}", x._coords[k], y._coords[k])

    if list(a._coords) != list(b._coords) or list(a._vars) != list(b._vars):
        return ["coordinates or variables"]
    if not same_value(a.attrs, b.attrs) or \
            not same_value(a.encoding, b.encoding):
        out.append("attrs or encoding")
    for k in a._coords:
        array(f"coord {k}", a._coords[k], b._coords[k])
    for k in a._vars:
        array(f"var {k}", a._vars[k], b._vars[k],
              ("postprocess",) if k == "cc" else ())
    return out


#: ``postprocess`` on the card's path, held to its plain forms: the label
#: that calls are recorded under (None: not recorded), the calls recorded
#: and not yet run again, and per label the calls held and their pair-days
TWICE = {"label": None, "pending": [], "held": {}, "real": None}
#: every module that binds ``postprocess`` for the scripts to call
TWICE_MODULES = ("xcorr_tpu_torch", "xcorr_tpu_torch.core",
                 "xcorr_tpu_torch.core.postprocess",
                 "xcorr_tpu_torch.scripts.snr", "xcorr_tpu_torch.scripts.psd",
                 "xcorr_tpu_torch.scripts.beamform",
                 "xcorr_tpu_torch.scripts.plmax",
                 "xcorr_tpu_torch.scripts.swresp",
                 "xcorr_tpu_torch.scripts.timelapse")


@contextlib.contextmanager
def postprocess_twice():
    """While it runs, each ``postprocess`` call on the card (``device``
    cuda) made under a label (:func:`held_twice`), by any name the
    scripts call it, records its arguments and a deep copy of its result
    (or its error): :func:`flush_twice` runs it again on the plain forms,
    outside the timed and profiled sections, and holds the two equal."""
    mods = [importlib.import_module(m) for m in TWICE_MODULES]
    real = importlib.import_module(
        "xcorr_tpu_torch.core.postprocess").postprocess
    sig = inspect.signature(real)

    def spy(*args, **kwargs):
        bound = sig.bind(*args, **kwargs).arguments
        if TWICE["label"] is None or \
                not str(bound.get("device", "cuda")).startswith("cuda"):
            return real(*args, **kwargs)
        try:
            out = real(*args, **kwargs)
        except ValueError as e:
            TWICE["pending"].append((TWICE["label"], args, kwargs, e))
            raise
        if out is not bound["ds"]:  # not one postprocessed before
            TWICE["pending"].append((TWICE["label"], args, kwargs,
                                     out.copy(deep=True)))
        return out

    TWICE["real"] = real
    for m in mods:
        m.postprocess = spy
    try:
        yield
    finally:
        for m in mods:
            m.postprocess = real
        TWICE["pending"].clear()


@contextlib.contextmanager
def held_twice(label):
    """Record the card's ``postprocess`` calls under ``label`` while it
    runs (:func:`postprocess_twice`)."""
    prev, TWICE["label"] = TWICE["label"], label
    try:
        yield
    finally:
        TWICE["label"] = prev


def flush_twice():
    """Run every recorded ``postprocess`` call again on the plain forms
    and hold its result (or its error) to the port forms' bit for bit."""
    pending, TWICE["pending"] = TWICE["pending"], []
    real = TWICE["real"]
    with plain_postprocess():
        for label, args, kwargs, want in pending:
            try:
                got = real(*args, **kwargs)
            except ValueError as e:
                check(isinstance(want, ValueError) and str(e) == str(want),
                      f"{label}: postprocess raised {e!r} on the plain "
                      f"forms, {want!r} on the port forms")
                got = None
            else:
                check(not isinstance(want, ValueError),
                      f"{label}: postprocess raised {want!r} on the port "
                      f"forms and not on the plain forms")
                diff = dataset_differences(want, got)
                check(not diff, f"{label}: postprocess on the port forms "
                                f"and on the plain forms differ in {diff}")
            held = TWICE["held"].setdefault(label, [0, 0])
            held[0] += 1
            held[1] += 0 if got is None else got.dims["pair"]


def twice_text(*labels):
    """The calls each label held to the plain forms, as printed."""
    parts = []
    for label in labels:
        n, pairs = TWICE["held"].get(label, (0, 0))
        check(n > 0, f"{label}: no postprocess call held to the plain forms")
        parts.append(f"{label} {n} calls ({pairs} pair-days)")
    return ("postprocess on the card, port forms (select, span_weights) "
            "against the plain forms (_select_plain, _span_weights_plain) "
            "on the same inputs, bit-identical: " + ", ".join(parts))


def phase7a_full_width(xt, dss, ndays):
    """``postprocess`` and ``snr`` of phase 6's pair-days at full lag
    width on the card, against the CPU; ms per pair-day by stage."""
    from xcorr_tpu_torch import ndlabel
    from xcorr_tpu_torch.signal import snr
    ds = ndlabel.combine_by_coords(dss)
    shape = ds["cc"].shape
    kw = {"lag_lim": CLIP_LAG, "filter_kwargs": HIGHPASS}

    def run(device):
        post = xt.postprocess(ds, device=device, **kw)
        lag = post.coords["lag"]
        sn = snr(post["cc"], (lag >= DELAY - 1.0) & (lag <= DELAY + 1.0),
                 (lag >= 6 * 3600.0) & (lag <= 9 * 3600.0), dim="lag",
                 extend=True, envelope=True, device=device,
                 **ANALYSIS_ATTRS)
        return post, sn

    (post, sn), card = timed(lambda: run("cuda"))
    (post_c, sn_c), cpu = timed(lambda: run("cpu"))
    want = post_c["cc"].values
    check(post["cc"].shape == want.shape == shape,
          f"postprocessed shape {post['cc'].shape}, {want.shape}, {shape}")
    check(bool(np.isfinite(post["cc"].values).all()), "non-finite cc")
    cc_err = rel_err(post["cc"].values, want, peak=True)
    check(cc_err <= P7_TOL, f"7a: postprocessed cc {cc_err} of the peak")
    snr_err = hold_snr(sn, sn_c, "7a")
    lag_max = np.unique(sn["lag_s_max"].values)
    ms = stage_ms(ds["cc"], -(ds["pair_offset"] + ds["time_offset"]))
    # postprocess alone on the port forms, then on the plain forms
    port, t_port = timed(lambda: xt.postprocess(ds, device="cuda", **kw))
    with plain_postprocess():
        plain, t_plain = timed(lambda: xt.postprocess(ds, device="cuda",
                                                      **kw))
    diff = dataset_differences(post, plain) + dataset_differences(port, plain)
    check(not diff, f"7a: postprocess on the port forms and on the plain "
                    f"forms differ in {diff}")
    phase(7, f"7a full width, {ndays} pair-days, cc {shape} float32: "
             f"postprocess + snr card {card:.2f} s ({card / ndays:.3f} s "
             f"per pair-day), CPU {cpu:.2f} s ({cpu / ndays:.3f}); card vs "
             f"CPU: cc {cc_err:.2e} of the peak, snr/s/n {snr_err:.2e} "
             f"relative, lag_s_max equal ({lag_max.tolist()} s)")
    phase(7, "7a card ms per pair-day by stage (warm): " + "; ".join(
        f"{name} {t / ndays:.1f}" for name, t in ms))
    phase(7, f"7a postprocess alone on the card (warm), ms per pair-day: "
             f"port forms {1e3 * t_port / ndays:.1f}, plain forms "
             f"{1e3 * t_plain / ndays:.1f}; the first run's result and "
             f"the port forms' rerun bit-identical to the plain forms' "
             f"(all {ndays} pair-days)")


#: days of the campaign: enough for both EVENTS; the script's time limit
#: bounds the rest
CAMPAIGN_DAYS = 5
CAMPAIGN_START = pd.Timestamp("2014-03-01")
NOISE = 1e-3
#: (campaign day, first window, last window) of the strong arrivals
EVENTS = [(1, 1, 6), (4, 2, 5)]


def campaign_day(xt, init_args, pairs, dists, offsets, iday, which=None):
    """One day's CCF datasets of the production pairs, one per pair (or
    per index of ``which``): seeded noise plus one 8 Hz Ricker arrival at
    distance / 1480 m/s + the pair's ``offsets`` (s) per window, 40 times
    the noise on the windows of ``EVENTS`` and twice it elsewhere; status
    1, seeded sub-sample time offsets. Each pair-day has its own seed."""
    day = CAMPAIGN_START + pd.Timedelta(days=iday)
    t = (np.arange(50) - 25) / FS
    a = (np.pi * 8.0 * t) ** 2
    wavelet = ((1 - 2 * a) * np.exp(-a)).astype(np.float32)
    out = []
    for ip in range(len(pairs)) if which is None else which:
        rng = np.random.default_rng([SEED, iday, ip])
        ds = xt.init(pair=pairs[ip], starttime=day,
                     endtime=day + pd.Timedelta(days=1), **init_args)
        cc = ds["cc"].values
        rng.standard_normal(out=cc, dtype=np.float32)
        cc *= np.float32(NOISE)
        nt = cc.shape[1]
        amp = np.full(nt, 2 * NOISE, dtype=np.float32)
        for d, i0, i1 in EVENTS:
            if d == iday:
                amp[i0:i1 + 1] = 40 * NOISE
        k = int(np.searchsorted(ds.coords["lag"].values,
                                dists[ip] * 1e3 / 1480.0
                                + offsets[ip])) - 25
        cc[0, :, k:k + wavelet.size] += amp[:, None] * wavelet
        ds["status"].values[...] = 1
        ds["distance"].values[...] = dists[ip]
        ds["time_offset"].values[...] = rng.uniform(-0.01, 0.01, (1, nt))
        out.append(ds)
    return out


def campaign_split(xt, dss, pair_snr):
    """One campaign day on the card taken apart, ms per pair-day:
    ``pair_snr``; the ``postprocess`` it starts with; ``pair_snr`` of the
    postprocessed dataset, which postprocess hands back as it is, so the
    SNR alone; each stage of :func:`stage_ms` on the lag window that
    postprocess clips."""
    def run(d):
        return pair_snr(d, celerity=CELERITY, filter_kwargs=HIGHPASS,
                        attrs=ANALYSIS_ATTRS, device="cuda")

    split = {"pair_snr": 0.0, "postprocess": 0.0, "snr": 0.0}
    for d in dss:
        split["pair_snr"] += 1e3 * timed(lambda: run(d))[1]
        post, t = timed(lambda: xt.postprocess(
            d, clim=CELERITY, filter_kwargs=HIGHPASS, device="cuda"))
        split["postprocess"] += 1e3 * t
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "already postprocessed"
            split["snr"] += 1e3 * timed(lambda: run(post))[1]
        lag, kept = d.coords["lag"], post.coords["lag"].values
        clipped = d["cc"].where((lag >= kept[0]) & (lag <= kept[-1]),
                                drop=True)
        check(clipped.shape == post["cc"].shape,
              f"7b split: clipped {clipped.shape}, {post['cc'].shape}")
        for name, ms in stage_ms(clipped,
                                 -(d["pair_offset"] + d["time_offset"])):
            split[name] = split.get(name, 0.0) + ms
    return {k: v / len(dss) for k, v in split.items()}


#: rounds of 7b's last day on the port forms and the plain forms in turns
AB_ROUNDS = 5


def campaign_ab(dss, pair_snr, rounds=AB_ROUNDS):
    """``pair_snr`` of one campaign day's pair-days on the card, on the
    port forms and on the plain forms (:func:`plain_postprocess`) in
    turns, the order swapped each round, unprofiled and not recorded:
    ``{form: [ms per pair-day of each round]}``."""
    def run():
        for d in dss:
            pair_snr(d, celerity=CELERITY, filter_kwargs=HIGHPASS,
                     attrs=ANALYSIS_ATTRS, device="cuda")

    ms = {"port": [], "plain": []}
    with held_twice(None):
        for r in range(rounds):
            for form in ("port", "plain")[::1 if r % 2 == 0 else -1]:
                with (plain_postprocess() if form == "plain"
                      else contextlib.nullcontext()):
                    ms[form].append(1e3 * timed(run)[1] / len(dss))
    return ms


def campaign_geometry(pairs, inv):
    """Seeded pair distances (km) and arrival offsets (s) of the campaign:
    the Z and R pairs of one receiver share a distance, and so do the
    three array pairs, whose arrivals carry the delays of the plane wave
    ``WAVE_AZ``, ``WAVE_VEL`` across their H03S receivers, in the local
    coordinates that ``beamform_datasets`` builds."""
    from xcorr_tpu_torch.util.receiver import (get_pair_xy_coordinates,
                                               split_pair)
    dists = np.random.default_rng(SEED).uniform(5000.0, 10000.0, len(pairs))
    for iz, ir in SWRESP_PAIRS:
        dists[ir] = dists[iz]
    dists[ARRAY_PAIRS] = dists[ARRAY_PAIRS[0]]
    array = [pairs[i] for i in ARRAY_PAIRS]
    receivers, x, y = get_pair_xy_coordinates(array, inv, km=False)
    k = [receivers.index(split_pair(pair)[1]) for pair in array]
    az = np.radians(WAVE_AZ)
    offsets = np.zeros(len(pairs))
    offsets[ARRAY_PAIRS] = ((x[k] - x[k].mean()) * np.sin(az)
                            + (y[k] - y[k].mean()) * np.cos(az)) / WAVE_VEL
    return dists, offsets


def array_inventory():
    from xcorr_tpu_torch.stream import Channel, Inventory
    return Inventory([Channel(*sid.split("."), latitude=lat, longitude=lon)
                      for sid, (lat, lon) in ARRAY_STATIONS.items()])


def phase7b_campaign(xt, p8):
    """The SNR -> trigger -> PSD path over the campaign days of the 8
    production pairs at the production celerity window, card against
    CPU; on the same days, phase 8's beamform (8a), plmax (8b, first day)
    and swresp (8c), accumulated in ``p8``."""
    from xcorr_tpu_torch import ndlabel
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.scripts.psd import pair_psd
    from xcorr_tpu_torch.scripts.snr import pair_snr
    from xcorr_tpu_torch.signal import coincidence_trigger, trigger_periods
    init_args, _, pairs, _ = default_config()
    inv = array_inventory()
    dists, offsets = campaign_geometry(pairs, inv)
    p8.update(init_args=init_args, pairs=pairs, dists=dists,
              offsets=offsets, inv=inv)

    def snr_day(dss, device):
        out = [pair_snr(d, celerity=CELERITY, filter_kwargs=HIGHPASS,
                        attrs=ANALYSIS_ATTRS, device=device) for d in dss]
        check(all(o is not None for o in out), f"{device}: a pair had no "
                                               f"data after postprocess")
        return ndlabel.concat(out, "pair")

    days = {"cuda": [], "cpu": []}
    wall = {"cuda": 0.0, "cpu": 0.0}
    dev_ms, kernels, copies, err, first = 0.0, 0, 0, 0.0, None
    launched = lost = 0
    for iday in range(CAMPAIGN_DAYS):
        dss = campaign_day(xt, init_args, pairs, dists, offsets, iday)
        with held_twice("7b"), device_profile() as prof:
            card, t = timed(lambda: snr_day(dss, "cuda"))
        wall["cuda"] += t
        first = t if first is None else first
        ms, k, c, n, miss = device_ops(prof)
        dev_ms, kernels, copies = dev_ms + ms, kernels + k, copies + c
        launched, lost = launched + n, lost + (miss > 0)
        cpu, t = timed(lambda: snr_day(dss, "cpu"))
        wall["cpu"] += t
        err = max(err, hold_snr(card, cpu, f"7b day {iday}"))
        days["cuda"].append(card)
        days["cpu"].append(cpu)
        if iday == CAMPAIGN_DAYS - 1:
            with held_twice("7b split"):
                split = campaign_split(xt, dss, pair_snr)
            ab = campaign_ab(dss, pair_snr)
        t8 = time.perf_counter()
        with held_twice("8a"):
            phase8a_beamform(dss, iday, p8)
        if iday == 0:
            with held_twice("8b"):
                phase8b_plmax(xt, dss, p8)
        with held_twice("8c"):
            phase8c_swresp(xt, dss, p8)
        p8["seconds"] += time.perf_counter() - t8
        flush_twice()
        del dss
    npd = CAMPAIGN_DAYS * len(pairs)
    share = share_text(dev_ms, wall["cuda"], lost)
    phase(7, f"7b snr, {len(pairs)} pairs x {CAMPAIGN_DAYS} days = {npd} "
             f"pair-days at clim {CELERITY}: card {wall['cuda']:.2f} s "
             f"({1e3 * wall['cuda'] / npd:.1f} ms per pair-day; first day "
             f"{first:.2f} s, profiled), CPU {wall['cpu']:.2f} s "
             f"({1e3 * wall['cpu'] / npd:.1f} ms per pair-day); device "
             f"{dev_ms:.1f} ms, share {share}; device operations per "
             f"pair-day {(kernels + copies) / npd:.1f} (kernels "
             f"{kernels / npd:.1f}, copies {copies / npd:.1f}; launched "
             f"{launched / npd:.1f}); card vs "
             f"CPU snr/s/n {err:.2e} relative, lag_s_max equal")
    whole = ("pair_snr", "postprocess", "snr")
    stages = {k: v for k, v in split.items() if k not in whole}
    chain = sum(v for k, v in stages.items() if k != "hilbert (snr)")
    phase(7, f"7b day {CAMPAIGN_DAYS} taken apart on the card (warm, "
             f"unprofiled), ms per pair-day: pair_snr "
             f"{split['pair_snr']:.1f}; its postprocess "
             f"{split['postprocess']:.1f} and snr {split['snr']:.1f}; "
             f"postprocess's selection and lag clip (by difference) "
             f"{split['postprocess'] - chain:.1f}; on the clipped window "
             + "; ".join(f"{k} {v:.1f}" for k, v in stages.items()))

    def spread(v):
        return (f"median {np.median(v):.1f} (min {min(v):.1f}, max "
                f"{max(v):.1f})")
    phase(7, f"7b day {CAMPAIGN_DAYS} pair_snr on the card, port forms and "
             f"plain forms in turns ({AB_ROUNDS} rounds of "
             f"{len(pairs)} pair-days, order swapped each round), ms per "
             f"pair-day: port {spread(ab['port'])}; plain "
             f"{spread(ab['plain'])}; rounds port "
             f"{[round(v, 2) for v in ab['port']]}, plain "
             f"{[round(v, 2) for v in ab['plain']]}")

    periods = {}
    for device in ("cuda", "cpu"):
        snr_all = ndlabel.combine_by_coords(days[device])
        ct = coincidence_trigger(snr_all["snr"], thr_on=10.0, dim="time")
        periods[device] = (trigger_periods(ct) if ct.attrs["nperiods"]
                           else None, snr_all)
    want = periods["cpu"][0]
    check(want is not None and len(want) == len(EVENTS),
          f"7b: {0 if want is None else len(want)} triggered periods on the "
          f"CPU, {len(EVENTS)} designed")
    check(periods["cuda"][0] is not None
          and periods["cuda"][0].equals(want),
          f"7b: trigger periods differ: {periods['cuda'][0]} vs {want}")

    wall = {"cuda": 0.0, "cpu": 0.0}
    err, npsd, shape = 0.0, 0, None
    for _, row in want.iterrows():
        start, end = row["start"], row["end"]
        check(start.normalize() == end.normalize(),
              f"7b: period {start} - {end} spans days")
        dss = campaign_day(xt, init_args, pairs, dists, offsets,
                           (start.normalize() - CAMPAIGN_START).days)
        for ip, pair in enumerate(pairs):
            out = {}
            for device in ("cuda", "cpu"):
                with held_twice("7b psd"):
                    out[device], t = timed(lambda: pair_psd(
                        dss[ip], pair, start, end, clim=CELERITY,
                        duration=2.5, padding_factor=4,
                        filter_kwargs=HIGHPASS,
                        snr=periods[device][1]["snr"], fmax=20.0,
                        device=device))
                wall[device] += t
            check(out["cuda"] is not None and out["cpu"] is not None,
                  f"7b: no PSD for {pair}")
            g, w = out["cuda"]["psd"].values, out["cpu"]["psd"].values
            check(g.shape == w.shape and bool(np.isfinite(g).all()),
                  f"7b: PSD {g.shape} vs {w.shape}")
            err = max(err, rel_err(g, w, peak=True))
            npsd, shape = npsd + 1, g.shape
        flush_twice()
        del dss
    check(err <= P7_TOL, f"7b: PSD {err} of its max")
    spans = "; ".join(f"{r.start} - {r.end}" for r in want.itertuples())
    phase(7, f"7b psd: {len(want)} triggered periods ({spans}) "
             f"identical on card and CPU; {npsd} (pair, period) "
             f"spectrograms (last {shape}): card {wall['cuda']:.2f} s, CPU "
             f"{wall['cpu']:.2f} s; card vs CPU PSD {err:.2e} of its max")
    phase(7, "7b " + twice_text("7b", "7b split", "7b psd"))


#: the six stations of the production array pairs
#: (``xcorr_tpu/scripts/cc.py:111-113``), latitude and longitude: the IMS
#: hydrophone triads H10N, north of Ascension Island, and H03S, south of
#: the Juan Fernandez Islands, placed to about 100 m
ARRAY_STATIONS = {
    "IM.H10N1..EDH": (-7.8445, -14.4690),
    "IM.H10N2..EDH": (-7.8590, -14.4980),
    "IM.H10N3..EDH": (-7.8350, -14.4950),
    "IM.H03S1..EDH": (-33.8220, -78.8130),
    "IM.H03S2..EDH": (-33.8390, -78.8340),
    "IM.H03S3..EDH": (-33.8120, -78.8360),
}
#: indices in ``default_config``'s pairs: the array pairs
#: IM.H10N{1,2,3}..EDH-IM.H03S{1,2,3}..EDH; the (Z, R) pairs of RAR with
#: H10N1 and with H03S1; the timelapse pairs H10N1-H03S1, H10N2-H03S2
ARRAY_PAIRS = [4, 5, 6]
SWRESP_PAIRS = [(0, 1), (2, 3)]
TL_PAIRS = (4, 5)
#: the plane wave across the H03S triad that 8a recovers: propagation
#: azimuth (degrees from north) and horizontal velocity (m/s)
WAVE_AZ, WAVE_VEL = 250.0, 1480.0
#: swresp's ratio and phase are held on bins where |Y_Z| and |Y_R| both
#: exceed this share of their window's max, at P7_TOL / SW_LEVEL: a
#: float32 spectrum within P7_TOL of its max is that much off there
SW_LEVEL = 1e-2
#: 8d at the size of VERDICT r5's ask: 60 consecutive days, 4 bands
TL_DAYS = 60
TL_BANDS = ((3.0, 6.0), (6.0, 9.0), (9.0, 12.0), (12.0, 20.0))
TL_SAMPLE_TIMES, TL_SAMPLE_CELLS = 12, 64
#: 8d's A/B of the cell forms: rounds in turns, and the bar of the form's
#: peaks against the plain form's (relative; both run on the card)
TL_AB_ROUNDS = 3
TL_AB_RTOL = 1e-6
#: 8e: the year-size stack (times made from 8d's by a seeded perturbation),
#: one in TL_YEAR_GAP of them without a spectrogram for the bookkeeping
TL_YEAR = 365
TL_YEAR_GAP = 50
BF_TOL = 1e-9            # beamform card vs CPU: relative, degrees for doa


def new_phase8():
    """Phase 8's accumulators, filled by 7b's day loop and 8d."""
    return {"seconds": 0.0, "bf": {}, "plm": {}, "sw": {}}


def tally(acc, key, card, cpu, prof, units):
    """Add one profiled card run's wall, device ms and operations, and
    its CPU twin's wall, to ``acc[key]``."""
    ms, k, c, n, miss = device_ops(prof)
    r = acc.setdefault(key, {"card": 0.0, "cpu": 0.0, "dev_ms": 0.0,
                             "ops": 0, "launched": 0, "lost": 0,
                             "units": 0, "err": 0.0})
    r["card"] += card
    r["cpu"] += cpu
    r["dev_ms"] += ms
    r["ops"] += k + c
    r["launched"] += n
    r["lost"] += miss > 0
    r["units"] += units
    return r


def tally_line(label, r, unit):
    share = share_text(r["dev_ms"], r["card"], r["lost"])
    n = r["units"]
    return (f"{label}: card {1e3 * r['card'] / n:.1f} ms per {unit}, CPU "
            f"{1e3 * r['cpu'] / n:.1f} ms per {unit} ({n} {unit}s); device "
            f"{r['dev_ms']:.1f} ms, share {share}, device operations per "
            f"{unit} {r['ops'] / n:.1f} (launched {r['launched'] / n:.1f})")


def hold_close(got, want, tol, label, angle=False):
    """``got`` against ``want`` elementwise: relative (absolute for an
    ``angle`` in degrees, modulo 360), equal where not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    check(np.array_equal(fin, np.isfinite(got))
          and np.array_equal(got[~fin], want[~fin]),
          f"{label}: non-finite entries differ")
    if angle:
        d = np.abs((got[fin] - want[fin] + 180.0) % 360.0 - 180.0)
    else:
        d = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]),
                                                      1e-300)
    err = float(d.max()) if d.size else 0.0
    check(err <= tol, f"{label}: {err} > {tol}")
    return err


def phase8a_beamform(dss, iday, p8):
    """``beamform_datasets`` of one campaign day's three array pairs,
    envelope off and on, card against CPU; on the ``EVENTS`` windows the
    injected plane wave must come back."""
    from xcorr_tpu_torch.scripts.beamform import beamform_datasets
    arr = [dss[i] for i in ARRAY_PAIRS]
    for envelope in (False, True):
        kw = dict(clim=CELERITY, envelope=envelope, attrs=ANALYSIS_ATTRS,
                  filter_kwargs=HIGHPASS)
        with device_profile() as prof:
            card, t = timed(lambda: beamform_datasets(
                arr, p8["inv"], device="cuda", **kw))
        cpu, tc = timed(lambda: beamform_datasets(
            arr, p8["inv"], device="cpu", **kw))
        check(card is not None and cpu is not None, "8a: no estimate")
        r = tally(p8["bf"], envelope, t, tc, prof, 1)
        same = all(np.array_equal(card[v].values, cpu[v].values)
                   for v in ("s_x", "s_y", "doa", "vel", "err"))
        r["identical"] = r.get("identical", 0) + same
        for v in ("s_x", "s_y", "vel", "err"):
            r["err"] = max(r["err"], hold_close(
                card[v].values, cpu[v].values, BF_TOL, f"8a {v}"))
        r["err"] = max(r["err"], hold_close(
            card["doa"].values, cpu["doa"].values, BF_TOL, "8a doa", True))
        for d, i0, i1 in EVENTS:
            if d != iday:
                continue
            doa = card["doa"].values[i0:i1 + 1]
            vel = card["vel"].values[i0:i1 + 1]
            want = (WAVE_AZ + 180.0) % 360.0
            ddoa = float(np.abs((doa - want + 180.0) % 360.0 - 180.0).max())
            dvel = float(np.abs(vel / WAVE_VEL - 1.0).max())
            check(ddoa < 5.0 and dvel < 0.1,
                  f"8a day {iday}: event windows doa {doa}, vel {vel}; "
                  f"injected {want} deg, {WAVE_VEL} m/s")
            r["wave"] = max(r.get("wave", (0.0, 0.0)), (ddoa, dvel))


def tie_count(diff, w, err_abs, md):
    """How many of the peaks ``diff`` (index tuples present in one
    device's mask only) are near-ties in ``w``: the peak and the largest
    other value of its (2·md+1)² window differ by at most 2·err_abs. Any
    other difference fails."""
    for p in diff:
        lead, (i, j) = p[:-2], p[-2:]
        win = w[lead][max(0, i - md):i + md + 1,
                      max(0, j - md):j + md + 1].copy()
        win[min(i, md), min(j, md)] = -np.inf
        gap = abs(float(w[p]) - float(win.max()))
        check(gap <= 2 * err_abs, f"8b: peak {p} differs between card and "
                                  f"CPU by more than a tie ({gap})")
    return len(diff)


def phase8b_plmax(xt, dss, p8):
    """``pair_plmax`` of one campaign day's 8 pair-days, with the STFT and
    with the scaleogram, card against CPU: the spectrogram within P7_TOL
    of its max, the peak sets equal but for near-ties."""
    from xcorr_tpu_torch.scripts.plmax import pair_plmax
    from xcorr_tpu_torch.signal import scaleogram, spectrogram
    md = 25
    for wavelet in (False, True):
        kw = dict(clim=CELERITY, min_distance=md, wavelet=wavelet,
                  duration=2.5, padding_factor=4, filter_kwargs=HIGHPASS)
        ties = npeaks = 0
        for d in dss:
            with device_profile() as prof:
                dfc, t = timed(lambda: pair_plmax(d, device="cuda", **kw))
            dfp, tc = timed(lambda: pair_plmax(d, device="cpu", **kw))
            r = tally(p8["plm"], wavelet, t, tc, prof, 1)
            check(dfc is not None and dfp is not None, "8b: no peaks")
            psd = {}
            for dev in ("cuda", "cpu"):
                cc = xt.postprocess(d, clim=CELERITY, filter_kwargs=HIGHPASS,
                                    device=dev)["cc"]
                psd[dev] = (scaleogram(cc, dim="lag", device=dev) if wavelet
                            else spectrogram(cc, duration=2.5,
                                             padding_factor=4, device=dev))
            g, w = psd["cuda"].values, psd["cpu"].values
            err = rel_err(g, w, peak=True)
            check(err <= P7_TOL, f"8b: psd {err} of its max")
            r["err"] = max(r["err"], err)
            dims = psd["cpu"].dims

            def index(df):
                cols = [np.searchsorted(psd["cpu"].coords[k].values,
                                        df[k].values) for k in dims]
                return set(zip(*cols))
            diff = index(dfc) ^ index(dfp)
            ties += tie_count(diff, w, float(np.abs(g - w).max()), md)
            npeaks += len(dfp)
            r["shape"] = g.shape
        r["ties"] = r.get("ties", 0) + ties
        r["peaks"] = r.get("peaks", 0) + npeaks


def phase8c_swresp(xt, dss, p8):
    """``swresp_datasets`` of one campaign day's two (Z, R) pairs, card
    against CPU, on the bins where both spectra are above SW_LEVEL of
    their max; the errors on the bins where |Y_Z| > 1e-3 of its max are
    printed, not held."""
    from xcorr_tpu_torch.scripts.swresp import swresp_datasets
    kw = dict(clim=CELERITY, attrs=ANALYSIS_ATTRS, filter_kwargs=HIGHPASS)
    for iz, ir in SWRESP_PAIRS:
        with device_profile() as prof:
            card, t = timed(lambda: swresp_datasets(dss[iz], dss[ir],
                                                    device="cuda", **kw))
        cpu, tc = timed(lambda: swresp_datasets(dss[iz], dss[ir],
                                                device="cpu", **kw))
        r = tally(p8["sw"], "swresp", t, tc, prof, 1)
        check(card is not None and cpu is not None, "8c: no response")
        nt, nf = cpu["ratio"].shape
        mags = []
        for i in (iz, ir):
            cc = xt.postprocess(dss[i], clim=CELERITY, filter_kwargs=HIGHPASS,
                                device="cpu")["cc"].values[0, :nt]
            Y = np.abs(np.fft.rfft(cc[:, :2 * (nf - 1)], axis=-1))
            mags.append(Y / Y.max(axis=-1, keepdims=True))
        keep = (mags[0] > SW_LEVEL) & (mags[1] > SW_LEVEL)
        loose = mags[0] > 1e-3
        g, w = card["ratio"].values, cpu["ratio"].values
        with np.errstate(divide="ignore", invalid="ignore"):
            dr = np.abs(g - w) / np.abs(w)
        dp = np.abs(np.angle(np.exp(1j * (card["phase"].values
                                          - cpu["phase"].values))))
        bar = P7_TOL / SW_LEVEL
        check(dr[keep].max() <= bar and dp[keep].max() <= bar,
              f"8c: ratio {dr[keep].max()}, phase {dp[keep].max()} rad on "
              f"the held bins, bar {bar}")
        r["err"] = max(r["err"], float(dr[keep].max()))
        r["phase"] = max(r.get("phase", 0.0), float(dp[keep].max()))
        r["loose"] = max(r.get("loose", (0.0, 0.0)),
                         (float(np.nanmax(dr[loose])),
                          float(dp[loose].max())))
        r["held"] = r.get("held", 0) + int(keep.sum())
        r["bins"] = r.get("bins", 0) + keep.size


def phase8_report(p8):
    for env, r in sorted(p8["bf"].items()):
        phase(8, tally_line(f"8a beamform, envelope {env}", r, "array-day")
              + f"; card vs CPU {r['err']:.2e} (bar {BF_TOL}), "
              f"bit-identical on {r['identical']} of {r['units']} "
              f"array-days; event windows: doa within {r['wave'][0]:.2f} "
              f"deg of {(WAVE_AZ + 180.0) % 360.0:g}, vel within "
              f"{100 * r['wave'][1]:.2f}% of {WAVE_VEL:g} m/s")
    for wavelet, r in sorted(p8["plm"].items()):
        name = "scaleogram" if wavelet else "STFT"
        phase(8, tally_line(f"8b plmax ({name}, {r['shape']} per "
                            f"pair-day)", r, "pair-day")
              + f"; card vs CPU psd {r['err']:.2e} of its max; "
              f"{r['peaks']} peaks, {r['ties']} differ as near-ties")
    phase(8, "8a-8c " + twice_text("8a", "8b", "8c"))
    r = p8["sw"]["swresp"]
    phase(8, tally_line("8c swresp", r, "pair-day")
          + f"; card vs CPU on {r['held']} of {r['bins']} bins: ratio "
          f"{r['err']:.2e} relative, phase {r['phase']:.2e} rad (bar "
          f"{P7_TOL / SW_LEVEL:g}); where |Y_Z| > 1e-3 of its max: ratio "
          f"{r['loose'][0]:.2e}, phase {r['loose'][1]:.2e} rad")


def shift_value(a, b, df, dl):
    """The normalized 2-D correlation of spectrograms ``a`` and ``b`` at
    the shift (``df``, ``dl``), in float64 on the host:
    sum of a[f + df, l + dl] * b[f, l] over the overlap, as
    ``correlate_spectrograms`` defines its peak and shifts."""
    a = a / np.linalg.norm(a.astype(np.float64))
    b = b / np.linalg.norm(b.astype(np.float64))
    F, L = a.shape
    return float(np.sum(
        a[max(df, 0):F + min(df, 0), max(dl, 0):L + min(dl, 0)]
        * b[max(-df, 0):F + min(-df, 0), max(-dl, 0):L + min(-dl, 0)],
        dtype=np.float64))


def phase8d_timelapse(xt, p8):
    """The timelapse of two array pairs over TL_DAYS days and TL_BANDS:
    the spectrogram cache and every cell on the card; on the CPU the
    spectrograms of TL_SAMPLE_TIMES seeded times and a seeded sample of
    TL_SAMPLE_CELLS of their cells per (pair, band), held to the card:
    equal shifts but for near-ties, where the float64 correlation of the
    CPU's spectrograms at the card's shift and at the CPU's differ by at
    most 2 P7_TOL; counted."""
    from xcorr_tpu_torch.ops import cells as tl
    from xcorr_tpu_torch.scripts.timelapse import (correlate_spectrograms,
                                                   pair_spectrograms)
    times = pd.date_range(CAMPAIGN_START, periods=TL_DAYS, freq="1D")
    iu, ju = np.triu_indices(TL_DAYS)
    cell_of = {(a, b): k for k, (a, b) in enumerate(zip(iu, ju))}
    rng = np.random.default_rng([SEED, 8])
    kw = dict(clim=CELERITY, duration=2.5, padding_factor=4,
              filter_kwargs=HIGHPASS)
    gen = [0.0]

    def days(ip, idx):
        """The pair's datasets of the days ``idx``, made as iterated; the
        making is timed apart."""
        for i in idx:
            t0 = time.perf_counter()
            ds = campaign_day(xt, p8["init_args"], p8["pairs"], p8["dists"],
                              p8["offsets"], int(i), which=[ip])[0]
            gen[0] += time.perf_counter() - t0
            yield ds

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cache = {"card": 0.0, "dev_ms": 0.0, "ops": 0, "launched": 0,
             "lost": 0}
    cells = {"card": 0.0, "dev_ms": 0.0, "ops": 0, "launched": 0,
             "lost": 0, "n": 0}
    err = {"spec": 0.0, "cc2": 0.0}
    shapes, ties = {}, 0
    runs = []            # (label, stack, the main path's cells)
    launched = dict.fromkeys(tl.KERNELS, 0)
    for ip in TL_PAIRS:
        gen[0] = 0.0
        with held_twice("8d"), device_profile() as prof:
            (specs, freq), t = timed(lambda: pair_spectrograms(
                days(ip, range(TL_DAYS)), times, device="cuda", **kw))
        flush_twice()
        ms, k, c, n, miss = device_ops(prof)
        cache["card"] += t - gen[0]
        cache["dev_ms"] += ms
        cache["ops"] += k + c
        cache["launched"] += n
        cache["lost"] += miss > 0
        check(all(s is not None for s in specs), "8d: a day had no data")
        sample = np.sort(rng.choice(TL_DAYS, TL_SAMPLE_TIMES, replace=False))
        cpu_specs, _ = pair_spectrograms(days(ip, sample), times[sample],
                                         device="cpu", **kw)
        for k, i in enumerate(sample):
            err["spec"] = max(err["spec"], rel_err(specs[i], cpu_specs[k],
                                                   peak=True))
        la, lb = np.triu_indices(TL_SAMPLE_TIMES)
        pick = np.sort(rng.choice(la.size, TL_SAMPLE_CELLS, replace=False))
        la, lb = la[pick], lb[pick]
        for f0, f1 in TL_BANDS:
            sel = (freq >= f0) & (freq <= f1)
            stack = np.stack([s[sel] for s in specs])
            shapes[(f0, f1)] = stack.shape
            with device_profile() as prof:
                torch.cuda.synchronize()
                tl.reset_launches()
                (pk, df_, dl_), t = timed(lambda: correlate_spectrograms(
                    stack, iu, ju, device="cuda"))
                want = tl_launches_of(stack, -(-iu.size // 64))
                check(tl.launches == want,
                      f"8d: TL1 and TL2 launched {tl.launches}, not "
                      f"{want} (once per batch on the route of its rows)")
                for name in tl.KERNELS:
                    launched[name] += tl.launches[name]
            ms, k, c, n, miss = device_ops(prof)
            cells["card"] += t
            cells["dev_ms"] += ms
            cells["ops"] += k + c
            cells["launched"] += n
            cells["lost"] += miss > 0
            cells["n"] += iu.size
            # one (pair, band) stack and its cells go on to phase 9d
            p8.setdefault("tl_stack", (stack, (pk, df_, dl_),
                                       f"{p8['pairs'][ip]} {f0:g}-{f1:g} "
                                       "Hz"))
            runs.append((f"{p8['pairs'][ip]} {f0:g}-{f1:g} Hz", stack,
                         (pk, df_, dl_)))
            cstack = np.stack([s[sel] for s in cpu_specs])
            cpk, cdf, cdl = correlate_spectrograms(cstack, la, lb,
                                                   device="cpu")
            idx = [cell_of[(sample[a], sample[b])] for a, b in zip(la, lb)]
            err["cc2"] = max(err["cc2"],
                             float(np.abs(pk[idx] - cpk).max()))
            for n in np.flatnonzero((df_[idx] != cdf) | (dl_[idx] != cdl)):
                a, b = cstack[la[n]], cstack[lb[n]]
                gap = abs(shift_value(a, b, df_[idx][n], dl_[idx][n])
                          - shift_value(a, b, cdf[n], cdl[n]))
                check(gap <= 2 * P7_TOL,
                      f"8d {p8['pairs'][ip]} band {f0}-{f1} Hz: shifts "
                      f"({df_[idx][n]}, {dl_[idx][n]}) on the card, "
                      f"({cdf[n]}, {cdl[n]}) on the CPU, {gap} apart")
                ties += 1
            check(bool(np.isfinite(pk).all()), "8d: non-finite cc2")
            diag = pk[iu == ju]
            check(bool(np.abs(diag - 1.0).max() < 1e-5),
                  f"8d: self-correlation peaks {diag.min()} - {diag.max()}")
        del specs, cpu_specs
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(err["spec"] <= P7_TOL and err["cc2"] <= P7_TOL,
          f"8d: spectrograms {err['spec']} of their max, cc2 {err['cc2']}")
    npd = len(TL_PAIRS) * TL_DAYS

    def share(r, wall):
        return share_text(r["dev_ms"], wall, r["lost"])
    phase(8, f"8d timelapse, {len(TL_PAIRS)} pairs x {TL_DAYS} days x "
             f"{len(TL_BANDS)} bands: spectrogram cache {npd} pair-days, "
             f"card {1e3 * cache['card'] / npd:.1f} ms per pair-day "
             f"(postprocess + spectrogram; making the data timed apart), "
             f"device share {share(cache, cache['card'])}, device "
             f"operations per pair-day {cache['ops'] / npd:.1f} "
             f"(launched {cache['launched'] / npd:.1f})")
    phase(8, f"8d cells on the card: {cells['n']} in {cells['card']:.2f} s "
             f"= {cells['n'] / cells['card']:.0f} cells/s, device share "
             f"{share(cells, cells['card'])}, device operations per cell "
             f"{cells['ops'] / cells['n']:.2f} (launched "
             f"{cells['launched'] / cells['n']:.2f}); stacks (times, freqs, "
             f"lags) "
             + "; ".join(f"{f0:g}-{f1:g} Hz {v}"
                         for (f0, f1), v in shapes.items())
             + f"; peak device memory {peak_gb:.2f} GB above "
               f"{base / 1e9:.2f}")
    phase(8, "8d " + twice_text("8d"))
    phase(8, f"8d card vs CPU: spectrograms of {TL_SAMPLE_TIMES} times per "
             f"pair within {err['spec']:.2e} of their max; "
             f"{TL_SAMPLE_CELLS} cells per (pair, band): cc2 within "
             f"{err['cc2']:.2e}, delta_freq and delta_lag equal but for "
             f"{ties} near-ties")
    # the largest stack (the widest band of the longer pair): the scan
    # route on its days at longer rows, the kernels alone, and the
    # year-size stack made from it
    widest = max(runs, key=lambda r: r[1].shape[1] * r[1].shape[2])
    t0 = time.perf_counter()
    for name, n in phase8d_long_rows(widest).items():
        launched[name] += n
    t_long = time.perf_counter() - t0
    phase(8, f"8d launches on the cells' main path (the first card run of "
             f"each stack and the long-row stack, counts reset just before "
             f"each and read just after): {json.dumps(launched)}")
    t0 = time.perf_counter()
    phase8d_ab(runs)
    t1 = time.perf_counter()
    rec = phase8d_kernels(widest)
    t2 = time.perf_counter()
    year = phase8e_year(widest)
    t3 = time.perf_counter()
    phase8e_bookkeeping()
    phase(8, f"8d-8e command time: long rows {t_long:.1f} s, A/B "
             f"{t1 - t0:.1f} s, TL1/TL2 alone {t2 - t1:.1f} s, 8e year-size "
             f"stack {t3 - t2:.1f} s, bookkeeping "
             f"{time.perf_counter() - t3:.1f} s")
    return rec, launched, year


def near_ties(stack, ii, jj, got, want, bar, label):
    """Cells whose shifts differ between two runs (``got``, ``want``:
    ``(peak, df, dl)``): each must be a near-tie, the float64 correlations
    of the two spectrograms at both shifts within ``bar``; counted."""
    n_tie = 0
    for n in np.flatnonzero((got[1] != want[1]) | (got[2] != want[2])):
        a, b = stack[ii[n]], stack[jj[n]]
        gap = abs(shift_value(a, b, got[1][n], got[2][n])
                  - shift_value(a, b, want[1][n], want[2][n]))
        check(gap <= bar, f"{label} cell ({ii[n]}, {jj[n]}): shifts "
                          f"({got[1][n]}, {got[2][n]}) and ({want[1][n]}, "
                          f"{want[2][n]}), {gap} apart")
        n_tie += 1
    return n_tie


def tl_geometry(stack):
    """``(nf, nl, h)`` of a stack's transforms: the form's ``rfft2``
    lengths and its spectra's last axis."""
    from xcorr_tpu_torch.ops.fft import next_fast_len
    nf = next_fast_len(2 * stack.shape[1] - 1)
    nl = next_fast_len(2 * stack.shape[2] - 1)
    return nf, nl, nl // 2 + 1


def tl_launches_of(stack, batches):
    """The cell kernels' launches a run of ``batches`` batches of
    ``stack`` makes: TL1 once per batch, and TL2 once per batch on the
    route its rows take (``ops.cells.row_plan``): the row kernel, or the
    scan."""
    from xcorr_tpu_torch.ops.cells import row_plan
    row = row_plan(tl_geometry(stack)[1]).route == "kernel"
    return {"gather_product": batches,
            "circular_argmax": 0 if row else batches,
            "inverse_argmax": batches if row else 0}


def phase8d_ab(runs):
    """8d's cells on the form (each spectrogram's spectrum once per stack,
    TL1, TL2 on its rows' route) and on ``_correlate_spectrograms_plain``
    (both spectra of every cell and the fftshift copies) over every
    (pair, band) stack of 8d, in turns, the order swapped each round,
    TL_AB_ROUNDS rounds, unprofiled; then one profiled run of each for
    device ms per batch and the device share, and each form's peak
    device memory above the stack. The form's peaks within TL_AB_RTOL
    (relative) of the plain form's, shifts equal but for near-ties
    (float64, ``shift_value``), counted; the form's reruns bit-identical
    to the main path's run."""
    from xcorr_tpu_torch.scripts import timelapse as tls
    forms = {"form": tls.correlate_spectrograms,
             "plain": tls._correlate_spectrograms_plain}
    ncells = sum(st.shape[0] * (st.shape[0] + 1) // 2 for _, st, _ in runs)
    secs = {f: [] for f in forms}
    out = {}
    for r in range(TL_AB_ROUNDS):
        for f in tuple(forms)[::1 if r % 2 == 0 else -1]:
            wall = 0.0
            for label, st, _ in runs:
                iu, ju = np.triu_indices(st.shape[0])
                res, t = timed(lambda: forms[f](st, iu, ju, device="cuda"))
                wall += t
                if r == 0:
                    out[(f, label)] = res
                elif f == "form":
                    check(all(np.array_equal(a, b) for a, b in
                              zip(res, out[(f, label)])),
                          f"8d A/B {label}: the form's rerun differs")
            secs[f].append(wall)
    err, same, n_tie = 0.0, 0, 0
    for label, st, main in runs:
        iu, ju = np.triu_indices(st.shape[0])
        got, want = out[("form", label)], out[("plain", label)]
        check(all(np.array_equal(a, b) for a, b in zip(got, main)),
              f"8d A/B {label}: the form differs from its main-path run")
        err = max(err, rel_err(got[0], want[0]))
        same += int(np.sum((got[0] == want[0]) & (got[1] == want[1])
                           & (got[2] == want[2])))
        n_tie += near_ties(st, iu, ju, got, want, 2 * TL_AB_RTOL,
                           f"8d A/B {label}")
    check(err <= TL_AB_RTOL, f"8d A/B: peaks {err} from the plain form's")
    dev, mem = {}, {}
    for f, fn in forms.items():
        ms, lost, batches, wall, peak = 0.0, 0, 0, 0.0, 0
        for label, st, _ in runs:
            iu, ju = np.triu_indices(st.shape[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with device_profile() as prof:
                _, t = timed(lambda: fn(st, iu, ju, device="cuda"))
            peak = max(peak, torch.cuda.max_memory_allocated() - base
                       - st.nbytes)
            m, _, _, _, miss = device_ops(prof)
            ms += m
            lost += miss > 0
            wall += t
            batches += -(-iu.size // 64)
        dev[f] = (f"{ms / batches:.4f} ms per batch of 64 (share "
                  f"{share_text(ms, wall, lost)})")
        mem[f] = peak / 1e9
    big = max(runs, key=lambda r: r[1].shape[1] * r[1].shape[2])[1]
    nf, nl, h = tl_geometry(big)
    spectra_gb = big.shape[0] * nf * h * 8 / 1e9
    med = {f: float(np.median(v)) for f, v in secs.items()}
    phase(8, f"8d A/B, {len(runs)} stacks, {ncells} cells, "
             f"{TL_AB_ROUNDS} rounds in turns: form "
             f"{ncells / med['form']:.0f} cells/s (rounds "
             + ", ".join(f"{t:.3f}" for t in secs["form"])
             + f" s), plain {ncells / med['plain']:.0f} cells/s (rounds "
             + ", ".join(f"{t:.3f}" for t in secs["plain"])
             + f" s), {med['plain'] / med['form']:.2f}x; device form "
             f"{dev['form']}, plain {dev['plain']}; peak device memory "
             f"above the stack: form {mem['form']:.3f} GB (the largest "
             f"stack's spectra {spectra_gb:.3f} GB, {big.shape[0]} x {nf} "
             f"x {h} complex64), plain {mem['plain']:.3f} GB")
    phase(8, f"8d A/B: the form's peaks within {err:.3e} (relative) of "
             f"the plain form's, bar {TL_AB_RTOL:g}; {same} of {ncells} "
             f"cells bit-identical (peak and shifts); shifts equal but "
             f"for {n_tie} near-ties (float64)")


#: 8d's long-row stack: days of the widest stack at a lag width whose
#: rows pass the row kernel's shared memory (nl = 30,000; 9,100 lags is
#: a 10,000 km pair's, so this is a pair about 16,500 km apart)
TL_LONG_DAYS, TL_LONG_L = 12, 15000


def long_stack(st):
    """TL_LONG_DAYS spectrograms of ``st`` at TL_LONG_L lags: each day's
    lags repeated, every other copy reversed, cut to TL_LONG_L."""
    days = st[:TL_LONG_DAYS]
    parts = [days if k % 2 == 0 else days[:, :, ::-1]
             for k in range(-(-TL_LONG_L // st.shape[2]))]
    return np.ascontiguousarray(
        np.concatenate(parts, axis=2)[:, :, :TL_LONG_L])


def phase8d_long_rows(run):
    """The scan route on the main path: every cell of ``long_stack`` of
    ``run``'s stack through ``correlate_spectrograms`` (counts reset just
    before and read just after: TL1 and the scan once per batch, the row
    kernel never) and through the plain form; peaks within TL_AB_RTOL
    (relative), shifts equal but for near-ties (float64), counted.
    Returns the form's launches."""
    from xcorr_tpu_torch.ops import cells as tl
    from xcorr_tpu_torch.scripts import timelapse as tls
    label, st, _ = run
    stack = long_stack(st)
    nf, nl, _ = tl_geometry(stack)
    iu, ju = np.triu_indices(stack.shape[0])
    check(tl.row_plan(nl).route == "scan",
          f"8d long rows: nl = {nl} takes the row kernel")
    torch.cuda.synchronize()
    tl.reset_launches()
    got, t = timed(lambda: tls.correlate_spectrograms(stack, iu, ju,
                                                      device="cuda"))
    launches = dict(tl.launches)
    want_l = tl_launches_of(stack, -(-iu.size // 64))
    check(launches == want_l,
          f"8d long rows: launched {launches}, not {want_l}")
    want, t_plain = timed(lambda: tls._correlate_spectrograms_plain(
        stack, iu, ju, device="cuda"))
    err = rel_err(got[0], want[0])
    check(err <= TL_AB_RTOL, f"8d long rows: peaks {err} from the plain "
                             "form's")
    n_tie = near_ties(stack, iu, ju, got, want, 2 * TL_AB_RTOL,
                      "8d long rows")
    phase(8, f"8d long rows ({label}'s first {TL_LONG_DAYS} days at "
             f"{TL_LONG_L} lags, stack {stack.shape}, nf x nl = {nf} x "
             f"{nl}, the scan route): {iu.size} cells, form {t:.3f} s, "
             f"plain {t_plain:.3f} s (first calls at this shape); launches "
             f"{json.dumps(launches)}; peaks within {err:.3e} (relative) "
             f"of the plain form's, shifts equal but for {n_tie} "
             f"near-ties (float64)")
    return launches


def phase8d_kernels(run):
    """TL1 and both routes of TL2 alone against their plain versions on
    the first batch of 64 cells of ``run``'s stack (8d's widest band):
    errors, bits, median CUDA-event ms of 20 of each, and the card's
    bound (bytes: the spectra the batch names read once and the products
    written once; the maps' windows read once; the kept rows' half
    spectra read once, or the row transforms' operations, 5 nl log2 nl
    per pair of rows, where larger). The scan must give its plain
    version's value bits and index on the batch's maps, on an all-zero
    map and on a map with a planted tie and a planted NaN. The row
    kernel, on the column inverses as the form lays them out: peaks
    within TL_AB_RTOL (relative) of its plain version's, indices equal
    but for near-ties (float64, 8d's rule), counted; a rerun the same
    bits; an all-zero input its plain version's peak and index; a NaN
    planted in the first kept row a NaN peak at its plain version's
    index, in the fourth NaN at that row's first window column; its
    library yardstick ``torch.fft.irfft`` of the same kept rows,
    without the argmax. Returns each kernel's record."""
    from xcorr_tpu_torch.ops import cells as tl
    from xcorr_tpu_torch.scripts import timelapse as tls
    label, st, _ = run
    T, F, L = st.shape
    nf, nl, h = tl_geometry(st)
    sp = torch.from_numpy(st).cuda()
    S = tls._spectra(sp, 0, T, nf, nl)
    iu, ju = np.triu_indices(T)
    ii = torch.from_numpy(iu[:64].astype(np.int64)).cuda()
    jj = torch.from_numpy(ju[:64].astype(np.int64)).cuda()
    B, M = ii.numel(), nf * h
    rec = {}
    P = tl.gather_product(S, ii, S, jj)
    torch.cuda.synchronize()
    want = tl.gather_product_plain(S, ii, S, jj)
    err = (P - want).abs().max().item()
    rel = err / want.abs().max().item()
    bits = torch.equal(torch.view_as_real(P), torch.view_as_real(want))
    check(rel <= 1e-6, f"TL1 {label}: {rel} of its plain version's max")
    named = np.union1d(iu[:64], ju[:64]).size
    rec["gather_product"] = {
        "max_abs_err": err,
        "ms": median_ms(lambda: tl.gather_product(S, ii, S, jj)),
        "plain_ms": median_ms(lambda: tl.gather_product_plain(S, ii, S,
                                                               jj))}
    rec["gather_product"].update(zip(
        ("bound_ms", "bound_by"),
        bound(named * M * 8 + 2 * B * 8, B * M * 8, 6.0 * B * M)[:2]))
    r = torch.fft.irfft2(P, s=(nf, nl))
    win = (2 * F - 1) * (2 * L - 1)
    planted = r[:2].clone()
    planted[0].fill_(0.5)
    planted[0, 0, 0] = planted[0, nf - 1, nl - 1] = 2.0      # a tie
    planted[1, nf - 1, nl - 2] = float("nan")   # lags (-1, -2): first
    planted[1, 3 % nf, 5 % nl] = float("nan")
    for name, m in (("batch", r), ("zero", torch.zeros_like(r[:1])),
                    ("tie and NaN", planted)):
        got = tl.circular_argmax(m, F, L)
        torch.cuda.synchronize()
        ref = tl.circular_argmax_plain(m, F, L)
        check(torch.equal(got[1], ref[1]) and torch.equal(
            got[0].view(torch.int32), ref[0].view(torch.int32)),
            f"TL2 {label} {name} maps: {got} against its plain {ref}")
    check(bool(torch.isnan(tl.circular_argmax(planted, F, L)[0][1])),
          "TL2: the planted NaN is not the peak")
    rec["circular_argmax"] = {
        "max_abs_err": 0.0,
        "ms": median_ms(lambda: tl.circular_argmax(r, F, L)),
        "plain_ms": median_ms(lambda: tl.circular_argmax_plain(r, F, L))}
    rec["circular_argmax"].update(zip(
        ("bound_ms", "bound_by"), bound(B * win * 4, B * 12, B * win)[:2]))
    del S, P, r, planted
    # TL2's row kernel, on the column inverses as the form lays them out
    Sc = tls._spectra(sp, 0, T, nf, nl, cols=True)
    Y = torch.fft.ifft(tl.gather_product(Sc, ii, Sc, jj).transpose(-2, -1),
                       dim=-2, norm="forward")
    del Sc
    got = tl.inverse_argmax(Y, F, L, nl)
    again = tl.inverse_argmax(Y, F, L, nl)
    torch.cuda.synchronize()
    ref = tl.inverse_argmax_plain(Y, F, L, nl)
    check(torch.equal(got[1], again[1]) and torch.equal(
        got[0].view(torch.int32), again[0].view(torch.int32)),
        f"row kernel {label}: a rerun differs")
    W = 2 * L - 1

    def shifts(pk, k):
        k = k.cpu().numpy()
        return (pk.cpu().numpy(), (k // W - (F - 1)).astype(np.int32),
                (k % W - (L - 1)).astype(np.int32))
    g3, w3 = shifts(*got), shifts(*ref)
    row_err = rel_err(g3[0], w3[0])
    check(row_err <= TL_AB_RTOL,
          f"row kernel {label}: peaks {row_err} of its plain version's")
    row_ties = near_ties(st, iu[:64], ju[:64], g3, w3, 2 * TL_AB_RTOL,
                         f"row kernel {label}")
    zero = torch.zeros_like(Y[:2])
    gz = tl.inverse_argmax(zero, F, L, nl)
    wz = tl.inverse_argmax_plain(zero, F, L, nl)
    check(torch.equal(gz[1], wz[1]) and torch.equal(gz[0], wz[0]),
          f"row kernel, zero input: {gz} against its plain {wz}")
    # NaNs planted in kept rows: in the first against the plain version
    # and numpy's float64 witness, in later rows (a pair's either row, and
    # the last, alone in its block) against the witness alone, since the
    # plain version's cuFFT may carry a NaN into a neighbouring row of
    # its batch
    nan = complex(float("nan"), float("nan"))
    planted = Y[:2].clone()
    planted[1, (0 - (F - 1)) % nf, nl // 4] = nan
    gn = tl.inverse_argmax(planted, F, L, nl)
    wn = tl.inverse_argmax_plain(planted, F, L, nl)
    xk = row_witness(planted, F, L, nl)
    check(bool(torch.isnan(gn[0][1]) and torch.isnan(wn[0][1]))
          and torch.equal(gn[1], wn[1]) and int(gn[1][1]) == xk[1] == 0,
          f"row kernel, planted NaN: {gn} against its plain {wn}, "
          f"numpy's {xk}")
    planted = Y[:2].clone()
    for c, kept_rows in ((0, (2 * F - 2,)), (1, (5, 2, 2 * F - 2))):
        for i in kept_rows:
            planted[c, (i - (F - 1)) % nf, (7 * i) % h] = nan
    gn = tl.inverse_argmax(planted, F, L, nl)
    xk = row_witness(planted, F, L, nl)
    check(bool(torch.isnan(gn[0]).all())
          and list(gn[1].cpu().numpy()) == list(xk)
          == [(2 * F - 2) * W, 2 * W],
          f"row kernel, NaNs in later kept rows: {gn}, numpy's NaNs at "
          f"{xk}")
    rows = torch.from_numpy((np.arange(2 * F - 1) - (F - 1)) % nf).cuda()
    kept = (Y[:, rows] / nf).contiguous()
    rec["inverse_argmax"] = {
        "max_abs_err": float(np.abs(g3[0] - w3[0]).max()),
        "ms": median_ms(lambda: tl.inverse_argmax(Y, F, L, nl)),
        "plain_ms": median_ms(
            lambda: tl.inverse_argmax_plain(Y, F, L, nl)),
        "library_ms": median_ms(
            lambda: torch.fft.irfft(kept, n=nl, dim=-1))}
    rec["inverse_argmax"].update(zip(("bound_ms", "bound_by"), bound(
        B * (2 * F - 1) * h * 8, B * 12,
        B * F * 5 * nl * math.log2(nl))[:2]))
    del Y, kept, planted
    notes = {
        "gather_product": f" rel {rel:.3e}, bit-identical {bits}",
        "circular_argmax": " (value bits and index equal on the batch's "
                           "maps, a zero map, a planted tie and NaNs)",
        "inverse_argmax": f" rel {row_err:.3e}, indices equal but for "
                          f"{row_ties} near-ties (float64), a rerun the "
                          "same bits, a zero input as its plain version, "
                          "planted NaNs as numpy's float64 witness"}
    for name, v in rec.items():
        v.setdefault("library_ms", None)
        lib = ("" if v["library_ms"] is None else
               f", library (irfft of the kept rows) {v['library_ms']:.4f} "
               "ms")
        phase(8, f"{name} at 8d's largest stack ({label}, stack {st.shape}, "
                 f"{B} cells, nf x nl = {nf} x {nl}): max_abs_err "
                 f"{v['max_abs_err']:.3e}{notes[name]}; kernel "
                 f"{v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms bound "
                 f"{v['bound_ms']:.4f} ms ({v['bound_by']}), "
                 f"{100 * v['bound_ms'] / v['ms']:.1f}% of bound{lib}")
    return rec


def row_witness(Y, n1, n2, nl):
    """Each cell's flat argmax over the window of ``irfft(Y, n=nl) / nf``
    from numpy's float64 ``irfft`` of each kept row on the host, with
    ``argmax``'s rule (the first NaN, else the first maximum): a witness
    that no batching of rows on the card touches."""
    Yh = Y.cpu().numpy().astype(np.complex128)
    nf = Yh.shape[1]
    rows = (np.arange(2 * n1 - 1) - (n1 - 1)) % nf
    cols = (np.arange(2 * n2 - 1) - (n2 - 1)) % nl
    with np.errstate(invalid="ignore"):
        m = np.fft.irfft(Yh[:, rows], n=nl, axis=-1)[..., cols] / nf
    return [int(k) for k in m.reshape(len(Yh), -1).argmax(-1)]


def year_stack(st):
    """TL_YEAR spectrograms made from ``st``'s by a seeded multiplicative
    perturbation (each a day of ``st`` times a field in [0.8, 1.25))."""
    rng = np.random.default_rng([SEED, 85])
    days = np.arange(TL_YEAR) % st.shape[0]
    year = np.empty((TL_YEAR, *st.shape[1:]), np.float32)
    for t in range(TL_YEAR):
        year[t] = st[days[t]] * rng.uniform(0.8, 1.25, st.shape[1:])
    return year


def phase8e_year(run):
    """8e: the year-size stack of ``run``'s pair and band, all
    TL_YEAR (TL_YEAR + 1) / 2 cells on the form (counts reset just before
    and read just after: TL1 and TL2 once per batch) and on the plain
    form, once each, with cells/s and peak device memory above the
    stack; every cell's peak within TL_AB_RTOL (relative) of the plain
    form's, shifts equal but for near-ties (float64), counted; a seeded
    sample of 256 cells reported on its own. Returns the form's launches."""
    from xcorr_tpu_torch.ops import cells as tl
    from xcorr_tpu_torch.scripts import timelapse as tls
    label, st, _ = run
    year = year_stack(st)
    iu, ju = np.triu_indices(TL_YEAR)
    nf, nl, h = tl_geometry(year)
    res, secs, mem = {}, {}, {}
    launches = None
    for f, fn in (("form", tls.correlate_spectrograms),
                  ("plain", tls._correlate_spectrograms_plain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if f == "form":
            tl.reset_launches()
        res[f], secs[f] = timed(lambda: fn(year, iu, ju, device="cuda"))
        if f == "form":
            launches = dict(tl.launches)
        mem[f] = (torch.cuda.max_memory_allocated() - base
                  - year.nbytes) / 1e9
    want_l = tl_launches_of(year, -(-iu.size // 64))
    check(launches == want_l,
          f"8e: TL1 and TL2 launched {launches}, not {want_l} (once per "
          "batch on the route of its rows)")
    got, want = res["form"], res["plain"]
    err = rel_err(got[0], want[0])
    check(err <= TL_AB_RTOL, f"8e: peaks {err} from the plain form's")
    check(bool(np.isfinite(got[0]).all()), "8e: non-finite cc2")
    n_tie = near_ties(year, iu, ju, got, want, 2 * TL_AB_RTOL, "8e")
    pick = np.sort(np.random.default_rng([SEED, 86]).choice(
        iu.size, 256, replace=False))
    s_err = rel_err(got[0][pick], want[0][pick])
    s_same = int(np.sum((got[1][pick] == want[1][pick])
                        & (got[2][pick] == want[2][pick])))
    same = int(np.sum((got[0] == want[0]) & (got[1] == want[1])
                      & (got[2] == want[2])))
    phase(8, f"8e year-size stack ({label} from 8d's {st.shape[0]} days, "
             f"stack {year.shape}, nf x nl = {nf} x {nl}), {iu.size} cells "
             f"once each: form {iu.size / secs['form']:.0f} cells/s "
             f"({secs['form']:.3f} s), plain "
             f"{iu.size / secs['plain']:.0f} cells/s ({secs['plain']:.3f} "
             f"s), {secs['plain'] / secs['form']:.2f}x; peak device memory "
             f"above the stack: form {mem['form']:.3f} GB (spectra "
             f"{TL_YEAR * nf * h * 8 / 1e9:.3f} GB), plain "
             f"{mem['plain']:.3f} GB; launches {json.dumps(launches)}; "
             f"peaks within {err:.3e} (relative) of the plain form's, "
             f"{same} cells bit-identical, shifts equal but for {n_tie} "
             f"near-ties (float64); the seeded 256: peaks within "
             f"{s_err:.3e}, shifts equal in {s_same}")
    return launches


def phase8e_bookkeeping():
    """The cell bookkeeping of one pair and band at TL_YEAR times (one in
    TL_YEAR_GAP without a spectrogram) on ``fill_cells`` and on
    ``_fill_cells_plain``, timed on the card's host, given the same
    precomputed cell results (the correlation is not timed); the two
    Datasets' variables must be the same bytes."""
    from xcorr_tpu_torch.scripts import timelapse as tls
    times = pd.date_range(CAMPAIGN_START, periods=TL_YEAR, freq="1D").values
    valid = [t for t in range(TL_YEAR) if t % TL_YEAR_GAP != 7]
    iu, ju = np.triu_indices(TL_YEAR)
    rng = np.random.default_rng([SEED, 87])
    n = len(valid) * (len(valid) + 1) // 2
    peaks = rng.uniform(0.0, 1.0, n).astype(np.float32)
    dfs = rng.integers(-80, 81, n).astype(np.int32)
    dls = rng.integers(-9000, 9001, n).astype(np.int32)

    def correlate(ii, jj):
        check(len(ii) == n, f"bookkeeping: {len(ii)} cells, not {n}")
        return peaks, dfs, dls

    out, secs = {}, {}
    for f, fill in (("form", tls.fill_cells),
                    ("plain", tls._fill_cells_plain)):
        ds = tls.init_timelapse([PAIR], times, TL_BANDS[-1:])
        t0 = time.perf_counter()
        fill(ds, 0, 0, iu, ju, valid, correlate)
        secs[f] = time.perf_counter() - t0
        out[f] = ds
    for name in ("cc2", "delta_freq", "delta_lag", "status"):
        a, b = out["form"][name].values, out["plain"][name].values
        check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
              f"bookkeeping: {name} differs between the forms")
    phase(8, f"8e bookkeeping at T = {TL_YEAR} ({len(valid)} valid, {n} "
             f"cells, one pair and band) on the card's host: form "
             f"{secs['form']:.4f} s, plain {secs['plain']:.4f} s; cc2, "
             f"delta_freq, delta_lag and status the same bytes")

# -- 9. the multi-device layer on the one card -------------------------------

#: phase 9's logical mesh: the one card, named twice
MESH_DEVICES = ("cuda:0", "cuda:0")
#: seconds a 9c worker may take
WORKER_TIMEOUT = 300


def wall_ms(fn, reps=5):
    """Median wall ms of ``fn()`` after one warm-up, the device
    synchronized at both ends."""
    fn()
    return float(np.median([1e3 * timed(fn)[1] for _ in range(reps)]))


def phase9a_sharded(ff, cc, mesh, imin, imax, oracle):
    """``sharded_correlate`` of phase 4's 16 day-scale windows over the
    logical mesh, once per route: the route's kernel once per entry and
    nothing else, rows 0 and 1 (phase 4's oracle) and 8 (the second
    entry's first) within CCF_ATOL of float64, the peak on the injected
    delay, the difference from the unsharded ``correlate`` and wall times
    per window, the host gather included: sharded, unsharded with the
    same pinned readback (``Readback``), and unsharded with a plain
    ``.cpu()``. Returns the launches by route."""
    from xcorr_tpu_torch.parallel import sharded_correlate
    from xcorr_tpu_torch.parallel.pipeline import Readback
    B = 16
    x, y = day_windows(B)
    shift = int(DELAY * FS)
    oracle = dict(enumerate(oracle))
    oracle[8] = f64_oracle(x[8].double().cpu().numpy(),
                           y[8].double().cpu().numpy(), imin, imax)
    lags = dict(index_min=imin, index_max=imax)
    launches = {}
    for route, (kname, _) in ROUTES.items():
        set_route(route)
        ff.reset_launches()
        got = sharded_correlate(x, y, mesh=mesh, **lags)
        counts = dict(ff.launches)
        check(counts[kname] == mesh.size
              and sum(counts.values()) == mesh.size,
              f"9a route {route}: sharded_correlate launched {counts}, "
              f"expected {kname} once per mesh entry")
        launches[route] = {kname: counts[kname]}
        check(got.shape == (B, imax - imin) and bool(np.isfinite(got).all()),
              f"9a route {route}: result {got.shape}, or not finite")
        err = max(float(np.abs(got[i] - o).max()) for i, o in oracle.items())
        check(err <= CCF_ATOL, f"9a route {route}: CCF error {err} > "
                               f"{CCF_ATOL}")
        peak = int(got[0].argmax()) + imin - (N - 1)
        check(peak == shift, f"9a route {route}: peak at {peak} samples")
        plain = cc.correlate(x, y, **lags).cpu().numpy()
        diff = float(np.abs(got - plain).max())
        check(diff <= CCF_ATOL, f"9a route {route}: {diff} from the "
                                "unsharded correlate")
        t_mesh = wall_ms(lambda: sharded_correlate(x, y, mesh=mesh, **lags))
        t_one = wall_ms(lambda: Readback(cc.correlate(x, y, **lags)).wait())
        t_cpu = wall_ms(lambda: cc.correlate(x, y, **lags).cpu())
        phase(9, f"9a route {route} ({kname}): sharded_correlate {B} x {N} "
                 f"over {mesh.size} entries: {kname} launches "
                 f"{counts[kname]}, max abs vs f64 {err:.3e} (rows "
                 f"{sorted(oracle)}), vs unsharded {diff:.3e} "
                 f"(bit-identical: {diff == 0.0}); ms per window with the "
                 f"host gather (median of 5): sharded {t_mesh / B:.4f}, "
                 f"unsharded {t_one / B:.4f} (same pinned readback; split "
                 f"overhead {(t_mesh - t_one) / B:+.4f}), unsharded with "
                 f".cpu() {t_cpu / B:.4f}")
    set_route("corr")
    del x, y
    torch.cuda.empty_cache()
    return launches


def phase9b_mesh_engine(xt, ff, mesh, ref, ref_wall):
    """Phase 6's 4 pair-days through ``device_process_bulk(mesh=)`` under
    ``util.profiler.trace``: K1 once per entry, statuses and CCFs held to
    phase 6's warm mesh=None run (``ref``), the trace's busy time and
    device spans beside the profiler's own device time, wall,
    host->device bytes, peak memory and ``device_memory``. Returns the
    launches."""
    from xcorr_tpu_torch.parallel import device_process_bulk
    from xcorr_tpu_torch.util import profiler
    inv, client, days, dataset = engine_setup(xt)
    dss = [dataset(d) for d in days]
    timer = profiler.StageTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as logdir:
        ff.reset_launches()
        with profiler.trace(logdir) as prof:
            t0 = time.perf_counter()
            finalize, fallback = device_process_bulk(
                dss, client, inventory=inv, timer=timer, verb=0, mesh=mesh)
            finalize()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = dict(ff.launches)
        busy = profiler.parse_device_trace(logdir)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(not fallback, f"9b: the device engine fell back: {fallback}")
    check(counts["fused_corr"] == mesh.size
          and sum(counts.values()) == mesh.size,
          f"9b: launched {counts}, expected fused_corr once per entry")
    diff, same = 0.0, True
    for d, (cc_ref, status_ref) in zip(dss, ref):
        check(np.array_equal(d["status"].values, status_ref),
              f"9b: statuses {d['status'].values.tolist()}")
        diff = max(diff, float(np.abs(d["cc"].values - cc_ref).max()))
        same &= bool(np.array_equal(d["cc"].values, cc_ref))
    check(diff <= CCF_ATOL, f"9b: CCFs {diff} from mesh=None")
    check(busy is not None and 0 < busy["device_busy_s"] <= wall
          and busy["launches"] > 0, f"9b: trace {busy}, wall {wall}")
    # the trace holds host operations too, whose device time repeats
    # their kernels': only the card's own events are summed
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    ndev = sum(e.count for e in dev)
    mem = profiler.device_memory(mesh)
    h2d = timer.as_dict()["device-dispatch"].get("GB", 0.0)
    phase(9, f"9b device_process_bulk(mesh=) of phase 6's {len(dss)} "
             f"pair-days: {wall:.2f} s wall (mesh=None, phase 6 warm: "
             f"{ref_wall:.2f} s), fused_corr launches "
             f"{counts['fused_corr']}, statuses equal, max |CCF - "
             f"mesh=None| {diff:.3e} (bit-identical: {same}), "
             f"host->device {h2d:.3f} GB, peak device memory "
             f"{peak_gb:.2f} GB above {base / 1e9:.2f}")
    phase(9, f"9b util.profiler.trace: parse_device_trace busy "
             f"{busy['device_busy_s']:.4f} s in {busy['launches']} device "
             f"spans (busy / wall {busy['device_busy_s'] / wall:.4f}); "
             f"torch.profiler key_averages of the same run, the card's "
             f"events: {dev_ms:.1f} ms in {ndev} kernels and copies")
    phase(9, "9b device_memory(mesh): " + "; ".join(
        f"{k}: peak allocated {v['allocated_bytes.all.peak'] / 1e9:.2f} GB,"
        f" reserved {v['reserved_bytes.all.current'] / 1e9:.2f} GB"
        for k, v in mem.items()))
    return {"fused_corr": counts["fused_corr"]}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank, port, outdir):
    """A 9c process: join the two-process gloo group, take this rank's
    ``host_slice`` of phase 6's 4 pair-days, run them through
    ``device_process_bulk`` on cuda:0 and write their CCFs and statuses
    to ``<outdir>/rank<rank>.npz``; the last line is a JSON record."""
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import xcorr_tpu_torch as xt
    from xcorr_tpu_torch.ops import fused_fft as ff
    from xcorr_tpu_torch.parallel import (device_process_bulk, distributed,
                                          host_slice)
    check(distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                                 process_id=rank),
          "initialize() returned False")
    inv, client, days, dataset = engine_setup(xt)
    mine = host_slice(list(range(len(days))))
    dss = [dataset(days[i]) for i in mine]
    ff.reset_launches()
    t0 = time.perf_counter()
    finalize, fallback = device_process_bulk(dss, client, inventory=inv,
                                             verb=0, device="cuda")
    finalize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not fallback, f"worker {rank}: fell back {fallback}")
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), days=np.asarray(mine),
             cc=np.stack([d["cc"].values for d in dss]),
             status=np.stack([d["status"].values for d in dss]))
    distributed.shutdown()
    check("jax" not in sys.modules, "the worker imported jax")
    print(json.dumps({"rank": rank, "days": mine,
                      "launches": dict(ff.launches), "wall_s": wall}))


def phase9c_processes(ref, ref_wall):
    """Two worker processes on the one card form a gloo group, each runs
    its ``host_slice`` of phase 6's 4 pair-days; their union is held to
    phase 6's warm one-process run (``ref``). Returns the launches by
    rank."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as outdir:
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(rank), str(port), outdir], cwd=here, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(2)]
        outs = []
        try:
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
                except subprocess.TimeoutExpired:
                    fail(f"9c: a worker ran past {WORKER_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        recs = []
        for rank, (p, out) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"9c worker {rank} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
            recs.append(json.loads(out.strip().splitlines()[-1]))
        parts = [np.load(os.path.join(outdir, f"rank{r}.npz"))
                 for r in range(2)]
        union = {}
        for part in parts:
            for k, day in enumerate(part["days"]):
                check(int(day) not in union, f"9c: day {day} twice")
                union[int(day)] = (part["cc"][k], part["status"][k])
    check(sorted(union) == list(range(len(ref))),
          f"9c: the workers took days {sorted(union)}")
    diff, same = 0.0, True
    for day, (cc_ref, status_ref) in enumerate(ref):
        got_cc, got_status = union[day]
        check(np.array_equal(got_status, status_ref),
              f"9c: day {day} statuses {got_status.tolist()}")
        diff = max(diff, float(np.abs(got_cc - cc_ref).max()))
        same &= bool(np.array_equal(got_cc, cc_ref))
    check(diff <= CCF_ATOL, f"9c: CCFs {diff} from the one-process run")
    for r in recs:
        check(r["launches"]["fused_corr"] >= 1,
              f"9c worker {r['rank']} launched {r['launches']}")
    phase(9, f"9c two processes on the card (gloo group on 127.0.0.1:"
             f"{port}): days " + ", ".join(
                 f"rank {r['rank']} {r['days']} ({r['wall_s']:.2f} s in "
                 f"device_process_bulk, launches "
                 f"{ {k: v for k, v in r['launches'].items() if v} })"
                 for r in recs)
             + f"; {wall:.2f} s from start to both exits (one process, "
               f"phase 6 warm: {ref_wall:.2f} s in device_process_bulk); "
               f"union max |CCF - one process| {diff:.3e} (bit-identical: "
               f"{same})")
    return {f"rank {r['rank']}": {k: v for k, v in r["launches"].items()
                                  if v} for r in recs}


def phase9d_timelapse(mesh, p8):
    """``correlate_spectrograms(mesh=)`` of one (pair, band) stack of
    phase 8d, held to 8d's mesh=None cells: peaks within P7_TOL
    relative, shifts equal but for near-ties, checked in float64 as 8d
    checks them and counted."""
    from xcorr_tpu_torch.scripts.timelapse import correlate_spectrograms
    stack, (pk, df_, dl_), label = p8["tl_stack"]
    iu, ju = np.triu_indices(stack.shape[0])
    (gpk, gdf, gdl), t_mesh = timed(
        lambda: correlate_spectrograms(stack, iu, ju, mesh=mesh))
    _, t_one = timed(
        lambda: correlate_spectrograms(stack, iu, ju, device="cuda"))
    err = rel_err(gpk, pk)
    check(err <= P7_TOL, f"9d: peaks {err} from mesh=None")
    ties = 0
    for n in np.flatnonzero((gdf != df_) | (gdl != dl_)):
        a, b = stack[iu[n]], stack[ju[n]]
        gap = abs(shift_value(a, b, gdf[n], gdl[n])
                  - shift_value(a, b, df_[n], dl_[n]))
        check(gap <= 2 * P7_TOL, f"9d cell {n}: shifts ({gdf[n]}, "
                                 f"{gdl[n]}) and ({df_[n]}, {dl_[n]}), "
                                 f"{gap} apart")
        ties += 1
    phase(9, f"9d correlate_spectrograms(mesh=) of {label}, stack "
             f"{stack.shape}, {iu.size} cells: peaks within {err:.2e} of "
             f"mesh=None (bit-identical: {bool(np.array_equal(gpk, pk))}), "
             f"shifts equal but for {ties} near-ties; {t_mesh:.3f} s "
             f"sharded, {t_one:.3f} s unsharded")



#: phase 10: the four-step's XLA-form branches (plan keywords)
P10_BRANCHES = {"fft": {"stageb": "fft"}, "matmul": {"stageb": "matmul"},
                "packed": {"stageb": "fft", "packed": True}}
#: phase 10c: every route of the four-step (plan keywords)
P10_ROUTES = {"corr": {"route": "corr"}, "acc": {"route": "acc"},
              "full": {"route": "full"}, "fft": {"stageb": "fft"},
              "matmul": {"stageb": "matmul"}}
PACKED_ATOL = 1e-5       # packed branch vs float64: |Z|^2 differences
DEFAULT_ATOL = 1e-4      # precision='default' (TF32) vs float64
#: cuBLAS's TF32 GEMM kernels, by name (the port's own gemm_tf32_kernel
#: instances are told apart by their pass count)
TF32_GEMM = re.compile(r"tf32|1688|16816", re.I)
#: profiler sessions of 10c per call: at most under 'default' (until a
#: TF32 GEMM is named), always under 'high' (none may be)
P10_DEFAULT_SESSIONS, P10_HIGH_SESSIONS = 20, 5


def ccf_err(out, oracle):
    """Max abs error of the first two windows against their oracle."""
    oh = out[:2].double().cpu().numpy()
    return max(float(np.abs(oh[i] - oracle[i]).max()) for i in range(2))


def phase10a_k2(ff, plan, pair_plan):
    """K2 against its plain version at the 'fft' branch's day-scale
    shapes: (16, 2, 576, 16384) with all of T, and (16, 2, 288, 16384)
    with T's rows 288-575 (a 2-way seq split's second entry), within
    K_RTOL, bit-identical reruns, times, bounds and cuFFT's time on the
    same planes; then at the pair-day's (8, 2, 265, 16384) with
    ``pair_plan``'s constants (n1 = 528), cuFFT's time beside it too.
    Returns the full shape's record."""
    rec = None
    dev = torch.device("cuda", 0)
    for lo in (0, plan.N1 // 2):
        H = plan.N1 - lo
        T = plan.row_consts(dev, lo, plan.N1)[1]
        d = kernel_inputs(16, H, plan.N2, 8, 5, SEED + lo, (None, None, T))
        label = f"(16, 2, {H}, {plan.N2}) T rows {lo}-{plan.N1 - 1}"
        r = phase3_k2(ff, label, d["ax"], d["ay"], T, rtol=K_RTOL,
                      library=True, tag=10)
        rec = rec or r
        del d, T
    # and at phase 3's pair-day shape (H = 265), with cuFFT beside it
    p = pair_plan
    d = kernel_inputs(8, p.half, p.N2, p.rows_in, p.rows_out, SEED,
                      p.device_consts("cuda"))
    phase3_k2(ff, f"(8, 2, {p.half}, {p.N2}) pair-day", d["ax"], d["ay"],
              d["T"], library=True, tag=10)
    del d
    torch.cuda.empty_cache()
    return rec


def phase10b_branches(ff, fft4, x, y, imin, imax, oracle):
    """The 'fft', 'matmul' and packed branches on phase 4's 16 windows:
    error against the float64 oracle (CCF_ATOL; packed PACKED_ATOL), the
    peak on the injected delay, K2's launches (2 + 1; packed 1 + 1; none
    for 'matmul'), ms per window, peak working memory. Returns K2's
    launches on the 'fft' branch."""
    B = x.shape[0]
    launches = None
    for label, kw in P10_BRANCHES.items():
        plan = fft4.plan_correlate4(N, imin, imax, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ff.reset_launches()
        out = plan(x, y)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        counts = {k: v for k, v in ff.launches.items() if v}
        want = {} if label == "matmul" else {
            "stageb_fwd": 1 if label == "packed" else 2, "stageb_inv": 1}
        check(counts == want, f"10b {label}: launched {counts}, expected "
                              f"{want}")
        check(tuple(out.shape) == (B, imax - imin)
              and bool(torch.isfinite(out).all()), f"10b {label}: result")
        err = ccf_err(out, oracle)
        limit = PACKED_ATOL if label == "packed" else CCF_ATOL
        check(err <= limit, f"10b {label}: CCF error {err} > {limit}")
        peak = int(out[0].argmax()) + imin - (N - 1)
        check(peak == int(DELAY * FS), f"10b {label}: peak at {peak}")
        del out
        ms = median_ms(lambda: plan(x, y), 5) / B
        plane = B * 2 * plan.N1 * plan.N2 * 4 / 1e9
        phase(10, f"10b stageb={kw['stageb']}"
                  f"{' packed' if label == 'packed' else ''}: {B} x {N}, "
                  f"N1={plan.N1} (all rows) N2={plan.N2}: max abs vs f64 "
                  f"{err:.3e} (limit {limit}), {ms:.4f} ms per window, "
                  f"launches {counts}, peak working memory {peak_gb:.2f} GB "
                  f"({peak_gb / plane:.1f} planes of {plane:.2f} GB)")
        if label == "fft":
            launches = dict(counts)
    torch.cuda.empty_cache()
    return launches


def device_kernels(fn, done, tries):
    """``(names, sessions)``: the names of the kernels and copies the card
    ran in ``fn()``, read by ``torch.profiler`` (CPU and CUDA activity)
    in new sessions, gathered until ``done(names)`` holds or ``tries``
    sessions have run, and the number of sessions. After minutes of a
    run, a session of the card's torch 2.11 may report none or only
    some of the card's events (PERF.md section 7)."""
    from torch.profiler import ProfilerActivity, profile
    card = torch.autograd.DeviceType.CUDA
    names = set()
    for n in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names |= {e.key for e in prof.key_averages() if e.device_type == card}
        if done(names):
            break
    return sorted(names), n


def tf32_gemm(name):
    """Whether kernel ``name`` is a one-pass TF32 product: cuBLAS's TF32
    GEMM, or K3's and K4's product with one pass (its three-pass
    instance is ``'high'``'s)."""
    if "gemm_tf32_kernel" in name:
        return ", 1>" in name
    return bool(TF32_GEMM.search(name))


def day_lags(xt):
    """``(index_min, index_max)`` of the production lag window of a 24 h
    window at 50 Hz, 0-9 h."""
    ds = xt.init(pair=PAIR, starttime="2014-02-01",
                 endtime="2014-02-01T03:00", preprocess={"EDH": EDH},
                 attrs={"institution": "x", "author": "x", "source": "x"},
                 sampling_rate=FS, window_length=WINDOW,
                 window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG)
    lag = ds.coords["lag"].attrs
    return int(lag["index_min"]), int(lag["index_max"])


def ccf_digest(out):
    """sha256 of a CCF tensor's bytes."""
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def kernel_names(out_path):
    """10c's profiler reads in a process of their own
    (``--kernel-names``): on phase 4's seeded windows, every route of
    :data:`P10_ROUTES` under ``'high'`` and ``'default'``, the names of
    the kernels the card ran (:func:`device_kernels`: ``'default'`` read
    until a TF32 GEMM is named, at most :data:`P10_DEFAULT_SESSIONS`
    sessions; ``'high'`` always :data:`P10_HIGH_SESSIONS`), the sessions
    read and the sha256 of the call's CCFs, written to ``out_path`` as
    JSON. After minutes of a process, the card's torch 2.11 profiler may
    name some of a call's kernels in no session: on an H100, ten minutes
    into this script, the ``matmul`` route's TF32 GEMM went unnamed in 20
    of 20 sessions, though every such call gives the TF32 product's
    CCFs; a new process named it in 25 of 25."""
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import xcorr_tpu_torch as xt
    from xcorr_tpu_torch.ops import fft4
    set_route("corr")
    imin, imax = day_lags(xt)
    x, y = day_windows()
    rec = {}
    for name, kw in P10_ROUTES.items():
        for prec in ("high", "default"):
            plan = fft4.plan_correlate4(N, imin, imax, precision=prec, **kw)
            out = plan(x, y)
            if prec == "default":
                keys, n = device_kernels(
                    lambda: plan(x, y),
                    lambda ks: any(map(tf32_gemm, ks)),
                    P10_DEFAULT_SESSIONS)
            else:
                keys, n = device_kernels(lambda: plan(x, y),
                                         lambda ks: False, P10_HIGH_SESSIONS)
            rec[f"{name} {prec}"] = {"keys": keys, "sessions": n,
                                     "digest": ccf_digest(out)}
            del plan, out
    check("jax" not in sys.modules, "the kernel-name process imported jax")
    with open(out_path, "w") as f:
        json.dump(rec, f)


def kernel_names_run():
    """:func:`kernel_names` in a new process on the card; its record."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as outdir:
        path = os.path.join(outdir, "names.json")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--kernel-names",
             path], cwd=here, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        try:
            out = proc.communicate(timeout=WORKER_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            fail(f"10c: the kernel-name process ran past {WORKER_TIMEOUT} s")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        check(proc.returncode == 0, f"10c: the kernel-name process exited "
                                    f"{proc.returncode}:\n{out[-4000:]}")
        with open(path) as f:
            return json.load(f)


def phase10c_precision(fft4, x, y, imin, imax, oracle):
    """precision='default' against 'high' on every route: errors against
    the oracle (CCF_ATOL and DEFAULT_ATOL), ms per window, outputs that
    differ, TF32 GEMMs by kernel name under 'default' and none under
    'high', read in a new process on the same seeded windows
    (:func:`kernel_names`), whose CCFs must be this process's, bit for
    bit; then the TF32 switches as they were and a 'high' call still
    within CCF_ATOL."""
    B = x.shape[0]
    switches = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    named = kernel_names_run()
    names_s = time.perf_counter() - t0
    sessions = {}
    for name, kw in P10_ROUTES.items():
        res = {}
        for prec in ("high", "default"):
            plan = fft4.plan_correlate4(N, imin, imax, precision=prec, **kw)
            out = plan(x, y)
            got = named[f"{name} {prec}"]
            check(ccf_digest(out) == got["digest"],
                  f"10c {name} {prec}: the kernel-name process's CCFs "
                  f"differ from this process's")
            keys = got["keys"]
            sessions[f"{name} {prec}"] = got["sessions"]
            tf32 = [k for k in keys if tf32_gemm(k)]
            res[prec] = (out, ccf_err(out, oracle),
                         median_ms(lambda: plan(x, y), 5) / B,
                         [k for k in tf32 if "gemm_tf32_kernel" not in k],
                         [k for k in tf32 if "gemm_tf32_kernel" in k], keys)
        (oh, eh, mh, ch, nh, kh), (od, ed, md, cd, nd, kd) = (
            res["high"], res["default"])
        diff = (oh - od).abs().max().item()
        if not (cd or nd) or ch or nh:
            phase(10, f"10c {name}: GEMMs named under 'high' "
                      f"{[k[:60] for k in kh if 'gemm' in k.lower()]}; "
                      f"under 'default' "
                      f"{[k[:60] for k in kd if 'gemm' in k.lower()]}")
        check(any("gemm" in k.lower() for k in kh),
              f"10c {name}: the profiler named no GEMM under 'high' in "
              f"{P10_HIGH_SESSIONS} sessions")
        check(eh <= CCF_ATOL, f"10c {name} 'high': CCF error {eh}")
        check(ed <= DEFAULT_ATOL, f"10c {name} 'default': CCF error {ed} > "
                                  f"{DEFAULT_ATOL}")
        check(diff > 0, f"10c {name}: 'default' equals 'high'")
        check(bool(cd or nd), f"10c {name}: no TF32 GEMM under 'default'")
        check(not ch and not nh, f"10c {name}: TF32 GEMMs under 'high': "
                                 f"{ch + nh}")
        phase(10, f"10c {name}: 'high' max abs vs f64 {eh:.3e}, {mh:.4f} ms "
                  f"per window; 'default' {ed:.3e} (limit {DEFAULT_ATOL}), "
                  f"{md:.4f} ms per window ({mh / md:.2f}x); max |default - "
                  f"high| {diff:.3e}; TF32 GEMMs under 'default': cuBLAS "
                  f"{[k[:60] for k in cd]}, one-pass gemm_tf32_kernel "
                  f"{len(nd)}; under 'high': none")
        del res, oh, od
    phase(10, f"10c profiler sessions read by route and precision in a "
              f"new process ('default': until a TF32 GEMM was named; its "
              f"CCFs this process's, bit for bit; {names_s:.1f} s): "
              f"{sessions}")
    now = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    check(now == switches, f"10c: TF32 switches {switches} -> {now}")
    err = ccf_err(fft4.plan_correlate4(N, imin, imax, route="corr")(x, y),
                  oracle)
    check(err <= CCF_ATOL, f"10c: 'high' after 'default': {err}")
    phase(10, f"10c after the 'default' calls: TF32 switches (matmul, "
              f"cudnn) {now}, as before; a 'high' corr call {err:.3e} from "
              f"f64")
    torch.cuda.empty_cache()


def phase10d_mesh(ff, fft4, x, y, imin, imax, oracle):
    """The 'fft' and 'matmul' branches on phase 4's windows over the
    logical mesh as ("seq",) of 2 and ("batch", "seq") of (1, 2): within
    CCF_ATOL of unsplit (bit-identity reported) and of the float64
    oracle, K2's launches per entry, the split's overhead per window;
    stageb='pallas' with a mesh raises. Returns the launches."""
    from xcorr_tpu_torch.parallel import make_mesh
    B = x.shape[0]
    meshes = {"('seq',) of 2": make_mesh(devices=MESH_DEVICES,
                                         axis_names=("seq",)),
              "('batch', 'seq') of (1, 2)": make_mesh(
                  devices=MESH_DEVICES, axis_names=("batch", "seq"),
                  shape=(1, 2))}
    launches = {}
    for stageb in ("fft", "matmul"):
        one = fft4.plan_correlate4(N, imin, imax, stageb=stageb)
        want = one(x, y)
        t_one = median_ms(lambda: one(x, y), 5)
        for label, mesh in meshes.items():
            plan = fft4.plan_correlate4(N, imin, imax, stageb=stageb,
                                        mesh=mesh)
            ff.reset_launches()
            got = plan(x, y)
            torch.cuda.synchronize()
            counts = {k: v for k, v in ff.launches.items() if v}
            expect = {} if stageb == "matmul" else {
                "stageb_fwd": 2 * mesh.size, "stageb_inv": mesh.size}
            check(counts == expect, f"10d {stageb} {label}: launched "
                                    f"{counts}, expected {expect}")
            diff = (got - want).abs().max().item()
            check(diff <= CCF_ATOL, f"10d {stageb} {label}: {diff} from "
                                    "unsplit")
            err = ccf_err(got, oracle)
            check(err <= CCF_ATOL, f"10d {stageb} {label}: CCF error {err}")
            t = median_ms(lambda: plan(x, y), 5)
            phase(10, f"10d stageb={stageb} mesh {label} on {MESH_DEVICES}: "
                      f"launches {counts}, max |split - unsplit| "
                      f"{diff:.3e} (bit-identical: {diff == 0.0}), max abs "
                      f"vs f64 {err:.3e} (unsplit "
                      f"{ccf_err(want, oracle):.3e}); ms per window split "
                      f"{t / B:.4f}, unsplit {t_one / B:.4f} (overhead "
                      f"{(t - t_one) / B:+.4f})")
            launches[f"10d {stageb} {label}"] = counts
            del got
        del want
    try:
        fft4.plan_correlate4(N, imin, imax, mesh=meshes["('seq',) of 2"])
        fail("10d: stageb='pallas' with a mesh did not raise")
    except ValueError as e:
        check("single-chip" in str(e), f"10d: {e}")
        phase(10, f"10d stageb='pallas' with a mesh raises: {e}")
    torch.cuda.empty_cache()
    return launches


def engine_run(xt, ff, precision=None):
    """Phase 6's 4 pair-days through ``device_process_bulk`` +
    ``finalize`` with ``XCORR_CC_PRECISION`` set to ``precision`` (unset
    for None): the datasets, wall seconds and launches."""
    from xcorr_tpu_torch.parallel.engine import device_process_bulk
    inv, client, days, dataset = engine_setup(xt)
    dss = [dataset(d) for d in days]
    if precision is not None:
        os.environ["XCORR_CC_PRECISION"] = precision
    try:
        ff.reset_launches()
        t0 = time.perf_counter()
        finalize, fallback = device_process_bulk(dss, client, inventory=inv,
                                                 verb=0, device="cuda")
        finalize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("XCORR_CC_PRECISION", None)
    check(not fallback, f"engine fell back: {fallback}")
    return dss, wall, {k: v for k, v in ff.launches.items() if v}


def phase10e_engine(xt, ff, ref, ref_wall):
    """``XCORR_CC_PRECISION=default`` through phase 6's device engine on
    its 4 pair-days: K1 once, statuses and peaks as phase 6, CCFs against
    the 'high' run ``ref`` (within DEFAULT_ATOL, reported), the warm
    wall. Returns the launches."""
    dss, wall, counts = engine_run(xt, ff, "default")
    check(counts == {"fused_corr": 1}, f"10e: launched {counts}")
    diff = 0.0
    for d, (cc_ref, status_ref) in zip(dss, ref):
        check(np.array_equal(d["status"].values, status_ref),
              f"10e: statuses {d['status'].values.tolist()}")
        ccv = d["cc"].values
        check(bool(np.isfinite(ccv).all()), "10e: non-finite CCF")
        lag = d.coords["lag"].values
        peaks = [float(lag[int(np.argmax(ccv[0, i]))])
                 for i in range(ccv.shape[1])]
        check(all(abs(p - DELAY) < 1.0 / FS + 1e-9 for p in peaks),
              f"10e: CCF peaks {peaks} s")
        diff = max(diff, float(np.abs(ccv - cc_ref).max()))
    check(0 < diff <= DEFAULT_ATOL, f"10e: CCFs {diff} from 'high'")
    phase(10, f"10e XCORR_CC_PRECISION=default, device_process_bulk of "
              f"{len(dss)} pair-days: {wall:.2f} s wall ('high', phase 6 "
              f"warm: {ref_wall:.2f} s), launches {counts}, statuses "
              f"equal, peaks on the delay, max |CCF - 'high'| {diff:.3e}")
    return counts


def phase10(xt, ff, fft4, imin, imax, oracle, ref, ref_wall):
    """The four-step's 'fft' and 'matmul' branches, packed, their seq
    split and the precision knob at day scale (10a-10e). Returns K2's
    record at the branch's shape, its launches on the 'fft' branch and
    the phase's launches by part."""
    plan = fft4.plan_correlate4(N, imin, imax, stageb="fft")
    check((plan.N1, plan.N2) == (576, 16384),
          f"'fft' geometry {(plan.N1, plan.N2)}")
    rec = phase10a_k2(ff, plan, fft4.plan_correlate4(
        N, imin, imax, normalize=True, route="corr"))
    x, y = day_windows()
    k2 = phase10b_branches(ff, fft4, x, y, imin, imax, oracle)
    phase10c_precision(fft4, x, y, imin, imax, oracle)
    path = {"10b fft": k2}
    path.update(phase10d_mesh(ff, fft4, x, y, imin, imax, oracle))
    del x, y
    torch.cuda.empty_cache()
    path["10e engine"] = phase10e_engine(xt, ff, ref, ref_wall)
    return rec, k2, path


#: phase 11: the production CLI over an SDS archive on this machine
P11_PAIR = "IM.H10N1..EDH-IM.H03S1..EDH"
P11_DAYS = ("2014-02-01", "2014-02-02")
#: archive days: the window buffer before the first pair-day, and each
#: pair-day's last 24 h window, which starts at 21:00
P11_ARCHIVE = pd.date_range("2014-01-31", "2014-02-04", freq="1D")


#: phase 11's BHZ-EDH pair-days (both days) and BHR-EDH pair-day (the
#: first day alone)
P11_BHZ_PAIR = BHZ_PAIR
P11_BHR_PAIR = BHR_PAIR
P11_BHZ = "IU.RAR.10.BHZ"
#: the source train's weight on each raw BH component: BHZ carries it
#: whole, BH1 and BH2 as the radial component of ``BHR_BAZ``
P11_BH_GAIN = {"Z": 1.0, "1": -math.cos(math.radians(BHR_BAZ)),
               "2": -math.sin(math.radians(BHR_BAZ))}
#: phase 6's BHZ response, on every BH channel
P11_PAZ = {"poles": [-0.037 + 0.037j, -0.037 - 0.037j], "zeros": [0j, 0j],
           "gain": 1.0, "sensitivity": 2.5e8}


def phase11_inventory(path):
    """Phase 6's EDH inventory (sensitivity 1.5e9 counts per unit) for
    the phase's two EDH stations and its BHZ PAZ for ``IU.RAR.10.BHZ``,
    ``BH1``, ``BH2`` and ``BHR``, written as the CLI's
    ``--inventory``."""
    from xcorr_tpu_torch.stream import Channel, Inventory, PAZResponse
    resp = PAZResponse(sensitivity=1.5e9)
    inv = Inventory([
        Channel("IM", "H10N1", "", "EDH", latitude=-6.34, longitude=71.01,
                response=resp),
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8,
                response=resp)] + [
        Channel("IU", "RAR", "10", cha, latitude=-21.2, longitude=-159.8,
                response=PAZResponse(**P11_PAZ))
        for cha in ("BHZ", "BH1", "BH2", "BHR")])
    inv.to_json(path)
    return inv


def phase11_synth(noise=30.0, delays=None):
    """Phase 11's 250 Hz generator: seeded noise of ``noise`` counts and
    the shared source train, each receiver ``delays`` s late."""
    from xcorr_tpu_torch.stream import SyntheticClient
    return SyntheticClient(
        sampling_rate=RAW_FS, noise_amplitude=noise, source_amplitude=600.0,
        source_period=600.0, seed=SEED, delays=delays or {})


def phase11_bh_days(day, noise=30.0, delay=-DELAY):
    """A day of ``IU.RAR.10.BH1``, ``BH2`` and ``BHZ`` raw at 40 Hz that
    carry phase 11's source train in seconds: the train made at 250 Hz
    ``delay`` s late (early, since the pair's first receiver is the late
    one), resampled by 4/25 (a zero-phase FIR), weighted by
    ``P11_BH_GAIN``, plus each component's own seeded noise. Returns the
    Traces by component."""
    from scipy.signal import resample_poly
    from xcorr_tpu_torch.stream import Stats, Trace
    (src,) = phase11_synth(0.0, {P11_BHZ: delay})._synthesize_day(
        P11_BHZ, day)
    train = resample_poly(src.data.astype(np.float64), 4, 25)
    doy = pd.Timestamp(day).dayofyear
    net, sta, loc, _ = P11_BHZ.split(".")
    out = {}
    for c, gain in P11_BH_GAIN.items():
        rng = np.random.default_rng([SEED, doy] if c == "Z"
                                    else [SEED, doy, int(c)])
        data = gain * train + noise * rng.standard_normal(train.size)
        out[c] = Trace(data.astype(np.float32), Stats(
            network=net, station=sta, location=loc, channel="BH" + c,
            starttime=src.stats.starttime, sampling_rate=BH_FS))
    return out


def phase11_chain_lag(inv, bh="BHZ", hours=4):
    """Lag (s) of the CCF peak of the production EDH chain's and the
    ``bh`` chain's outputs (``BHZ`` or ``BHR``) for phase 11's noise-free
    source train, the first ``hours`` of a day: where the pair-day of
    ``bh`` and EDH peaks beyond the delay."""
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.stream import Stream
    from xcorr_tpu_torch.stream.process import process as run_chain
    chains = default_config()[0]["preprocess"]
    day = P11_DAYS[0]
    (edh,) = phase11_synth(0.0)._synthesize_day("IM.H03S1..EDH", day)
    bhs = phase11_bh_days(day, 0.0, 0.0)
    out = []
    for traces, cha in (([edh], "EDH"), (
            [bhs["Z"]] if bh == "BHZ" else list(bhs.values()), bh)):
        for tr in traces:
            tr.data = tr.data[:int(hours * 3600 * tr.stats.sampling_rate)]
            tr.stats.npts = tr.data.size
        ops = [o for o in chains[cha] if o[0] not in ("merge", "trim")]
        out.append(run_chain(Stream(traces), ops, inventory=inv)
                   .select(channel=cha)[0].data)
    return peak_lag(*out)


def phase11_archive(root):
    """A miniSEED SDS archive of the EDH stations, 250 Hz raw, seeded
    noise with a shared source train, H10N1 ``DELAY`` s late, and of
    ``IU.RAR.10.BH1``, ``BH2`` and ``BHZ`` at 40 Hz with the same train
    ``DELAY`` s early: one day file per channel and day, each written
    whole by ``SDSArchive(format="mseed").write`` (Steim1, int32 counts).
    Returns the day files, the bytes written and the seconds the writes
    took."""
    from xcorr_tpu_torch.stream import Stream
    from xcorr_tpu_torch.stream.sds import SDSArchive
    synth = phase11_synth(delays={"IM.H10N1..EDH": DELAY,
                                  "IM.H03S1..EDH": 0.0})
    archive = SDSArchive(root, format="mseed")
    paths, seconds = [], 0.0
    for day in P11_ARCHIVE:
        traces = [synth._synthesize_day(r, day)[0]
                  for r in P11_PAIR.split("-")]
        for tr in [*traces, *phase11_bh_days(day).values()]:
            t0 = time.perf_counter()
            archive.write(Stream([tr]))
            seconds += time.perf_counter() - t0
            s = tr.stats
            paths.append(archive.path(s.network, s.station, s.location,
                                      s.channel, s.starttime))
    return paths, sum(map(os.path.getsize, paths)), seconds


def phase11_mixed_file():
    """A small miniSEED buffer of what a day file of a real archive may
    hold: two stations' records interleaved one for one, each station in
    pieces with gaps and overlaps, records of 512 and 4096 bytes."""
    from xcorr_tpu_torch.native.mseed import encode_mseed
    from xcorr_tpu_torch.stream import Stats, Trace
    rng = np.random.default_rng(SEED)
    t0 = pd.Timestamp(P11_DAYS[0]).value / 1e9
    recs = {}
    for sta, starts in (("H10N1", (0.0, 8.0, 30.0, 36.0, 35.0)),
                        ("H03S1", (0.0, 7.996, 20.0, 60.0, 59.5))):
        recs[sta] = []
        for i, start in enumerate(starts):
            reclen = 4096 if i == 2 else 512
            payload = encode_mseed(Trace(
                np.round(1e3 * rng.standard_normal(2000)).astype(np.int32),
                Stats(network="IM", station=sta, location="",
                      channel="EDH", starttime=t0 + start,
                      sampling_rate=RAW_FS)), reclen=reclen)
            recs[sta] += [payload[j:j + reclen]
                          for j in range(0, len(payload), reclen)]
    merged, a, b = [], recs["H10N1"], recs["H03S1"]
    for k in range(max(len(a), len(b))):
        merged += a[k:k + 1] + b[k:k + 1]
    return b"".join(merged)


def phase11_reads_equal(paths):
    """Every day file and the mixed buffer through ``read_mseed_bytes``
    and through the per-record plain path: the same Traces, bit for bit.
    Returns the files' seconds by each path and the mixed buffer's
    trace count."""
    from xcorr_tpu_torch.native import mseed
    payloads = []
    for path in paths:
        with open(path, "rb") as fh:
            payloads.append(fh.read())
    payloads.append(phase11_mixed_file())
    fast_s = plain_s = 0.0
    for payload in payloads:
        t0 = time.perf_counter()
        got = mseed.read_mseed_bytes(payload)
        t1 = time.perf_counter()
        want = mseed._read_mseed_bytes_plain(payload)
        t2 = time.perf_counter()
        fast_s, plain_s = fast_s + t1 - t0, plain_s + t2 - t1
        check(len(got) == len(want), f"{len(got)} runs, plain {len(want)}")
        for g, w in zip(got, want):
            check(g.id == w.id and g.stats.starttime.ns == w.stats
                  .starttime.ns and g.stats.sampling_rate == w.stats
                  .sampling_rate and g.stats.npts == w.stats.npts
                  and g.data.dtype == w.data.dtype
                  and g.data.tobytes() == w.data.tobytes()
                  and list(g.stats) == list(w.stats),
                  f"read_mseed_bytes differs from the plain path: {g} "
                  f"against {w}")
    return fast_s, plain_s, len(got)


def carried_merge_bytes(traces):
    """Bytes the carried window read allocates for ``traces``: a copy of
    each day file's samples out of the cache, and each id's merged union
    (float64 for integer samples) before its trim."""
    groups = {}
    for tr in traces:
        groups.setdefault((tr.id, tr.stats.sampling_rate), []).append(tr)
    union = 0
    for (_, fs), group in groups.items():
        t0 = min(tr.stats.starttime for tr in group)
        t1 = max(tr.stats.endtime for tr in group)
        dtype = np.result_type(*(tr.data.dtype for tr in group))
        union += (int(round((t1 - t0) * fs)) + 1) * (
            dtype.itemsize if np.issubdtype(dtype, np.floating) else 8)
    return sum(tr.data.nbytes for tr in traces) + union


P11_WINDOW = ("IM.H03S1..EDH", "2014-02-02")


def merge_hypotheses(traces, start, end, threads=8, reps=5):
    """What a 250 Hz window merge costs, part by part, on this machine's
    host: ``traces`` the day files' read-only views, ``[start, end]`` the
    window. One thread, medians of ``reps``: ``np.zeros`` of the window
    (``calloc``, which clears a reused heap chunk) against ``np.empty``;
    the fill from the views (the int32 -> float64 cast) against a float64
    copy of the same count. Then ``threads`` at once, each in its own
    thread, as the campaign's fetch threads run: merges (``np.zeros`` and
    the fill), with their slowest allocation call and the minor page
    faults the thread and the process counted; fills into buffers the
    threads touched before (no allocation, no first touch: the memory's
    bandwidth alone); merges inside a chain, each into the buffer its
    thread keeps (``_steps.window_array``), the first round into new
    arrays (from the heap the merges above freed) and the second into
    the same buffers again; and the EDH
    chain's bandpass (``sosfilt``) over a 2 MB slice, which stays in the
    caches (the cores alone). Returns the text."""
    import resource
    from concurrent.futures import ThreadPoolExecutor
    from xcorr_tpu_torch.stream import _steps, _window
    n = _window.merge_window(traces, start, end)[0].stats.npts
    src = np.ones(n)

    def med(fn):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return float(np.median(out))

    def fill(dst):
        k = 0
        for tr in traces:
            m = min(tr.data.size, n - k)
            dst[k:k + m] = tr.data[:m]
            k += m
            if k == n:
                break
        return dst

    zeros, empty = med(lambda: np.zeros(n)), med(lambda: np.empty(n))
    cast = med(lambda: fill(np.empty(n)))
    copy64 = med(lambda: np.copyto(np.empty(n), src))

    def merge(_):
        f0, t0 = thread_faults(), time.perf_counter()
        buf = np.zeros(n)
        t1 = time.perf_counter()
        fill(buf)
        return time.perf_counter() - t0, t1 - t0, thread_faults() - f0

    together = threading.Barrier(threads)

    def buffered(_):
        """One merge inside a chain, every thread at once (the barrier
        gives each of ``threads`` calls a thread of its own)."""
        together.wait(60)
        with _steps.chain():
            t0 = time.perf_counter()
            _window.merge_window(traces, start, end)
            return time.perf_counter() - t0

    import scipy.signal as sp_signal
    sos = sp_signal.butter(4, [3.0 / 125.0, 20.0 / 125.0], btype="bandpass",
                           output="sos")
    small = np.random.default_rng(SEED).standard_normal(1 << 18)

    def bandpass(x):
        return sp_signal.sosfilt(sos, x)

    def process_faults():
        return resource.getrusage(resource.RUSAGE_SELF).ru_minflt

    alone = med(lambda: bandpass(small))
    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(merge, range(threads)))  # the threads' first touch
        f0, t0 = process_faults(), time.perf_counter()
        runs = list(ex.map(merge, range(threads)))
        wall = time.perf_counter() - t0
        pf = process_faults() - f0
        bufs = [fill(np.empty(n)) for _ in range(threads)]
        t0 = time.perf_counter()
        refills = list(ex.map(lambda b: timed_call(fill, b), bufs))
        refill_wall = time.perf_counter() - t0
        del bufs
        t0 = time.perf_counter()
        calls = list(ex.map(lambda x: timed_call(bandpass, x),
                            [small.copy() for _ in range(threads)]))
        calls_wall = time.perf_counter() - t0
        rounds = []
        for _ in range(2):
            t0 = time.perf_counter()
            each = list(ex.map(buffered, range(threads)))
            rounds.append((time.perf_counter() - t0, each))
    moved = threads * n * (8 + traces[0].data.dtype.itemsize)
    return (f"{n} samples, {traces[0].data.dtype} views -> float64; one "
            f"thread: np.zeros {zeros:.4f} s, np.empty {empty:.6f} s; the "
            f"fill from the views {cast:.4f} s, a float64 copy of as many "
            f"{copy64:.4f} s; {threads} merges (np.zeros + fill) in "
            f"{threads} threads {wall:.4f} s wall, each "
            f"{float(np.median([r[0] for r in runs])):.4f} s median "
            f"(alone: {zeros + cast:.4f}), {moved / wall / 1e9:.2f} GB/s "
            f"summed, the slowest np.zeros call "
            f"{max(r[1] for r in runs):.4f} s, minor page faults "
            f"{sum(r[2] for r in runs) * 4096 / 1e6:.0f} MB by the "
            f"threads' counters, {pf * 4096 / 1e6:.0f} MB by the "
            f"process's; {threads} fills into buffers touched before "
            f"{refill_wall:.4f} s wall, each "
            f"{float(np.median(refills)):.4f} s median (alone: "
            f"{cast:.4f}), {moved / refill_wall / 1e9:.2f} GB/s summed; "
            f"{threads} merges in a chain at once, each into its "
            f"thread's buffer: a new array {rounds[0][0]:.4f} s wall, each "
            f"{float(np.median(rounds[0][1])):.4f} s median; the kept "
            f"buffer again {rounds[1][0]:.4f} s wall, each "
            f"{float(np.median(rounds[1][1])):.4f} s median; "
            f"the bandpass of a 2 MB slice alone {alone:.4f} s, "
            f"{threads} at once {calls_wall:.4f} s wall, each "
            f"{float(np.median(calls)):.4f} s median")


def window_sosfilt(traces, start, end, inv, threads=8, reps=3):
    """The EDH chain's two ``sosfilt`` calls on one production window of
    this machine's host: the window (``traces`` the day files' views,
    ``[start, end]``) merged, demeaned and divided by its sensitivity, as
    the chain's steps before its bandpass leave it; then the bandpass
    (``butter(4)``, 4 sections) and ``decimate``'s anti-alias low-pass
    (``cheby2(10, 96)``, 5 sections) on the bandpass's output, each by
    the native loop (``_sosfilt.sosfilt_inplace``: four sections to a
    register where the CPU has AVX2) and by scipy's loop in place
    (``_steps._sosfilt_inplace_plain``), medians of ``reps`` alone and
    ``threads`` at once, each output the bytes of this machine's
    ``scipy.signal.sosfilt``. Also inputs whose zeros and NaNs of either
    sign meet in a section: whether this scipy gives the bytes the
    native loop does (reported, not held). Returns the text."""
    import scipy
    import scipy.signal as sp_signal
    from concurrent.futures import ThreadPoolExecutor
    from xcorr_tpu_torch.stream import _sosfilt, _steps, _window
    t0 = time.perf_counter()
    _sosfilt._load()
    load_s = time.perf_counter() - t0
    tr = _window.merge_window(traces, start, end)[0]
    tr.detrend("demean")
    tr.remove_sensitivity(inventory=inv)
    x = tr.data
    fs = tr.stats.sampling_rate
    steps = (("bandpass", sp_signal.butter(4, [3.0 / (fs / 2),
                                               20.0 / (fs / 2)],
                                           btype="bandpass", output="sos")),
             ("low-pass", sp_signal.cheby2(10, 96, 0.98 * fs / 10.0,
                                           btype="lowpass", fs=fs,
                                           output="sos")))
    forms = (("native", _sosfilt.sosfilt_inplace),
             ("scipy's loop", _steps._sosfilt_inplace_plain))
    parts = []
    for name, sos in steps:
        want = sp_signal.sosfilt(sos, x)
        times = {}
        for label, fn in forms:
            alone = []
            for _ in range(reps):
                y = x.copy()
                t0 = time.perf_counter()
                fn(sos, y)
                alone.append(time.perf_counter() - t0)
                check(y.tobytes() == want.tobytes(),
                      f"{name} by {label} differs from scipy "
                      f"{scipy.__version__}'s sosfilt on the window")
            ys = [x.copy() for _ in range(threads)]
            with ThreadPoolExecutor(threads) as ex:
                t0 = time.perf_counter()
                each = list(ex.map(lambda y: timed_call(fn, sos, y), ys))
                wall = time.perf_counter() - t0
            check(all(y.tobytes() == want.tobytes() for y in ys),
                  f"{name} by {label} in {threads} threads differs")
            times[label] = (float(np.median(alone)), wall,
                            float(np.median(each)))
        parts.append(f"{name} ({sos.shape[0]} sections): " + ", ".join(
            f"{label} {a:.4f} s alone, {threads} at once {w:.4f} s wall "
            f"({e:.4f} each)" for label, (a, w, e) in times.items()))
        x = want
    odd = np.zeros(64)
    odd[1::4] = -0.0
    odd[[5, 9, 13, 20, 30, 31]] = [np.nan, -np.nan, np.inf, -np.inf,
                                   5e-324, -5e-324]
    same = all(form(sos, v.copy()).tobytes()
               == sp_signal.sosfilt(sos, v).tobytes()
               for _, sos in steps for v in (odd, -odd)
               for _, form in forms[:1])
    return (f"{x.size} samples at {fs:g} Hz on {host_cpu()} (the native "
            f"loop on "
            f"{'AVX2 lanes' if _sosfilt.lanes() else 'scipy schedule'}), "
            f"scipy {scipy.__version__}: "
            + "; ".join(parts) + f"; every output the bytes of scipy's "
            f"sosfilt; zeros and NaNs of either sign "
            f"{'the same bytes' if same else 'NOT the same bytes'}; the "
            f"library loaded (built if new) in {load_s:.2f} s")


def host_cpu():
    """The host CPU's model name and count, as Linux reports them."""
    try:
        with open("/proc/cpuinfo") as f:
            names = [ln.split(":", 1)[1].strip() for ln in f
                     if ln.startswith("model name")]
    except OSError:
        names = []
    return f"{names[0] if names else 'an unnamed CPU'} x {os.cpu_count()}"


def timed_call(fn, *args):
    """Seconds of ``fn(*args)``."""
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def phase11_window_steps(sds, inv):
    """One 250 Hz window of phase 11's archive (``P11_WINDOW``: the
    window centred on that midnight) fetched and run through the
    production EDH chain alone, in one thread, by step: on the carried
    forms (``plain_host_path(lanczos=False)``) and the port's, in turns
    (carried, port, port, carried), every output the same bits; then the
    window merge's parts (``merge_hypotheses``) and the chain's two
    ``sosfilt`` calls, native and scipy's (``window_sosfilt``). Returns
    the text."""
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.stream import Client, _window
    from xcorr_tpu_torch.util.time import get_dates
    receiver, day = P11_WINDOW
    client = Client(sds_root=sds)
    ops = {"EDH": default_config()[0]["preprocess"]["EDH"]}
    lines, bits = [], None
    for plain in (True, False, False, True):
        form = plain_host_path(lanczos=False) if plain \
            else contextlib.nullcontext()
        with form, chain_stages() as stages:
            st = client.get_processed_waveforms(
                receiver, pd.Timestamp(day), ops, duration=WINDOW,
                inventory=inv, sampling_rate=FS, strict=True)
        check(len(st) == 1, f"window of {receiver}: {st}")
        out = st[0].data.tobytes()
        check(bits is None or out == bits,
              "the window's chain output differs between the forms")
        bits = out
        lines.append(("carried: " if plain else "port: ")
                     + stage_report(stages))
    t = pd.Timestamp(day)
    start = t - pd.Timedelta(seconds=WINDOW * 0.55)
    end = start + pd.Timedelta(seconds=WINDOW * 1.1)
    archive = client.archives[0]
    traces = [tr for d in get_dates(start, end)
              for tr in _window.day_views(archive, receiver, d)]
    return lines, merge_hypotheses(traces, start, end), \
        window_sosfilt(traces, start, end, inv)


def window_remove_response(sds, inv, threads=8, reps=3):
    """One 40 Hz window's ``remove_response`` division on this machine's
    host, by part: the input, ``nfft``, inverse response and taper that
    the production BHZ chain hands ``_steps.deconvolve`` for phase 11's
    window of ``P11_BHZ`` (``P11_WINDOW``'s day), then the cast, ``rfft``,
    product and ``irfft`` of the carried expressions
    (``_deconvolve_plain``) and of the port's form (``deconvolve``: no
    cast of a float64 window, the spectrum in the thread's scratch, the
    products in place, the inverse into the thread's buffer), each in a
    chain's scope. Alone, ``reps`` in turns, the first of each form apart
    (the port's on fresh arrays, later ones on what the thread kept);
    then ``threads`` at once, twice on the same threads (fresh, then
    kept). Every output is the bytes of ``_deconvolve_plain``. Returns
    the text."""
    from concurrent.futures import ThreadPoolExecutor
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.stream import Client, _steps
    got = []
    real = _steps.deconvolve

    def spy(*args):
        got.append((args[0].copy(), *args[1:]))
        return real(*args)
    _steps.deconvolve = spy
    try:
        Client(sds_root=sds).get_processed_waveforms(
            P11_BHZ, pd.Timestamp(P11_WINDOW[1]),
            {"BHZ": default_config()[0]["preprocess"]["BHZ"]},
            duration=WINDOW, inventory=inv, sampling_rate=FS, strict=True)
    finally:
        _steps.deconvolve = real
    x, n, nfft, inv_r, taper = got[0]
    want = _steps._deconvolve_plain(x, n, nfft, inv_r, taper).tobytes()

    def carried():
        t = [time.perf_counter()]
        c = x.astype(np.float64)
        t.append(time.perf_counter())
        spec = np.fft.rfft(c, nfft)
        t.append(time.perf_counter())
        if taper is not None:
            spec *= taper
        prod = spec * inv_r
        t.append(time.perf_counter())
        out = np.fft.irfft(prod, nfft)[:n]
        t.append(time.perf_counter())
        return np.diff(t), out

    def port():
        t = [time.perf_counter()]
        c = _steps.as_float64(x)
        t.append(time.perf_counter())
        with _steps.scratch((nfft // 2 + 1,), np.complex128) as spec:
            np.fft.rfft(c, nfft, out=spec)
            t.append(time.perf_counter())
            if taper is not None:
                np.multiply(spec, taper, out=spec)
            np.multiply(spec, inv_r, out=spec)
            t.append(time.perf_counter())
            out = np.fft.irfft(spec, nfft,
                               out=_steps.buffer((nfft,), np.float64))
        t.append(time.perf_counter())
        return np.diff(t), out[:n]

    forms = {"carried": carried, "port": port}

    def run(form):
        with _steps.chain():
            parts, out = forms[form]()
            same = out.tobytes() == want
            del out
        return parts, same

    alone = {f: [] for f in forms}
    for i in range(reps):
        for f in (forms if i % 2 == 0 else list(forms)[::-1]):
            parts, same = run(f)
            check(same, f"remove_response's {f} form differs from "
                        f"_deconvolve_plain")
            alone[f].append(parts)
    crowd = {f: [] for f in forms}
    for f in forms:
        with ThreadPoolExecutor(threads) as ex:
            for _ in range(2):
                res = list(ex.map(lambda _: run(f), range(threads)))
                check(all(same for _, same in res),
                      f"remove_response's {f} form in {threads} threads "
                      f"differs")
                crowd[f].append(np.median([p for p, _ in res], axis=0))

    def text(parts):
        return "/".join(f"{v:.4f}" for v in parts) + \
            f" = {float(np.sum(parts)):.4f}"

    return (f"{x.size} samples ({x.dtype}) at nfft = {nfft} on "
            f"{host_cpu()}, numpy {np.__version__}; cast/rfft/product/"
            f"irfft s, the first call alone, then the median of the "
            f"{reps - 1} after it, then {threads} at once (medians over "
            f"the threads) fresh and kept: " + "; ".join(
                f"{f} {text(alone[f][0])}, "
                f"{text(np.median(alone[f][1:], axis=0))}; {threads} at "
                f"once {text(crowd[f][0])}, {text(crowd[f][1])}"
                for f in forms)
            + "; every output the bytes of the carried expressions")


def phase11_cli(xt, ff):
    """The production entry point on the card, archive to shards to
    analysis: ``xcorr-torch-cc`` (the host engine, K1 on the ``corr``
    route) writes a shard per pair-day through the port's HDF5 codec,
    first for two EDH-EDH pair-days, then for two BHZ-EDH and one BHR-EDH
    pair-days (the BH chains' response and Lanczos steps on the host),
    each run on a fetch pool of its own (``run_cli``); every shard reads
    back and validates with status 1, peaking at the
    injected delay (the BH ones plus the lag between the two chains), the
    first of each bit-identical to an in-memory ``process`` of the same
    pair-day on the plain path of the read and the response
    (``plain_host_path``); ``xcorr-torch-snr`` reads the EDH-EDH shards
    and matches ``pair_snr`` (on the in-memory dataset, then on the second
    shard). Returns K1's launches in each CLI run."""
    from xcorr_tpu_torch.core import lazy
    from xcorr_tpu_torch.core.process import shutdown_fetch_pool
    from xcorr_tpu_torch.io.netcdf import from_netcdf
    from xcorr_tpu_torch.scripts import cc as cc_cli
    from xcorr_tpu_torch.scripts import snr as snr_cli
    from xcorr_tpu_torch.stream import Client
    from xcorr_tpu_torch.stream import _daycache, _response, _shared, _window
    from xcorr_tpu_torch.stream import sds as sds_mod
    set_route("corr")
    tmp = tempfile.TemporaryDirectory()
    sds, root = os.path.join(tmp.name, "sds"), os.path.join(tmp.name, "cc")
    inv_path = os.path.join(tmp.name, "inventory.json")
    inv = phase11_inventory(inv_path)
    paths, sds_bytes, sds_s = phase11_archive(sds)
    phase(11, f"miniSEED SDS archive: 2 EDH stations at {RAW_FS:g} Hz and "
              f"IU.RAR.10.BH1/BH2/BHZ at {BH_FS:g} Hz x {len(P11_ARCHIVE)} "
              f"days, "
              f"{sds_bytes / 1e6:.1f} MB, each day file written whole by "
              f"SDSArchive.write in {sds_s / len(paths):.3f} s "
              f"({sds_s:.2f} s in all)")
    fast_s, plain_s, nmixed = phase11_reads_equal(paths)
    phase(11, f"read_mseed_bytes equal to the per-record plain path on "
              f"all {len(paths)} day files and a mixed file ({nmixed} "
              f"traces: gaps, overlaps, interleaved ids), bit for bit; "
              f"{fast_s:.3f} s against {plain_s:.3f} s for them all, one "
              f"thread")

    def run_cli(pair, days, out=root):
        """``xcorr-torch-cc`` over ``pair``'s pair-days (a pair, or a list
        of pairs run as one campaign) into ``out`` from an empty
        day-file cache and response cache, its shard writes, day-file
        reads (views of the cache; those that found the decode cached are
        hits), decodes and window merges timed where the campaign makes
        them: wall, K1's and the other launches, write seconds, decodes
        as (seconds, path), reads as (seconds, day), merges as (seconds,
        bytes the merge filled, bytes the carried merge allocates for the
        same traces: a copy of each and the union), and where each merge
        took its array (``window_arrays``: no thread takes a fresh one
        of a key twice, and only the fetch pool's threads fetch for the
        pair-days), from a fetch pool made for the run, which it shuts
        down at its end; the process's peak resident set meanwhile; the
        campaign scope's counts (``stream/_shared.py``), the scope empty
        at the end."""
        pairs = [pair] if isinstance(pair, str) else list(pair)
        writes, decodes, reads, merges, scopes = [], [], [], [], []
        real = (lazy.write, sds_mod._decode_dayfile, _window.day_views,
                _window.merge_window, lazy.WindowScope)

        class Scope(real[4]):
            def __init__(self, plan):
                super().__init__(plan)
                scopes.append(self)

        def timed(fn, out, arg=0):
            def call(*a, **kw):
                t0 = time.perf_counter()
                res = fn(*a, **kw)
                out.append((time.perf_counter() - t0, a[arg] if a else None))
                return res
            return call

        def merge(traces, start, end):
            t0 = time.perf_counter()
            st = real[3](traces, start, end)
            merges.append((time.perf_counter() - t0,
                           sum(tr.data.nbytes for tr in st),
                           carried_merge_bytes(traces)))
            return st

        lazy.write = timed(real[0], writes)
        sds_mod._decode_dayfile = timed(real[1], decodes)
        _window.day_views = timed(real[2], reads, 2)
        _window.merge_window = merge
        lazy.WindowScope = Scope
        _shared.reset_counts()
        _daycache.DAYS.clear()
        _response.RESPONSES.clear()
        shutdown_fetch_pool()
        ff.reset_launches()
        t0 = time.perf_counter()
        try:
            with chain_stages() as stages, window_arrays() as arrays, \
                    peak_rss() as rss:
                rc = cc_cli.main(
                    ["--root", out, "--sds-root", sds]
                    + [a for p in pairs for a in ("--pair", p)]
                    + ["--start", f"{days[0]:%F}", "--end", f"{days[-1]:%F}",
                       "--inventory", inv_path])
                torch.cuda.synchronize()
        finally:
            (lazy.write, sds_mod._decode_dayfile, _window.day_views,
             _window.merge_window, lazy.WindowScope) = real
        wall = time.perf_counter() - t0
        decoded = [p for _, p in decodes]
        check(len(decoded) == len(set(decoded))
              and set(decoded) <= set(paths),
              f"day files decoded more than once: {sorted(decoded)}")
        counts = dict(ff.launches)
        check(rc == 0, f"xcorr-torch-cc returned {rc}")
        check(counts["fused_corr"] > 0,
              f"xcorr-torch-cc never launched fused_corr: {counts}")
        others = {k: v for k, v in counts.items()
                  if k != "fused_corr" and v}
        check(not others, f"xcorr-torch-cc also launched {others}")
        npd = len(days) * len(pairs)
        check(len(writes) == npd, f"{len(writes)} shard writes for {npd} "
                                  f"pair-days")
        shared = _shared.counts()
        check(len(scopes) == 1 and scopes[0].nbytes == 0
              and not scopes[0].planned(),
              f"{pair}: the campaign scope is not empty at the end: "
              f"{[(sc.nbytes, sc.planned()) for sc in scopes]}")
        report, most = window_array_report(arrays)
        check(most <= 1, f"{pair}: a fetch thread took {most} fresh arrays "
                         f"of one key: {report}")
        threads = pool_threads()
        fresh, took = pool_fresh(arrays)
        check(0 < took <= threads, f"{pair}: {took} threads of a fetch pool "
                                   f"of {threads} took arrays")
        shutdown_fetch_pool()
        return wall, counts["fused_corr"], [w for w, _ in writes], \
            decodes, reads, merges, stages, report, threads, rss, fresh, \
            shared

    def cli_line(pair, days, run, shards, shard_reads):
        wall, k1, writes, decodes, reads, merges, _, arrays, threads, \
            rss, fresh, shared = run
        npd = len(days) * (1 if isinstance(pair, str) else len(pair))
        top = max(fresh) if fresh else 0
        mb = [b / 1e6 for _, b, _ in merges]
        carried = [c / 1e6 for _, _, c in merges]
        return (f"xcorr-torch-cc {pair}: {npd} pair-days in "
                f"{wall:.2f} s wall, {wall / npd:.2f} s per pair-day; "
                f"K1 launches {k1}; bytes per shard {shards}; write s per "
                f"shard (in the campaign) {[round(x, 4) for x in writes]}; "
                f"read s per shard {[round(x, 4) for x in shard_reads]}; "
                f"miniSEED day-file reads {len(reads)}: {len(decodes)} "
                f"decodes of {len({p for _, p in decodes})} distinct files "
                f"and {len(reads) - len(decodes)} cache hits; decode s "
                f"{[round(d, 3) for d, _ in decodes]} "
                f"({sum(d for d, _ in decodes):.2f} s summed over the "
                f"campaign's threads); reads "
                f"{sum(r for r, _ in reads):.2f} s summed "
                f"({np.median([r for r, _ in reads]):.3f} s median); "
                f"window merges {len(merges)}: "
                f"{sum(m for m, _, _ in merges):.2f} s summed "
                f"({np.median([m for m, _, _ in merges]):.3f} s median), "
                f"{min(mb):.1f}-{max(mb):.1f} MB filled per window "
                f"(the carried merge {min(carried):.1f}-"
                f"{max(carried):.1f} MB: a copy of each day file and the "
                f"union); one fetch pool of {threads} threads over the "
                f"{npd} pair-days, which took {fresh.get(top, 0)} "
                f"fresh arrays of {top / 1e6:.1f} MB; the chains' arrays: "
                f"{arrays}; peak resident set "
                f"{(rss['peak'] or 0) / 1e9:.2f} GB (at the start "
                f"{(rss['start'] or 0) / 1e9:.2f} GB); the campaign scope: "
                f"{shared['chains']} chains, {shared['hits']} hits, "
                f"{shared['waits']} waits, {shared['bypassed']} bypassed, "
                f"{shared['over_cap']} not kept for the cap, "
                f"{shared['empty']} empty, peak "
                f"{shared['peak_bytes'] / 1e6:.1f} MB held, empty at the "
                f"end")

    def held(pair, days, want_lag):
        """Every shard of ``pair``: read, validate, status, peaks at
        ``want_lag``; the first against an in-memory ``process`` of its
        pair-day (its day files already decoded by the CLI's run).
        Returns the shards' bytes and read seconds and the datasets the
        SNR is held to."""
        init_args, client_args, _, _ = cc_cli.default_config(sds)
        client = Client(**client_args)
        shards, snr_in, shard_reads = [], [], []
        for iday, day in enumerate(days):
            path = xt.ncfile(pair, day, root)
            t0 = time.perf_counter()
            ds = xt.read(path)
            shard_reads.append(time.perf_counter() - t0)
            check(ds is not None, f"{path} did not read back")
            check(xt.io.validate(ds) is not None,
                  f"{path} did not validate")
            status = ds["status"].values
            check(bool((status == 1).all()), f"{pair} {day:%F} status "
                                             f"{status.tolist()}")
            if iday == 0:
                want = xt.init(pair=pair, starttime=day,
                               endtime=day + pd.Timedelta("1D"),
                               **{**init_args, "inventory": inv})
                _response.RESPONSES.clear()
                t0 = time.perf_counter()
                with plain_host_path(lanczos=False):
                    xt.process(want, client, inventory=inv, device="cuda",
                               verb=0)
                    torch.cuda.synchronize()
                mem_wall = time.perf_counter() - t0
                a, b = ds["cc"].values, want["cc"].values
                diff = float(np.abs(a - b).max())
                same = a.dtype == b.dtype and a.tobytes() == b.tobytes()
                check(same, f"{pair} {day:%F}: shard vs in-memory process "
                            f"on the plain path: max |diff| {diff}, "
                            f"dtypes {a.dtype} {b.dtype}")
                versus = (f"bit-identical to an in-memory process on the "
                          f"plain path of the read and the response "
                          f"({mem_wall:.2f} s)")
            else:
                want, versus = ds, "read back"
            lag = ds.coords["lag"].values
            ccv = ds["cc"].values
            peaks = sorted({float(lag[int(np.argmax(ccv[0, i]))])
                            for i in range(ccv.shape[1])})
            check(all(abs(p - want_lag) < 1.0 / FS + 1e-9 for p in peaks),
                  f"{pair} {day:%F}: shard CCF peaks {peaks} s, expected "
                  f"{want_lag} s")
            shards.append(os.path.getsize(path))
            snr_in.append(want)
            phase(11, f"{pair} {day:%F}: shard of {ccv.shape} {ccv.dtype}, "
                      f"status all 1, {versus}, peaks at {peaks} s")
        return shards, shard_reads, snr_in

    days = pd.date_range(*P11_DAYS, freq="1D")
    edh = run_cli(P11_PAIR, days)
    shards, shard_reads, snr_in = held(P11_PAIR, days, DELAY)

    # the SNR CLI over the shards, against pair_snr in memory
    snr_path = os.path.join(tmp.name, "snr.nc")
    t0 = time.perf_counter()
    rc = snr_cli.main([P11_DAYS[0], P11_DAYS[1], "--root", root, "--pair",
                       P11_PAIR, "--out", snr_path])
    torch.cuda.synchronize()
    snr_wall = time.perf_counter() - t0
    check(rc == 0, f"xcorr-torch-snr returned {rc}")
    got = from_netcdf(snr_path)
    want = [snr_cli.pair_snr(d, filter_kwargs={"frequency": 3.0,
                                               "btype": "highpass",
                                               "order": 2},
                             device="cuda") for d in snr_in]
    check(all(w is not None for w in want), "pair_snr gave no SNR")
    want = xt.ndlabel.combine_by_coords(want)
    err = hold_snr(got, want, "xcorr-torch-snr vs pair_snr")
    read_lines = phase11_shard_read(xt, root, days, tmp.name, want, got)
    phase(11, cli_line(P11_PAIR, days, edh, shards, shard_reads))
    phase(11, f"xcorr-torch-cc {P11_PAIR} by chain stage, s summed over "
              f"its fetch threads: {stage_report(edh[6])}")
    t0 = time.perf_counter()
    lines, parts, filters = phase11_window_steps(sds, inv)
    for line in lines:
        phase(11, f"one 250 Hz window of {P11_WINDOW[0]} alone, one thread, "
                  f"by step, {line}")
    phase(11, f"its sosfilt calls, native and scipy's: {filters}")
    phase(11, f"its window merge by part: {parts}; the window's outputs "
              f"bit-identical on both forms ({time.perf_counter() - t0:.1f}"
              f" s for this part)")
    phase(11, f"xcorr-torch-snr over the shards: {snr_wall:.2f} s, snr/s/n "
              f"within {err:.3e} (relative) of pair_snr in memory, "
              f"lag_s_max equal; h5py not imported")
    for line in read_lines:
        phase(11, line)

    phase(11, f"one {BH_FS:g} Hz window's remove_response by part: "
              f"{window_remove_response(sds, inv)}")

    # two BHZ-EDH and one BHR-EDH pair-days: the BH chains' response and
    # Lanczos steps on the host
    wall = {}
    for bh, pair, bh_days in (("BHZ", P11_BHZ_PAIR, days),
                              ("BHR", P11_BHR_PAIR, days[:1])):
        lag = phase11_chain_lag(inv, bh)
        run = run_cli(pair, bh_days)
        bh_shards, bh_reads, _ = held(pair, bh_days, DELAY + lag)
        phase(11, cli_line(pair, bh_days, run, bh_shards, bh_reads)
                  + f"; peaks expected at {DELAY} s plus {lag:.2f} s "
                  f"between the EDH and {bh} chains for noise-free "
                  f"arrivals")
        phase(11, f"xcorr-torch-cc {pair} by chain stage, s summed over "
                  f"its fetch threads: {stage_report(run[6])}")
        if bh == "BHR":
            check_unread_z(run[6], "phase 11 BHR-EDH")
        wall[bh] = (run[0] / len(bh_days), run[1])
    trio = phase11_trio(xt, run_cli, cli_line, root, days[:1], tmp.name)
    check("h5py" not in sys.modules, "h5py was imported")
    tmp.cleanup()
    phase(11, f"xcorr-torch-cc wall per pair-day: EDH-EDH "
              f"{edh[0] / len(days):.2f} s, BHZ-EDH "
              f"{wall['BHZ'][0]:.2f} s, BHR-EDH {wall['BHR'][0]:.2f} s; "
              f"the three pairs as one campaign {trio[0] / 3:.2f} s")
    return {"11 xcorr-torch-cc": {"fused_corr": edh[1]},
            "11 xcorr-torch-cc BHZ-EDH": {"fused_corr": wall["BHZ"][1]},
            "11 xcorr-torch-cc BHR-EDH": {"fused_corr": wall["BHR"][1]},
            "11 xcorr-torch-cc three pairs": {"fused_corr": trio[1]}}


#: rounds of phase 11's read A/B (each form once a round, the order
#: swapped every round) and repetitions of each part of the read alone
P11_READ_ROUNDS = 3
P11_READ_REPS = 3
#: attributes of an SNR file that carry the time of the run, and the
#: hashes over them
P11_STAMPS = ("history", "postprocess", "sha256_hash",
              "sha256_hash_metadata")


def same_read(a, b):
    """Two read results equal bit for bit (``same_value``; a 0-d array
    as its element, object arrays element by element); a raise equals a
    raise of its type."""
    if isinstance(a, Exception) or isinstance(b, Exception):
        return type(a) is type(b)
    a, b = (x[()] if isinstance(x, np.ndarray) and not x.ndim else x
            for x in (a, b))
    if type(a) is not type(b):
        return False
    if isinstance(a, np.generic):
        a, b = np.asarray(a), np.asarray(b)
    if isinstance(a, np.ndarray) and a.dtype == object:
        return a.shape == b.shape and b.dtype == object and all(
            same_read(x, y) for x, y in zip(a.reshape(-1), b.reshape(-1)))
    return same_value(a, b)


def outcome(fn, *args):
    """``fn(*args)``, or the exception it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the raise is the outcome
        return e


def snr_file_differences(a, b):
    """Names of the variables and coordinates of two SNR datasets whose
    dims, bytes or attributes (but ``P11_STAMPS``) differ, and
    ``(attrs)`` where the datasets' attributes do."""
    bad = [] if list(a.variables) == list(b.variables) else ["(names)"]
    if not same_value({k: v for k, v in a.attrs.items()
                       if k not in P11_STAMPS},
                      {k: v for k, v in b.attrs.items()
                       if k not in P11_STAMPS}):
        bad.append("(attrs)")
    for k in a.variables:
        x, y = a.variables[k], b.variables.get(k)
        if y is None or x.dims != y.dims or not same_value(
                x.values, y.values) or not same_value(
                {n: v for n, v in x.attrs.items() if n not in P11_STAMPS},
                {n: v for n, v in y.attrs.items() if n not in P11_STAMPS}):
            bad.append(k)
    return bad


@contextlib.contextmanager
def plain_codec():
    """The codec's read forms swapped for their plain versions while it
    runs (``io/hdf5.py`` ``FORMS``: ``_read_chunked_plain``, the whole
    chunked read as it was, and ``_getitem_plain``, a whole read then
    numpy's index)."""
    from xcorr_tpu_torch.io import hdf5
    cls = hdf5._ReadDataset
    names = {n: "__getitem__" if n == "getitem" else f"_{n}"
             for n in hdf5.FORMS}
    real = {attr: cls.__dict__[attr] for attr in names.values()}
    for n, attr in names.items():
        setattr(cls, attr, getattr(cls, f"_{n}_plain"))
    try:
        yield
    finally:
        for attr, form in real.items():
            setattr(cls, attr, form)


def phase11_shard_read(xt, root, days, tmp, want, first):
    """``xcorr-torch-snr`` over the EDH-EDH shards under ``root`` on the
    codec's read forms (``io/hdf5_chunks.py``: the chunked read into one
    array on the read pool) and on their plain versions
    (``plain_codec``), in turns over ``P11_READ_ROUNDS`` rounds: wall
    per pair-day, the reads' seconds inside the CLI, bytes inflated and
    written per shard (``io/hdf5_chunks.py`` counts), the peak resident
    set; each SNR file held to ``want`` (``pair_snr`` in memory) and to
    ``first`` (the CLI's file before) bit for bit. Then the first
    shard's read alone by part (``shard_read_parts``). Returns the lines
    to print."""
    from xcorr_tpu_torch import io as xio
    from xcorr_tpu_torch.io import hdf5_chunks
    from xcorr_tpu_torch.io.netcdf import from_netcdf
    from xcorr_tpu_torch.scripts import snr as snr_cli
    forms = {"port": contextlib.nullcontext, "plain": plain_codec}
    real, runs = xio.read, {f: [] for f in forms}
    try:
        for r in range(P11_READ_ROUNDS):
            for form in (("port", "plain") if r % 2 == 0
                         else ("plain", "port")):
                reads = []

                def read(*a, **kw):
                    t0 = time.perf_counter()
                    ds = real(*a, **kw)
                    reads.append(time.perf_counter() - t0)
                    return ds

                xio.read = read
                out = os.path.join(tmp, f"snr-{form}-{r}.nc")
                hdf5_chunks.reset_counts()
                t0 = time.perf_counter()
                with forms[form](), peak_rss() as rss:
                    rc = snr_cli.main([P11_DAYS[0], P11_DAYS[1], "--root",
                                       root, "--pair", P11_PAIR, "--out",
                                       out])
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check(rc == 0, f"xcorr-torch-snr on the {form} read "
                               f"returned {rc}")
                got = from_netcdf(out)
                hold_snr(got, want, f"xcorr-torch-snr on the {form} read "
                                    f"vs pair_snr")
                bad = snr_file_differences(got, first)
                check(not bad, f"xcorr-torch-snr on the {form} read, round "
                               f"{r}: {bad} differ from its first file")
                runs[form].append((wall / len(days), reads,
                                   hdf5_chunks.counts(), rss["peak"]))
    finally:
        xio.read = real
    check(runs["port"][-1][2]["chunks"] > 0 and
          runs["plain"][-1][2]["chunks"] == 0,
          "the read forms did not run as named: chunks decoded "
          f"{runs['port'][-1][2]} (port), {runs['plain'][-1][2]} (plain)")

    def line(form):
        walls = [w for w, *_ in runs[form]]
        reads = [x for _, rs, *_ in runs[form] for x in rs]
        c = runs[form][-1][2]
        return (f"{form}: {np.median(walls):.4f} s per pair-day (median of "
                f"{len(walls)}: {[round(w, 4) for w in walls]}), reads "
                f"{np.median(reads):.4f} s median per shard "
                f"({len(reads)} reads), {c['inflated'] / len(days) / 1e6:.2f}"
                f" MB inflated and {c['written'] / len(days) / 1e6:.2f} MB "
                f"written per shard by the one-array read, peak resident "
                f"set {max(p or 0 for *_, p in runs[form]) / 1e9:.2f} GB")

    faster = sum(p[0] < q[0] for p, q in zip(runs["port"], runs["plain"]))
    lines = [f"xcorr-torch-snr over {len(days)} EDH-EDH shards, read forms "
             f"in turns ({P11_READ_ROUNDS} rounds): {line('port')}; "
             f"{line('plain')}; the port's faster in {faster} of "
             f"{P11_READ_ROUNDS}; every SNR file the same bits as the "
             f"first and within 1e-5 of pair_snr"]
    lines.append(shard_read_parts(xt.ncfile(P11_PAIR, days[0], root)))
    return lines


def shard_read_parts(path):
    """One shard's read alone, by part (medians of ``P11_READ_REPS``, s):
    its chunks' stored bytes out of the file; inflate, serial and on the
    read pool's threads; unshuffle into one array; the whole read on the
    port's form (pool and serial) and the plain one; the kept block of
    ``cc`` at the SNR CLI's celerity window as a slice read, which
    inflates each chunk only up to the block's last byte. Checks the
    forms' bits equal."""
    from xcorr_tpu_torch.io import hdf5, hdf5_chunks
    from xcorr_tpu_torch.io import hdf5_filters as hf
    from xcorr_tpu_torch.io.read import read

    def med(fn):
        ts = []
        for _ in range(P11_READ_REPS):
            t0 = time.perf_counter()
            out = fn()
            ts.append(time.perf_counter() - t0)
        return out, float(np.median(ts))

    ds = read(path, fast=True)
    dist = float(ds["distance"].values.max()) * 1000.0
    lag = ds.coords["lag"].values
    lags = np.nonzero((lag >= dist / 1500.0) & (lag <= dist / 1460.0))[0]
    times = np.nonzero(ds["status"].values[0] == 1)[0]
    key = (slice(0, 1), slice(int(times[0]), int(times[-1]) + 1),
           slice(int(lags[0]), int(lags[-1]) + 1))
    with hdf5.File(path) as f:
        d = f["cc"]
        store = d._chunk_store()
        bufs, t_bytes = med(lambda: [store._fetch(a, nb)
                                     for nb, _, _, a in store.items])
        whole, t_pool = med(lambda: d[...])
        real = hdf5_chunks.THREADS
        hdf5_chunks.THREADS = 1
        try:
            serial, t_serial = med(lambda: d[...])
        finally:
            hdf5_chunks.THREADS = real
        plain, t_plain = med(lambda: d._getitem_plain(...))
        block, t_block = med(lambda: d[key])
        hdf5_chunks.reset_counts()
        d[key]
        inflated_block = hdf5_chunks.counts()["inflated"]
    check(same_read(whole, plain) and same_read(serial, plain),
          f"{path}: the whole read differs between its forms")
    check(same_read(block, plain[key]), f"{path}: the kept block differs")
    n = int(np.prod(store.chunk))
    want = n * store.dtype.itemsize
    _, t_inf1 = med(lambda: [hf.inflate(b, want) for b in bufs])
    pool = hdf5_chunks._read_pool()
    inflated, t_infn = med(
        lambda: list(pool.map(lambda b: hf.inflate(b, want), bufs)))
    full = tuple(slice(0, c) for c in store.chunk)

    def unshuffle():
        out = np.empty(store.shape, store.dtype)
        for item, buf in zip(store.items, inflated):
            hf.unshuffle_into(buf, store.chunk, full, out[tuple(
                slice(o, o + c) for o, c in zip(item[2], store.chunk))])
        return out

    un, t_un = med(unshuffle)
    check(same_read(un, plain), f"{path}: the parts' unshuffle differs")
    return (f"one shard's read by part, s (median of {P11_READ_REPS}): "
            f"{len(bufs)} chunks' bytes out of the file "
            f"{store.stored / 1e6:.1f} MB {t_bytes:.4f}; inflate to "
            f"{len(bufs) * want / 1e6:.1f} MB serial {t_inf1:.4f}, on "
            f"{hdf5_chunks.THREADS} threads {t_infn:.4f}; unshuffle into "
            f"one array, serial {t_un:.4f}; the whole read on the port's "
            f"form {t_pool:.4f} (serial {t_serial:.4f}), plain "
            f"{t_plain:.4f}; the kept block {block.shape} "
            f"({block.nbytes / 1e6:.3f} MB, {inflated_block / 1e6:.1f} MB "
            f"inflated) as a slice read {t_block:.4f}; the forms' bits "
            f"equal")


#: phase 11's three pairs, as one campaign over its first day
P11_TRIO = (P11_PAIR, P11_BHZ_PAIR, P11_BHR_PAIR)

#: the variables of a shard that a campaign's form must leave the same bits
SHARD_VARS = ("cc", "status", "pair_offset", "time_offset", "hash")


def phase11_trio(xt, run_cli, cli_line, single_root, day, tmp):
    """``xcorr-torch-cc`` over ``P11_TRIO`` and ``day`` as one campaign:
    six receiver-windows per window time, four distinct
    (``IM.H03S1..EDH`` in all three pairs). The shards are the bits of
    the single-pair runs' shards of that day in ``single_root`` (each
    pair alone shares nothing within a window time: the uncached
    result), with status 1; the campaign scope ran four chains and
    served two windows per window time, K1 launched once per pair-day,
    and the scope is empty at the end (``run_cli``). Returns the wall and
    K1's launches."""
    out = os.path.join(tmp, "cc-trio")
    run = run_cli(list(P11_TRIO), day, out)
    nwin, sizes = None, []
    for pair in P11_TRIO:
        path = xt.ncfile(pair, day[0], out)
        got, want = xt.read(path), xt.read(xt.ncfile(pair, day[0],
                                                     single_root))
        check(bool((got["status"].values == 1).all()),
              f"{pair} in the campaign: status {got['status'].values}")
        for name in SHARD_VARS:
            if name in want.variables:
                a, b = got[name].values, want[name].values
                check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                      f"{pair} {name}: the campaign's shard differs from "
                      f"the pair alone")
        nwin = got["status"].shape[1]
        sizes.append(os.path.getsize(path))
    shared = run[-1]
    check(shared["chains"] == 4 * nwin
          and shared["hits"] + shared["waits"] == 2 * nwin
          and not shared["bypassed"],
          f"three pairs x {nwin} windows: the scope ran {shared}, expected "
          f"{4 * nwin} chains and {2 * nwin} served")
    check(run[1] == len(P11_TRIO), f"K1 launched {run[1]} times for "
                                   f"{len(P11_TRIO)} pair-days")
    phase(11, cli_line(list(P11_TRIO), day, run, sizes, [])
              + f"; the shards bit-identical to each pair alone, status 1; "
              f"{4 * nwin} chains for {6 * nwin} receiver-windows")
    phase(11, f"xcorr-torch-cc over the three pairs by chain stage, s "
              f"summed over its fetch threads: {stage_report(run[6])}")
    return run[0], run[1]


REPO = os.path.dirname(os.path.abspath(__file__))
P12_FIXTURES = os.path.join(REPO, "tests", "fixtures_torch", "hdf5")
P12_BUDGET_S = 30.0


#: seeded basic slices per chunked dataset of phase 12
P12_KEYS = 12


def p12_keys(shape, rng, n=P12_KEYS):
    """``n`` basic keys on ``shape`` (ints, negative too; slices with
    ``None``, negative and out-of-range bounds; an ``Ellipsis`` now and
    then), and the last element."""
    keys = [(Ellipsis, -1)] if shape else []
    for _ in range(n):
        key = []
        for s in shape:
            if rng.random() < 0.2:
                key.append(int(rng.integers(-s, s)))
            else:
                key.append(slice(int(rng.integers(-s - 1, s + 1)),
                                 [None, int(rng.integers(-s - 1, s + 1))][
                                     int(rng.integers(0, 2))]))
        if key and rng.random() < 0.3:
            key[int(rng.integers(0, len(key)))] = Ellipsis
        keys.append(tuple(key))
    return keys


def phase12_slices(names):
    """Each chunked dataset of the files ``names`` (in the working
    directory) read by ``p12_keys`` on the port's slice read and on
    ``_getitem_plain``: the same bits or the same raise. Returns the
    datasets and keys read."""
    from xcorr_tpu_torch.io import hdf5
    rng = np.random.default_rng(12)
    nsets = nkeys = 0
    for name in names:
        f = outcome(hdf5.File, name)
        if isinstance(f, Exception):
            continue
        with f:
            for var in f.keys():
                d = outcome(f.__getitem__, var)
                if isinstance(d, Exception) or d.chunks is None \
                        or d.shape is None:
                    continue
                nsets += 1
                # the plain version's whole read, once: numpy indexes it
                whole = outcome(d._getitem_plain, ...)
                for key in p12_keys(d.shape, rng):
                    got = outcome(d.__getitem__, key)
                    want = whole if isinstance(whole, Exception) else \
                        outcome(whole.__getitem__, key)
                    check(same_read(got, want),
                          f"{name}/{var}[{key!r}]: the slice read gives "
                          f"{got!r:.80}, the plain one {want!r:.80}")
                    nkeys += 1
    return nsets, nkeys


def phase12_foreign_files(xt):
    """The port's HDF5 reader on files other writers make, where no h5py
    is: each fixture, read with the fixture directory as the working
    directory (its external names resolve there), to its recorded digest
    (or the exception the JAX package's read raised), the native filter
    decoders built from this checkout's source, the shard validated,
    ``xcorr-torch-snr`` over it against the CPU's ``pair_snr``."""
    from xcorr_tpu_torch.io import hdf5_filters
    from xcorr_tpu_torch.io.netcdf import from_netcdf
    from xcorr_tpu_torch.native import _cxx
    from xcorr_tpu_torch.scripts import snr as snr_cli
    from tools.hdf5_view import digest_or_raise
    t_start = time.perf_counter()
    with open(os.path.join(P12_FIXTURES, "expected.json")) as fh:
        exp = json.load(fh)
    t0 = time.perf_counter()
    lib = hdf5_filters._load()
    built_s = time.perf_counter() - t0
    want_lib = _cxx.build("libxch5filters", hdf5_filters._SOURCES)
    check(lib._name == want_lib and os.path.exists(want_lib),
          f"the filter decoders {lib._name} are not {want_lib}")
    reads = {}
    with contextlib.chdir(P12_FIXTURES):
        for name, want in exp["files"].items():
            t0 = time.perf_counter()
            got = digest_or_raise(from_netcdf, name)
            reads[name] = (time.perf_counter() - t0) * 1e3
            check(got == want["digest"],
                  f"{name}: the view differs from the JAX package's "
                  f"({got})")
            got = digest_or_raise(from_netcdf, name, header_only=True)
            check(got == want["digest_header_only"],
                  f"{name}: the header-only view differs from the JAX "
                  f"package's ({got})")
    phase(12, f"native filter decoders (szip, scaleoffset, lzf) "
              f"{os.path.relpath(want_lib, REPO)}, built from "
              f"xcorr_tpu_torch/native/{hdf5_filters._SOURCES[0]} of this "
              f"checkout in {built_s:.2f} s (the name hashes the source "
              "and the flags)")
    phase(12, f"{len(reads)} fixtures read to the JAX package's views "
              "(with and without header_only; the header-only read of "
              "null.h5 raises TypeError in both); read ms per file: "
              + json.dumps({k: round(v, 3) for k, v in reads.items()}))
    t0 = time.perf_counter()
    with contextlib.chdir(P12_FIXTURES):
        nsets, nkeys = phase12_slices(sorted(exp["files"]))
    phase(12, f"{nsets} chunked datasets of the fixtures read by {nkeys} "
              f"seeded basic slices on the port's slice read and the "
              f"plain one, the same bits or the same raise "
              f"({time.perf_counter() - t0:.2f} s)")
    shard = exp["shard"]
    tmp = tempfile.TemporaryDirectory()
    day = pd.Timestamp(shard["day"])
    path = xt.ncfile(shard["pair"], day, tmp.name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(P12_FIXTURES, shard["file"]), "rb") as src, \
            open(path, "wb") as dst:
        dst.write(src.read())
    t0 = time.perf_counter()
    ds = xt.read(path)
    read_s = time.perf_counter() - t0
    check(ds is not None, f"{shard['file']} did not read and validate")
    check(bool((ds["status"].values == 1).all()), "shard status not all 1")
    out = os.path.join(tmp.name, "snr.nc")
    t0 = time.perf_counter()
    rc = snr_cli.main([shard["day"], shard["day"], "--root", tmp.name,
                       "--pair", shard["pair"], "--celerity",
                       *map(str, shard["celerity"]), "--filter-freq",
                       str(shard["filter"]["frequency"]), "--out", out])
    torch.cuda.synchronize()
    snr_s = time.perf_counter() - t0
    check(rc == 0, f"xcorr-torch-snr returned {rc}")
    got = from_netcdf(out)
    err = max(rel_err(got[k].values.reshape(-1), shard["snr"][k])
              for k in ("snr", "s", "n"))
    check(err <= P7_TOL, f"xcorr-torch-snr vs the CPU's pair_snr: "
                         f"relative error {err} > {P7_TOL}")
    check("h5py" not in sys.modules, "h5py was imported")
    tmp.cleanup()
    wall = time.perf_counter() - t_start
    check(wall <= P12_BUDGET_S, f"phase 12 took {wall:.1f} s")
    phase(12, f"{shard['file']}: read and validated in {read_s:.4f} s; "
              f"xcorr-torch-snr on the card {snr_s:.2f} s, snr/s/n within "
              f"{err:.3e} (relative) of the CPU's pair_snr; h5py not "
              f"imported; phase 12 {wall:.2f} s")


def main(only=None):
    """The smoke run; with ``only`` 10 or 11, phases 1 and 2 (the build
    alone) and that phase (phase 10's references made afresh); with 12,
    phases 1 and 12."""
    t_start = time.perf_counter()
    # -- 1. the card ---------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    import xcorr_tpu_torch as xt
    from xcorr_tpu_torch.ops import _build, cc, fft4
    from xcorr_tpu_torch.ops import fused_fft as ff
    check("jax" not in sys.modules, "the port imported jax")
    set_route("corr")
    phase(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"device {torch.cuda.get_device_name(0)} "
             f"count {torch.cuda.device_count()}")
    if only == 12:
        phase12_foreign_files(xt)
        phase(12, f"phase 12 alone passed: all "
                  f"{time.perf_counter() - t_start:.1f} s")
        return

    # -- 2. build ----------------------------------------------------------
    tmp = tempfile.TemporaryDirectory()
    ptxas = {} if only else {unit: subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.path.join(tmp.name, f"{i}.o"), str(_build._CSRC / src)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for i, (unit, src) in enumerate(PTXAS_UNITS.items())}
    t0 = time.perf_counter()
    lib = _build.load()
    phase(2, f"kernels built in {_build.build_seconds:.2f} s "
             f"(load {time.perf_counter() - t0:.2f} s)")
    if only == 10:
        return main_phase10(xt, ff, fft4, t_start)
    if only == 11:
        k1 = phase11_cli(xt, ff)
        phase(11, f"phase 11 alone passed: launches {json.dumps(k1)}, all "
                  f"{time.perf_counter() - t_start:.1f} s")
        return
    for unit, proc in ptxas.items():
        report = proc.communicate()[1]
        check(proc.returncode == 0, f"nvcc -Xptxas -v of {unit} failed: "
                                    f"{report}")
        for line in ptxas_summary(unit, report, ff):
            phase(2, f"{unit} ptxas, {line}")
    tmp.cleanup()
    hmma, forms = tf32_hmma(_build._library_path(), _build._nvcc())
    # four instances: B's copies in 16 or 4 bytes, three passes or one
    gemm = {k: v for k, v in hmma.items() if "gemm_tf32_kernel" in k}
    check(len(gemm) == 4 and min(gemm.values()) > 0,
          f"TF32 HMMA per product instance: {gemm} (forms {forms})")
    phase(2, f"TF32 HMMA in the library's SASS: K3's and K4's product "
             f"(gemm_tf32.cu) {sum(gemm.values())} in {len(gemm)} "
             f"instances ({', '.join(f'{k}: {v}' for k, v in gemm.items())}"
             f"); elsewhere {sum(hmma.values()) - sum(gemm.values())}; HMMA "
             f"forms {forms}")

    # -- 3. every kernel against its plain version ------------------------
    # lag window and four-step plan of the production geometry
    ds_geom = xt.init(pair=PAIR, starttime="2014-02-01",
                      endtime="2014-02-01T03:00", preprocess={"EDH": EDH},
                      attrs={"institution": "x", "author": "x",
                             "source": "x"},
                      sampling_rate=FS, window_length=WINDOW,
                      window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG)
    lag_attrs = ds_geom.coords["lag"].attrs
    imin, imax = int(lag_attrs["index_min"]), int(lag_attrs["index_max"])
    check(int(lag_attrs["npts"]) == N, f"npts {lag_attrs['npts']} != {N}")
    plans = {route: fft4.plan_correlate4(N, imin, imax, normalize=True,
                                         route=route) for route in ROUTES}
    check(all((p.N1, p.N2, p.half) == (528, 16384, 265)
              for p in plans.values()),
          f"default geometry {[(p.N1, p.N2) for p in plans.values()]}")
    plan = plans["corr"]
    plan_1056 = fft4.plan_correlate4(N, imin, imax, n1=1056,
                                     normalize=True, route="acc")
    check(not fft4.tf32_enabled(), "TF32 is on after building a plan")
    phase(3, f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
             f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
             f"float32_matmul_precision="
             f"{torch.get_float32_matmul_precision()}")
    rec = phase3_kernels(ff, plan, plan_1056, lib.xc_fused_corr_phases)

    # -- 4. day-scale correlate, once per route ---------------------------
    oracle = phase4_correlate(ff, cc, fft4, imin, imax)

    # -- 5. the slice: one production-geometry pair-day per route ----------
    launches = phase5_pair_days(xt, ff)

    # -- 6. the device engine: 4 pair-days in one launch -------------------
    t6 = time.perf_counter()
    launches["fused_corr"], dss, engine_wall = phase6_device_engine(xt, ff)
    # phase 9 holds its mesh and its processes to this mesh=None run
    engine_ref = [(d["cc"].values.copy(), d["status"].values.copy())
                  for d in dss]

    # -- 7. the analysis slice: full width, then the campaign --------------
    t7 = time.perf_counter()
    with postprocess_twice():
        phase7a_full_width(xt, dss, ENGINE_DAYS)
        del dss
        t7b = time.perf_counter()
        p8 = new_phase8()
        phase7b_campaign(xt, p8)
        t8d = time.perf_counter()

        # -- 8. the rest of the analysis tier: 8a-8c ran in 7b's day loop --
        phase8_report(p8)
        tl_rec, tl_launches, _ = phase8d_timelapse(xt, p8)
    t_end = time.perf_counter()
    phase(8, f"command time: phases 1-5 {t6 - t_start:.1f} s, phase 6 "
             f"{t7 - t6:.1f} s, 7a {t7b - t7:.1f} s, 7b "
             f"{t8d - t7b - p8['seconds']:.1f} s, 8a-8c "
             f"{p8['seconds']:.1f} s, 8d {t_end - t8d:.1f} s, all "
             f"{t_end - t_start:.1f} s")

    # -- 9. the multi-device layer: a logical mesh, two processes ----------
    from xcorr_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=MESH_DEVICES)
    phase(9, f"{mesh}: a logical mesh, {torch.cuda.device_count()} card "
             "visible; both entries run on cuda:0, one after the other, "
             "so the times below are the split's overhead, not a "
             "multi-card speed")
    t9 = time.perf_counter()
    path = {f"9a {route}": v for route, v in phase9a_sharded(
        ff, cc, mesh, imin, imax, oracle).items()}
    path["9b engine"] = phase9b_mesh_engine(xt, ff, mesh, engine_ref,
                                            engine_wall)
    t9c = time.perf_counter()
    path.update({f"9c {k}": v for k, v in phase9c_processes(
        engine_ref, engine_wall).items()})
    t9d = time.perf_counter()
    phase9d_timelapse(mesh, p8)
    t9_end = time.perf_counter()
    phase(9, "launches on this slice's path, each count reset just before "
             "its run and read just after: " + json.dumps(path))
    phase(9, f"command time: 9a-9b {t9c - t9:.1f} s, 9c "
             f"{t9d - t9c:.1f} s, 9d {t9_end - t9d:.1f} s, phase 9 "
             f"{t9_end - t9:.1f} s, all {t9_end - t_start:.1f} s")

    # -- 10. the four-step's 'fft'/'matmul' branches, mesh=, precision -----
    k2_rec, k2, path10 = phase10(xt, ff, fft4, imin, imax, oracle,
                                 engine_ref, engine_wall)
    rec.update(k2_rec)
    launches.update(k2)
    rec.update(tl_rec)
    launches.update(tl_launches)
    t10_end = time.perf_counter()
    phase(10, "launches on this slice's path, each count reset just before "
              "its run and read just after: " + json.dumps(path10))
    phase(10, f"command time: phase 10 {t10_end - t9_end:.1f} s, all "
              f"{t10_end - t_start:.1f} s")

    # -- 11. the production CLI: archive -> shards -> analysis -------------
    path11 = phase11_cli(xt, ff)
    t11_end = time.perf_counter()
    phase(11, "launches on this slice's path, each count reset just before "
              "its CLI run and read just after: " + json.dumps(path11))
    phase(11, f"command time: phase 11 {t11_end - t10_end:.1f} s, all "
              f"{t11_end - t_start:.1f} s")

    # -- 12. files other HDF5 writers make, without h5py --------------------
    phase12_foreign_files(xt)
    t12_end = time.perf_counter()
    phase(12, f"command time: phase 12 {t12_end - t11_end:.1f} s, all "
              f"{t12_end - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": rec[name]["max_abs_err"],
        "ms": rec[name]["ms"],
        "plain_ms": rec[name]["plain_ms"],
        "bound_ms": rec[name]["bound_ms"],
        "bound_by": rec[name]["bound_by"],
        "library_ms": rec[name].get("library_ms"),
    } for name in (*ff.KERNELS, *TL_KERNELS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_phase10(xt, ff, fft4, t_start):
    """Phase 10 alone (``--phase10``), after the build: the lag window,
    phase 4's oracle and phase 6's 'high' engine run made here."""
    imin, imax = day_lags(xt)
    x, y = day_windows()
    oracle = day_oracle(x, y, imin, imax)
    del x, y
    engine_run(xt, ff)
    dss, ref_wall, _ = engine_run(xt, ff)
    ref = [(d["cc"].values.copy(), d["status"].values.copy()) for d in dss]
    t0 = time.perf_counter()
    _, _, path = phase10(xt, ff, fft4, imin, imax, oracle, ref, ref_wall)
    phase(10, "launches, each count reset just before its run and read "
              "just after: " + json.dumps(path))
    phase(10, f"phase 10 alone passed: phase 10 "
              f"{time.perf_counter() - t0:.1f} s, all "
              f"{time.perf_counter() - t_start:.1f} s")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif sys.argv[1:2] == ["--kernel-names"]:
        kernel_names(sys.argv[2])
    else:
        main(only={"--phase10": 10, "--phase11": 11, "--phase12": 12}.get(
            (sys.argv[1:2] or [None])[0]))
