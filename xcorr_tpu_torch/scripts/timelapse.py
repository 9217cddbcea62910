r"""
:mod:`scripts.timelapse` -- Timelapse CLI (``xcorr-torch-timelapse``)
=====================================================================

Cross-correlate the spectrograms of every triggered-time pair on the
(time1, time2) plane, per frequency band
(spec: ``xcorr/scripts/timelapse.py:35-467``; port of
``xcorr_tpu/scripts/timelapse.py``).

All T spectrograms of a pair are computed once
(:func:`pair_spectrograms`, on datasets in memory), then the
upper-triangle cells are 2-D-correlated in batches on the torch device
that ``--platform`` names (:func:`correlate_spectrograms`; ``cuda`` by
default, raising without a card), or with ``mesh=`` each batch split
over a mesh's devices (SURVEY.md §2.8 P2): each spectrogram's spectrum
once per stack, then per batch the hand-written gather-product (TL1)
and the inverse's peaks (TL2) of :mod:`..ops.cells`: cuFFT's column
inverse and a hand-written kernel that inverts each kept row and takes
its peak in shared memory, or, for rows too long for that, cuFFT's
``irfft2`` and a hand-written scan of the map. :func:`fill_cells`
writes a (pair, band)'s cells with one indexed assignment per variable.
:data:`FORMS` names the two forms; each has its plain version
(``_<name>_plain``). The shard I/O is imported on use.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd
import torch

from .. import ops
from ..core.postprocess import postprocess
from ..core.process import resolve_device
from ..ndlabel import Dataset
from ..signal.spectrogram import spectrogram
from ..util.convert import to_device, to_numpy
from ..util.metadata import global_attrs
from . import utils

__all__ = ["init_timelapse", "correlate_spectrograms", "pair_spectrograms",
           "fill_cells", "timelapse", "main", "FORMS"]


def init_timelapse(pair, times, freq_bands, attrs: dict = None):
    """The (pair, freq, time1, time2) result dataset
    (reference ``scripts/timelapse.py:35-139``)."""
    ds = Dataset()
    ds.attrs = global_attrs({
        "title": "Timelapse 2-D spectrogram cross-correlation",
        **(attrs or {}),
    })
    pair = np.atleast_1d(np.asarray(pair, dtype=object))
    ds.coords["pair"] = pair
    fb = np.asarray(freq_bands, dtype=np.float64)
    ds.coords["freq"] = fb.mean(axis=1)
    ds.coords["freq"].attrs = {"long_name": "Center frequency",
                               "units": "s-1"}
    ds["freq_bw"] = (("freq",), fb[:, 1] - fb[:, 0],
                     {"long_name": "Frequency bandwidth", "units": "s-1"})
    t = np.asarray(times)
    ds.coords["time1"] = t
    ds.coords["time2"] = t.copy()
    shape = (pair.size, fb.shape[0], t.size, t.size)
    ds["cc2"] = (("pair", "freq", "time1", "time2"),
                 np.full(shape, np.nan, dtype=np.float32),
                 {"long_name": "2-D cross-correlation peak", "units": "-"})
    ds["delta_freq"] = (("pair", "freq", "time1", "time2"),
                        np.full(shape, np.nan, dtype=np.float32),
                        {"long_name": "Frequency shift at peak",
                         "units": "s-1"})
    ds["delta_lag"] = (("pair", "freq", "time1", "time2"),
                       np.full(shape, np.nan, dtype=np.float32),
                       {"long_name": "Lag shift at peak", "units": "s"})
    ds["status"] = (("pair", "freq", "time1", "time2"),
                    np.zeros(shape, dtype=np.int8),
                    {"long_name": "processing status"})
    return ds


def _normed(a):
    """Frobenius-normalize over the trailing two axes."""
    n = torch.sqrt(torch.sum(a * a, dim=(-2, -1), keepdim=True))
    return a / torch.where(n == 0, torch.ones_like(n), n)


#: bytes of one stack's spectra that a device keeps at once. A stack
#: whose spectra pass it walks the cell grid in tiles of times, keeping
#: one tile's rows and one tile's columns (each at most half of it); a
#: year of the widest band (T = 365, F = 81, L about 9,100) takes 4.3 GB,
#: so a production stack stays whole on an 80 GB card.
SPECTRA_BYTES = 16 << 30
#: bytes of the zero-padded input of one ``rfft2`` over a chunk of times:
#: the transient of taking a stack's spectra
CHUNK_BYTES = 1 << 30


def _spectra(sp, start: int, stop: int, nf: int, nl: int,
             cols: bool = False):
    """The ``rfft2`` at ``(nf, nl)`` of the normalized spectrograms
    ``sp[start:stop]``: ``(stop - start, nf, nl//2+1)`` complex,
    C-contiguous, taken over chunks of :data:`CHUNK_BYTES` of padded
    input; with ``cols``, each transposed, ``(stop - start, nl//2+1,
    nf)``, C-contiguous (the layout in which the row route's column
    inverse needs no copy)."""
    n = stop - start
    step = max(1, CHUNK_BYTES // (nf * nl * sp.element_size()))
    out = None
    for s in range(0, n, step):
        chunk = sp[start + s:min(start + s + step, stop)]
        f = torch.fft.rfft2(_normed(chunk), s=(nf, nl))
        if cols:
            f = f.transpose(-2, -1)
        if f.shape[0] == n:
            return f.contiguous()
        if out is None:
            out = torch.empty((n, *f.shape[1:]), dtype=f.dtype,
                              device=f.device)
        out[s:s + f.shape[0]] = f
    return out


def _tile(T: int, nf: int, nl: int, itemsize: int) -> int:
    """Times per tile of the cell grid: all ``T`` where the stack's
    spectra fit :data:`SPECTRA_BYTES`, else as many as let a row tile and
    a column tile fit it together."""
    one = nf * (nl // 2 + 1) * 2 * itemsize
    if T * one <= SPECTRA_BYTES:
        return max(T, 1)
    return max(1, SPECTRA_BYTES // (2 * one))


def _product_peaks(prods, n1, n2, nl, cols=False):
    """Peaks and flat argmaxes of a batch of cells from their conjugate
    products (TL1's outputs, in cell order; with ``cols``, each
    ``(B, nl//2+1, nf)``): TL2, :func:`..ops.cells.product_peaks`, on
    the route its row length takes (``ops.cells.row_plan(nl)``: cuFFT's
    column ``ifft`` and the row kernel where a row fits a block's shared
    memory, else cuFFT's ``irfft2`` and the scan)."""
    P = torch.cat(prods) if len(prods) > 1 else prods[0]
    return ops.cells.product_peaks(P.transpose(-2, -1) if cols else P,
                                   n1, n2, nl)


def correlate_spectrograms(specs, i_idx, j_idx, batch: int = 64,
                           mesh=None, device="cuda"):
    """Batched normalized 2-D correlation peaks between spectrogram pairs,
    on ``device`` (``'cuda'`` by default, which raises without a card).

    specs: (T, F, L) stack (float32 on the card); (i_idx, j_idx): cell
    index lists, in ``[-T, T)`` (a negative index counts from the end;
    any other raises ``IndexError``). Returns (peak, df_shift, dl_shift)
    arrays of len(cells), where the shifts are argmax offsets in bins
    relative to zero lag.

    Each spectrogram is normalized and transformed once (``rfft2`` at the
    port's cuFFT-fast lengths, chunks of :data:`CHUNK_BYTES`), and its
    spectrum kept. Then each batch of ``batch`` cells (the last at its
    own size) takes the conjugate products of its cells' spectra by
    index (TL1, :func:`..ops.cells.gather_product`), and the peak and
    flat argmax of the fftshifted window of each cell's ``irfft2`` (TL2,
    :func:`..ops.cells.product_peaks`): on the card, where a row of
    length ``nl`` fits one block's shared memory (``nl`` up to 28,672;
    :func:`..ops.cells.row_plan`), cuFFT's column ``ifft`` and one kernel
    that inverts each kept row and reduces it in shared memory, so no
    map is stored; for longer rows cuFFT's ``irfft2`` and the scan of
    the map's window in place. On the row route a card keeps each
    spectrum transposed, ``(nl//2+1, nf)``, so that TL1's products and
    the column inverse's output keep that layout and cuFFT copies
    nothing. A stack whose spectra pass :data:`SPECTRA_BYTES` takes its
    cells tile pair by tile pair of times (:func:`_tile`), keeping one
    row tile's and one column tile's spectra at once, but for its last
    batch, which runs in cell order: so each cell's inverse runs in a
    batch of the size that the plain version gives it. A batch whose
    cells span tile pairs takes TL1 once per tile pair.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`, in place of ``device``):
    the stack goes to each of its devices, and its spectra are taken on
    each; ``batch`` is rounded to a multiple of the mesh's size, as the
    JAX package rounds it, and each batch splits into contiguous shares,
    one per entry, each run on the entry's device; the results come back
    in cell order.

    The plain version, :func:`_correlate_spectrograms_plain`, takes both
    spectra of every cell; on the CPU both give the same bits.
    """
    if mesh is None:
        devices = (resolve_device(device),)
    else:
        from ..parallel.mesh import split
        devices = tuple(resolve_device(d) for d in mesh.devices)
        batch = max(batch, mesh.size) // mesh.size * mesh.size
    uniq = tuple(dict.fromkeys(devices))
    stacks = {d: to_device(specs, d) for d in uniq}
    sp0 = stacks[devices[0]]
    T, (n1, n2) = sp0.shape[0], sp0.shape[-2:]
    ii = _positions(i_idx, T, "i_idx")
    jj = _positions(j_idx, T, "j_idx")
    nf = ops.fft.next_fast_len(2 * n1 - 1)
    nl = ops.fft.next_fast_len(2 * n2 - 1)
    w = 2 * n2 - 1
    ncells = ii.shape[0]
    # the spectra, and so TL1's products, in the layout TL2 takes
    cols = {d: ops.cells.products_in_columns(nl, d) for d in uniq}
    # the order the cells run in: tile pair by tile pair (cell order
    # within each) but for the last batch, which runs as it stands, so
    # that each cell is transformed in a share of the size the plain
    # version gives it (a transform's bits may depend on its batch's size)
    tile = _tile(T, nf, nl, sp0.element_size())
    nt = -(-T // tile)
    key = (ii // tile) * nt + jj // tile
    head = (ncells - 1) // batch * batch if ncells else 0
    order = np.arange(ncells)
    if nt > 1:
        order[:head] = np.argsort(key[:head], kind="stable")
    key = key[order]
    # each cell's indices in its tiles, in that order, on every device
    local = {d: (to_device(ii[order] % tile, d),
                 to_device(jj[order] % tile, d)) for d in uniq}
    held = {}                        # tile -> its spectra on every device

    def spectra_of(a, b):
        """The spectra of row tile ``a`` and column tile ``b``; no other
        tile's are kept."""
        for t in [t for t in held if t not in (a, b)]:
            del held[t]
        for t in (a, b):
            if t not in held:
                held[t] = {d: _spectra(stacks[d], t * tile,
                                       min(T, (t + 1) * tile), nf, nl,
                                       cols[d])
                           for d in uniq}
        return held[a], held[b]

    # each device's outputs hold, in that order, the cells it ran
    peaks = {d: torch.empty(ncells, dtype=stacks[d].dtype, device=d)
             for d in uniq}
    am = {d: torch.empty(ncells, dtype=torch.int64, device=d)
          for d in uniq}
    owner = np.zeros(ncells, dtype=np.intp)   # index into uniq
    for s in range(0, ncells, batch):
        rows = min(batch, ncells - s)
        parts = [(devices[0], 0, rows)] if mesh is None else \
            split(mesh, rows)
        for d, p0, p1 in parts:
            lo, hi = s + p0, s + p1
            prods = []
            for k0, k1 in _runs(key[lo:hi]):
                sa, sb = spectra_of(*divmod(int(key[lo + k0]), nt))
                cs = slice(lo + k0, lo + k1)
                prods.append(ops.cells.gather_product(
                    sa[d], local[d][0][cs], sb[d], local[d][1][cs]))
            peaks[d][lo:hi], am[d][lo:hi] = _product_peaks(
                prods, n1, n2, nl, cols[d])
            del prods
            owner[lo:hi] = uniq.index(d)
    held.clear()
    pk_host = np.empty(ncells, dtype=np.float32)
    am_host = np.empty(ncells, dtype=np.int64)
    for k, d in enumerate(uniq):
        mine = owner == k
        pk_host[order[mine]] = to_numpy(peaks[d])[mine]
        am_host[order[mine]] = to_numpy(am[d])[mine]
    return (pk_host,
            (am_host // w - (n1 - 1)).astype(np.int32),
            (am_host % w - (n2 - 1)).astype(np.int32))


def _positions(idx, T: int, name: str):
    """The cell indices ``idx`` as int64 positions in a stack of ``T``:
    a negative index counts from the end, as ``sp[idx]`` counts it in
    the plain version (and numpy and the JAX package), and one outside
    ``[-T, T)`` raises ``IndexError``, as ``sp[idx]`` does, before any
    kernel could read past the spectra."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < -T or idx.max() >= T):
        raise IndexError(f"{name} out of range for a stack of {T} "
                         "spectrograms")
    return np.where(idx < 0, idx + T, idx)


def _runs(keys):
    """``(start, stop)`` of each run of equal values of ``keys``."""
    if not keys.size:
        return []
    cut = np.flatnonzero(np.diff(keys)) + 1
    return list(zip([0, *cut.tolist()], [*cut.tolist(), keys.size]))


def _cell_peaks(sp, ii, jj):
    """The plain version's cells: peaks and flat argmaxes of the
    normalized 2-D correlations of the cells ``(ii, jj)`` of the stack
    ``sp``, on ``sp``'s device."""
    n1, n2 = sp.shape[-2], sp.shape[-1]
    nf = ops.fft.next_fast_len(2 * n1 - 1)
    nl = ops.fft.next_fast_len(2 * n2 - 1)
    a = _normed(sp[ii])
    b = _normed(sp[jj])
    A = torch.fft.rfft2(a, s=(nf, nl))
    B = torch.fft.rfft2(b, s=(nf, nl))
    r = torch.fft.irfft2(A * torch.conj(B), s=(nf, nl))
    # fftshift both axes to linear lags
    r = ops.cc.lag_slice_of_circular(r.movedim(-2, -1), n1, nf, 0,
                                     2 * n1 - 1).movedim(-1, -2)
    r = ops.cc.lag_slice_of_circular(r, n2, nl, 0, 2 * n2 - 1)
    flat = r.reshape(r.shape[0], -1)
    k = torch.argmax(flat, dim=-1)
    return torch.gather(flat, -1, k[:, None])[:, 0], k


def _correlate_spectrograms_plain(specs, i_idx, j_idx, batch: int = 64,
                                  mesh=None, device="cuda"):
    """The plain version of :func:`correlate_spectrograms` (the tests' and
    the card's A/B, nothing on the main path): batched normalized 2-D
    correlation peaks between spectrogram pairs, on ``device``
    (``'cuda'`` by default, which raises without a card).

    specs: (T, F, L) stack; (i_idx, j_idx): cell index lists.
    Returns (peak, df_shift, dl_shift) arrays of len(cells), where the
    shifts are argmax offsets in bins relative to zero lag. Each batch
    gathers both spectrograms of ``batch`` cells, normalizes them,
    correlates them through ``rfft2``/``irfft2`` at the port's
    cuFFT-fast lengths and takes the flat argmax; the last batch runs at
    its own size.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`, in place of ``device``):
    the stack goes to each of its devices, ``batch`` is rounded to a
    multiple of its size, as the JAX package rounds it, and each batch
    splits into contiguous shares, one per entry, each run on the
    entry's device; the results come back in cell order.
    """
    if mesh is None:
        devices = (resolve_device(device),)
    else:
        from ..parallel.mesh import split
        devices = tuple(resolve_device(d) for d in mesh.devices)
        batch = max(batch, mesh.size) // mesh.size * mesh.size
    uniq = tuple(dict.fromkeys(devices))
    stacks = {d: to_device(specs, d) for d in uniq}
    ii = np.asarray(i_idx, dtype=np.int64)
    jj = np.asarray(j_idx, dtype=np.int64)
    cells = {d: (to_device(ii, d), to_device(jj, d)) for d in uniq}
    n1, n2 = stacks[devices[0]].shape[-2:]
    w = 2 * n2 - 1
    ncells = ii.shape[0]
    # each device's outputs hold the cells its entries ran
    peaks = {d: torch.empty(ncells, dtype=stacks[d].dtype, device=d)
             for d in uniq}
    am = {d: torch.empty(ncells, dtype=torch.int64, device=d)
          for d in uniq}
    owner = np.zeros(ncells, dtype=np.intp)   # index into uniq
    for s in range(0, ncells, batch):
        rows = min(batch, ncells - s)
        parts = [(devices[0], 0, rows)] if mesh is None else \
            split(mesh, rows)
        for d, a, b in parts:
            rs = slice(s + a, s + b)
            peaks[d][rs], am[d][rs] = _cell_peaks(
                stacks[d], cells[d][0][rs], cells[d][1][rs])
            owner[rs] = uniq.index(d)
    if len(uniq) == 1:
        pk_host = to_numpy(peaks[uniq[0]]).astype(np.float32)
        am_host = to_numpy(am[uniq[0]])
    else:
        pk_host = np.empty(ncells, dtype=np.float32)
        am_host = np.empty(ncells, dtype=np.int64)
        for k, d in enumerate(uniq):
            mine = owner == k
            pk_host[mine] = to_numpy(peaks[d])[mine]
            am_host[mine] = to_numpy(am[d])[mine]
    return (pk_host,
            (am_host // w - (n1 - 1)).astype(np.int32),
            (am_host % w - (n2 - 1)).astype(np.int32))


def pair_spectrograms(datasets, times, clim=(1460.0, 1500.0),
                      duration: float = 2.5, padding_factor: int = 4,
                      filter_kwargs: dict = None, device="cuda"):
    """The spectrogram cache of one pair: ``(specs, freq)``.

    ``datasets`` yields one CCF dataset (or None) per entry of ``times``;
    each is postprocessed and the spectrogram of its window nearest to the
    time is kept as a float32 ``(freq, lag)`` array, trimmed to the first
    one's lag size; None where there is no dataset or postprocess leaves
    no data. ``freq`` is the spectrograms' frequency coordinate (None when
    none was made).
    """
    specs = []
    freq_coord = None
    lag_size = None
    for t, shard in zip(times, datasets):
        if shard is None:
            specs.append(None)
            continue
        try:
            shard = postprocess(shard, clim=clim,
                                filter_kwargs=filter_kwargs, device=device)
        except ValueError:
            specs.append(None)
            continue
        cc = shard["cc"]
        # nearest window to the triggered time
        tv = pd.DatetimeIndex(cc.coords["time"].values)
        k = int(np.argmin(np.abs(tv - t)))
        one = cc.isel(time=k).squeeze("pair")
        psd = spectrogram(one, duration=duration,
                          padding_factor=padding_factor, device=device)
        if freq_coord is None:
            freq_coord = psd.coords["freq"].values
            lag_size = psd.sizes["lag"]
        if psd.sizes["lag"] != lag_size:
            psd = psd.isel(lag=slice(0, lag_size))
        specs.append(np.asarray(psd.values, dtype=np.float32))
    return specs, freq_coord


def fill_cells(ds, ip, ifb, iu, ju, valid, correlate):
    """Correlate and write the cells of pair ``ip`` and band ``ifb``: the
    upper-triangle cells ``(iu, ju)`` whose two times are both in
    ``valid`` (the times with a spectrogram, ascending), correlated by
    ``correlate(ii, jj)`` (their positions in the stack of the valid
    times; it returns ``(peaks, df_shifts, dl_shifts)``), and written
    into ``cc2``, ``delta_freq``, ``delta_lag`` and ``status`` (1) of
    ``ds`` with one indexed assignment each. Returns the number of
    cells. The plain version, :func:`_fill_cells_plain`, scans ``valid``
    for each cell and writes cell by cell; both write the same bits."""
    pos = np.full(ds.sizes["time1"], -1, dtype=np.int64)
    pos[np.asarray(valid, dtype=np.int64)] = np.arange(len(valid))
    keep = (pos[iu] >= 0) & (pos[ju] >= 0)
    a, b = iu[keep], ju[keep]
    if not a.size:
        return 0
    peaks, dfs, dls = correlate(pos[a], pos[b])
    for name, v in (("cc2", peaks), ("delta_freq", dfs),
                    ("delta_lag", dls), ("status", 1)):
        ds[name].values[ip, ifb, a, b] = v
    return int(a.size)


def _fill_cells_plain(ds, ip, ifb, iu, ju, valid, correlate):
    """The plain version of :func:`fill_cells`: a scan of ``valid`` for
    each cell and four writes per cell."""
    cells = [(a, b) for a, b in zip(iu, ju)
             if a in valid and b in valid]
    if not cells:
        return 0
    vmap = {v: k for k, v in enumerate(valid)}
    ii = [vmap[a] for a, b in cells]
    jj = [vmap[b] for a, b in cells]
    peaks, dfs, dls = correlate(ii, jj)
    for (a, b), pk, df_, dl_ in zip(cells, peaks, dfs, dls):
        ds["cc2"].values[ip, ifb, a, b] = pk
        ds["delta_freq"].values[ip, ifb, a, b] = df_
        ds["delta_lag"].values[ip, ifb, a, b] = dl_
        ds["status"].values[ip, ifb, a, b] = 1
    return len(cells)


#: the forms of this module, each beside its plain version
#: ``_<name>_plain``, so that a caller can put the plain ones in place
FORMS = ("correlate_spectrograms", "fill_cells")


def _read_shards(pair, times, root):
    """One shard (or None) per time, read as they are iterated."""
    from .. import io as xio
    from ..io.filesystem import ncfile
    for t in times:
        nc = ncfile(pair, t, root)
        yield xio.read(nc, fast=True) if os.path.exists(nc) else None


def timelapse(pairs, times, root, freq_bands=((3.0, 6.0), (6.0, 12.0)),
              clim=(1460.0, 1500.0), duration: float = 2.5,
              padding_factor: int = 4, attrs: dict = None,
              batch: int = 64, filter_kwargs: dict = None,
              mesh=None, verb: int = 1, device="cuda"):
    """Full timelapse computation for the given triggered times, from the
    shards under ``root``, on ``device``; with ``mesh``, the cells of each
    (pair, band) split over the mesh (:func:`correlate_spectrograms`)."""
    device = resolve_device(device)
    times = pd.DatetimeIndex(np.asarray(times))
    ds = init_timelapse(list(pairs), times.values, freq_bands, attrs)
    iu, ju = np.triu_indices(len(times))

    for ip, pair in enumerate(pairs):
        # load + postprocess + spectrogram ONCE per triggered time
        specs, freq_coord = pair_spectrograms(
            _read_shards(pair, times, root), times, clim=clim,
            duration=duration, padding_factor=padding_factor,
            filter_kwargs=filter_kwargs, device=device)
        valid = [i for i, s in enumerate(specs) if s is not None]
        if len(valid) < 2:
            continue
        if verb:
            print(f"{pair}: {len(valid)} spectrograms cached")

        for ifb, (f0, f1) in enumerate(freq_bands):
            sel = (freq_coord >= f0) & (freq_coord <= f1)
            if not sel.any():
                continue
            stack = np.stack([specs[i][sel] for i in valid])
            ncells = fill_cells(
                ds, ip, ifb, iu, ju, valid,
                lambda ii, jj: correlate_spectrograms(
                    stack, ii, jj, batch=batch, mesh=mesh, device=device))
            if not ncells:
                continue
            if verb:
                print(f"  band {f0}-{f1} Hz: {ncells} cells")

    # mirror the lower triangle (cc2 symmetric; shifts antisymmetric)
    for name, sign in (("cc2", 1), ("delta_freq", -1), ("delta_lag", -1),
                       ("status", 1)):
        v = ds[name].values
        ds[name].values[:] = np.where(
            np.isnan(v) if v.dtype.kind == "f" else (v == 0),
            sign * np.swapaxes(v, -1, -2), v)
    return ds


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-timelapse",
        description="2-D CC of CCF spectrograms on the (time1,time2) "
                    "plane (PyTorch port).")
    parser.add_argument("ct", metavar="ct", type=str,
                        help="Coincidence-trigger netCDF (xcorr-torch-ct), "
                             "or 'all' with --start/--end for every day")
    parser.add_argument("--root", metavar="..", type=str, default="data/cc")
    parser.add_argument("--pair", metavar="..", type=str, action="append",
                        required=True)
    parser.add_argument("--start", metavar="..", type=str, default=None)
    parser.add_argument("--end", metavar="..", type=str, default=None)
    parser.add_argument("--freq", metavar="..", type=float, nargs=2,
                        action="append", default=None,
                        help="Frequency band (repeatable)")
    parser.add_argument("--celerity", metavar="..", type=float, nargs=2,
                        default=(1460.0, 1500.0))
    parser.add_argument("--filter-freq", metavar="..", type=float,
                        default=3.0,
                        help="Postprocess highpass corner (Hz)")
    parser.add_argument("--duration", metavar="..", type=float,
                        default=2.5, help="Spectrogram segment length (s)")
    parser.add_argument("--out", metavar="..", type=str, default=None)
    parser.add_argument("--init", action="store_true", default=False,
                        help="Only initialize the (time1,time2) dataset")
    parser.add_argument("--update", metavar="..", type=str, default=None,
                        help="Resume/extend an existing timelapse netCDF")
    utils.add_common_arguments(parser)
    utils.add_attrs_group(parser)
    args = parser.parse_args(argv)

    log = utils.init_logging(args.debug)
    device = resolve_device(utils.init_compute(args)["device"])
    attrs = utils.parse_attrs(args)
    from .. import io as xio

    if args.ct == "all":
        times = pd.date_range(args.start, args.end, freq="1D")
    else:
        ct_ds = xio.read(args.ct, fast=True) or xio.from_netcdf(args.ct)
        trig = ct_ds["ct"].values
        tvals = pd.DatetimeIndex(ct_ds.coords["time"].values)
        times = tvals[~np.isnan(np.asarray(trig, dtype=float))]
        times = pd.DatetimeIndex(sorted(set(times.normalize())))
    freq_bands = args.freq or [(3.0, 6.0), (6.0, 12.0)]
    log.info("timelapse: %d pairs x %d times x %d bands on %s",
             len(args.pair), len(times), len(freq_bands), device)

    if args.init:
        ds = init_timelapse(args.pair, times.values, freq_bands, attrs)
    else:
        ds = timelapse(args.pair, times, args.root, freq_bands=freq_bands,
                       clim=tuple(args.celerity), attrs=attrs,
                       duration=args.duration,
                       filter_kwargs={"frequency": args.filter_freq,
                                      "btype": "highpass", "order": 2},
                       device=device)
        if args.update and os.path.exists(args.update):
            from ..ndlabel import combine_by_coords
            old = xio.read(args.update, fast=True) or \
                xio.from_netcdf(args.update)
            ds = combine_by_coords([old, ds])

    out = args.out or utils.ncfile_name(
        (args.prefix or "") + "timelapse", times[0], times[-1],
        args.suffix)
    if os.path.exists(out) and not args.overwrite and not args.update:
        log.error("%s exists (use --overwrite)", out)
        return 1
    xio.write(ds, out, verb=1, force_write=True)
    log.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
