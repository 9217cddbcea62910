# Carried from xcorr_tpu/stream/trace.py (see test_torch_host_copies).
r"""
:mod:`stream.trace` -- Trace / Stream / Stats / UTCDateTime
===========================================================

A lightweight waveform container replacing the reference's obspy dependency
at the host edge (obspy is not part of this build). Semantics of the methods
mirror ``obspy.Trace``/``obspy.Stream`` as exercised by the reference's
preprocess DSL (``xcorr/stream/process.py:29-94``).

The heavy per-sample math here is *host fallback only* — the production
path compiles the same operations to fused XLA kernels
(:mod:`xcorr_tpu.ops`) over dense batches.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.signal as sp_signal
from . import _steps
from ._fftlen import next_fast_len
from ._lanczos import lanczos_interp

__all__ = ["UTCDateTime", "Stats", "Trace", "Stream"]


class UTCDateTime:
    """Nanosecond UTC datetime with float-seconds arithmetic
    (obspy.UTCDateTime-compatible subset)."""

    __slots__ = ("_ns",)

    def __init__(self, value=0):
        if isinstance(value, UTCDateTime):
            self._ns = value._ns
        elif isinstance(value, (int, float, np.integer, np.floating)):
            self._ns = int(round(float(value) * 1e9))
        else:
            ts = pd.Timestamp(value)
            if ts.tz is not None:
                ts = ts.tz_convert("UTC").tz_localize(None)
            self._ns = ts.value

    # arithmetic in seconds
    def __add__(self, seconds):
        out = UTCDateTime.__new__(UTCDateTime)
        out._ns = self._ns + int(round(float(seconds) * 1e9))
        return out

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, UTCDateTime):
            return (self._ns - other._ns) / 1e9
        return self.__add__(-float(other))

    def __eq__(self, o):
        return isinstance(o, UTCDateTime) and self._ns == o._ns

    def __lt__(self, o): return self._ns < UTCDateTime(o)._ns
    def __le__(self, o): return self._ns <= UTCDateTime(o)._ns
    def __gt__(self, o): return self._ns > UTCDateTime(o)._ns
    def __ge__(self, o): return self._ns >= UTCDateTime(o)._ns
    def __hash__(self): return hash(self._ns)

    @property
    def datetime(self):
        return pd.Timestamp(self._ns).to_pydatetime()

    @property
    def timestamp(self):
        return self._ns / 1e9

    @property
    def ns(self):
        return self._ns

    def strftime(self, fmt):
        return pd.Timestamp(self._ns).strftime(fmt)

    @property
    def year(self): return pd.Timestamp(self._ns).year

    @property
    def julday(self): return pd.Timestamp(self._ns).dayofyear

    def __repr__(self):
        return f"UTCDateTime({pd.Timestamp(self._ns).isoformat()}Z)"

    def __str__(self):
        return f"{pd.Timestamp(self._ns).isoformat()}Z"


class Stats(dict):
    """Trace metadata with attribute access and derived fields
    (endtime, delta)."""

    _defaults = {
        "network": "", "station": "", "location": "", "channel": "",
        "sampling_rate": 1.0, "npts": 0,
    }

    def __init__(self, header=None, **kw):
        super().__init__()
        merged = {**self._defaults, **(dict(header) if header else {}), **kw}
        st = merged.pop("starttime", None)
        merged["starttime"] = UTCDateTime(st) if st is not None \
            else UTCDateTime(0)
        for k, v in merged.items():
            self[k] = v

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        self[key] = value

    def __getitem__(self, key):
        if key == "endtime":
            return self["starttime"] + (
                (self["npts"] - 1) / self["sampling_rate"]
                if self["npts"] else 0.0)
        if key == "delta":
            return 1.0 / self["sampling_rate"]
        return super().__getitem__(key)

    def __contains__(self, key):
        return key in ("endtime", "delta") or super().__contains__(key)

    def copy(self):
        return Stats(self)


class Trace:
    """A single continuous waveform: numpy samples + Stats."""

    def __init__(self, data=None, header=None):
        self.data = np.asarray(data if data is not None else [],
                               dtype=np.float64 if data is None
                               else np.asarray(data).dtype)
        self.stats = header if isinstance(header, Stats) else Stats(header)
        self.stats.npts = self.data.size

    # -- identity ----------------------------------------------------------

    @property
    def id(self):
        s = self.stats
        return f"{s.network}.{s.station}.{s.location}.{s.channel}"

    def __len__(self):
        return self.data.size

    def __repr__(self):
        s = self.stats
        return (f"{self.id} | {s.starttime} - {s.endtime} | "
                f"{s.sampling_rate:.1f} Hz, {s.npts} samples")

    def copy(self):
        return Trace(self.data.copy(), self.stats.copy())

    def times(self):
        return np.arange(self.stats.npts) / self.stats.sampling_rate

    # -- operations (obspy.Trace method subset used by the ops DSL) --------

    def detrend(self, type="simple", **kw):
        x = _steps.as_float64(self.data)
        if type in ("demean", "constant"):
            self.data = _steps.demean(x)
        elif type == "linear":
            self.data = sp_signal.detrend(x, type="linear")
        elif type == "simple":
            n = x.size
            if n > 1:
                slope = (x[-1] - x[0]) / (n - 1)
                self.data = x - (x[0] + np.arange(n) * slope)
        else:
            raise ValueError(f"unknown detrend type {type!r}")
        return self

    def taper(self, max_percentage, type="hann", max_length=None,
              side="both", **kw):
        n = self.data.size
        if max_percentage is None:
            wlen = int(max_length * self.stats.sampling_rate)
        else:
            wlen = int(n * float(max_percentage))
            if max_length is not None:
                wlen = min(wlen, int(max_length * self.stats.sampling_rate))
        wlen = min(wlen, n // 2)
        if wlen < 1:
            return self
        if type == "cosine":
            # obspy 'cosine' taper: cosine ramp over wlen samples
            ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(wlen) / wlen))
        else:
            # obspy builds symmetric windows of 2*wlen+1 and takes each
            # side; the periodic 2*wlen window is its exact truncation
            # (and ops.taper.taper_vector's form — host and device
            # chains must produce identical tapers)
            win = sp_signal.get_window(type, 2 * wlen, fftbins=True)
            ramp = win[:wlen]
        taper = np.ones(n)
        if side in ("both", "left"):
            taper[:wlen] = ramp
        if side in ("both", "right"):
            taper[n - wlen:] = ramp[::-1]
        self.data = self.data * taper
        return self

    def filter(self, type, zerophase=False, corners=4, **options):
        fs = self.stats.sampling_rate
        nyq = 0.5 * fs
        if type == "bandpass":
            wn = [options["freqmin"] / nyq, options["freqmax"] / nyq]
            sos = sp_signal.butter(corners, wn, btype="bandpass",
                                   output="sos")
        elif type == "bandstop":
            wn = [options["freqmin"] / nyq, options["freqmax"] / nyq]
            sos = sp_signal.butter(corners, wn, btype="bandstop",
                                   output="sos")
        elif type == "highpass":
            sos = sp_signal.butter(corners, options["freq"] / nyq,
                                   btype="highpass", output="sos")
        elif type == "lowpass":
            sos = sp_signal.butter(corners, options["freq"] / nyq,
                                   btype="lowpass", output="sos")
        else:
            raise ValueError(f"unknown filter type {type!r}")
        if zerophase:
            self.data = _steps.sosfiltfilt(sos, self.data)
        else:
            self.data = _steps.sosfilt(sos, self.data)
        return self

    def decimate(self, factor, no_filter=False, **kw):
        if not no_filter:
            # obspy default anti-alias: zero-phase lowpass at 0.4x new nyq...
            # obspy uses integerDecimation preceded by lowpass_cheby_2
            fs = self.stats.sampling_rate
            freq = fs * 0.5 / float(factor)
            sos = sp_signal.cheby2(10, 96, 0.98 * freq, btype="lowpass",
                                   fs=fs, output="sos")
            self.data = _steps.sosfilt(sos, self.data)
        self.data = _steps.every(self.data, factor)
        self.stats.sampling_rate = self.stats.sampling_rate / float(factor)
        self.stats.npts = self.data.size
        return self

    def interpolate(self, sampling_rate, method="lanczos", a=20,
                    starttime=None, npts=None, **kw):
        """Lanczos (windowed-sinc) interpolation onto a new sampling rate."""
        old_fs = self.stats.sampling_rate
        old_t0 = self.stats.starttime
        t0 = UTCDateTime(starttime) if starttime is not None else old_t0
        offset = t0 - old_t0  # seconds
        if npts is None:
            duration = (self.stats.npts - 1) / old_fs - offset
            npts = int(np.floor(duration * sampling_rate)) + 1
        new_times = offset + np.arange(npts) / sampling_rate  # in old-t0 sec
        pos = new_times * old_fs  # fractional sample positions
        if method == "lanczos":
            self.data = lanczos_interp(self.data.astype(np.float64), pos, a)
        else:
            self.data = np.interp(pos, np.arange(self.stats.npts),
                                  self.data.astype(np.float64))
        self.stats.sampling_rate = float(sampling_rate)
        self.stats.starttime = t0
        self.stats.npts = self.data.size
        return self

    def resample(self, sampling_rate, **kw):
        """Fourier resampling (obspy.Trace.resample analog)."""
        num = int(round(self.stats.npts * sampling_rate
                        / self.stats.sampling_rate))
        self.data = sp_signal.resample(self.data.astype(np.float64), num)
        self.stats.sampling_rate = float(sampling_rate)
        self.stats.npts = self.data.size
        return self

    def normalize(self, **kw):
        m = np.abs(self.data).max()
        if m > 0:
            self.data = self.data / m
        return self

    def trim(self, starttime=None, endtime=None, pad=False, fill_value=0.0,
             nearest_sample=True, **kw):
        fs = self.stats.sampling_rate
        t0 = self.stats.starttime
        i0 = 0
        i1 = self.stats.npts
        if starttime is not None:
            starttime = UTCDateTime(starttime)
            off = (starttime - t0) * fs
            i0 = int(round(off)) if nearest_sample else int(np.ceil(off))
        if endtime is not None:
            endtime = UTCDateTime(endtime)
            off = (endtime - t0) * fs
            i1 = (int(round(off)) if nearest_sample
                  else int(np.floor(off))) + 1
        if pad:
            # count the requested grid samples before / inside / after
            # the data so the output is ALWAYS i1-i0 samples, including
            # windows disjoint from the data (the naive left/right/
            # slice split returned i1-npts samples for an
            # entirely-after window)
            npts = self.stats.npts
            left = max(0, min(i1, 0) - i0)
            right = max(0, i1 - max(i0, npts))
            lo = min(max(i0, 0), npts)
            hi = max(min(i1, npts), lo)
            data = self.data[lo:hi]
            if left or right:
                data = np.concatenate([
                    np.full(left, fill_value, dtype=data.dtype),
                    data,
                    np.full(right, fill_value, dtype=data.dtype),
                ])
        else:
            i0c, i1c = max(i0, 0), min(i1, self.stats.npts)
            data = self.data[i0c:i1c]
            i0 = i0c
        self.data = data
        self.stats.starttime = t0 + i0 / fs
        self.stats.npts = data.size
        return self

    def slice(self, starttime=None, endtime=None, **kw):
        return self.copy().trim(starttime, endtime, **kw)

    def remove_sensitivity(self, inventory=None, **kw):
        sens = inventory.get_sensitivity(self.id, self.stats.starttime)
        self.data = _steps.divide(self.data, float(sens))
        return self

    def remove_response(self, inventory=None, output="VEL",
                        water_level=60.0, pre_filt=None, **kw):
        """Deconvolve the instrument response by water-level spectral
        division (obspy.Trace.remove_response algorithm)."""
        from ._response import inverse_response
        from .inventory import flat_response
        resp = (inventory.get_response(self.id, self.stats.starttime)
                if inventory is not None else flat_response())
        n = self.stats.npts
        nfft = next_fast_len(2 * n)
        inv_r, taper = inverse_response(resp, nfft, self.stats.delta,
                                        output, water_level, pre_filt)
        self.data = _steps.deconvolve(self.data, n, nfft, inv_r, taper)
        return self

    def attach_response(self, inventory=None, **kw):
        if inventory is not None:
            self.stats["response"] = inventory.get_response(
                self.id, self.stats.starttime)
        return self

    def simulate(self, paz_remove=None, paz_simulate=None,
                 water_level=60.0, **kw):
        """PAZ-based deconvolution/convolution (obspy.Trace.simulate
        subset)."""
        from .inventory import PAZResponse
        n = self.stats.npts
        nfft = next_fast_len(2 * n)
        freqs = np.fft.rfftfreq(nfft, d=self.stats.delta)
        spec = np.fft.rfft(self.data.astype(np.float64), nfft)
        if paz_remove is not None:
            r = PAZResponse(**paz_remove).evaluate(freqs)
            spec = spec * _invert_spectrum_water_level(r, water_level)
        if paz_simulate is not None:
            spec = spec * PAZResponse(**paz_simulate).evaluate(freqs)
        self.data = np.fft.irfft(spec, nfft)[:n]
        return self


def _lanczos_interp(x, pos, a):
    """Lanczos windowed-sinc interpolation at fractional positions."""
    n = x.size
    i0 = np.floor(pos).astype(int)
    out = np.zeros(pos.size, dtype=np.float64)
    wsum = np.zeros(pos.size, dtype=np.float64)
    for k in range(-a + 1, a + 1):
        idx = i0 + k
        valid = (idx >= 0) & (idx < n)
        t = pos - idx
        w = np.sinc(t) * np.sinc(t / a) * (np.abs(t) < a)
        out += np.where(valid, x[np.clip(idx, 0, n - 1)] * w, 0.0)
        wsum += np.where(valid, w, 0.0)
    # renormalize by the in-bounds kernel mass; zero-mass samples (all
    # taps out of range) pass through as the accumulated 0
    out = np.where(wsum > 0, out / np.where(wsum > 0, wsum, 1.0), out)
    return out


def _cosine_sac_taper(freqs, flimit):
    """SAC-style cosine taper between (f1, f2, f3, f4) corner
    frequencies (obspy.signal.invsim.cosine_sac_taper analog)."""
    f1, f2, f3, f4 = flimit
    taper = np.zeros_like(freqs)
    a = (freqs >= f2) & (freqs <= f3)
    taper[a] = 1.0
    b = (freqs > f1) & (freqs < f2)
    taper[b] = 0.5 * (1.0 + np.cos(np.pi * (f2 - freqs[b]) / (f2 - f1)))
    c = (freqs > f3) & (freqs < f4)
    taper[c] = 0.5 * (1.0 + np.cos(np.pi * (freqs[c] - f3) / (f4 - f3)))
    return taper


def _invert_spectrum_water_level(spec, water_level_db):
    """Water-level spectral inversion (obspy invert_spectrum analog)."""
    amp = np.abs(spec)
    max_amp = amp.max() if amp.size else 1.0
    swamp = max_amp * 10 ** (-water_level_db / 20.0)
    low = amp < swamp
    safe = np.where(amp > 0, spec, 1.0)
    scaled = np.where(
        low & (amp > 0), swamp * safe / np.abs(safe), safe)
    out = np.zeros_like(spec)
    nz = np.abs(scaled) > 0
    out[nz] = 1.0 / scaled[nz]
    out[~np.isfinite(out)] = 0.0
    return out


class Stream:
    """Ordered collection of Traces (obspy.Stream subset)."""

    def __init__(self, traces=None):
        self.traces = list(traces) if traces else []

    def __iter__(self):
        return iter(self.traces)

    def __len__(self):
        return len(self.traces)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Stream(self.traces[i])
        return self.traces[i]

    def __add__(self, other):
        if isinstance(other, Trace):
            return Stream(self.traces + [other])
        return Stream(self.traces + list(other))

    def __iadd__(self, other):
        if isinstance(other, Trace):
            self.traces.append(other)
        else:
            self.traces.extend(list(other))
        return self

    def __repr__(self):
        return "\n".join([f"{len(self)} Trace(s) in Stream:"]
                         + [repr(t) for t in self.traces])

    def append(self, trace):
        self.traces.append(trace)
        return self

    def plot(self, show: bool = False, **kwargs):
        """Quick waveform figure, one axis per trace (the reference's
        ``Stream.plot()`` via obspy, ``examples/stream/client.py``).
        Returns the matplotlib figure; ``show=True`` also displays it."""
        import matplotlib.pyplot as plt
        n = max(len(self.traces), 1)
        fig, axes = plt.subplots(n, 1, sharex=True, squeeze=False,
                                 figsize=kwargs.pop("figsize", (10, 2 * n)),
                                 **kwargs)
        for ax, tr in zip(axes[:, 0], self.traces):
            t = (pd.Timestamp(tr.stats.starttime.ns)
                 + pd.to_timedelta(np.arange(tr.stats.npts)
                                   / tr.stats.sampling_rate, unit="s"))
            ax.plot(t, tr.data, lw=0.4, color="k")
            ax.set_ylabel(tr.id, fontsize=8)
        axes[-1, 0].set_xlabel("time")
        fig.tight_layout()
        if show:
            plt.show()
        return fig

    def copy(self):
        return Stream([t.copy() for t in self.traces])

    def sort(self, keys=("network", "station", "location", "channel",
                         "starttime")):
        self.traces.sort(key=lambda t: tuple(
            t.stats[k].ns if k in ("starttime", "endtime") else t.stats[k]
            for k in keys))
        return self

    def select(self, network=None, station=None, location=None, channel=None,
               **kw):
        from fnmatch import fnmatch
        out = []
        for t in self.traces:
            s = t.stats
            if network is not None and not fnmatch(s.network, network):
                continue
            if station is not None and not fnmatch(s.station, station):
                continue
            if location is not None and not fnmatch(s.location, location):
                continue
            if channel is not None and not fnmatch(s.channel, channel):
                continue
            out.append(t)
        return Stream(out)

    def merge(self, method=1, fill_value=None, interpolation_samples=0,
              dtype=None, **kw):
        """Merge traces with identical ids; gaps are filled
        (``fill_value='interpolate'`` linearly bridges gaps, matching the
        reference's canonical merge op, ``xcorr/stream/process.py:421-425``).

        The output preserves the traces' common dtype (obspy-compatible;
        pass ``dtype=`` to override) and gaps are tracked as INTERVALS
        from the trace layout — no sentinel scan over the merged array,
        so a day-scale union span merges in one allocation + one copy
        pass. NaN samples INSIDE trace data are payload and pass through
        untouched (obspy semantics; the previous NaN-sentinel fill would
        have bridged them).
        """
        by_id = {}
        for t in self.traces:
            by_id.setdefault((t.id, t.stats.sampling_rate), []).append(t)
        merged = []
        for (tid, fs), traces in by_id.items():
            traces.sort(key=lambda t: t.stats.starttime.ns)
            t0 = traces[0].stats.starttime
            t1 = max(t.stats.endtime for t in traces)
            npts = int(round((t1 - t0) * fs)) + 1
            out_dtype = dtype or np.result_type(
                *(t.data.dtype for t in traces))
            interpolate = (fill_value == "interpolate")
            if not np.issubdtype(out_dtype, np.floating) and (
                    interpolate or (
                        isinstance(fill_value, (float, np.floating))
                        and not (np.isfinite(fill_value)
                                 and float(fill_value).is_integer()))):
                out_dtype = np.float64  # float fill on integer traces
            # covered-interval sweep (traces sorted by start): the
            # first trace starts at index 0 and the last covered index
            # is npts-1, so every gap is interior with valid samples on
            # both sides
            spans, gaps, cov_end = [], [], 0
            for t in traces:
                i0 = int(round((t.stats.starttime - t0) * fs))
                if i0 > cov_end:
                    gaps.append((cov_end, i0))
                cov_end = max(cov_end, i0 + t.stats.npts)
                spans.append(i0)
            if gaps and fill_value is None and method == 0:
                raise ValueError("gaps present and no fill_value given")
            # calloc: gap regions are already the default 0.0 fill
            data = _steps.merged(traces, spans, npts, out_dtype)
            for g0, g1 in gaps:
                if interpolate:
                    # same formula as np.interp over the gap indices
                    # with the nearest valid neighbors as knots
                    data[g0:g1] = np.interp(
                        np.arange(g0, g1), [g0 - 1, g1],
                        [float(data[g0 - 1]), float(data[g1])])
                elif fill_value is not None:
                    data[g0:g1] = fill_value
            stats = traces[0].stats.copy()
            stats.npts = npts
            merged.append(Trace(data, stats))
        self.traces = merged
        self.sort()
        return self

    def rotate(self, method, back_azimuth=None, inventory=None, **kw):
        """'NE->RT' and '->ZNE' rotations (obspy.Stream.rotate subset)."""
        if method == "->ZNE":
            # our synthetic/archive data is already ZNE/Z12; map 1->N, 2->E
            for t in self.traces:
                if t.stats.channel.endswith("1"):
                    t.stats.channel = t.stats.channel[:-1] + "N"
                elif t.stats.channel.endswith("2"):
                    t.stats.channel = t.stats.channel[:-1] + "E"
            return self
        if method == "NE->RT":
            if back_azimuth is None:
                raise ValueError("back_azimuth required for NE->RT")
            ba = np.radians(back_azimuth)
            for base in {t.stats.channel[:-1] for t in self.traces}:
                n = self.select(channel=base + "N")
                e = self.select(channel=base + "E")
                if len(n) == 1 and len(e) == 1:
                    ndat, edat = n[0].data, e[0].data
                    r = -edat * np.sin(ba) - ndat * np.cos(ba)
                    t_ = -edat * np.cos(ba) + ndat * np.sin(ba)
                    n[0].data, n[0].stats.channel = r, base + "R"
                    e[0].data, e[0].stats.channel = t_, base + "T"
            return self
        raise ValueError(f"unsupported rotate method {method!r}")

    # broadcast trace methods over all traces
    def _broadcast(self, name, *args, **kw):
        for t in self.traces:
            getattr(t, name)(*args, **kw)
        return self

    def detrend(self, *a, **k): return self._broadcast("detrend", *a, **k)
    def taper(self, *a, **k): return self._broadcast("taper", *a, **k)
    def filter(self, *a, **k): return self._broadcast("filter", *a, **k)
    def decimate(self, *a, **k): return self._broadcast("decimate", *a, **k)
    def normalize(self, *a, **k): return self._broadcast("normalize", *a, **k)
    def trim(self, *a, **k): return self._broadcast("trim", *a, **k)
    def resample(self, *a, **k): return self._broadcast("resample", *a, **k)

    def interpolate(self, *a, **k):
        return self._broadcast("interpolate", *a, **k)

    def remove_response(self, *a, **k):
        return self._broadcast("remove_response", *a, **k)

    def remove_sensitivity(self, *a, **k):
        return self._broadcast("remove_sensitivity", *a, **k)

    def attach_response(self, *a, **k):
        return self._broadcast("attach_response", *a, **k)

    def simulate(self, *a, **k): return self._broadcast("simulate", *a, **k)
