# Carried from xcorr_tpu/core/plot.py (see test_torch_host_copies).
r"""
:mod:`core.plot` -- CCF plotting helpers
========================================

Matplotlib convenience plots with visual parity to the reference
(``xcorr/core/plot.py:31-520``): ``plot_ccf`` (CCF + spectrogram panel
with celerity ticks), ``plot_ccfs`` (per-pair stacked axes),
``plot_ccfs_colored`` (pair-colored overlay with SNR filtering),
``plot_snr_ct`` (per-pair SNR lines + shaded coincidence triggers) and
``set_year_labels`` (center-positioned year tick labels).

Inputs are :mod:`xcorr_tpu.ndlabel` objects; every entry point accepts
either the ``cc`` DataArray (reference signature) or the whole Dataset
(``ds.xcorr.plot_ccf()`` accessor convenience — the ``distance``
variable is then picked up automatically).
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_ccf", "plot_ccfs", "plot_ccfs_colored", "plot_snr_ct",
           "set_year_labels"]


def _abs_scale(vals) -> float:
    """Max |vals| as a normalization scale; 1.0 for empty/all-NaN/zero
    input (``nan or 1.0`` is nan — NaN is truthy)."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        m = np.nanmax(np.abs(vals)) if np.asarray(vals).size else np.nan
    return float(m) if np.isfinite(m) and m > 0 else 1.0


def _cc_and_distance(obj, distance):
    """Accept a Dataset (grab cc + distance) or a cc DataArray."""
    if hasattr(obj, "data_vars"):
        if distance is None and "distance" in obj.data_vars:
            distance = obj["distance"]
        return obj["cc"], distance
    return obj, distance


def _isel_pair(da, pair):
    """Reduce a 'pair' dimension by integer index or label."""
    if "pair" not in da.dims:
        return da
    if isinstance(pair, str):
        return da.sel(pair=pair)
    return da.isel(pair=int(pair or 0))


def _distance_m(distance, pair=None):
    """Pair distance in meters from the distance DataArray (km-aware)."""
    if distance is None:
        return None
    factor = 1000.0 if distance.attrs.get("units") == "km" else 1.0
    if hasattr(distance, "dims") and "pair" in distance.dims:
        distance = _isel_pair(distance, pair)
    return float(np.asarray(distance.values).ravel()[0]) * factor


def _celerity_axis(ax, d, cmin, cmax, cmajor, cminor):
    """Secondary top axis with celerity ticks at lag = distance/c
    (reference ``xcorr/core/plot.py:186-193``)."""
    c_major = np.arange(cmin, cmax, cmajor)
    c_minor = np.arange(cmin, cmax, cminor)
    ax_t = ax.secondary_xaxis("top")
    ax_t.set_xticks(d / c_major)
    ax_t.set_xticklabels([f"{c:g} m/s" for c in c_major], fontsize=7,
                         fontstyle="italic")
    ax_t.set_xticks(d / c_minor, minor=True)
    ax_t.set_xlabel(" ")
    return ax_t


def plot_ccf(ds, distance=None, pair=0, time=0, normalize: bool = False,
             cmin: float = None, cmax: float = None, cmajor: float = None,
             cminor: float = None, lag_lim: tuple = None,
             freq_lim: tuple = None, spectrogram_cwt: bool = False,
             spectrogram_db: bool = True,
             spectrogram_contourf: bool = False,
             spectrogram_kwargs: dict = None,
             spectrogram_plot_kwargs: dict = None,
             cc_plot_kwargs: dict = None, envelope: bool = False,
             figure=None, **kwargs):
    """One pair's CCF traces with the spectrogram panel of one window.

    Reference parity (``xcorr/core/plot.py:31-251``): all time windows
    drawn as low-alpha lines, optional envelope, celerity secondary
    axis/limits from ``distance``, pair and time annotations, dB
    spectrogram with colorbar. ``spectrogram_cwt`` swaps the panel for
    the wavelet scaleogram (``:200-201``); ``spectrogram_contourf``
    renders filled contours instead of a pcolormesh (``:224``).
    Returns the figure's GridSpec.
    """
    import matplotlib.pyplot as plt
    from matplotlib.gridspec import GridSpec
    from matplotlib.ticker import AutoMinorLocator, StrMethodFormatter

    cc, distance = _cc_and_distance(ds, distance)
    cc = _isel_pair(cc, pair)
    pair_label = str(np.asarray(cc.coords["pair"].values).ravel()[0]) \
        if "pair" in cc.coords else ""

    vals = np.atleast_2d(np.asarray(cc.values, dtype=np.float64))
    cc_max = _abs_scale(vals)
    if normalize:
        vals = vals / cc_max
    cc_lim = (-1.05, 1.05) if normalize else (-1.05 * cc_max,
                                              1.05 * cc_max)
    cc_fmt = StrMethodFormatter("{x:.1f}" if normalize else "{x:.0e}")

    cmin = cmin or 1460.0
    cmax = cmax or 1500.0
    d = _distance_m(distance, pair)
    lag = np.asarray(cc.coords["lag"].values)
    lag_lim = lag_lim or ((d / cmax, d / cmin) if d
                          else (float(lag.min()), float(lag.max())))

    fig = figure or plt.figure(constrained_layout=True,
                               figsize=kwargs.pop("figsize", (7, 4)))
    gs = GridSpec(2, 2, figure=fig, width_ratios=(40, 1))
    ax1 = fig.add_subplot(gs[0, 0])
    ax2 = fig.add_subplot(gs[1, 0], sharex=ax1)
    ax3 = fig.add_subplot(gs[1, 1])

    cc_plot_kwargs = {"color": "k", "alpha": 0.25, "lw": 0.7,
                      **(cc_plot_kwargs or {})}
    for row in vals:
        ax1.plot(lag, row, **cc_plot_kwargs)
    if envelope:
        env = _isel_pair(ds["cc"] if hasattr(ds, "data_vars") else ds,
                         pair).signal.envelope(dim="lag")
        envv = np.atleast_2d(np.asarray(env.values, dtype=np.float64))
        if normalize:
            envv = envv / cc_max
        for row in envv:
            ax1.plot(lag, row, color="r", alpha=0.25, lw=0.7)
    ax1.set_xlim(*lag_lim)
    ax1.set_ylim(*cc_lim)
    ax1.yaxis.set_major_formatter(cc_fmt)
    ax1.set_ylabel("CCF [-]")
    ax1.xaxis.set_minor_locator(AutoMinorLocator())
    ax1.tick_params(labelbottom=False)
    ax1.yaxis.set_ticks_position("both")
    if d:
        _celerity_axis(ax1, d, cmin, cmax, cmajor or 5.0, cminor or 1.0)
    ax1.text(0.02, 0.96, pair_label, transform=ax1.transAxes,
             ha="left", va="top")
    if "time" in cc.coords:
        ax1.text(0.98, 0.96,
                 str(np.asarray(cc.coords["time"].values).ravel()[0])[:19],
                 transform=ax1.transAxes, ha="right", va="top")

    # spectrogram (or wavelet scaleogram) of one window
    mesh = _spectrogram_panel(
        ax2, cc, time, normalize, lag_lim, freq_lim, spectrogram_cwt,
        spectrogram_db, spectrogram_contourf, spectrogram_kwargs,
        spectrogram_plot_kwargs)
    cb = plt.colorbar(mesh, cax=ax3, use_gridspec=True,
                      extend="both" if spectrogram_db else "max")
    cb.set_label("PSD [dB]" if spectrogram_db else "PSD [-]")
    return gs


def _spectrogram_data(cc, time, normalize, spectrogram_cwt,
                      spectrogram_db, spectrogram_kwargs):
    """One window's spectrogram (or scaleogram) values in final
    (possibly dB) units, plus the labelled result for its coords."""
    one = cc
    if "time" in one.dims:
        one = one.isel(time=int(time))
    if spectrogram_cwt:
        p = one.signal.scaleogram(**(spectrogram_kwargs or {}))
    else:
        spectrogram_kwargs = {"duration": 2.5, "padding_factor": 4,
                              **(spectrogram_kwargs or {})}
        p = one.signal.spectrogram(**spectrogram_kwargs)
    pv = np.asarray(p.values, dtype=np.float64)
    if normalize and np.nanmax(pv):
        pv = pv / np.nanmax(pv)
    if spectrogram_db:
        pv = 10 * np.log10(np.where(pv > 0, pv, np.nan))
    return p, pv


def _spectrogram_panel(ax, cc, time, normalize, lag_lim, freq_lim,
                       spectrogram_cwt, spectrogram_db,
                       spectrogram_contourf, spectrogram_kwargs,
                       spectrogram_plot_kwargs, data=None, clim=None):
    """Draw one window's spectrogram (or wavelet scaleogram) into
    ``ax``; returns the mesh for the caller's colorbar. Shared by
    :func:`plot_ccf` (reference parity, ``xcorr/core/plot.py:198-225``)
    and :func:`plot_ccfs`'s per-pair panel variant (no reference
    analog). ``clim`` overrides the per-panel color limits — panels
    sharing one colorbar must share limits, or identical colors mean
    different values across panels."""
    from matplotlib.ticker import AutoMinorLocator

    p, pv = data if data is not None else _spectrogram_data(
        cc, time, normalize, spectrogram_cwt, spectrogram_db,
        spectrogram_kwargs)
    if clim is not None:
        vmin, vmax = clim
    else:
        vmax = np.nanmax(pv) if spectrogram_db else 0.8 * np.nanmax(pv)
        vmin = vmax - 30 if spectrogram_db else 0.0
    freq = np.asarray(p.coords["freq"].values)
    # spectrogram dims are (freq, lag) or (lag, freq); align to (freq, lag)
    if pv.shape[0] != freq.size:
        pv = pv.T
    spectrogram_plot_kwargs = {"cmap": "afmhot_r", "vmin": vmin,
                               "vmax": vmax,
                               **(spectrogram_plot_kwargs or {})}
    lagv = np.asarray(p.coords["lag"].values)
    if spectrogram_contourf:
        # an integer levels default would derive contour values from
        # each panel's own data range — multi-pair panels sharing one
        # colorbar would then color identical values differently; an
        # explicit shared level array keeps panels comparable. A
        # degenerate range (all-zero panel: vmin == vmax) would make
        # contourf raise 'levels must be increasing' — fall back to
        # matplotlib's locator there
        if np.isfinite(vmin) and np.isfinite(vmax) and vmax > vmin:
            spectrogram_plot_kwargs.setdefault(
                "levels", np.linspace(vmin, vmax, 15))
        else:
            spectrogram_plot_kwargs.setdefault("levels", 15)
        spectrogram_plot_kwargs.setdefault("extend",
                                           "both" if spectrogram_db
                                           else "max")
        mesh = ax.contourf(lagv, freq, np.nan_to_num(pv, nan=vmin),
                           **spectrogram_plot_kwargs)
    else:
        spectrogram_plot_kwargs.setdefault("shading", "auto")
        mesh = ax.pcolormesh(lagv, freq, pv, **spectrogram_plot_kwargs)
    ax.set_xlim(*lag_lim)
    if freq_lim:
        ax.set_ylim(*freq_lim)
    ax.set_xlabel("Lag [s]")
    ax.set_ylabel("Frequency [Hz]")
    ax.xaxis.set_minor_locator(AutoMinorLocator())
    ax.yaxis.set_minor_locator(AutoMinorLocator())
    ax.xaxis.set_ticks_position("both")
    ax.yaxis.set_ticks_position("both")
    return mesh


def plot_ccfs(ds, distance=None, normalize: bool = False, pairs=None,
              cmin: float = None, cmax: float = None, cmajor: float = None,
              cminor: float = None, lag_lim: tuple = None,
              cc_plot_kwargs: dict = None, figure=None,
              spectrogram: bool = False, time=0,
              freq_lim: tuple = None, spectrogram_cwt: bool = False,
              spectrogram_db: bool = True,
              spectrogram_contourf: bool = False,
              spectrogram_kwargs: dict = None,
              spectrogram_plot_kwargs: dict = None, **kwargs):
    """Multi-pair CCFs in stacked per-pair axes with celerity ticks
    (reference ``xcorr/core/plot.py:254-375``). Returns the GridSpec.

    ``spectrogram=True`` adds a per-pair spectrogram column for window
    ``time`` — the multi-pair analog of :func:`plot_ccf`'s panel, with
    the same ``spectrogram_cwt`` (wavelet scaleogram),
    ``spectrogram_db`` and ``spectrogram_contourf`` variants (no
    reference analog; the reference only offers the panel on its
    single-pair plot, ``xcorr/core/plot.py:31-47``)."""
    import matplotlib.pyplot as plt
    from matplotlib.gridspec import GridSpec
    from matplotlib.ticker import AutoMinorLocator, StrMethodFormatter

    cc, distance = _cc_and_distance(ds, distance)
    all_pairs = [str(p) for p in
                 np.asarray(cc.coords["pair"].values).ravel()] \
        if "pair" in cc.coords else [""]
    pairs = [str(p) for p in np.asarray(pairs).ravel()] \
        if pairs is not None else all_pairs

    cc_max = _abs_scale(np.asarray(cc.values))
    cc_lim = (-1.05, 1.05) if normalize else (-1.05 * cc_max,
                                              1.05 * cc_max)
    cc_fmt = StrMethodFormatter("{x:.1f}" if normalize else "{x:.0e}")

    cmin = cmin or 1460.0
    cmax = cmax or 1500.0
    lag = np.asarray(cc.coords["lag"].values)
    if distance is not None:
        dvals = np.asarray(distance.values, dtype=np.float64).ravel()
        factor = 1000.0 if distance.attrs.get("units") == "km" else 1.0
        lag_lim = lag_lim or (dvals.min() * factor / cmax,
                              dvals.max() * factor / cmin)
    else:
        lag_lim = lag_lim or (float(lag.min()), float(lag.max()))

    fig = figure or plt.figure(
        constrained_layout=True,
        figsize=kwargs.pop("figsize",
                           (10 if spectrogram else 7, len(pairs) + 1)))
    clim, sdatas = None, None
    if spectrogram:
        gs = GridSpec(len(pairs), 2, figure=fig, width_ratios=(3, 2))
        # COMMON color limits across panels: they share one colorbar,
        # so identical colors must mean identical values in every pair
        sdatas = [_spectrogram_data(
            _isel_pair(cc, p), time, normalize, spectrogram_cwt,
            spectrogram_db, spectrogram_kwargs) for p in pairs]
        gmax = np.nanmax([np.nanmax(pv) for _, pv in sdatas])
        vmax = gmax if spectrogram_db else 0.8 * gmax
        clim = (vmax - 30 if spectrogram_db else 0.0, vmax)
    else:
        gs = GridSpec(len(pairs), 1, figure=fig)
    cc_plot_kwargs = {"color": "k", "alpha": 0.25, "lw": 0.7,
                      **(cc_plot_kwargs or {})}

    axes, meshes = [], []
    for i, pair in enumerate(pairs):
        ax = fig.add_subplot(gs[i, 0]) if i == 0 else \
            fig.add_subplot(gs[i, 0], sharex=axes[0], sharey=axes[0])
        sel = _isel_pair(cc, pair)
        vals = np.atleast_2d(np.asarray(sel.values, dtype=np.float64))
        if normalize:
            vals = vals / cc_max
        for row in vals:
            ax.plot(lag, row, **cc_plot_kwargs)
        ax.yaxis.set_major_formatter(cc_fmt)
        if i != len(pairs) - 1:
            ax.tick_params(labelbottom=False)
        else:
            ax.set_xlabel("Lag [s]")
        d = _distance_m(distance, pair) if distance is not None else None
        if d:
            _celerity_axis(ax, d, cmin, cmax,
                           cmajor or 5.0, cminor or 1.0)
        ax.set_ylabel("CCF [-]" if i == 0 else None)
        ax.tick_params(labelleft=i == 0)
        ax.set_xlim(*lag_lim)
        ax.set_ylim(*cc_lim)
        ax.xaxis.set_minor_locator(AutoMinorLocator())
        ax.yaxis.set_ticks_position("both")
        ax.text(0.02, 0.96, pair, transform=ax.transAxes, ha="left",
                va="top")
        if i == 0 and "time" in cc.coords:
            ax.text(0.98, 0.96,
                    str(np.asarray(cc.coords["time"].values)
                        .ravel()[0])[:19],
                    transform=ax.transAxes, ha="right", va="top")
        axes.append(ax)
        if spectrogram:
            axp = fig.add_subplot(gs[i, 1]) if i == 0 else \
                fig.add_subplot(gs[i, 1], sharex=meshes[0][0],
                                sharey=meshes[0][0])
            mesh = _spectrogram_panel(
                axp, sel, time, normalize, lag_lim, freq_lim,
                spectrogram_cwt, spectrogram_db, spectrogram_contourf,
                spectrogram_kwargs, spectrogram_plot_kwargs,
                data=sdatas[i], clim=clim)
            if i != len(pairs) - 1:
                axp.set_xlabel(None)
                axp.tick_params(labelbottom=False)
            meshes.append((axp, mesh))
    if spectrogram and meshes:
        cb = fig.colorbar(meshes[-1][1], ax=[m[0] for m in meshes],
                          extend="both" if spectrogram_db else "max")
        cb.set_label("PSD [dB]" if spectrogram_db else "PSD [-]")
    return gs


def plot_ccfs_colored(ds, sn=None, sn_threshold: float = None,
                      normalize: bool = False, alpha: float = None,
                      lag_lim: tuple = None, lag_min: float = None,
                      lag_max: float = None, ax=None, **kwargs):
    """Multi-pair CCFs color-coded per pair in one axes, optionally
    filtered by a signal-to-noise threshold (reference
    ``xcorr/core/plot.py:403-494``)."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt
    from matplotlib.ticker import StrMethodFormatter

    cc, _ = _cc_and_distance(ds, None)
    ax = ax or plt.gca()
    alpha = alpha or 0.25
    if lag_lim is not None:
        lag_min, lag_max = lag_lim

    vals_all = np.asarray(cc.values, dtype=np.float64)
    cc_max = _abs_scale(vals_all)
    cc_lim = (-1.05, 1.05) if normalize else (-1.05 * cc_max,
                                              1.05 * cc_max)
    cc_fmt = StrMethodFormatter("{x:.1f}" if normalize else "{x:.0e}")

    sn_threshold = (sn_threshold or 10.0) if sn is not None else None
    lag = np.asarray(cc.coords["lag"].values)
    pairs = [str(p) for p in
             np.asarray(cc.coords["pair"].values).ravel()] \
        if "pair" in cc.coords else [""]

    lines = []
    for pair, c in zip(pairs, mpl.rcParams["axes.prop_cycle"]()):
        sel = _isel_pair(cc, pair)
        vals = np.atleast_2d(np.asarray(sel.values, dtype=np.float64))
        if sn_threshold is not None:
            sn_sel = _isel_pair(sn, pair)
            ok = np.asarray(sn_sel.values, dtype=np.float64) \
                >= sn_threshold
            if not ok.any():
                continue
            vals = vals[ok]
        if normalize:
            vals = vals / cc_max
        line = None
        for row in vals:
            line = ax.plot(lag, row, alpha=alpha, **c, **kwargs)[0]
        if line is not None:
            lines.append((line, pair))

    try:
        ax.ticklabel_format(axis="y", useOffset=False, style="plain")
    except AttributeError:
        pass  # a non-scalar formatter is already installed on this axes
    ax.set_ylim(*cc_lim)
    ax.set_xlim(lag_min, lag_max)
    ax.yaxis.set_major_formatter(cc_fmt)
    ax.set_xlabel("Lag [s]")
    if lines:
        ax.legend(*zip(*lines))
    if sn_threshold is not None:
        ax.set_title(f"{sn.attrs.get('long_name', sn.name or 'SNR')} "
                     f"> {sn_threshold}")
    return ax


def plot_snr_ct(snr, ct=None, ax=None, **kwargs):
    """Per-pair SNR time series with coincidence-trigger periods shaded
    (reference ``xcorr/core/plot.py:378-400`` + signal.trigger's
    plot_trigs)."""
    import matplotlib.pyplot as plt

    from ..signal.trigger import plot_trigs

    if ax is None:
        _, ax = plt.subplots(figsize=kwargs.pop("figsize", (9, 4)))
    t = snr.coords["time"].values
    vals = np.atleast_2d(np.asarray(snr.values, dtype=np.float64))
    pairs = [str(p) for p in
             np.asarray(snr.coords["pair"].values).ravel()] \
        if "pair" in snr.coords else [None] * len(vals)
    for row, pair in zip(vals, pairs):
        ax.plot(t, row, lw=0.7, label=pair, **kwargs)
    if any(p is not None for p in pairs):
        ax.legend(fontsize=7)
    if ct is not None:
        plot_trigs(snr, ct, ax=ax)
    ax.set_ylabel(snr.attrs.get("long_name", "SNR"))
    return ax


def set_year_labels(ax, start="2014-01-01", end="2021-01-01", **kwargs):
    """Center year labels between year-start ticks (reference
    ``xcorr/core/plot.py:497-520``)."""
    import matplotlib as mpl
    import pandas as pd

    t0, t1 = pd.to_datetime(start), pd.to_datetime(end)
    ax.set_xlim(t0.to_datetime64(), t1.to_datetime64())
    ax.set_xlabel(None)

    ticks = pd.date_range(t0, t1, freq="1YS")
    labels = ticks[:-1] + pd.DateOffset(months=6)

    ax.set_xticks(ticks.values)
    ax.xaxis.set_major_formatter(mpl.ticker.NullFormatter())
    ax.set_xticks(labels.values, minor=True)
    ax.set_xticklabels(labels.strftime("%Y").values, minor=True, **kwargs)
    for tick in ax.xaxis.get_minor_ticks():
        tick.tick1line.set_markersize(0)
        tick.tick2line.set_markersize(0)
        tick.label1.set_horizontalalignment("center")
    return ax
