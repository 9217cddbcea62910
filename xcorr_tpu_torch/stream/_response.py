r"""
:mod:`stream._response` -- inverse instrument responses, once per grid
======================================================================

``Trace.remove_response`` divides a window's spectrum by its instrument's
response on the grid of ``np.fft.rfftfreq(nfft, d=delta)``. The carried
method evaluates the pole/zero product, its water-level inversion and the
``pre_filt`` taper anew for every window and component, though they
depend only on the response, the grid, the output and the water level.
:func:`inverse_response` computes them once (:func:`_inverse_response_plain`,
the carried expressions) and keeps them read-only in :data:`RESPONSES`:
process-wide, thread-safe, single-flight, bounded by :data:`MAX_BYTES`
(:class:`._daycache.OnceCache`).

An entry is keyed by the response's values, never by the object: a
:class:`PAZResponse` is a mutable dataclass, and ``flat_response()`` makes
a new one on every call. Numbers are keyed by their type and bits, so a
signed zero or a float32 is never taken for another value that compares
equal.
"""

from __future__ import annotations

import numpy as np

from ._daycache import OnceCache

__all__ = ["inverse_response", "RESPONSES", "MAX_BYTES"]

#: inverse responses the process keeps: 16 at the BH windows' grid
#: (nfft = 7,864,320: 63 MB of complex128 each)
MAX_BYTES = 1 << 30


class ResponseCache(OnceCache):
    """``(inv_r, taper)`` by response values and grid; see the module."""

    def limit(self):
        return MAX_BYTES

    def arrays(self, value):
        return [a for a in value if a is not None]


#: the process's inverse responses
RESPONSES = ResponseCache()


def _exact(v):
    """``v`` as a key that equals another only for the same type and
    bits."""
    if isinstance(v, (str, int)) or v is None:
        return type(v), v
    return type(v), np.asarray(v).tobytes()


def _key(resp, nfft, delta, output, water_level, pre_filt):
    return (type(resp),
            np.asarray([complex(p) for p in resp.poles],
                       dtype=np.complex128).tobytes(),
            np.asarray([complex(z) for z in resp.zeros],
                       dtype=np.complex128).tobytes(),
            _exact(resp.gain), _exact(resp.sensitivity),
            (resp.input_units or "M/S").upper(),
            int(nfft), _exact(delta), output.upper(), _exact(water_level),
            None if pre_filt is None else tuple(map(_exact, pre_filt)))


def inverse_response(resp, nfft, delta, output="VEL", water_level=60.0,
                     pre_filt=None):
    """``(inv_r, taper)`` of :func:`_inverse_response_plain`, computed once
    per response values and grid while cached; both read-only."""
    key = _key(resp, nfft, delta, output, water_level, pre_filt)
    return RESPONSES.get(key, lambda: _inverse_response_plain(
        resp, nfft, delta, output, water_level, pre_filt))


def _inverse_response_plain(resp, nfft, delta, output="VEL",
                            water_level=60.0, pre_filt=None):
    """The carried ``Trace.remove_response``'s terms that do not depend on
    the samples: the water-level inverse of ``resp`` on the grid of
    ``np.fft.rfftfreq(nfft, d=delta)``, and the ``pre_filt`` taper there
    (``None`` without one)."""
    from .trace import _cosine_sac_taper, _invert_spectrum_water_level
    freqs = np.fft.rfftfreq(nfft, d=delta)
    inv_r = _invert_spectrum_water_level(
        resp.evaluate(freqs, output=output), water_level)
    taper = None if pre_filt is None else _cosine_sac_taper(freqs, pre_filt)
    return inv_r, taper
