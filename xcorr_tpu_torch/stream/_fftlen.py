"""FFT length of the host-side spectral division in :mod:`stream.trace`
(``remove_response``, ``simulate``).

The reference package's sizing, kept so that the carried trace code pads
to the same length as its source and samples the response on the same
frequency grid: ``2^a * m`` with the odd part ``m`` in {1, 3, 5, 9, 15}.
The device FFTs of the port size with :func:`ops.fft.next_fast_len`
instead.
"""

_ODD_PARTS = (1, 3, 5, 9, 15)


def next_fast_len(n: int) -> int:
    """Smallest ``2^a * m >= n`` with ``m`` in {1, 3, 5, 9, 15}."""
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()  # next power of two
    for m in _ODD_PARTS:
        v = m
        while v < n:
            v *= 2
        best = min(best, v)
    return best
