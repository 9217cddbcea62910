"""The port's carried host trace layer against the JAX reference's: the
spectral division of ``remove_response`` and ``simulate`` pads to the
reference's FFT length (not the port's cuFFT sizing) and gives the same
samples.

Both sides run the same float64 numpy code on the same seeded trace, so
the results must be equal bit for bit (tolerance 0).
"""
import numpy as np
import pytest

from xcorr_tpu.ops import fft as jfft
from xcorr_tpu_torch.ops import fft as tfft
from xcorr_tpu_torch.stream import _fftlen
from xcorr_tpu import stream as jstream
from xcorr_tpu_torch import stream as tstream

FS = 20.0
#: 2n = 20,000 = 2^5 * 5^4: cuFFT-fast, so the port's device sizing keeps
#: it while the reference pads to 20,480
N = 10_000
PAZ = dict(poles=[-0.04 + 0.04j, -0.04 - 0.04j], zeros=[0, 0], gain=1.0,
           sensitivity=2.5e8)
SEED_ID = ("IU", "RAR", "10", "BHZ")


def test_host_sizing_equals_reference():
    for n in [*range(0, 3000), 2 * N, 8_640_000, 8_639_999]:
        assert _fftlen.next_fast_len(n) == jfft.next_fast_len(n), n
    # the case below is one where the device sizing differs
    assert tfft.next_fast_len(2 * N) == 2 * N != jfft.next_fast_len(2 * N)


def _trace(pkg, seed=3):
    data = np.random.default_rng(seed).normal(size=N)
    net, sta, loc, cha = SEED_ID
    return pkg.Trace(data, {"network": net, "station": sta,
                            "location": loc, "channel": cha,
                            "sampling_rate": FS,
                            "starttime": "2014-01-01"})


def _inventory(pkg):
    net, sta, loc, cha = SEED_ID
    return pkg.Inventory([pkg.Channel(
        net, sta, loc, cha, latitude=-21.2, longitude=-159.8,
        response=pkg.PAZResponse(**PAZ))])


CASES = {
    "remove_response": lambda pkg, tr: tr.remove_response(
        inventory=_inventory(pkg), output="VEL", water_level=60.0),
    "remove_response_pre_filt": lambda pkg, tr: tr.remove_response(
        inventory=_inventory(pkg), output="DISP", water_level=60.0,
        pre_filt=(0.01, 0.02, 8.0, 9.0)),
    "remove_response_flat": lambda pkg, tr: tr.remove_response(),
    "simulate": lambda pkg, tr: tr.simulate(
        paz_remove=PAZ, paz_simulate={**PAZ, "poles": [-1.0 + 1.0j,
                                                       -1.0 - 1.0j]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spectral_division_matches_reference(case):
    want = CASES[case](jstream, _trace(jstream)).data
    got = CASES[case](tstream, _trace(tstream)).data
    assert got.shape == want.shape == (N,)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
