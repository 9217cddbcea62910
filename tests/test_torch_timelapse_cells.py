"""The timelapse's cells on the port's form
(``xcorr_tpu_torch/scripts/timelapse.py``: each spectrogram's spectrum
once per stack, TL1 and TL2 of ``xcorr_tpu_torch/ops/cells.py``, and the
cell bookkeeping with one indexed assignment per variable) against
their plain versions and the JAX package, on the CPU with seeded numpy
stacks.

Bars: on the CPU the form takes the plain versions of TL1 and TL2, so it
gives the bits of ``_correlate_spectrograms_plain`` (peaks and shifts),
tiled or not, on a mesh or not; against the JAX package, peaks within
1e-6 absolute and shifts equal (``tests/test_torch_analysis_rest.py``'s
bars); the two bookkeeping forms give identical Datasets. TL2's plain
version is held to a numpy model of the kernel's circular read (rows
``(i - (n1-1)) mod nf``, columns ``(j - (n2-1)) mod nl``, the first NaN,
else the first maximum) exactly. The card tests (``cuda`` marker) hold
each kernel to its plain version there: TL2's scan exactly, TL1 within
1e-6 of the largest magnitude of its plain version (the two products
may round their sums differently), TL2's row kernel within 1e-6
relative on the peaks with indices equal but for near-ties in float64
(another inverse rounds otherwise), at an odd, an even, a small and the
longest row of its route; the form on the card takes the route its rows
fit, the row kernel or the scan.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from xcorr_tpu_torch.ops import cells
from xcorr_tpu_torch.parallel import make_mesh
from xcorr_tpu_torch.scripts import timelapse as ttl

SHAPES = [(6, 9, 40), (7, 10, 33), (5, 8, 16), (9, 1, 5), (4, 3, 1)]
SHAPE_IDS = ["oddF-evenL", "evenF-oddL", "evenF-evenL", "F1-oddL", "L1"]


def stack(shape, seed=23, zero=2):
    """A seeded stack of spectrograms, one of them all zero."""
    sp = np.random.default_rng(seed).uniform(0.0, 1.0, shape) \
        .astype(np.float32)
    if zero is not None and zero < shape[0]:
        sp[zero] = 0.0
    return sp


def assert_same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- the form against its plain version -------------------------------------

@pytest.mark.parametrize("batch", [1, 4, 64])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_form_equals_plain(shape, batch):
    """Peaks and shifts bit for bit, an all-zero spectrogram, tail batch
    and one-cell batches included; the launches count no CPU call."""
    sp = stack(shape)
    ii, jj = np.triu_indices(shape[0])
    before = dict(cells.launches)
    got = ttl.correlate_spectrograms(sp, ii, jj, batch=batch, device="cpu")
    assert cells.launches == before
    assert_same(got, ttl._correlate_spectrograms_plain(
        sp, ii, jj, batch=batch, device="cpu"))
    # the zero spectrogram correlates to 0 at zero shift, as the plain one
    zero = (ii == 2) | (jj == 2)
    assert (got[0][zero] == 0).all()


def test_form_equals_plain_any_cells():
    """Cells in any order, repeated, off the triangle, and none."""
    sp = stack((8, 6, 21))
    rng = np.random.default_rng(4)
    ii, jj = rng.integers(0, 8, 50), rng.integers(0, 8, 50)
    for a, b in ((ii, jj), (ii[:0], jj[:0])):
        assert_same(ttl.correlate_spectrograms(sp, a, b, batch=7,
                                               device="cpu"),
                    ttl._correlate_spectrograms_plain(sp, a, b, batch=7,
                                                      device="cpu"))


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
@pytest.mark.parametrize("mesh_size", [None, 3])
def test_negative_and_out_of_range_indices(monkeypatch, mesh_size, tiled):
    """A negative cell index counts from the end on both forms, as
    ``sp[idx]`` counts it: the same bits as its positive twin. One outside
    ``[-T, T)``, on either side of a cell, raises ``IndexError`` on both
    forms."""
    T, F, L = 8, 6, 21
    sp = stack((T, F, L))
    if tiled:
        nf = ttl.ops.fft.next_fast_len(2 * F - 1)
        nl = ttl.ops.fft.next_fast_len(2 * L - 1)
        monkeypatch.setattr(ttl, "SPECTRA_BYTES", 6 * nf * (nl // 2 + 1) * 8)
        assert ttl._tile(T, nf, nl, 4) == 3
    rng = np.random.default_rng(5)
    ii, jj = rng.integers(-T, T, 40), rng.integers(-T, T, 40)
    ii[:2], jj[:2] = -T, -1
    mesh = None if mesh_size is None else make_mesh(
        devices=["cpu"] * mesh_size)
    kw = dict(batch=6, mesh=mesh, device="cpu")
    got = ttl.correlate_spectrograms(sp, ii, jj, **kw)
    assert_same(got, ttl._correlate_spectrograms_plain(sp, ii, jj, **kw))
    assert_same(got, ttl.correlate_spectrograms(sp, ii % T, jj % T, **kw))
    for form in (ttl.correlate_spectrograms,
                 ttl._correlate_spectrograms_plain):
        for bad in (T, -T - 1):
            with pytest.raises(IndexError):
                form(sp, np.r_[ii, bad], np.r_[jj, 0], **kw)
            with pytest.raises(IndexError):
                form(sp, np.r_[0, ii], np.r_[bad, jj], **kw)


def test_negative_indices_against_jax():
    """Negative cell indices: the JAX package's peaks and shifts."""
    from xcorr_tpu.scripts import timelapse as jtl
    T = 6
    sp = stack((T, 9, 40))
    ii, jj = np.triu_indices(T)
    ii, jj = ii - T, np.where(jj % 2, jj - T, jj)
    pk, df, dl = jtl.correlate_spectrograms(sp, ii, jj, batch=4)
    got = ttl.correlate_spectrograms(sp, ii, jj, batch=4, device="cpu")
    np.testing.assert_allclose(got[0], pk, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], df)
    np.testing.assert_array_equal(got[2], dl)


@pytest.mark.parametrize("mesh_size", [None, 3])
@pytest.mark.parametrize("cells_of", ["triangle", "random"])
def test_tiled_path(monkeypatch, cells_of, mesh_size):
    """A stack whose spectra pass a small ``SPECTRA_BYTES`` walks the grid
    in tiles of times, its spectra in chunks of a small ``CHUNK_BYTES``:
    the plain version's bits, cells in any order, on a mesh too."""
    T, F, L = 11, 9, 40
    sp = stack((T, F, L))
    nf = ttl.ops.fft.next_fast_len(2 * F - 1)
    nl = ttl.ops.fft.next_fast_len(2 * L - 1)
    one = nf * (nl // 2 + 1) * 8
    monkeypatch.setattr(ttl, "SPECTRA_BYTES", 6 * one)
    monkeypatch.setattr(ttl, "CHUNK_BYTES", 2 * nf * nl * 4)
    assert ttl._tile(T, nf, nl, 4) == 3
    if cells_of == "triangle":
        ii, jj = np.triu_indices(T)
    else:
        rng = np.random.default_rng(9)
        ii, jj = rng.integers(0, T, 90), rng.integers(0, T, 90)
    mesh = None if mesh_size is None else make_mesh(
        devices=["cpu"] * mesh_size)
    got = ttl.correlate_spectrograms(sp, ii, jj, batch=4, mesh=mesh,
                                     device="cpu")
    assert_same(got, ttl._correlate_spectrograms_plain(sp, ii, jj, batch=4,
                                                       device="cpu"))


@pytest.mark.parametrize("seed", range(8))
def test_tiled_path_any_batch(monkeypatch, seed):
    """The tiled path on seeded draws of stack, tile, cells, batch and
    mesh, with one-cell batches and shares among them: the plain
    version's bits, since each cell's ``irfft2`` runs in a batch of the
    size the plain version gives it (on the CPU a lone map's transform
    rounds otherwise)."""
    rng = np.random.default_rng([seed, 31])
    T, F, L = (int(rng.integers(4, 12)), int(rng.integers(1, 9)),
               int(rng.integers(1, 30)))
    sp = stack((T, F, L), seed=seed, zero=int(rng.integers(0, T)))
    nf = ttl.ops.fft.next_fast_len(2 * F - 1)
    nl = ttl.ops.fft.next_fast_len(2 * L - 1)
    tile = int(rng.integers(1, (T + 1) // 2))
    monkeypatch.setattr(ttl, "SPECTRA_BYTES",
                        2 * tile * nf * (nl // 2 + 1) * 8)
    assert ttl._tile(T, nf, nl, 4) == tile < T
    n = int(rng.integers(1, 60))
    ii, jj = rng.integers(0, T, n), rng.integers(0, T, n)
    size = (None, 2, 3)[seed % 3]
    mesh = None if size is None else make_mesh(devices=["cpu"] * size)
    kw = dict(batch=int(rng.integers(1, 9)), mesh=mesh, device="cpu")
    assert_same(ttl.correlate_spectrograms(sp, ii, jj, **kw),
                ttl._correlate_spectrograms_plain(sp, ii, jj, **kw))


def test_spectra_in_chunks_equal_whole(monkeypatch):
    """The spectra taken in chunks of times are the bits of one call."""
    sp = torch.from_numpy(stack((7, 5, 12)))
    whole = ttl._spectra(sp, 0, 7, 9, 24)
    monkeypatch.setattr(ttl, "CHUNK_BYTES", 2 * 9 * 24 * 4)
    part = ttl._spectra(sp, 0, 7, 9, 24)
    assert part.is_contiguous() and part.shape == (7, 9, 13)
    assert torch.equal(part, whole)
    assert torch.equal(ttl._spectra(sp, 2, 5, 9, 24), whole[2:5])


def test_spectra_in_columns():
    """With ``cols`` the spectra are the same bits transposed, each
    ``(nl//2+1, nf)`` and C-contiguous, whole or in chunks."""
    sp = torch.from_numpy(stack((7, 5, 12)))
    whole = ttl._spectra(sp, 0, 7, 9, 24)
    for chunk in (ttl.CHUNK_BYTES, 2 * 9 * 24 * 4):
        ttl.CHUNK_BYTES, keep = chunk, ttl.CHUNK_BYTES
        try:
            got = ttl._spectra(sp, 1, 6, 9, 24, cols=True)
        finally:
            ttl.CHUNK_BYTES = keep
        assert got.is_contiguous() and got.shape == (5, 13, 9)
        assert torch.equal(got, whole[1:6].transpose(-2, -1))


def test_mesh_equals_no_mesh():
    """``mesh=`` of the form: the form's bits without a mesh."""
    sp = stack((7, 10, 33))
    ii, jj = np.triu_indices(7)
    mesh = make_mesh(devices=["cpu"] * 3)
    assert_same(ttl.correlate_spectrograms(sp, ii, jj, batch=4, mesh=mesh),
                ttl.correlate_spectrograms(sp, ii, jj, batch=4,
                                           device="cpu"))


def test_form_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sp = stack((3, 4, 5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttl.correlate_spectrograms(sp, [0], [1])


def test_forms_name_their_plain_versions():
    for name in ttl.FORMS:
        assert callable(getattr(ttl, name))
        assert callable(getattr(ttl, f"_{name}_plain"))


# -- the form against the JAX package ---------------------------------------

@pytest.mark.parametrize("batch", [64, 4])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=SHAPE_IDS[:3])
def test_form_against_jax(shape, batch):
    from xcorr_tpu.scripts import timelapse as jtl
    sp = stack(shape)
    ii, jj = np.triu_indices(shape[0])
    pk, df, dl = jtl.correlate_spectrograms(sp, ii, jj, batch=batch)
    got = ttl.correlate_spectrograms(sp, ii, jj, batch=batch, device="cpu")
    np.testing.assert_allclose(got[0], pk, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], df)
    np.testing.assert_array_equal(got[2], dl)


# -- TL2's rule: the circular read against the slice-and-argmax path --------

def circular_read_argmax(r, n1, n2):
    """A numpy model of TL2: the window read at circular indices, the
    first NaN, else the first maximum, in the window's row-major order."""
    B, nf, nl = r.shape
    rows = (np.arange(2 * n1 - 1) - (n1 - 1)) % nf
    cols = (np.arange(2 * n2 - 1) - (n2 - 1)) % nl
    win = r[:, rows][:, :, cols].reshape(B, -1)
    peak = np.empty(B, r.dtype)
    k = np.empty(B, np.int64)
    for b in range(B):
        nan = np.flatnonzero(np.isnan(win[b]))
        k[b] = nan[0] if nan.size else int(np.argmax(win[b]))
        peak[b] = win[b, k[b]]
    return peak, k


def planted_maps(kind, B, nf, nl, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((B, nf, nl)).astype(np.float32)
    if kind == "constant":
        return np.full((B, nf, nl), 0.25, np.float32)
    if kind == "zero":
        return np.zeros((B, nf, nl), np.float32)
    if kind == "signed_zeros":
        return np.where(rng.random((B, nf, nl)) < 0.5, -0.0, 0.0) \
            .astype(np.float32)
    r = rng.integers(0, 3, (B, nf, nl)).astype(np.float32)
    if kind == "nan":
        r[rng.random((B, nf, nl)) < 0.05] = np.nan
    if kind == "minus_inf":
        r[:] = -np.inf
        r[rng.random((B, nf, nl)) < 0.02] = np.nan
    return r      # "ties": many equal maxima


@pytest.mark.parametrize("kind", ["random", "ties", "constant", "zero",
                                  "signed_zeros", "nan", "minus_inf"])
@pytest.mark.parametrize("geom", [(3, 7, 5, 13), (4, 9, 8, 20),
                                  (1, 1, 2, 3), (2, 9, 3, 17)],
                         ids=["odd", "even", "one-row", "tight"])
def test_tl2_rule(kind, geom):
    """TL2's plain version (the slice-and-argmax path) against the
    circular read, value bits and index."""
    n1, n2, nf, nl = geom
    r = planted_maps(kind, 3, nf, nl, seed=n2)
    if kind == "ties":   # the maximum planted twice, at both ends
        r[:, 0, 0] = r[:, nf - 1, nl - 1] = 7.0
    peak, k = cells.circular_argmax(torch.from_numpy(r), n1, n2)
    want_peak, want_k = circular_read_argmax(r, n1, n2)
    np.testing.assert_array_equal(k.numpy(), want_k)
    np.testing.assert_array_equal(peak.numpy().view(np.int32),
                                  want_peak.view(np.int32))


# -- the bookkeeping --------------------------------------------------------

@pytest.mark.parametrize("mesh_size", [None, 3])
@pytest.mark.parametrize("T", [1, 2, 13, 40])
def test_fill_cells_forms_equal(T, mesh_size):
    """Both bookkeeping forms write identical Datasets over two pairs and
    two bands, with times that have no spectrogram (a pair without its
    first time among them)."""
    rng = np.random.default_rng(T)
    times = pd.date_range("2014-01-01", periods=T, freq="1D").values
    mesh = None if mesh_size is None else make_mesh(
        devices=["cpu"] * mesh_size)
    iu, ju = np.triu_indices(T)
    valids = [[i for i in range(T) if i == 0 or rng.random() > 0.2]
              for _ in range(2)]
    if T > 3:
        valids[1] = valids[1][1:]
    out = []
    for fill in (ttl.fill_cells, ttl._fill_cells_plain):
        ds = ttl.init_timelapse(["A-B", "C-D"], times, ((1, 2), (2, 4)))
        for ip, valid in enumerate(valids):
            for ifb in range(2):
                sp = stack((len(valid), 5, 12), seed=100 * ip + ifb,
                           zero=None)
                n = fill(ds, ip, ifb, iu, ju, valid,
                         lambda ii, jj: ttl.correlate_spectrograms(
                             sp, ii, jj, batch=4, mesh=mesh, device="cpu"))
                assert n == len(valid) * (len(valid) + 1) // 2
        out.append(ds)
    assert list(out[0]._vars) == list(out[1]._vars)
    for name in ("cc2", "delta_freq", "delta_lag", "status"):
        a, b = out[0][name].values, out[1][name].values
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert (out[0]["status"].values == 1).sum() == sum(
        2 * len(v) * (len(v) + 1) // 2 for v in valids)


def test_fill_cells_no_cells():
    """No valid pair of times: nothing written, 0 cells, on both forms."""
    ds = ttl.init_timelapse(["A-B"], pd.date_range("2014-01-01",
                                                   periods=3).values,
                            ((1, 2),))
    iu, ju = np.triu_indices(3)

    def never(ii, jj):
        raise AssertionError("no cell to correlate")
    for fill in (ttl.fill_cells, ttl._fill_cells_plain):
        assert fill(ds, 0, 0, iu, ju, [], never) == 0
    assert (ds["status"].values == 0).all()


# -- the wrappers -----------------------------------------------------------

def spectra(T, nf, h, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((T, nf, h))
                             + 1j * rng.standard_normal((T, nf, h)))
                            .astype(dtype))


def test_wrappers_take_plain_on_cpu():
    a, b = spectra(5, 3, 4), spectra(6, 3, 4, seed=1)
    ii = torch.tensor([0, 4, 2], dtype=torch.int64)
    jj = torch.tensor([5, 0, 2], dtype=torch.int64)
    before = dict(cells.launches)
    assert torch.equal(cells.gather_product(a, ii, b, jj),
                       cells.gather_product_plain(a, ii, b, jj))
    r = torch.from_numpy(planted_maps("random", 2, 7, 11, 3))
    for got, want in zip(cells.circular_argmax(r, 3, 5),
                         cells.circular_argmax_plain(r, 3, 5)):
        assert torch.equal(got, want)
    assert cells.launches == before


@pytest.mark.parametrize("bad", ["index_dtype", "index_2d", "index_count",
                                 "index_range", "index_layout",
                                 "spectra_shape", "spectra_dtype"])
def test_gather_product_refuses(bad):
    a, b = spectra(5, 3, 4), spectra(6, 3, 4, seed=1)
    ii = torch.tensor([0, 4, 2], dtype=torch.int64)
    jj = torch.tensor([5, 0, 2], dtype=torch.int64)
    err = ValueError
    if bad == "index_dtype":
        ii, err = ii.int(), TypeError
    elif bad == "index_2d":
        ii, err = ii[:, None], TypeError
    elif bad == "index_count":
        jj = jj[:2]
    elif bad == "index_range":
        jj, err = torch.tensor([6, 0, 2]), IndexError
    elif bad == "index_layout":
        ii = torch.tensor([0, 9, 4, 9, 2, 9])[::2]
    elif bad == "spectra_shape":
        b = spectra(6, 3, 5)
    elif bad == "spectra_dtype":
        b = spectra(6, 3, 4, dtype=np.complex128)
    with pytest.raises(err):
        cells.gather_product(a, ii, b, jj)


@pytest.mark.parametrize("bad", ["rank", "rows", "cols", "n1"])
def test_circular_argmax_refuses(bad):
    r = torch.zeros((2, 7, 11))
    n1, n2 = 3, 5
    if bad == "rank":
        r = r[0]
    elif bad == "rows":
        n1 = 5
    elif bad == "cols":
        n2 = 7
    elif bad == "n1":
        n1 = 0
    with pytest.raises(ValueError):
        cells.circular_argmax(r, n1, n2)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TL1 and TL2 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(64, 31, 4600), (7, 10, 33), (3, 81, 9100)])
def test_kernels_match_plain_on_card(cuda_device, geom):
    """TL1 within 1e-6 of its plain version's largest magnitude, TL2 the
    plain version's value bits and index, on the maps of a batch and on
    planted ties, NaNs and a zero map; reruns give the same bits."""
    B, F, L = geom
    nf = ttl.ops.fft.next_fast_len(2 * F - 1)
    nl = ttl.ops.fft.next_fast_len(2 * L - 1)
    sp = torch.from_numpy(stack((B, F, L))).to(cuda_device)
    S = ttl._spectra(sp, 0, B, nf, nl)
    ii, jj = (torch.from_numpy(a.astype(np.int64)).to(cuda_device)
              for a in np.triu_indices(B))
    ii, jj = ii[:64].contiguous(), jj[:64].contiguous()
    before = dict(cells.launches)
    P = cells.gather_product(S, ii, S, jj)
    assert torch.equal(P, cells.gather_product(S, ii, S, jj))
    want = cells.gather_product_plain(S, ii, S, jj)
    assert ((P - want).abs().max() <= 1e-6 * want.abs().max()).item()
    r = torch.fft.irfft2(P, s=(nf, nl))
    maps = [r, torch.zeros_like(r[:2])]
    for kind in ("ties", "nan", "minus_inf"):
        m = torch.from_numpy(planted_maps(kind, 2, nf, nl, 5))
        if kind == "ties":
            m[:, 0, 0] = m[:, nf - 1, nl - 1] = 7.0
        maps.append(m.to(cuda_device))
    for m in maps:
        got = cells.circular_argmax(m, F, L)
        for g, w in zip(got, cells.circular_argmax_plain(m, F, L)):
            assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                               else g, w.view(torch.int32)
                               if w.is_floating_point() else w)
    torch.cuda.synchronize()
    assert cells.launches["gather_product"] == before["gather_product"] + 2
    assert cells.launches["circular_argmax"] == \
        before["circular_argmax"] + len(maps)


@pytest.mark.cuda
def test_form_on_card_matches_plain(cuda_device):
    """The form on the card: peaks within 1e-6 relative of the plain
    form's, TL1 and TL2 launched once per batch (nl = 1,200: TL2's row
    route, its row kernel, and the scan never)."""
    sp = stack((12, 31, 600))
    ii, jj = np.triu_indices(12)
    cells.reset_launches()
    got = ttl.correlate_spectrograms(sp, ii, jj, batch=16)
    batches = -(-ii.size // 16)
    assert cells.launches == {"gather_product": batches,
                              "circular_argmax": 0,
                              "inverse_argmax": batches}
    want = ttl._correlate_spectrograms_plain(sp, ii, jj, batch=16)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)


def shift_value(a, b, df, dl):
    """The float64 normalized correlation of spectrograms ``a`` and ``b``
    at shift ``(df, dl)``."""
    a = a / np.linalg.norm(a.astype(np.float64))
    b = b / np.linalg.norm(b.astype(np.float64))
    F, L = a.shape
    return float(np.sum(
        a[max(df, 0):F + min(df, 0), max(dl, 0):L + min(dl, 0)]
        * b[max(-df, 0):F + min(-df, 0), max(-dl, 0):L + min(-dl, 0)],
        dtype=np.float64))


def row_value(Y, c, k, n1, n2, nl):
    """The float64 value of cell ``c``'s map ``irfft(Y[c], n=nl) / nf`` at
    the flat window index ``k``."""
    i, j = divmod(int(k), 2 * n2 - 1)
    row = Y[c, (i - (n1 - 1)) % Y.shape[1]].astype(np.complex128)
    return np.fft.irfft(row, n=nl)[(j - (n2 - 1)) % nl] / Y.shape[1]


def row_witness(Y, n1, n2, nl):
    """Each cell's peak and flat argmax over the window of ``irfft(Y,
    n=nl) / nf``, from numpy's float64 ``irfft`` of each kept row on the
    CPU, with ``argmax``'s rule (the first NaN, else the first maximum):
    a witness that no batching of rows on the card touches."""
    Yh = Y.cpu().numpy().astype(np.complex128)
    nf = Yh.shape[1]
    rows = (np.arange(2 * n1 - 1) - (n1 - 1)) % nf
    cols = (np.arange(2 * n2 - 1) - (n2 - 1)) % nl
    with np.errstate(invalid="ignore"):
        m = np.fft.irfft(Yh[:, rows], n=nl, axis=-1)[..., cols] / nf
    flat = m.reshape(len(Yh), -1)
    k = flat.argmax(-1)
    return flat[np.arange(len(flat)), k], k


def check_row_kernel(Y, n1, n2, nl):
    """The row kernel against its plain version on ``Y``: peaks within
    1e-6 relative, indices equal but for near-ties (the float64 map at
    both indices within 2e-6 of the largest peak); a rerun the same
    bits. Returns the near-ties."""
    got = cells.inverse_argmax(Y, n1, n2, nl)
    again = cells.inverse_argmax(Y, n1, n2, nl)
    torch.cuda.synchronize()
    assert torch.equal(got[1], again[1]) and torch.equal(
        got[0].view(torch.int32), again[0].view(torch.int32))
    want = cells.inverse_argmax_plain(Y, n1, n2, nl)
    gp, gk = (t.cpu().numpy() for t in got)
    wp, wk = (t.cpu().numpy() for t in want)
    scale = np.abs(wp).max()
    assert np.abs(gp - wp).max() <= 1e-6 * scale
    Yh = Y.cpu().numpy()
    ties = np.flatnonzero(gk != wk)
    for c in ties:
        assert abs(row_value(Yh, c, gk[c], n1, n2, nl)
                   - row_value(Yh, c, wk[c], n1, n2, nl)) <= 2e-6 * scale
    return ties.size


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(6, 81, 9100), (6, 81, 6993), (5, 10, 20),
                                  (4, 81, 14336)],
                         ids=["odd-18225", "even-14000", "small-40",
                              "largest-28672"])
def test_row_kernel_matches_plain_on_card(cuda_device, geom):
    """TL2's row kernel on the column inverses of a real batch (every
    cell of a seeded stack's triangle): at an odd nl, an even nl with 7
    as a factor, a small nl and the longest row of its route. A zero
    product gives the plain version's peak and index. NaNs planted in
    kept rows give a NaN peak at the index of numpy's float64 witness
    (:func:`row_witness`), and, in the first kept row, at the plain
    version's. One launch counted per call."""
    T, F, L = geom
    nf = ttl.ops.fft.next_fast_len(2 * F - 1)
    nl = ttl.ops.fft.next_fast_len(2 * L - 1)
    assert cells.row_plan(nl).route == "kernel"
    sp = torch.from_numpy(stack((T, F, L))).to(cuda_device)
    S = ttl._spectra(sp, 0, T, nf, nl)
    ii, jj = (torch.from_numpy(a.astype(np.int64)).to(cuda_device)
              for a in np.triu_indices(T))
    Y = torch.fft.ifft(cells.gather_product(S, ii, S, jj), dim=-2,
                       norm="forward")
    before = cells.launches["inverse_argmax"]
    check_row_kernel(Y, F, L, nl)
    zero = torch.zeros_like(Y[:2])
    got = cells.inverse_argmax(zero, F, L, nl)
    want = cells.inverse_argmax_plain(zero, F, L, nl)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    # a NaN in the first kept row: cuFFT's plain inverse may carry it
    # into a neighbouring row of its batch (the card's run shows it), so
    # the plain version is compared where no earlier row can take it
    nan = complex(float("nan"), float("nan"))
    planted = Y[:2].clone()
    planted[1, (0 - (F - 1)) % nf, nl // 4] = nan
    got = cells.inverse_argmax(planted, F, L, nl)
    want = cells.inverse_argmax_plain(planted, F, L, nl)
    wp, wk = row_witness(planted, F, L, nl)
    assert torch.isnan(got[0][1]) and torch.isnan(want[0][1])
    assert torch.equal(got[1], want[1]) and int(got[1][1]) == wk[1] == 0
    # in later kept rows, a pair's either row and the last (alone in its
    # block): numpy's witness, since the plain version's cuFFT may carry
    # a NaN into a neighbouring row of its batch
    planted = Y[:2].clone()
    for c, rows in ((0, (2 * F - 2,)), (1, (5, 2, 2 * F - 2))):
        for i in rows:
            planted[c, (i - (F - 1)) % nf, (7 * i) % (nl // 2 + 1)] = nan
    got = cells.inverse_argmax(planted, F, L, nl)
    wp, wk = row_witness(planted, F, L, nl)
    assert torch.isnan(got[0]).all() and np.isnan(wp).all()
    np.testing.assert_array_equal(got[1].cpu().numpy(), wk)
    assert list(wk) == [(2 * F - 2) * (2 * L - 1), 2 * (2 * L - 1)]
    assert cells.launches["inverse_argmax"] == before + 5


@pytest.mark.cuda
def test_scan_route_on_card(cuda_device):
    """A stack whose rows pass the row kernel's shared memory (L =
    15,000, nl = 30,000) takes cuFFT's ``irfft2`` and the scan, chosen
    from nl: peaks within 1e-6 relative of the plain form's, shifts
    equal but for near-ties (float64), TL1 and the scan once per batch,
    the row kernel never."""
    T, F, L = 6, 31, 15000
    assert cells.row_plan(ttl.ops.fft.next_fast_len(2 * L - 1)).route \
        == "scan"
    sp = stack((T, F, L))
    ii, jj = np.triu_indices(T)
    cells.reset_launches()
    got = ttl.correlate_spectrograms(sp, ii, jj, batch=16)
    batches = -(-ii.size // 16)
    assert cells.launches == {"gather_product": batches,
                              "circular_argmax": batches,
                              "inverse_argmax": 0}
    want = ttl._correlate_spectrograms_plain(sp, ii, jj, batch=16)
    assert np.abs(got[0] - want[0]).max() <= 1e-6 * np.abs(want[0]).max()
    for n in np.flatnonzero((got[1] != want[1]) | (got[2] != want[2])):
        a, b = sp[ii[n]], sp[jj[n]]
        assert abs(shift_value(a, b, got[1][n], got[2][n])
                   - shift_value(a, b, want[1][n], want[2][n])) <= 2e-6
