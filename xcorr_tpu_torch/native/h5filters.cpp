// Decoders of the HDF5 filters the port's reader (io/hdf5.py) meets in
// files other tools write: szip (id 4), scaleoffset (id 6) and lzf
// (32000, h5py's). Each takes one stored chunk and writes the bytes the
// library's own filter gives back, or returns a negative code:
//   -1 the stream is corrupt or cut short,
//   -2 it decodes to another size than the caller's buffer,
//   -3 parameters this decoder does not take.
//
// szip is HDF5's framing (H5Zszip.c: a 4-byte little-endian size, then
// the stream) around libaec's SZ_BufftoBuffDecompress (sz_compat.c): the
// CCSDS 121.0-B adaptive entropy coder, 32- and 64-bit pixels as byte
// planes of 8-bit samples, scanlines padded to whole blocks.
// scaleoffset follows H5Zscaleoffset.c: a 21-byte header (minbits, the
// minimum's size and bytes), then each element's low minbits bits, most
// significant bit first, plus the minimum (or the fill value for the
// all-ones code); floats divided by the power of ten in their own type.
//
// Plain C interface for ctypes; no state, so calls run in parallel.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// -------------------------------------------------------------------------
// szip: the CCSDS 121.0 adaptive entropy decoder

constexpr uint32_t SZ_MSB = 16, SZ_NN = 32;
constexpr int ROS = 5;              // zero-block count meaning "to the end
                                    // of the segment"
constexpr int SE_TABLE_SIZE = 90;

struct BitReader {
    const uint8_t *p, *end;
    uint64_t acc = 0;
    int nbits = 0;
    bool bad = false;

    BitReader(const uint8_t *s, const uint8_t *e) : p(s), end(e) {}

    // n <= 32 bits, most significant first
    uint32_t get(int n) {
        if (n == 0) return 0;
        while (nbits < n) {
            if (p == end) { bad = true; return 0; }
            acc = (acc << 8) | *p++;
            nbits += 8;
        }
        nbits -= n;
        return (uint32_t)((acc >> nbits) & ((UINT64_C(1) << n) - 1));
    }

    // a fundamental sequence: the zeros before the next one bit
    uint32_t fs() {
        uint32_t z = 0;
        for (;;) {
            if (nbits == 0) {
                if (p == end) { bad = true; return 0; }
                acc = *p++;
                nbits = 8;
            }
            nbits--;
            if ((acc >> nbits) & 1) return z;
            if (++z > (1u << 30)) { bad = true; return 0; }
        }
    }
};

// Decode `total` samples of `bits` bits; reference samples restart each
// RSI of `rsi` blocks of `block` samples when `pp` (the NN predictor).
bool aec_decode(const uint8_t *in, const uint8_t *end, int bits, int block,
                int rsi, bool pp, size_t total, std::vector<uint32_t> &out) {
    const int id_len = bits > 16 ? 5 : bits > 8 ? 4 : 3;
    const uint32_t id_uncomp = (1u << id_len) - 1;
    const uint64_t xmax = (UINT64_C(1) << bits) - 1;
    const size_t rsi_size = (size_t)rsi * block;
    int se_beta[SE_TABLE_SIZE + 1], se_ms[SE_TABLE_SIZE + 1];
    for (int i = 0, k = 0; i < 13; i++)
        for (int j = 0, ms = k; j <= i; j++, k++) {
            se_beta[k] = i;
            se_ms[k] = ms;
        }
    BitReader br(in, end);
    out.assign(total, 0);
    std::vector<uint32_t> buf(rsi_size);
    size_t done = 0;
    while (done < total) {
        // one RSI into buf, its blocks until the samples are all there
        size_t used = 0;
        size_t want = rsi_size < total - done ? rsi_size : total - done;
        bool ref = pp;
        while (used < want) {
            uint32_t id = br.get(id_len);
            if (br.bad) return false;
            if (id == 0) {                      // low entropy
                uint32_t se = br.get(1);
                if (ref) buf[used++] = br.get(bits);
                if (br.bad) return false;
                if (se) {                       // second extension
                    size_t i = ref ? 1 : 0;
                    while (i < (size_t)block) {
                        uint32_t m = br.fs();
                        if (br.bad || m > (uint32_t)SE_TABLE_SIZE)
                            return false;
                        uint32_t d1 = m - se_ms[m];
                        if ((i & 1) == 0) {
                            buf[used++] = se_beta[m] - d1;
                            i++;
                        }
                        buf[used++] = d1;
                        i++;
                    }
                } else {                        // a run of zero blocks
                    uint32_t zb = br.fs() + 1;
                    if (br.bad) return false;
                    size_t b = used / block;
                    if (zb == (uint32_t)ROS) {
                        size_t left = rsi - b, seg = 64 - (b % 64);
                        zb = (uint32_t)(left < seg ? left : seg);
                    } else if (zb > (uint32_t)ROS) {
                        zb--;
                    }
                    size_t n = (size_t)zb * block - (ref ? 1 : 0);
                    if (rsi_size - used < n) return false;
                    std::memset(&buf[used], 0, n * sizeof(uint32_t));
                    used += n;
                }
            } else if (id == id_uncomp) {       // no compression
                for (int i = 0; i < block; i++) buf[used++] = br.get(bits);
            } else {                            // split, k = id - 1
                int k = (int)id - 1;
                if (ref) buf[used++] = br.get(bits);
                size_t start = used;
                for (int i = ref ? 1 : 0; i < block; i++) {
                    buf[used++] = br.fs() << k;
                    if (br.bad) return false;
                }
                if (k)
                    for (size_t i = start; i < used; i++) buf[i] += br.get(k);
            }
            if (br.bad) return false;
            ref = false;
        }
        // the predictor's inverse (unsigned samples), from the reference
        size_t n = want;
        if (pp && n) {
            uint64_t data = buf[0];
            out[done] = (uint32_t)data;
            for (size_t i = 1; i < n; i++) {
                uint64_t d = buf[i];
                uint64_t half_d = (d >> 1) + (d & 1);
                uint64_t theta = data < xmax - data ? data : xmax - data;
                if (half_d <= theta)
                    data = (d & 1) ? data - half_d : data + half_d;
                else if (data <= xmax - data)
                    data = d;
                else
                    data = xmax - d;
                out[done + i] = (uint32_t)data;
            }
        } else {
            for (size_t i = 0; i < n; i++) out[done + i] = buf[i];
        }
        done += n;
    }
    return true;
}

// -------------------------------------------------------------------------
// scaleoffset

template <typename T>
void swap_elements(uint8_t *p, size_t n) {
    for (size_t i = 0; i < n; i++) {
        uint8_t *e = p + i * sizeof(T);
        for (size_t a = 0, b = sizeof(T) - 1; a < b; a++, b--) {
            uint8_t t = e[a];
            e[a] = e[b];
            e[b] = t;
        }
    }
}

void swap_any(uint8_t *p, size_t n, unsigned size) {
    switch (size) {
        case 2: swap_elements<uint16_t>(p, n); break;
        case 4: swap_elements<uint32_t>(p, n); break;
        case 8: swap_elements<uint64_t>(p, n); break;
        default: break;
    }
}

template <typename U>
void post_int(uint8_t *out, const std::vector<uint64_t> &v, unsigned minbits,
              uint64_t minval, bool filavail, const uint8_t *fill) {
    U *buf = reinterpret_cast<U *>(out);
    U code = (U)((U)(((uint64_t)1 << minbits) - 1));
    U filval = 0;
    if (filavail) std::memcpy(&filval, fill, sizeof(U));
    for (size_t i = 0; i < v.size(); i++) {
        U x = (U)v[i];
        buf[i] = (filavail && x == code) ? filval : (U)(x + (U)minval);
    }
}

template <typename F, typename I>
void post_float(uint8_t *out, const std::vector<uint64_t> &v,
                unsigned minbits, uint64_t minval, bool filavail,
                const uint8_t *fill, int dscale) {
    F *buf = reinterpret_cast<F *>(out);
    F min, filval = 0;
    std::memcpy(&min, &minval, sizeof(F));
    if (filavail) std::memcpy(&filval, fill, sizeof(F));
    const I code = (I)((((uint64_t)1) << minbits) - 1);
    // the library's pow_fun: powf for float, pow for double; the
    // division and the sum in the element's own type
    const F scale = sizeof(F) == 4 ? (F)::powf(10.0f, (float)dscale)
                                   : (F)::pow(10.0, (double)dscale);
    for (size_t i = 0; i < v.size(); i++) {
        I x = (I)v[i];
        if (filavail && x == code)
            buf[i] = filval;
        else
            buf[i] = (F)x / scale + min;
    }
}

}  // namespace

extern "C" {

int64_t xch_unlzf(const uint8_t *src, int64_t n, uint8_t *out, int64_t want) {
    int64_t ip = 0, op = 0;
    while (ip < n) {
        uint32_t ctrl = src[ip++];
        if (ctrl < 32) {                        // a literal run
            int64_t ln = ctrl + 1;
            if (op + ln > want || ip + ln > n) return -1;
            std::memcpy(out + op, src + ip, (size_t)ln);
            ip += ln;
            op += ln;
            continue;
        }
        int64_t ln = ctrl >> 5;                 // a back reference
        int64_t ref = op - ((int64_t)(ctrl & 0x1F) << 8) - 1;
        if (ln == 7) {
            if (ip >= n) return -1;
            ln += src[ip++];
        }
        if (ip >= n) return -1;
        ref -= src[ip++];
        ln += 2;
        if (ref < 0 || op + ln > want) return -1;
        for (int64_t i = 0; i < ln; i++) out[op + i] = out[ref + i];
        op += ln;
    }
    return op == want ? op : -2;
}

// HDF5's szip filter. Its cd values are options mask, pixels per block,
// bits per pixel and pixels per scanline (here mask, ppb, bpp, pps). The
// stream's 4-byte header is the decoded size, which must be want: the
// chunk's size where the reader knows it, the header's own otherwise.
int64_t xch_unszip(const uint8_t *src, int64_t n, uint8_t *out, int64_t want,
                   uint32_t mask, uint32_t bpp, uint32_t ppb, uint32_t pps) {
    if (n < 4) return -1;
    uint32_t nalloc = (uint32_t)src[0] | ((uint32_t)src[1] << 8) |
                      ((uint32_t)src[2] << 16) | ((uint32_t)src[3] << 24);
    if ((int64_t)nalloc != want) return -2;
    if (bpp == 0 || bpp > 64 || (bpp > 32 && bpp != 64) || ppb == 0 ||
        ppb > 32 || (ppb & 1) || pps == 0)
        return -3;
    bool interleave = bpp == 32 || bpp == 64;
    int bits = interleave ? 8 : (int)bpp;
    int psize = bits > 16 ? 4 : bits > 8 ? 2 : 1;
    int rsi = (int)((pps + ppb - 1) / ppb);
    uint32_t pad = pps % ppb;
    size_t samples = (size_t)want / psize, scanlines = 0;
    if (pad) {
        scanlines = (samples + pps - 1) / pps;
        samples = (size_t)rsi * ppb * scanlines;
    }
    std::vector<uint32_t> s;
    if (!aec_decode(src + 4, src + n, bits, (int)ppb, rsi, (mask & SZ_NN) != 0,
                    samples, s))
        return -1;
    if (pad) {          // drop each scanline's padding to whole blocks
        size_t line = pps, padded = (size_t)rsi * ppb, k = 0;
        for (size_t l = 0; l < scanlines; l++)
            for (size_t i = 0; i < line; i++) s[k++] = s[l * padded + i];
        s.resize(k);
    }
    size_t total = s.size() * psize;
    if ((int64_t)total > want) total = (size_t)want;
    size_t count = total / psize;
    std::vector<uint8_t> tmp;
    uint8_t *dst = out;
    if (interleave) {
        tmp.resize(total);
        dst = tmp.data();
    }
    bool msb = (mask & SZ_MSB) != 0;
    for (size_t i = 0; i < count; i++) {
        uint32_t v = s[i];
        uint8_t *e = dst + i * psize;
        for (int j = 0; j < psize; j++) {
            int shift = msb ? 8 * (psize - 1 - j) : 8 * j;
            e[j] = (uint8_t)(v >> shift);
        }
    }
    if (interleave) {   // byte planes back into words
        size_t w = bpp / 8, m = total / w;
        for (size_t i = 0; i < m; i++)
            for (size_t j = 0; j < w; j++) out[i * w + j] = tmp[j * m + i];
    }
    return (int64_t)total == want ? want : -2;
}

// HDF5's scaleoffset filter: cd values as the library stores them
// (scale type, scale factor, elements, class, size, sign, order, fill
// value defined, fill value bytes from cd[8] on).
int64_t xch_unscaleoffset(const uint8_t *src, int64_t n, uint8_t *out,
                          int64_t want, const uint32_t *cd, int32_t ncd) {
    if (ncd < 8) return -3;
    uint32_t scale_type = cd[0], cls = cd[3], size = cd[4];
    uint32_t order = cd[6];
    bool filavail = cd[7] == 1;
    int dscale = (int)cd[1];
    size_t nelm = cd[2];
    if (size != 1 && size != 2 && size != 4 && size != 8) return -3;
    if (cls == 1 && (scale_type != 0 || (size != 4 && size != 8))) return -3;
    if (cls > 1) return -3;
    if ((int64_t)(nelm * size) != want) return -2;
    if (n < 21) return -1;
    uint32_t minbits = (uint32_t)src[0] | ((uint32_t)src[1] << 8) |
                       ((uint32_t)src[2] << 16) | ((uint32_t)src[3] << 24);
    unsigned msize = src[4] < 8 ? src[4] : 8;
    uint64_t minval = 0;
    for (unsigned i = 0; i < msize; i++)
        minval |= (uint64_t)src[5 + i] << (8 * i);
    if (minbits > size * 8) return -1;
    const uint8_t *data = src + 21;
    if (minbits == size * 8) {      // stored at full precision
        if (n - 21 < want) return -1;
        std::memcpy(out, data, (size_t)want);
        if (order == 1) swap_any(out, nelm, size);
        return want;
    }
    if (n - 21 < (int64_t)(((uint64_t)minbits * nelm + 7) / 8)) return -1;
    std::vector<uint64_t> v(nelm, 0);
    if (minbits) {
        BitReader br(data, src + n);
        for (size_t i = 0; i < nelm; i++) {
            uint64_t x = 0;
            unsigned left = minbits;
            while (left) {
                unsigned take = left > 32 ? 32 : left;
                x = (x << take) | br.get((int)take);
                left -= take;
            }
            v[i] = x;
        }
        if (br.bad) return -1;
    }
    uint8_t fill[80] = {0};
    for (int i = 8; i < ncd && i < 28; i++)
        std::memcpy(fill + 4 * (i - 8), &cd[i], 4);
    if (cls == 0) {     // signed or not, two's complement gives one sum
        if (size == 1)
            post_int<uint8_t>(out, v, minbits, minval, filavail, fill);
        else if (size == 2)
            post_int<uint16_t>(out, v, minbits, minval, filavail, fill);
        else if (size == 4)
            post_int<uint32_t>(out, v, minbits, minval, filavail, fill);
        else
            post_int<uint64_t>(out, v, minbits, minval, filavail, fill);
    } else if (size == 4) {
        post_float<float, int32_t>(out, v, minbits, minval, filavail, fill,
                                   dscale);
    } else {
        post_float<double, int64_t>(out, v, minbits, minval, filavail, fill,
                                    dscale);
    }
    if (order == 1) swap_any(out, nelm, size);
    return want;
}

}  // extern "C"
