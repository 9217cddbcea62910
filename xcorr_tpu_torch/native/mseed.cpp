// mseed.cpp — miniSEED v2 record codec for xcorr-tpu.
//
// The reference framework reads day-long waveforms from SDS archives of
// miniSEED via obspy's libmseed bindings (xcorr/stream/client.py:560-651);
// obspy is not part of this build, so this is the native data-plane codec:
// decode (Steim1, Steim2, INT16, INT32, FLOAT32, FLOAT64; big/little
// endian; 256-8192 byte records) and encode (Steim1, INT32, FLOAT32/64).
//
// C ABI for ctypes: see xcorr_tpu/native/mseed.py.
//
// Build: make -C xcorr_tpu/native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <vector>

namespace {

// ---------------------------------------------------------------- helpers

inline uint16_t rd_u16(const uint8_t* p, bool be) {
    return be ? (uint16_t)((p[0] << 8) | p[1])
              : (uint16_t)((p[1] << 8) | p[0]);
}
inline int16_t rd_i16(const uint8_t* p, bool be) {
    return (int16_t)rd_u16(p, be);
}
inline uint32_t rd_u32(const uint8_t* p, bool be) {
    return be ? ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                ((uint32_t)p[2] << 8) | p[3]
              : ((uint32_t)p[3] << 24) | ((uint32_t)p[2] << 16) |
                ((uint32_t)p[1] << 8) | p[0];
}
inline int32_t rd_i32(const uint8_t* p, bool be) {
    return (int32_t)rd_u32(p, be);
}
inline float rd_f32(const uint8_t* p, bool be) {
    uint32_t v = rd_u32(p, be);
    float f;
    std::memcpy(&f, &v, 4);
    return f;
}
inline double rd_f64(const uint8_t* p, bool be) {
    uint64_t v = be
        ? ((uint64_t)rd_u32(p, true) << 32) | rd_u32(p + 4, true)
        : ((uint64_t)rd_u32(p + 4, false) << 32) | rd_u32(p, false);
    double d;
    std::memcpy(&d, &v, 8);
    return d;
}
inline void wr_u16(uint8_t* p, uint16_t v) {  // big-endian writers
    p[0] = (uint8_t)(v >> 8);
    p[1] = (uint8_t)v;
}
inline void wr_u32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

// sign-extend the low `bits` bits of v
inline int32_t sext(uint32_t v, int bits) {
    uint32_t m = 1u << (bits - 1);
    return (int32_t)((v ^ m) - m);
}

// ------------------------------------------------------------ Steim decode

// Decode Steim1/2 data payload into diffs/samples. Returns samples decoded.
int decode_steim(const uint8_t* data, int nbytes, int expected,
                 bool be, int level, std::vector<int32_t>& out) {
    int nframes = nbytes / 64;
    int32_t x0 = 0;
    bool have_x0 = false;
    std::vector<int32_t> diffs;
    diffs.reserve(expected + 8);

    for (int f = 0; f < nframes; f++) {
        const uint8_t* frame = data + f * 64;
        uint32_t ctrl = rd_u32(frame, be);
        for (int w = 1; w < 16; w++) {
            int c = (ctrl >> (2 * (15 - w))) & 0x3;
            const uint8_t* word = frame + 4 * w;
            if (f == 0 && w == 1) {          // forward integration constant
                x0 = rd_i32(word, be);
                have_x0 = true;
                continue;
            }
            if (f == 0 && w == 2) continue;  // reverse integration constant
            if (c == 0) continue;            // non-data
            if (c == 1) {                    // 4 x 8-bit
                for (int k = 0; k < 4; k++)
                    diffs.push_back((int8_t)word[k]);
            } else if (level == 1) {
                if (c == 2) {                // 2 x 16-bit
                    diffs.push_back(rd_i16(word, be));
                    diffs.push_back(rd_i16(word + 2, be));
                } else {                     // c == 3: 1 x 32-bit
                    diffs.push_back(rd_i32(word, be));
                }
            } else {                         // Steim2
                uint32_t v = rd_u32(word, be);
                int dnib = (v >> 30) & 0x3;
                if (c == 2) {
                    if (dnib == 1) {         // 1 x 30-bit
                        diffs.push_back(sext(v & 0x3FFFFFFF, 30));
                    } else if (dnib == 2) {  // 2 x 15-bit
                        diffs.push_back(sext((v >> 15) & 0x7FFF, 15));
                        diffs.push_back(sext(v & 0x7FFF, 15));
                    } else if (dnib == 3) {  // 3 x 10-bit
                        diffs.push_back(sext((v >> 20) & 0x3FF, 10));
                        diffs.push_back(sext((v >> 10) & 0x3FF, 10));
                        diffs.push_back(sext(v & 0x3FF, 10));
                    }
                } else {                     // c == 3
                    if (dnib == 0) {         // 5 x 6-bit
                        for (int k = 4; k >= 0; k--)
                            diffs.push_back(sext((v >> (6 * k)) & 0x3F, 6));
                    } else if (dnib == 1) {  // 6 x 5-bit
                        for (int k = 5; k >= 0; k--)
                            diffs.push_back(sext((v >> (5 * k)) & 0x1F, 5));
                    } else if (dnib == 2) {  // 7 x 4-bit
                        for (int k = 6; k >= 0; k--)
                            diffs.push_back(sext((v >> (4 * k)) & 0xF, 4));
                    }
                }
            }
        }
    }
    if (!have_x0 || diffs.empty()) return 0;

    int n = (int)diffs.size();
    if (n > expected) n = expected;
    out.resize(n);
    // first sample is x0; diffs[0] is x0 - x(-1): ignored by convention
    out[0] = x0;
    for (int i = 1; i < n; i++) out[i] = out[i - 1] + diffs[i];
    return n;
}

// ------------------------------------------------------------ Steim1 encode

// Encode int32 samples as Steim1 frames into `out` (64-byte frames).
// Returns samples consumed; frames written = out.size()/64.
int encode_steim1(const int32_t* x, int n, int32_t prev, int maxframes,
                  std::vector<uint8_t>& out) {
    std::vector<int32_t> d(n);
    for (int i = 0; i < n; i++) d[i] = x[i] - (i ? x[i - 1] : prev);

    out.assign((size_t)maxframes * 64, 0);
    int i = 0;           // diff index consumed
    int f = 0;
    for (; f < maxframes && i < n; f++) {
        uint8_t* frame = out.data() + (size_t)f * 64;
        uint32_t ctrl = 0;
        int w = (f == 0) ? 3 : 1;  // frame 0: words 1,2 are x0/xn
        for (; w < 16 && i < n; w++) {
            // greedily pick the densest packing that fits
            auto fits8 = [&](int k) {
                return i + k <= n || true;
            };
            (void)fits8;
            int c;
            uint8_t* word = frame + 4 * w;
            auto in8 = [&](int j) {
                return j < n && d[j] >= -128 && d[j] <= 127;
            };
            auto in16 = [&](int j) {
                return j < n && d[j] >= -32768 && d[j] <= 32767;
            };
            if (in8(i) && in8(i + 1) && in8(i + 2) && in8(i + 3)) {
                c = 1;
                for (int k = 0; k < 4; k++)
                    word[k] = (uint8_t)(int8_t)d[i + k];
                i += 4;
            } else if (in16(i) && in16(i + 1)) {
                c = 2;
                wr_u16(word, (uint16_t)(int16_t)d[i]);
                wr_u16(word + 2, (uint16_t)(int16_t)d[i + 1]);
                i += 2;
            } else {
                c = 3;
                wr_u32(word, (uint32_t)d[i]);
                i += 1;
            }
            ctrl |= (uint32_t)c << (2 * (15 - w));
        }
        wr_u32(frame, ctrl);
    }
    out.resize((size_t)f * 64);
    if (out.size() < (size_t)maxframes * 64)
        out.resize((size_t)maxframes * 64, 0);
    // integration constants in frame 0
    wr_u32(out.data() + 4, (uint32_t)x[0]);
    wr_u32(out.data() + 8, (uint32_t)x[i - 1]);
    return i;
}

// ------------------------------------------------------------ record model

struct Segment {
    char network[3];
    char station[6];
    char location[3];
    char channel[4];
    double starttime;      // epoch seconds (UTC)
    double sampling_rate;
    int32_t npts;
    int32_t dtype;         // 0 = int32, 1 = float32, 2 = float64
    void* samples;         // malloc'd
};

double samprate(int16_t fact, int16_t mult) {
    double r = 0.0;
    if (fact > 0) r = fact;
    else if (fact < 0) r = -1.0 / fact;
    if (mult > 0) r *= mult;
    else if (mult < 0) r /= -mult;
    return r;
}

int days_from_civil(int y, int doy) {
    // epoch days for Jan 1 of year y (days since 1970-01-01) + doy-1
    int days = 0;
    if (y >= 1970) {
        for (int yy = 1970; yy < y; yy++)
            days += 365 + ((yy % 4 == 0 && yy % 100 != 0) || yy % 400 == 0);
    } else {
        for (int yy = y; yy < 1970; yy++)
            days -= 365 + ((yy % 4 == 0 && yy % 100 != 0) || yy % 400 == 0);
    }
    return days + doy - 1;
}

}  // namespace

extern "C" {

// Decode a miniSEED buffer into segments (one per record; the Python layer
// merges contiguous records). Returns the number of segments, writes a
// malloc'd Segment array into *out. Negative return = error code.
int xcm_decode(const uint8_t* buf, int64_t len, Segment** out) {
    std::vector<Segment> segs;
    int64_t off = 0;
    while (off + 64 <= len) {
        const uint8_t* rec = buf + off;
        // sniff a fixed header: bytes 0-5 ASCII digits, byte 6 quality
        char q = (char)rec[6];
        if (!(q == 'D' || q == 'R' || q == 'Q' || q == 'M')) break;

        // find blockette 1000 to learn encoding/order/reclen; try both
        // byte orders for the header fields (wordorder in b1000 governs)
        bool be = true;
        uint16_t year = rd_u16(rec + 20, be);
        if (year < 1900 || year > 2100) {
            be = false;
            year = rd_u16(rec + 20, be);
        }
        uint16_t nblk_off = rd_u16(rec + 46, be);
        uint16_t data_off = rd_u16(rec + 44, be);
        int nblockettes = rec[39];

        int encoding = 10;  // default Steim1
        int reclen = 512;
        bool data_be = be;
        uint16_t boff = nblk_off;
        for (int b = 0; b < nblockettes && boff >= 48 &&
                        (int64_t)boff + 8 <= len - off; b++) {
            uint16_t btype = rd_u16(rec + boff, be);
            uint16_t bnext = rd_u16(rec + boff + 2, be);
            if (btype == 1000) {
                encoding = rec[boff + 4];
                data_be = rec[boff + 5] == 1;
                // record-length exponent: spec range is 2^7..2^20; an
                // out-of-range byte (corrupt file) must not shift into
                // UB / a negative reclen that walks off the buffer
                int lexp = rec[boff + 6];
                reclen = (lexp >= 7 && lexp <= 20) ? (1 << lexp) : 0;
                break;
            }
            if (bnext == 0 || bnext <= boff) break;
            boff = bnext;
        }
        if (reclen < 128 || off + reclen > len) break;

        uint16_t doy = rd_u16(rec + 22, be);
        int hour = rec[24], minute = rec[25], sec = rec[26];
        uint16_t frac = rd_u16(rec + 28, be);  // 0.0001 s units
        int32_t timecorr = rd_i32(rec + 40, be);
        bool corr_applied = (rec[36] & 0x02) != 0;

        double t = (double)days_from_civil(year, doy) * 86400.0
                   + hour * 3600.0 + minute * 60.0 + sec + frac * 1e-4;
        if (!corr_applied) t += timecorr * 1e-4;

        uint16_t nsamp = rd_u16(rec + 30, be);
        double rate = samprate(rd_i16(rec + 32, be), rd_i16(rec + 34, be));

        Segment s;
        std::memset(&s, 0, sizeof(s));
        std::memcpy(s.network, rec + 18, 2);
        std::memcpy(s.station, rec + 8, 5);
        std::memcpy(s.location, rec + 13, 2);
        std::memcpy(s.channel, rec + 15, 3);
        s.starttime = t;
        s.sampling_rate = rate;

        const uint8_t* data = rec + data_off;
        int nbytes = reclen - data_off;
        if (nsamp > 0 && nbytes > 0) {
            if (encoding == 10 || encoding == 11) {
                std::vector<int32_t> v;
                int got = decode_steim(data, nbytes, nsamp, data_be,
                                       encoding == 10 ? 1 : 2, v);
                s.npts = got;
                s.dtype = 0;
                s.samples = std::malloc((size_t)got * 4);
                std::memcpy(s.samples, v.data(), (size_t)got * 4);
            } else if (encoding == 1) {      // INT16
                int got = nbytes / 2 < nsamp ? nbytes / 2 : nsamp;
                int32_t* v = (int32_t*)std::malloc((size_t)got * 4);
                for (int i = 0; i < got; i++)
                    v[i] = rd_i16(data + 2 * i, data_be);
                s.npts = got;
                s.dtype = 0;
                s.samples = v;
            } else if (encoding == 3) {      // INT32
                int got = nbytes / 4 < nsamp ? nbytes / 4 : nsamp;
                int32_t* v = (int32_t*)std::malloc((size_t)got * 4);
                for (int i = 0; i < got; i++)
                    v[i] = rd_i32(data + 4 * i, data_be);
                s.npts = got;
                s.dtype = 0;
                s.samples = v;
            } else if (encoding == 4) {      // FLOAT32
                int got = nbytes / 4 < nsamp ? nbytes / 4 : nsamp;
                float* v = (float*)std::malloc((size_t)got * 4);
                for (int i = 0; i < got; i++)
                    v[i] = rd_f32(data + 4 * i, data_be);
                s.npts = got;
                s.dtype = 1;
                s.samples = v;
            } else if (encoding == 5) {      // FLOAT64
                int got = nbytes / 8 < nsamp ? nbytes / 8 : nsamp;
                double* v = (double*)std::malloc((size_t)got * 8);
                for (int i = 0; i < got; i++)
                    v[i] = rd_f64(data + 8 * i, data_be);
                s.npts = got;
                s.dtype = 2;
                s.samples = v;
            } else {
                off += reclen;
                continue;  // unsupported encoding: skip record
            }
            segs.push_back(s);
        }
        off += reclen;
    }

    *out = (Segment*)std::malloc(segs.size() * sizeof(Segment));
    std::memcpy(*out, segs.data(), segs.size() * sizeof(Segment));
    return (int)segs.size();
}

void xcm_free(Segment* segs, int n) {
    if (!segs) return;
    for (int i = 0; i < n; i++) std::free(segs[i].samples);
    std::free(segs);
}

// Header-only scan: the record walk of xcm_decode with payload decoding
// skipped — npts comes from the fixed header's sample count and
// ``samples`` stays null. Availability/coverage scans of SDS day files
// then cost a header walk (64 bytes per record looked at) instead of a
// full Steim decode of the day. Records whose encoding xcm_decode would
// skip are skipped here too, so scan coverage never exceeds decode
// coverage (a corrupt payload can still decode SHORT of its header
// count — callers treat the scan as advisory).
int xcm_scan(const uint8_t* buf, int64_t len, Segment** out) {
    std::vector<Segment> segs;
    int64_t off = 0;
    while (off + 64 <= len) {
        const uint8_t* rec = buf + off;
        char q = (char)rec[6];
        if (!(q == 'D' || q == 'R' || q == 'Q' || q == 'M')) break;

        bool be = true;
        uint16_t year = rd_u16(rec + 20, be);
        if (year < 1900 || year > 2100) {
            be = false;
            year = rd_u16(rec + 20, be);
        }
        uint16_t nblk_off = rd_u16(rec + 46, be);
        int nblockettes = rec[39];

        int encoding = 10;
        int reclen = 512;
        uint16_t boff = nblk_off;
        for (int b = 0; b < nblockettes && boff >= 48 &&
                        (int64_t)boff + 8 <= len - off; b++) {
            uint16_t btype = rd_u16(rec + boff, be);
            uint16_t bnext = rd_u16(rec + boff + 2, be);
            if (btype == 1000) {
                encoding = rec[boff + 4];
                // same corrupt-exponent guard as xcm_decode
                int lexp = rec[boff + 6];
                reclen = (lexp >= 7 && lexp <= 20) ? (1 << lexp) : 0;
                break;
            }
            if (bnext == 0 || bnext <= boff) break;
            boff = bnext;
        }
        if (reclen < 128 || off + reclen > len) break;

        uint16_t doy = rd_u16(rec + 22, be);
        int hour = rec[24], minute = rec[25], sec = rec[26];
        uint16_t frac = rd_u16(rec + 28, be);
        int32_t timecorr = rd_i32(rec + 40, be);
        bool corr_applied = (rec[36] & 0x02) != 0;

        double t = (double)days_from_civil(year, doy) * 86400.0
                   + hour * 3600.0 + minute * 60.0 + sec + frac * 1e-4;
        if (!corr_applied) t += timecorr * 1e-4;

        uint16_t nsamp = rd_u16(rec + 30, be);
        double rate = samprate(rd_i16(rec + 32, be), rd_i16(rec + 34, be));

        bool supported = encoding == 1 || encoding == 3 || encoding == 4 ||
                         encoding == 5 || encoding == 10 || encoding == 11;
        // mirror xcm_decode's payload gate (nbytes > 0): a record whose
        // data offset leaves no payload decodes to nothing, so the scan
        // must not count its header nsamp either
        uint16_t data_off = rd_u16(rec + 44, be);
        if (nsamp > 0 && supported && data_off >= 48 &&
            (int)data_off < reclen) {
            Segment s;
            std::memset(&s, 0, sizeof(s));
            std::memcpy(s.network, rec + 18, 2);
            std::memcpy(s.station, rec + 8, 5);
            std::memcpy(s.location, rec + 13, 2);
            std::memcpy(s.channel, rec + 15, 3);
            s.starttime = t;
            s.sampling_rate = rate;
            s.npts = nsamp;
            s.dtype = 0;
            s.samples = nullptr;
            segs.push_back(s);
        }
        off += reclen;
    }

    *out = (Segment*)std::malloc(segs.size() * sizeof(Segment));
    std::memcpy(*out, segs.data(), segs.size() * sizeof(Segment));
    return (int)segs.size();
}

// Encode int32 samples as big-endian Steim1 miniSEED records.
// Returns byte length; caller frees *out with xcm_free_bytes.
int64_t xcm_encode_steim1(const char* net, const char* sta, const char* loc,
                          const char* cha, double starttime,
                          double sampling_rate, const int32_t* samples,
                          int32_t npts, int reclen, uint8_t** out) {
    if (reclen < 128 || (reclen & (reclen - 1)) != 0) return -1;
    int reclen_pow = 0;
    while ((1 << reclen_pow) < reclen) reclen_pow++;
    int maxframes = (reclen - 64) / 64;

    std::vector<uint8_t> all;
    int i = 0;
    int seq = 1;
    while (i < npts) {
        std::vector<uint8_t> frames;
        int32_t prev = i ? samples[i - 1] : samples[0];
        int got = encode_steim1(samples + i, npts - i, prev, maxframes,
                                frames);
        if (got <= 0) return -2;

        double t = starttime + (double)i / sampling_rate;
        uint8_t hdr[64];
        std::memset(hdr, 0, sizeof(hdr));
        char seqs[8];
        std::snprintf(seqs, sizeof(seqs), "%06d", seq % 1000000);
        std::memcpy(hdr, seqs, 6);
        hdr[6] = 'D';
        hdr[7] = ' ';
        auto put = [&](int at, const char* sarg, int w) {
            for (int k = 0; k < w; k++)
                hdr[at + k] = (k < (int)std::strlen(sarg))
                                  ? (uint8_t)sarg[k] : ' ';
        };
        put(8, sta, 5);
        put(13, loc, 2);
        put(15, cha, 3);
        put(18, net, 2);

        // time
        int64_t tsec = (int64_t)t;
        double remain = t - (double)tsec;
        int64_t days = tsec / 86400;
        int64_t daysec = tsec % 86400;
        if (daysec < 0) { daysec += 86400; days -= 1; }
        // days since epoch -> year/doy
        int year = 1970;
        int64_t d = days;
        while (true) {
            int leap = ((year % 4 == 0 && year % 100 != 0) ||
                        year % 400 == 0);
            int ylen = 365 + leap;
            if (d >= ylen) { d -= ylen; year++; }
            else break;
        }
        wr_u16(hdr + 20, (uint16_t)year);
        wr_u16(hdr + 22, (uint16_t)(d + 1));
        hdr[24] = (uint8_t)(daysec / 3600);
        hdr[25] = (uint8_t)((daysec % 3600) / 60);
        hdr[26] = (uint8_t)(daysec % 60);
        wr_u16(hdr + 28, (uint16_t)(remain * 1e4 + 0.5));

        wr_u16(hdr + 30, (uint16_t)got);
        // sampling rate as factor/multiplier
        int16_t fact, mult;
        if (sampling_rate >= 1.0) {
            fact = (int16_t)(sampling_rate + 0.5);
            mult = 1;
            if ((double)fact != sampling_rate) {
                fact = (int16_t)(sampling_rate * 100 + 0.5);
                mult = -100;
            }
        } else {
            fact = (int16_t)(-1.0 / sampling_rate - 0.5);
            mult = 1;
        }
        wr_u16(hdr + 32, (uint16_t)fact);
        wr_u16(hdr + 34, (uint16_t)mult);
        hdr[39] = 1;                 // one blockette
        wr_u16(hdr + 44, 64);        // data offset
        wr_u16(hdr + 46, 48);        // first blockette offset
        // blockette 1000
        wr_u16(hdr + 48, 1000);
        wr_u16(hdr + 50, 0);
        hdr[52] = 10;                // Steim1
        hdr[53] = 1;                 // big endian
        hdr[54] = (uint8_t)reclen_pow;

        all.insert(all.end(), hdr, hdr + 64);
        all.insert(all.end(), frames.begin(), frames.end());
        all.resize(((all.size() + reclen - 1) / reclen) * reclen, 0);

        i += got;
        seq++;
    }
    *out = (uint8_t*)std::malloc(all.size());
    std::memcpy(*out, all.data(), all.size());
    return (int64_t)all.size();
}

void xcm_free_bytes(uint8_t* p) { std::free(p); }

}  // extern "C"
