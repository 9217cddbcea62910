// mseed_runs.cpp — the port's read path of the miniSEED codec.
//
// A buffer's records are decoded and joined in the library into one array
// per contiguous run, by the rule of mseed.py's _merge_contiguous (which
// the per-record plain path, xcm_decode, keeps): a record joins the open
// run when its id and sampling rate equal the run's and its start lies
// one sample period (within 1e-4 s) after the run's end, both times in
// integer nanoseconds as UTCDateTime rounds them. Built with
// -ffp-contract=off, so every product and quotient below is one IEEE
// operation, as in Python.
//
// This file includes mseed.cpp, the codec the JAX package's copy shares:
// the byte readers, the Steim decoder, the time and rate of a header are
// that file's, and the record walk below is xcm_decode's, record for
// record. What differs is where samples go: xcm_decode mallocs each
// record's samples and keeps them all until the merge (a 250 Hz day file
// is ~54,000 records); here they go into a few large mmap'd blocks, and
// no record's samples stay on the heap.
//
// Sequence, for ctypes (see mseed.py read_mseed_bytes):
//   xcm_runs_decode -> xcm_runs_ids -> xcm_runs_merge -> xcm_runs_headers
//   -> xcm_runs_fill, and xcm_runs_free in every case. The ids are merged
// by keys the caller computes from the raw fields (decode, strip, join),
// so two ids are equal exactly when Python's Trace.id would call them so.

#include "mseed.cpp"

#include <sys/mman.h>

#include <cmath>

namespace {

// a record's id fields, each NUL-terminated (ctypes reads each up to its
// first NUL)
struct Id {
    char network[3];
    char station[6];
    char location[3];
    char channel[4];
};

struct Rec {
    int32_t id;            // raw id
    int32_t dtype;         // 0 = int32, 1 = float32, 2 = float64
    int32_t npts;
    double starttime;
    double sampling_rate;
    const void* samples;   // in a block
};

struct Run {
    int32_t id;            // raw id of its first record
    int32_t dtype;         // np.concatenate's promotion over its records
    double starttime;      // its first record's
    double sampling_rate;
    int64_t npts;
};

// records never straddle blocks: one holds at most 65535 samples of
// 8 bytes, far below a block
const size_t kBlock = 16u << 20;
const size_t kItem[3] = {4, 4, 8};

struct Decoded {
    std::vector<void*> blocks;
    size_t used = kBlock;         // bytes used of the last block
    std::vector<Rec> recs;
    std::vector<Id> ids;          // distinct raw ids, in order of first use
    std::vector<Run> runs;
    std::vector<int32_t> first;   // first record of each run

    ~Decoded() {
        for (void* b : blocks) munmap(b, kBlock);
    }

    // room for n bytes, or null when the system has none
    uint8_t* take(size_t n) {
        if (used + n > kBlock) {
            void* b = mmap(nullptr, kBlock, PROT_READ | PROT_WRITE,
                           MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
            if (b == MAP_FAILED) return nullptr;
            blocks.push_back(b);
            used = 0;
        }
        uint8_t* p = (uint8_t*)blocks.back() + used;
        used += n;
        return p;
    }

    int32_t id_of(const uint8_t* rec) {
        Id id;
        std::memset(&id, 0, sizeof(id));
        std::memcpy(id.network, rec + 18, 2);
        std::memcpy(id.station, rec + 8, 5);
        std::memcpy(id.location, rec + 13, 2);
        std::memcpy(id.channel, rec + 15, 3);
        int j = (int)ids.size() - 1;
        // records of one id come in long stretches: try the last first
        if (j < 0 || std::memcmp(&ids[j], &id, sizeof(Id)) != 0) {
            for (j = 0; j < (int)ids.size(); j++)
                if (std::memcmp(&ids[j], &id, sizeof(Id)) == 0) break;
            if (j == (int)ids.size()) ids.push_back(id);
        }
        return j;
    }
};

// UTCDateTime's nanoseconds of float seconds: int(round(s * 1e9)).
// __int128 holds any value a record's header can give exactly.
__int128 ns_of(double seconds) {
    return (__int128)std::nearbyint(seconds * 1e9);
}

// xcm_decode's walk, its records kept in d; false when out of memory
bool walk(const uint8_t* buf, int64_t len, Decoded* d) {
    d->recs.reserve((size_t)(len / 128) + 1);
    std::vector<int32_t> steim_out;
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
        uint16_t data_off = rd_u16(rec + 44, be);
        int nblockettes = rec[39];

        int encoding = 10;
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

        const uint8_t* data = rec + data_off;
        int nbytes = reclen - data_off;
        bool steim = encoding == 10 || encoding == 11;
        if (nsamp > 0 && nbytes > 0 &&
            (steim || encoding == 1 || encoding == 3 || encoding == 4 ||
             encoding == 5)) {
            int dtype = encoding == 4 ? 1 : encoding == 5 ? 2 : 0;
            uint8_t* out = d->take((size_t)nsamp * kItem[dtype]);
            if (!out) return false;
            int got;
            if (steim) {
                got = decode_steim(data, nbytes, nsamp, data_be,
                                   encoding == 10 ? 1 : 2, steim_out);
                std::memcpy(out, steim_out.data(), (size_t)got * 4);
            } else {
                int size = encoding == 1 ? 2 : (int)kItem[dtype];
                got = nbytes / size < nsamp ? nbytes / size : nsamp;
                for (int i = 0; i < got; i++) {
                    const uint8_t* p = data + size * i;
                    if (encoding == 1)
                        ((int32_t*)out)[i] = rd_i16(p, data_be);
                    else if (encoding == 3)
                        ((int32_t*)out)[i] = rd_i32(p, data_be);
                    else if (encoding == 4)
                        ((float*)out)[i] = rd_f32(p, data_be);
                    else
                        ((double*)out)[i] = rd_f64(p, data_be);
                }
            }
            d->used -= ((size_t)nsamp - got) * kItem[dtype];
            d->recs.push_back({d->id_of(rec), dtype, got, t, rate, out});
        }
        off += reclen;
    }
    return true;
}

}  // namespace

extern "C" {

// Decode every record of a buffer. Returns the number of distinct raw ids
// (0 for a buffer with no record), or -1 when memory ran out; the state
// in *out either way.
int xcm_runs_decode(const uint8_t* buf, int64_t len, Decoded** out) {
    Decoded* d = new Decoded;
    *out = d;
    if (!walk(buf, len, d)) return -1;
    return (int)d->ids.size();
}

void xcm_runs_ids(const Decoded* d, Id* ids) {
    std::memcpy(ids, d->ids.data(), d->ids.size() * sizeof(Id));
}

// Join the records into runs; key[i] is raw id i's key (equal keys are
// equal ids). Returns the number of runs, or -1 where Python's loop
// divides by a zero sampling rate.
int xcm_runs_merge(Decoded* d, const int32_t* key) {
    d->runs.clear();
    d->first.clear();
    __int128 run_ns = 0;
    for (size_t k = 0; k < d->recs.size(); k++) {
        const Rec& s = d->recs[k];
        __int128 start_ns = ns_of(s.starttime);
        if (!d->runs.empty()) {
            Run& r = d->runs.back();
            // the run's endtime: starttime + (npts - 1) / fs, or + 0.0
            if (r.npts && r.sampling_rate == 0.0) return -1;
            __int128 end_ns = run_ns + (r.npts
                ? ns_of((double)(r.npts - 1) / r.sampling_rate) : 0);
            double dt = (double)(start_ns - end_ns) / 1e9;
            if (key[s.id] == key[r.id] &&
                r.sampling_rate == s.sampling_rate) {
                if (s.sampling_rate == 0.0) return -1;
                if (std::fabs(dt - 1.0 / s.sampling_rate) < 1e-4) {
                    r.npts += s.npts;
                    if (r.dtype != s.dtype) r.dtype = 2;
                    continue;
                }
            }
        }
        d->runs.push_back({s.id, s.dtype, s.starttime, s.sampling_rate,
                           s.npts});
        d->first.push_back((int32_t)k);
        run_ns = start_ns;
    }
    return (int)d->runs.size();
}

void xcm_runs_headers(const Decoded* d, Run* out) {
    std::memcpy(out, d->runs.data(), d->runs.size() * sizeof(Run));
}

// Copy each run's samples into dst[run] (npts items of its dtype),
// converting records of another dtype as np.concatenate does.
void xcm_runs_fill(const Decoded* d, void* const* dst) {
    for (size_t r = 0; r < d->runs.size(); r++) {
        const Run& run = d->runs[r];
        size_t end = r + 1 < d->runs.size() ? (size_t)d->first[r + 1]
                                            : d->recs.size();
        uint8_t* p = (uint8_t*)dst[r];
        for (size_t k = d->first[r]; k < end; k++) {
            const Rec& s = d->recs[k];
            if (s.dtype == run.dtype) {
                size_t n = (size_t)s.npts * kItem[s.dtype];
                std::memcpy(p, s.samples, n);
                p += n;
                continue;
            }
            double* q = (double*)p;   // a mixed run is float64
            for (int i = 0; i < s.npts; i++)
                q[i] = s.dtype == 0 ? (double)((const int32_t*)s.samples)[i]
                     : s.dtype == 1 ? (double)((const float*)s.samples)[i]
                     : ((const double*)s.samples)[i];
            p += (size_t)s.npts * 8;
        }
    }
}

void xcm_runs_free(Decoded* d) { delete d; }

}  // extern "C"
