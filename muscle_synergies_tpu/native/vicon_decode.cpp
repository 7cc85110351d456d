// Fast numeric-block decoder for Vicon Nexus CSV exports.
//
// The ingest hot path is turning ~130k lines x ~130 columns of ASCII
// floats into a dense float64 matrix (the reference burns this time in
// a per-cell Python loop, reader.py:927-955; our Python fallback uses
// pandas' C reader).  The decoder is a FUSED single pass: newline
// search via SIMD memchr, and an inline fixed-point parser that
// discovers each cell's end while converting it — no separate
// blank-line scan or cell-boundary scan, so each byte is touched once
// in the common case (~2.5x the throughput of the scan-then-parse
// version this replaces).
//
// Built as a plain shared library (no Python.h); bound via ctypes.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef __linux__
#include <sched.h>
#endif

namespace {

// Powers of ten exactly representable in double (for the one-rounding
// fast path below).
const double p10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,
    1e10, 1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18,
};

// A cell character that constitutes content.  Lines whose cells are
// all empty (only separators/whitespace) are "blank" and skipped by
// both the row counter and the decoder — the two MUST agree or the
// threaded decode writes rows at wrong offsets.
inline bool is_content(char c) {
    return c != ',' && c != ' ' && c != '\t' && c != '\r';
}

// SWAR helpers for runs of 8 ASCII digits (the classic public-domain
// technique used by fast_float/simdjson): one unaligned 8-byte load
// replaces 8 iterations of the scalar digit loop.  Vicon cells are
// dominated by 8-fractional-digit fixed-point values, so this is the
// single hottest pattern in the file.
inline uint64_t load8(const char* p) {
    uint64_t v;
    std::memcpy(&v, p, sizeof(v));
    return v;  // little-endian assumed (x86/ARM hosts)
}

inline bool all_digits8(uint64_t chunk) {
    return ((chunk & 0xF0F0F0F0F0F0F0F0ULL) |
            (((chunk + 0x0606060606060606ULL) & 0xF0F0F0F0F0F0F0F0ULL) >>
             4)) == 0x3333333333333333ULL;
}

inline uint32_t parse8(uint64_t chunk) {
    const uint64_t mask = 0x000000FF000000FFULL;
    const uint64_t mul1 = 0x000F424000000064ULL;  // 100 + (1000000 << 32)
    const uint64_t mul2 = 0x0000271000000001ULL;  // 1 + (10000 << 32)
    chunk -= 0x3030303030303030ULL;
    chunk = (chunk * 10) + (chunk >> 8);
    return static_cast<uint32_t>(
        (((chunk & mask) * mul1) + (((chunk >> 16) & mask) * mul2)) >> 32);
}

// CPUs this process may actually run on.  hardware_concurrency()
// reports the machine's online CPUs and ignores container/cgroup
// affinity masks, which oversubscribes 1-core sandboxes with threads
// that only add scheduling overhead.
long available_cpus() {
#ifdef __linux__
    cpu_set_t set;
    if (sched_getaffinity(0, sizeof(set), &set) == 0) {
        int n = CPU_COUNT(&set);
        if (n > 0) return n;
    }
#endif
    unsigned hw = std::thread::hardware_concurrency();
    return hw ? hw : 1;
}

}  // namespace

extern "C" {

// Count data rows (non-blank lines) in the buffer.
long msk_count_rows(const char* buf, long len) {
    long rows = 0;
    bool has_content = false;
    for (long i = 0; i < len; ++i) {
        char c = buf[i];
        if (c == '\n') {
            if (has_content) ++rows;
            has_content = false;
        } else if (is_content(c)) {
            has_content = true;
        }
    }
    if (has_content) ++rows;
    return rows;
}

// Decode the numeric block in [buf, buf+len).
//
// Returns 0 on success, or the 1-based data-row number of the first
// cell that failed to parse as a float (for error reporting).
//
// Cell grammar (must match the pandas fallback and the old
// scan-then-parse decoder bit-for-bit):
//   - cells split on ',', rows on '\n', trailing '\r's stripped
//   - leading/trailing spaces and tabs trimmed; empty cell -> NaN
//   - a lone '+' is treated as empty (from_chars quirk, kept)
//   - plain fixed-point cells ("1", "-0.00220871") take an exact
//     one-rounding fast path: with <= 18 digits and a < 2^53 mantissa,
//     double(mant) / double(10^frac) equals the correctly-rounded
//     value (Gay's small-decimal rule) — bit-identical to from_chars
//   - exponents / long mantissas / inf / nan fall back to from_chars
//   - columns beyond num_cols are ignored; short rows pad with NaN
//   - blank lines (no content in ANY column) are skipped entirely
static long decode_range(const char* buf, long len, long num_cols,
                         double* out, long max_rows, long* out_rows,
                         long row_base) {
    const double nan_val = std::nan("");
    const char* p = buf;
    const char* const bend = buf + len;
    long row = 0;
    while (p < bend && row < max_rows) {
        const char* nl =
            static_cast<const char*>(memchr(p, '\n', bend - p));
        const char* line_end = nl ? nl : bend;
        const char* ce = line_end;
        while (ce > p && ce[-1] == '\r') --ce;

        double* out_row = out + row * num_cols;
        long col = 0;
        bool content = false;
        const char* q = p;
        while (col < num_cols) {
            while (q < ce && (*q == ' ' || *q == '\t')) ++q;
            const char* cs = q;
            bool neg = false;
            if (q < ce && (*q == '-' || *q == '+')) {
                neg = (*q == '-');
                ++q;
            }
            unsigned long long mant = 0;
            int digits = 0, frac = 0;
            bool dot = false;
            while (q < ce && digits <= 18) {
                if (digits <= 10 && ce - q >= 8) {
                    uint64_t chunk = load8(q);
                    if (all_digits8(chunk)) {
                        mant = mant * 100000000ULL + parse8(chunk);
                        digits += 8;
                        if (dot) frac += 8;
                        q += 8;
                        continue;
                    }
                }
                char c = *q;
                if (c >= '0' && c <= '9') {
                    mant = mant * 10ULL + (unsigned long long)(c - '0');
                    ++digits;
                    if (dot) ++frac;
                    ++q;
                } else if (c == '.' && !dot) {
                    dot = true;
                    ++q;
                } else {
                    break;
                }
            }
            bool clean = (q == ce || *q == ',');
            if (clean && digits > 0 && digits <= 18 && !(mant >> 53)) {
                double v = static_cast<double>(mant);
                if (frac) v /= p10[frac];
                out_row[col++] = neg ? -v : v;
                content = true;
            } else if (clean && q == cs) {
                out_row[col++] = nan_val;  // empty / whitespace cell
            } else {
                // slow path: find the cell end, trim, from_chars
                const char* cell_end = q;
                while (cell_end < ce && *cell_end != ',') ++cell_end;
                const char* te = cell_end;
                while (te > cs && (te[-1] == ' ' || te[-1] == '\t'))
                    --te;
                if (te > cs) content = true;
                const char* fs = cs;
                if (fs < te && *fs == '+') ++fs;
                double v;
                auto res = std::from_chars(fs, te, v);
                if (res.ec != std::errc() || res.ptr != te) {
                    if (fs != te) return row_base + row + 1;
                    out_row[col++] = nan_val;  // "" or lone '+'
                } else {
                    out_row[col++] = v;
                }
                q = cell_end;
            }
            if (q < ce && *q == ',') {
                ++q;
                continue;
            }
            break;  // line exhausted
        }
        if (!content) {
            // first num_cols cells were all empty: the row still
            // counts if any IGNORED column has content (matches
            // msk_count_rows, which scans whole lines)
            const char* r = q;
            while (r < ce && !is_content(*r)) ++r;
            content = (r < ce);
        }
        if (content) {
            for (; col < num_cols; ++col) out_row[col] = nan_val;
            ++row;  // blank rows: NaNs written above get overwritten
        }
        p = line_end + 1;
    }
    *out_rows = row;
    return 0;
}

// Decode the numeric block (parallel over row ranges when the buffer
// is large and more than one CPU is actually available; forceable
// through MSK_DECODE_THREADS for testing).
//
// Same contract as decode_range with row_base = 0: returns 0 on
// success or the 1-based row number of the first unparseable cell.
long msk_decode_block(const char* buf, long len, long num_cols,
                      double* out, long max_rows, long* out_rows) {
    long n_threads = std::min<long>(available_cpus(), 16);
    if (const char* env = std::getenv("MSK_DECODE_THREADS")) {
        long forced = std::strtol(env, nullptr, 10);
        if (forced > 0) n_threads = std::min<long>(forced, 16);
    }
    if (len < (1 << 20) || n_threads <= 1) {
        return decode_range(buf, len, num_cols, out, max_rows, out_rows,
                            0);
    }

    // split at line boundaries
    std::vector<long> starts{0};
    for (long t = 1; t < n_threads; ++t) {
        long pos = len * t / n_threads;
        while (pos < len && buf[pos - 1] != '\n') ++pos;
        starts.push_back(pos);
    }
    starts.push_back(len);

    // rows before each chunk (so each thread writes at its offset)
    std::vector<long> row_offset(n_threads + 1, 0);
    for (long t = 0; t < n_threads; ++t) {
        row_offset[t + 1] =
            row_offset[t] +
            msk_count_rows(buf + starts[t], starts[t + 1] - starts[t]);
    }

    std::vector<long> status(n_threads, 0), got(n_threads, 0);
    std::vector<std::thread> workers;
    for (long t = 0; t < n_threads; ++t) {
        workers.emplace_back([&, t]() {
            long rows_cap = std::min(max_rows - row_offset[t],
                                     row_offset[t + 1] - row_offset[t]);
            if (rows_cap < 0) rows_cap = 0;
            status[t] = decode_range(
                buf + starts[t], starts[t + 1] - starts[t], num_cols,
                out + row_offset[t] * num_cols, rows_cap, &got[t],
                row_offset[t]);
        });
    }
    for (auto& w : workers) w.join();

    long total = 0;
    for (long t = 0; t < n_threads; ++t) total += got[t];
    *out_rows = total;
    for (long t = 0; t < n_threads; ++t) {
        if (status[t] != 0) return status[t];
    }
    return 0;
}

}  // extern "C"
