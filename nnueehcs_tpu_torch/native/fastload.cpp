// Fast numeric-table parser for delimited text datasets.
//
// The harness ingests multi-GB whitespace/comma-delimited surrogate tables
// (reference dataset formats: airfoil/puma whitespace files, CSV). pandas
// falls back to its python engine for regex separators like `\s+`, which is
// orders of magnitude slower than necessary. This parser mmap-reads the
// file, splits it into newline-aligned chunks, and parses rows in parallel
// with strtod.
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment):
//   fl_parse(path, delim, skip_rows, &rows, &cols) -> double* (caller frees
//       with fl_free). delim == 0 means "any run of spaces/tabs".
//   fl_free(ptr)
//
// Build: g++ -O3 -shared -fPIC -o _fastload.so fastload.cpp -lpthread
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <thread>
#include <vector>

namespace {

struct Chunk {
    const char* begin;
    const char* end;
    std::vector<double> values;
    long rows = 0;
    bool ok = true;
};

inline bool is_ws_delim(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Hand-rolled decimal float parser (sign, digits, '.', exponent). ~5-10x
// faster than locale-aware strtod; falls back to strtod for anything
// unusual (inf/nan/hex). Returns true on success and advances *pp.
inline bool parse_double(const char*& p, const char* end, double* out) {
    const char* s = p;
    bool neg = false;
    if (s < end && (*s == '-' || *s == '+')) { neg = (*s == '-'); ++s; }
    unsigned long long mant = 0;
    int digits = 0, frac_digits = 0;
    bool any = false;
    while (s < end && *s >= '0' && *s <= '9') {
        if (digits < 18) { mant = mant * 10 + (*s - '0'); ++digits; }
        else ++frac_digits;  // overflowed mantissa: track as implicit exp
        ++s; any = true;
    }
    int extra_exp = frac_digits;   // digits dropped from the integer part
    frac_digits = 0;
    if (s < end && *s == '.') {
        ++s;
        while (s < end && *s >= '0' && *s <= '9') {
            if (digits < 18) { mant = mant * 10 + (*s - '0'); ++digits; ++frac_digits; }
            ++s; any = true;
        }
    }
    if (!any) return false;
    long exp10 = extra_exp - frac_digits;
    if (s < end && (*s == 'e' || *s == 'E')) {
        const char* es = s + 1;
        bool eneg = false;
        if (es < end && (*es == '-' || *es == '+')) { eneg = (*es == '-'); ++es; }
        long ev = 0; bool eany = false;
        while (es < end && *es >= '0' && *es <= '9') {
            ev = ev * 10 + (*es - '0'); ++es; eany = true;
        }
        if (eany) { exp10 += eneg ? -ev : ev; s = es; }
    }
    static const double pow10_pos[] = {1e0,1e1,1e2,1e3,1e4,1e5,1e6,1e7,1e8,
                                       1e9,1e10,1e11,1e12,1e13,1e14,1e15,
                                       1e16,1e17,1e18,1e19,1e20,1e21,1e22};
    double v = static_cast<double>(mant);
    if (exp10 > 0) {
        v = (exp10 <= 22) ? v * pow10_pos[exp10] : 0.0;
        if (exp10 > 22) return false;            // rare: defer to strtod
    } else if (exp10 < 0) {
        long e = -exp10;
        if (e <= 22) v = v / pow10_pos[e];
        else return false;                       // rare: defer to strtod
    }
    *out = neg ? -v : v;
    p = s;
    return true;
}

// Parse [begin, end) line by line. delim == 0 -> whitespace runs.
void parse_chunk(Chunk* chunk, char delim, long expected_cols) {
    const char* p = chunk->begin;
    const char* end = chunk->end;
    chunk->values.reserve(static_cast<size_t>((end - p) / 8));
    while (p < end) {
        // skip leading separators on the line
        while (p < end && (is_ws_delim(*p) || (delim && *p == delim))) ++p;
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        long cols = 0;
        while (p < end && *p != '\n') {
            double v;
            if (!parse_double(p, end, &v)) {
                // strtod fallback (inf/nan/extreme exponents) via a bounded
                // NUL-terminated buffer: the mmap'd file has no terminator
                // and strtod would otherwise read past the mapping
                char buf[64];
                size_t len = static_cast<size_t>(end - p);
                if (len > sizeof(buf) - 1) len = sizeof(buf) - 1;
                memcpy(buf, p, len);
                buf[len] = '\0';
                char* next = nullptr;
                v = strtod(buf, &next);
                if (next == buf) { chunk->ok = false; return; }
                p += (next - buf);
            }
            chunk->values.push_back(v);
            ++cols;
            while (p < end && *p != '\n' &&
                   (is_ws_delim(*p) || (delim && *p == delim))) ++p;
        }
        if (p < end) ++p;  // consume newline
        if (expected_cols > 0 && cols != expected_cols) {
            chunk->ok = false;
            return;
        }
        ++chunk->rows;
    }
}

}  // namespace

extern "C" {

double* fl_parse(const char* path, char delim, long skip_rows,
                 long* out_rows, long* out_cols) {
    *out_rows = 0;
    *out_cols = 0;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) { close(fd); return nullptr; }
    size_t size = static_cast<size_t>(st.st_size);
    const char* data = static_cast<const char*>(
        mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    close(fd);
    if (data == MAP_FAILED) return nullptr;

    const char* begin = data;
    const char* end = data + size;

    // skip header rows
    for (long i = 0; i < skip_rows && begin < end; ++i) {
        const char* nl = static_cast<const char*>(
            memchr(begin, '\n', static_cast<size_t>(end - begin)));
        begin = nl ? nl + 1 : end;
    }

    // determine column count from the first data line
    Chunk probe;
    probe.begin = begin;
    const char* first_nl = static_cast<const char*>(
        memchr(begin, '\n', static_cast<size_t>(end - begin)));
    probe.end = first_nl ? first_nl + 1 : end;
    parse_chunk(&probe, delim, 0);
    if (!probe.ok || probe.rows == 0) { munmap((void*)data, size); return nullptr; }
    long cols = static_cast<long>(probe.values.size());

    // split the remainder into newline-aligned chunks
    unsigned n_threads = std::thread::hardware_concurrency();
    if (n_threads == 0) n_threads = 4;
    if (n_threads > 16) n_threads = 16;
    size_t span = static_cast<size_t>(end - begin);
    if (span < (1u << 20)) n_threads = 1;

    std::vector<Chunk> chunks(n_threads);
    const char* pos = begin;
    size_t per = span / n_threads;
    for (unsigned t = 0; t < n_threads; ++t) {
        chunks[t].begin = pos;
        const char* target = (t + 1 == n_threads) ? end : pos + per;
        if (target > end) target = end;
        const char* nl = target < end
            ? static_cast<const char*>(
                  memchr(target, '\n', static_cast<size_t>(end - target)))
            : nullptr;
        chunks[t].end = nl ? nl + 1 : end;
        pos = chunks[t].end;
    }

    std::vector<std::thread> threads;
    for (auto& c : chunks)
        threads.emplace_back(parse_chunk, &c, delim, cols);
    for (auto& th : threads) th.join();

    long total_rows = 0;
    for (auto& c : chunks) {
        if (!c.ok) { munmap((void*)data, size); return nullptr; }
        total_rows += c.rows;
    }
    munmap((void*)data, size);

    double* out = static_cast<double*>(
        malloc(sizeof(double) * static_cast<size_t>(total_rows) *
               static_cast<size_t>(cols)));
    if (!out) return nullptr;
    double* w = out;
    for (auto& c : chunks) {
        memcpy(w, c.values.data(), c.values.size() * sizeof(double));
        w += c.values.size();
    }
    *out_rows = total_rows;
    *out_cols = cols;
    return out;
}

void fl_free(double* ptr) { free(ptr); }

}  // extern "C"
