// Native FASTA/FASTQ scanner (the IO layer's hot loop).
//
// The reference consumes inputs through needletail, a native parser
// (reference: src/lib.rs:52-54 usage; Cargo.toml needletail dependency);
// this is the analogous native runtime piece here. One pass over the raw
// byte buffer: sequence bytes compact into `out` (newlines and line
// structure stripped), record boundaries land in `recs` as
// (name_off, name_len, seq_off, seq_len) int64 quadruples indexing into
// the INPUT buffer (names) and the OUTPUT buffer (sequences).
//
// Python drives it through ctypes (kbo_tpu_torch/io/fastx.py, built with
// g++ at first use by kbo_tpu_torch/native.py); gzip inputs are inflated
// Python-side first, so this only ever sees plain bytes.

#include <cstdint>
#include <cstring>

namespace {
// trailing-whitespace set matching Python bytes.rstrip()
inline bool is_trail_ws(uint8_t c) {
  return c == '\r' || c == ' ' || c == '\t' || c == '\v' || c == '\f';
}
}  // namespace

extern "C" {

// Returns the number of records, or -1 on malformed input.
// out must hold >= n bytes; recs must hold >= 4 * max_recs int64s.
// A first call with recs == nullptr only counts records.
int64_t fastx_scan_fasta(const uint8_t* buf, int64_t n, uint8_t* out,
                         int64_t* recs, int64_t max_recs) {
    int64_t i = 0, nrec = 0, out_pos = 0;
    while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
    if (i >= n || buf[i] != '>') return -1;
    while (i < n) {
        if (buf[i] != '>') return -1;
        int64_t name_start = ++i;
        while (i < n && buf[i] != '\n') i++;
        int64_t name_end = i;
        while (name_end > name_start && is_trail_ws(buf[name_end - 1]))
            name_end--;
        if (i < n) i++;  // consume '\n'
        int64_t seq_start = out_pos;
        while (i < n && buf[i] != '>') {
            int64_t line_start = i;
            while (i < n && buf[i] != '\n') i++;
            int64_t line_end = i;
            // match the Python oracle's rstrip(): trailing whitespace on a
            // sequence line is not sequence
            while (line_end > line_start && is_trail_ws(buf[line_end - 1]))
                line_end--;
            if (out && line_end > line_start) {
                memcpy(out + out_pos, buf + line_start,
                       (size_t)(line_end - line_start));
            }
            out_pos += line_end - line_start;
            if (i < n) i++;
        }
        if (recs) {
            if (nrec >= max_recs) return -1;
            recs[4 * nrec + 0] = name_start;
            recs[4 * nrec + 1] = name_end - name_start;
            recs[4 * nrec + 2] = seq_start;
            recs[4 * nrec + 3] = out_pos - seq_start;
        }
        nrec++;
    }
    return nrec;
}

int64_t fastx_scan_fastq(const uint8_t* buf, int64_t n, uint8_t* out,
                         int64_t* recs, int64_t max_recs) {
    int64_t i = 0, nrec = 0, out_pos = 0;
    while (i < n) {
        // skip blank separator lines (any whitespace-only line), like the
        // Python oracle's header.strip() loop
        while (i < n) {
            int64_t j = i;
            while (j < n && (buf[j] == '\n' || is_trail_ws(buf[j]))) {
                if (buf[j] == '\n') { i = j + 1; break; }
                j++;
            }
            if (j < n && buf[j] == '\n') continue;
            if (j >= n) { i = n; }
            break;
        }
        if (i >= n) break;
        if (buf[i] != '@') return -1;
        int64_t name_start = ++i;
        while (i < n && buf[i] != '\n') i++;
        int64_t name_end = i;
        while (name_end > name_start && is_trail_ws(buf[name_end - 1]))
            name_end--;
        if (i < n) i++;
        int64_t line_start = i;  // sequence line (single line per FASTQ)
        while (i < n && buf[i] != '\n') i++;
        int64_t line_end = i;
        while (line_end > line_start && is_trail_ws(buf[line_end - 1]))
            line_end--;
        if (out && line_end > line_start)
            memcpy(out + out_pos, buf + line_start,
                   (size_t)(line_end - line_start));
        int64_t seq_start = out_pos;
        out_pos += line_end - line_start;
        if (i < n) i++;
        if (i >= n || buf[i] != '+') return -1;  // separator line
        while (i < n && buf[i] != '\n') i++;
        if (i < n) i++;
        while (i < n && buf[i] != '\n') i++;  // quality line (skipped)
        if (i < n) i++;
        if (recs) {
            if (nrec >= max_recs) return -1;
            recs[4 * nrec + 0] = name_start;
            recs[4 * nrec + 1] = name_end - name_start;
            recs[4 * nrec + 2] = seq_start;
            recs[4 * nrec + 3] = out_pos - seq_start;
        }
        nrec++;
    }
    return nrec;
}

}  // extern "C"
