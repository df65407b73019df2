// Native host-side hot loops for doppelspeller.
//
// The reference gets its host performance from numba-JIT'd kernels; this
// build keeps all *device* math in JAX but the host still has to normalize
// millions of titles and build the packed trigram index.  These are the C++ equivalents of:
//   * transform_title        (reference common.py:20-47)
//   * per-title unique trigram extraction + df counting + bit-packing
//     (reference match_maker.py:91-178, scipy lil_matrix build)
//
// Exposed with a plain C ABI and loaded via ctypes (no pybind11 in the
// image).  Compiled on first import by doppelspeller/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------- transform
//
// In:  UTF-8 bytes of an already NFD-normalized string (Python does the NFD;
//      CPython's unicodedata is C and fast).  Bytes >= 0x80 are dropped —
//      identical to .encode('ascii', 'ignore').
// Out: transformed text (lower-case [a-z0-9 ]), its length, and the uint8
//      char-code row (pad 0, ' '=1, 'a'..'z'=2..27, '0'..'9'=28..37).
// Returns 0 on success, 1 if the title needs the Python fallback (contains
// exotic whitespace the reference's regexes treat specially).
int transform_title_c(const uint8_t* in, int64_t in_len,
                      char* out_text, int32_t* out_len,
                      uint8_t* out_enc, int32_t max_chars, int32_t n_grams) {
    // pass 1: ascii-ignore, lower, '-'->' ', keep [a-z0-9 ]
    char buf[4096];
    int m = 0;
    for (int64_t i = 0; i < in_len && m < (int)sizeof(buf); ++i) {
        uint8_t c = in[i];
        if (c >= 0x80) continue;            // ascii-ignore
        // whitespace → space (see text.py): python's str-mode \s also
        // matches the separator controls \x1c-\x1f
        if (c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f' ||
            (c >= 0x1c && c <= 0x1f))
            c = ' ';
        if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
        if (c == '-') c = ' ';
        if ((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == ' ')
            buf[m++] = (char)c;
    }
    // collapse spaces + strip
    char buf2[4096];
    int k = 0;
    bool prev_space = true;                 // leading spaces dropped
    for (int i = 0; i < m; ++i) {
        if (buf[i] == ' ') {
            if (prev_space) continue;
            prev_space = true;
            buf2[k++] = ' ';
        } else {
            prev_space = false;
            buf2[k++] = buf[i];
        }
    }
    while (k > 0 && buf2[k - 1] == ' ') --k;   // rstrip
    int n_chars = k;
    // truncate + re-strip (reference common.py:32)
    if (k > max_chars) {
        k = max_chars;
        while (k > 0 && buf2[k - 1] == ' ') --k;
    }
    // left-pad with '0' to n_grams chars when the PRE-truncation length was
    // short (reference common.py:34-38)
    if (n_chars < n_grams) {
        int pad = n_grams - k;
        std::memmove(buf2 + pad, buf2, k);
        for (int i = 0; i < pad; ++i) buf2[i] = '0';
        k = n_grams;
    }
    std::memcpy(out_text, buf2, k);
    *out_len = k;
    // encode
    for (int i = 0; i < k && i < max_chars; ++i) {
        char c = buf2[i];
        uint8_t code;
        if (c == ' ') code = 1;
        else if (c >= 'a' && c <= 'z') code = 2 + (c - 'a');
        else code = 28 + (c - '0');
        out_enc[i] = code;
    }
    for (int i = k; i < max_chars; ++i) out_enc[i] = 0;
    return 0;
}

// batch transform: concatenated UTF-8 input with offsets
// out_text is n * (max_chars) bytes, out_flags marks python-fallback rows
void transform_titles_c(const uint8_t* data, const int64_t* offsets, int64_t n,
                        char* out_text, int32_t* out_lens, uint8_t* out_enc,
                        uint8_t* out_flags, int32_t max_chars, int32_t n_grams) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* start = data + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        out_flags[i] = (uint8_t)transform_title_c(
            start, len, out_text + i * max_chars, out_lens + i,
            out_enc + i * max_chars, max_chars, n_grams);
    }
}

// --------------------------------------------------------------- index build
//
// From uint8 char-code rows, extract per-title unique trigram ids
// (id = c0*37^2 + c1*37 + c2 over the text alphabet: ' '=0, a..z=1..26,
// 0..9=27..36), set occupancy bits (bit t of row g, little-endian within a
// byte), count document frequency, and emit the flat (title, trigram) list
// for the IDF-sum pass.  Returns total nnz.
static inline int32_t text_code(uint8_t enc) {
    // enc: ' '=1, 'a'..'z'=2..27, '0'..'9'=28..37 → text: 0, 1..26, 27..36
    return (int32_t)enc - 1;
}

int64_t build_index_c(const uint8_t* enc, const int32_t* lens, int64_t n_titles,
                      uint8_t* packed, int64_t packed_row_bytes,
                      int32_t* df, int32_t* flat_ids, int32_t* flat_counts,
                      int32_t max_chars) {
    int64_t nnz = 0;
    int32_t grams[256];
    for (int64_t t = 0; t < n_titles; ++t) {
        const uint8_t* row = enc + t * max_chars;
        int32_t len = lens[t];
        int m = 0;
        for (int32_t i = 0; i + 2 < len; ++i) {
            int32_t id = text_code(row[i]) * 1369 + text_code(row[i + 1]) * 37
                       + text_code(row[i + 2]);
            grams[m++] = id;
        }
        std::sort(grams, grams + m);
        int u = 0;
        for (int i = 0; i < m; ++i)
            if (i == 0 || grams[i] != grams[i - 1]) grams[u++] = grams[i];
        flat_counts[t] = u;
        int64_t byte = t >> 3;
        uint8_t bit = (uint8_t)(1u << (t & 7));
        for (int i = 0; i < u; ++i) {
            int32_t g = grams[i];
            packed[(int64_t)g * packed_row_bytes + byte] |= bit;
            df[g] += 1;
            flat_ids[nnz++] = g;
        }
    }
    return nnz;
}

}  // extern "C"
