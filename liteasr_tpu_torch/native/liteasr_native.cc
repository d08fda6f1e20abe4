// Native host-side loops of liteasr_tpu_torch: a copy of
// liteasr_tpu/native/liteasr_native.cc (the port imports nothing of the JAX
// package).
//
// The reference framework keeps these loops in pure Python
// (liteasr/utils/score.py:4-22 levenshtein; liteasr/utils/kaldiio/matio.py
// ark parsing). The device does the math, but the host still scores whole
// test sets and reads feature matrices on the data path: these are the C++
// equivalents, exposed through a plain C ABI for ctypes.
//
// liteasr_tpu_torch/native/__init__.py builds it with g++ at first use into
// build/liteasr_tpu_torch/ (g++ -O3 -std=c++17 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Levenshtein distance over uint32 code points (unicode-safe).
int levenshtein_u32(const uint32_t* a, int n, const uint32_t* b, int m) {
    if (n > m) {
        std::swap(a, b);
        std::swap(n, m);
    }
    std::vector<int> curr(n + 1);
    std::vector<int> prev(n + 1);
    for (int j = 0; j <= n; ++j) curr[j] = j;
    for (int i = 1; i <= m; ++i) {
        std::swap(prev, curr);
        curr[0] = i;
        const uint32_t bi = b[i - 1];
        for (int j = 1; j <= n; ++j) {
            const int ins = prev[j] + 1;
            const int del = curr[j - 1] + 1;
            const int chg = prev[j - 1] + (a[j - 1] != bi ? 1 : 0);
            curr[j] = std::min(ins, std::min(del, chg));
        }
    }
    return curr[n];
}

// Batched Levenshtein: pairs of (ref, hyp) flattened with offsets.
// refs/hyps: concatenated uint32 sequences; *_off: n_pairs+1 offsets.
// out: per-pair distances.
void levenshtein_batch_u32(const uint32_t* refs, const int64_t* ref_off,
                           const uint32_t* hyps, const int64_t* hyp_off,
                           int n_pairs, int32_t* out) {
    for (int i = 0; i < n_pairs; ++i) {
        out[i] = levenshtein_u32(
            refs + ref_off[i], (int)(ref_off[i + 1] - ref_off[i]),
            hyps + hyp_off[i], (int)(hyp_off[i + 1] - hyp_off[i]));
    }
}

// Read one Kaldi binary float matrix ("\0B" "FM ") at `offset` in `path`
// directly into caller memory `out` (row-major float32, rows*cols floats).
// Returns 0 on success, negative error codes otherwise.
// Caller learns rows/cols via kaldi_fm_shape first.
int kaldi_fm_shape(const char* path, int64_t offset, int32_t* rows,
                   int32_t* cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, (long)offset, SEEK_SET) != 0) { std::fclose(f); return -2; }
    char hdr[2];
    if (std::fread(hdr, 1, 2, f) != 2 || hdr[0] != '\0' || hdr[1] != 'B') {
        std::fclose(f);
        return -3;
    }
    char tok[4] = {0};
    if (std::fread(tok, 1, 3, f) != 3 || tok[0] != 'F' || tok[1] != 'M') {
        std::fclose(f);
        return -4;  // only FM here; python handles DM/CM
    }
    unsigned char sz;
    if (std::fread(&sz, 1, 1, f) != 1 || sz != 4) { std::fclose(f); return -5; }
    if (std::fread(rows, 4, 1, f) != 1) { std::fclose(f); return -6; }
    if (std::fread(&sz, 1, 1, f) != 1 || sz != 4) { std::fclose(f); return -5; }
    if (std::fread(cols, 4, 1, f) != 1) { std::fclose(f); return -6; }
    std::fclose(f);
    return 0;
}

int kaldi_fm_read(const char* path, int64_t offset, float* out,
                  int64_t capacity) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    // skip: \0B (2) + "FM " (3) + \4 rows (5) + \4 cols (5)
    if (std::fseek(f, (long)(offset + 2 + 3), SEEK_SET) != 0) {
        std::fclose(f);
        return -2;
    }
    unsigned char sz;
    int32_t rows = 0, cols = 0;
    if (std::fread(&sz, 1, 1, f) != 1 || std::fread(&rows, 4, 1, f) != 1 ||
        std::fread(&sz, 1, 1, f) != 1 || std::fread(&cols, 4, 1, f) != 1) {
        std::fclose(f);
        return -6;
    }
    const int64_t count = (int64_t)rows * cols;
    if (count > capacity) { std::fclose(f); return -7; }
    if ((int64_t)std::fread(out, 4, count, f) != count) {
        std::fclose(f);
        return -8;
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
