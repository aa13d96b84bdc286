// Native host-side PLINK .bed operations.
//
// Equivalent of the reference's C++ data layer: the per-byte
// LUT decode and column statistics of `cusk/src/prep.cpp:15-77` and the
// decode tables of `cusk/include/mps/bed_lut.h`, as a small shared library
// driven from Python via ctypes. These are the host data-loader hot loops
// that feed the device input pipeline; the on-device decode lives in
// cigwas_tpu/ops/decode.py.
//
// Built on first use by cigwas_tpu/native.py (g++ -O3 -shared -fPIC) into
// libbedops-<source hash>.so.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// 2-bit code -> genotype value; code 1 = missing (value slot unused)
const float CODE_VALUE[4] = {2.0f, 2.0f, 1.0f, 0.0f};
const float CODE_VALID[4] = {1.0f, 0.0f, 1.0f, 1.0f};

// 256-entry tables over whole bytes: per byte, 4 decoded values/valids.
struct ByteLut {
    float vals[256][4];
    float valid[256][4];
    uint8_t counts[256][4];  // per-byte genotype counts [g0, g1, g2, missing]
    ByteLut() {
        for (int b = 0; b < 256; ++b) {
            int c0 = 0, c1 = 0, c2 = 0, cm = 0;
            for (int j = 0; j < 4; ++j) {
                int code = (b >> (2 * j)) & 0x3;
                vals[b][j] = CODE_VALUE[code];
                valid[b][j] = CODE_VALID[code];
                switch (code) {
                    case 3: ++c0; break;
                    case 2: ++c1; break;
                    case 0: ++c2; break;
                    default: ++cm; break;
                }
            }
            counts[b][0] = (uint8_t)c0;
            counts[b][1] = (uint8_t)c1;
            counts[b][2] = (uint8_t)c2;
            counts[b][3] = (uint8_t)cm;
        }
    }
};

const ByteLut LUT;

}  // namespace

extern "C" {

// Decode packed bytes into (values, validity) float arrays.
// bytes: (m, bpc) row-major; out arrays: (m, n) row-major.
void bed_decode(
    const uint8_t* bytes,
    int64_t m,
    int64_t bpc,
    int64_t n,
    float* out_vals,
    float* out_valid
) {
    for (int64_t row = 0; row < m; ++row) {
        const uint8_t* src = bytes + row * bpc;
        float* vd = out_vals + row * n;
        float* ok = out_valid + row * n;
        int64_t i = 0;
        for (int64_t b = 0; b < bpc && i < n; ++b) {
            const float* v = LUT.vals[src[b]];
            const float* va = LUT.valid[src[b]];
            for (int j = 0; j < 4 && i < n; ++j, ++i) {
                vd[i] = v[j];
                ok[i] = va[j];
            }
        }
    }
}

// Per-marker mean/std/mode over non-missing genotypes; the prep hot loop
// (`compute_bed_col_stats_no_impute`). Whole-byte count tables process four
// genotypes per lookup; the sample tail is handled per-code.
void bed_col_stats(
    const uint8_t* bytes,
    int64_t m,
    int64_t bpc,
    int64_t n,
    float* means,
    float* stds,
    int32_t* modes
) {
    const int64_t full_bytes = n / 4;
    const int tail = (int)(n % 4);
    for (int64_t row = 0; row < m; ++row) {
        const uint8_t* src = bytes + row * bpc;
        int64_t c[4] = {0, 0, 0, 0};  // g0, g1, g2, missing
        for (int64_t b = 0; b < full_bytes; ++b) {
            const uint8_t* k = LUT.counts[src[b]];
            c[0] += k[0];
            c[1] += k[1];
            c[2] += k[2];
            c[3] += k[3];
        }
        if (tail) {
            uint8_t last = src[full_bytes];
            for (int j = 0; j < tail; ++j) {
                int code = (last >> (2 * j)) & 0x3;
                switch (code) {
                    case 3: ++c[0]; break;
                    case 2: ++c[1]; break;
                    case 0: ++c[2]; break;
                    default: ++c[3]; break;
                }
            }
        }
        int64_t n_valid = c[0] + c[1] + c[2];
        int mode = 0;
        if (c[1] > c[mode]) mode = 1;
        if (c[2] > c[mode]) mode = 2;
        double mean = n_valid ? (double)(c[1] + 2 * c[2]) / (double)n_valid : 0.0;
        // population variance over valid entries from the genotype counts
        double ss = c[0] * mean * mean + c[1] * (1.0 - mean) * (1.0 - mean) +
                    c[2] * (2.0 - mean) * (2.0 - mean);
        double sd = n_valid ? std::sqrt(ss / (double)n_valid) : 0.0;
        means[row] = (float)mean;
        stds[row] = (float)sd;
        modes[row] = mode;
    }
}

// Streamed column-stat pass over a .bed file (skips the 3 magic bytes);
// returns number of markers processed, or -1 on IO error.
int64_t bed_file_col_stats(
    const char* path,
    int64_t n,
    int64_t max_markers,
    float* means,
    float* stds,
    int32_t* modes
) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, 3, SEEK_SET) != 0) {
        std::fclose(f);
        return -1;
    }
    const int64_t bpc = (n + 3) / 4;
    const int64_t batch = 4096;
    uint8_t* buf = new uint8_t[bpc * batch];
    int64_t done = 0;
    while (done < max_markers) {
        int64_t want = batch < (max_markers - done) ? batch : (max_markers - done);
        size_t got = std::fread(buf, (size_t)bpc, (size_t)want, f);
        if (got == 0) break;
        bed_col_stats(
            buf, (int64_t)got, bpc, n, means + done, stds + done, modes + done
        );
        done += (int64_t)got;
        if ((int64_t)got < want) break;
    }
    delete[] buf;
    std::fclose(f);
    return done;
}

}  // extern "C"
