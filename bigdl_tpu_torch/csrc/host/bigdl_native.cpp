// Native host-side runtime kernels of bigdl_tpu_torch: a copy of the JAX
// package's native/bigdl_native.cpp, kept in step with it so both packages'
// host helpers give the same bits.  Built with g++ (no nvcc) into
// build/bigdl_tpu_torch/host/ by bigdl_tpu_torch/native.py at first use.
//
// The reference ships a native kernel library (native/mkl/src/main/c/jni/
// mkl.c, 643 LoC: JNI stubs over Intel MKL BLAS/VML) because its host CPUs
// do the tensor math.  On TPU the tensor math lowers to XLA/Pallas, so the
// native layer moves to where the host still does real work:
//
//   * the fp16 wire codec (parameters/FP16CompressedTensor.scala:173-266)
//     for host-side checkpoint/wire compression,
//   * MT19937 (utils/RandomGenerator.scala:24-266) for deterministic
//     host-side preprocessing draws, bit-compatible with the Python
//     class in bigdl_tpu_torch/utils/random_generator.py,
//   * the image-ingest hot loops (dataset/image/*.scala: bytes->BGR
//     decode-normalize, crop, flip, bilinear resize, per-channel
//     normalize, HWC->CHW batch packing) that feed the device.
//
// Exposed as a plain C ABI consumed via ctypes (bigdl_tpu_torch/native.py);
// every entry point is pure (or operates on an opaque handle), so ctypes'
// GIL release gives real parallelism to the multi-worker batcher.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>

extern "C" {

// ---------------------------------------------------------------------------
// fp16 wire codec — truncation to the top 16 bits of the IEEE754 float
// (the reference's toFP16/fromFP16), i.e. bfloat16 truncation.
// ---------------------------------------------------------------------------

void bn_fp16_compress(const float* src, int64_t n, uint16_t* dst) {
    for (int64_t i = 0; i < n; ++i) {
        uint32_t u;
        std::memcpy(&u, src + i, 4);
        dst[i] = (uint16_t)(u >> 16);
    }
}

void bn_fp16_decompress(const uint16_t* src, int64_t n, float* dst) {
    for (int64_t i = 0; i < n; ++i) {
        uint32_t u = ((uint32_t)src[i]) << 16;
        std::memcpy(dst + i, &u, 4);
    }
}

// FP16CompressedTensor.add semantics: decompress both, add, re-truncate.
void bn_fp16_add(const uint16_t* a, const uint16_t* b, int64_t n,
                 uint16_t* dst) {
    for (int64_t i = 0; i < n; ++i) {
        uint32_t ua = ((uint32_t)a[i]) << 16;
        uint32_t ub = ((uint32_t)b[i]) << 16;
        float fa, fb;
        std::memcpy(&fa, &ua, 4);
        std::memcpy(&fb, &ub, 4);
        float s = fa + fb;
        uint32_t us;
        std::memcpy(&us, &s, 4);
        dst[i] = (uint16_t)(us >> 16);
    }
}

// ---------------------------------------------------------------------------
// MT19937 with Torch7 seeding/tempering — bit-compatible with
// bigdl_tpu_torch.utils.random_generator.RandomGenerator (same stream, same
// Box-Muller pair caching), so the Python class can delegate wholesale.
// ---------------------------------------------------------------------------

namespace {
constexpr int MT_N = 624;
constexpr int MT_M = 397;
constexpr uint32_t MATRIX_A = 0x9908B0DFu;
constexpr uint32_t UMASK = 0x80000000u;
constexpr uint32_t LMASK = 0x7FFFFFFFu;

struct BnMT {
    uint32_t s[MT_N];
    int32_t next;
    int32_t left;
    double nx, ny, nrho;   // Box-Muller pair cache
    int32_t nvalid;
    uint64_t seed;
};

void mt_reload(BnMT* m) {
    uint32_t ns[MT_N];
    for (int i = 0; i < MT_N; ++i) {
        uint32_t nxt = m->s[(i + 1) % MT_N];
        uint32_t mixed = (m->s[i] & UMASK) | (nxt & LMASK);
        uint32_t tw = (mixed >> 1) ^ ((nxt & 1u) ? MATRIX_A : 0u);
        ns[i] = m->s[(i + MT_M) % MT_N] ^ tw;
    }
    std::memcpy(m->s, ns, sizeof(ns));
    m->left = MT_N;
    m->next = 0;
}

inline uint32_t mt_next(BnMT* m) {
    if (--m->left == 0) mt_reload(m);
    uint32_t y = m->s[m->next++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9D2C5680u;
    y ^= (y << 15) & 0xEFC60000u;
    y ^= y >> 18;
    return y;
}

inline double mt_uniform01(BnMT* m) {
    return mt_next(m) * (1.0 / 4294967296.0);
}
}  // namespace

void* bn_mt_new(uint64_t seed) {
    BnMT* m = new BnMT();
    m->seed = seed;
    m->s[0] = (uint32_t)(seed & 0xFFFFFFFFu);
    for (int i = 1; i < MT_N; ++i)
        m->s[i] = 1812433253u * (m->s[i - 1] ^ (m->s[i - 1] >> 30)) + i;
    m->next = 0;
    m->left = 1;
    m->nx = m->ny = m->nrho = 0.0;
    m->nvalid = 0;
    return m;
}

void bn_mt_free(void* h) { delete (BnMT*)h; }

void bn_mt_set_seed(void* h, uint64_t seed) {
    BnMT* m = (BnMT*)h;
    BnMT* fresh = (BnMT*)bn_mt_new(seed);
    *m = *fresh;
    delete fresh;
}

uint64_t bn_mt_get_seed(void* h) { return ((BnMT*)h)->seed; }

// State import/export for clone()/copy() parity with the Python class.
void bn_mt_get_state(void* h, uint32_t* s624, int64_t* imeta, double* dmeta) {
    BnMT* m = (BnMT*)h;
    std::memcpy(s624, m->s, sizeof(m->s));
    imeta[0] = m->next;
    imeta[1] = m->left;
    imeta[2] = m->nvalid;
    imeta[3] = (int64_t)m->seed;
    dmeta[0] = m->nx;
    dmeta[1] = m->ny;
    dmeta[2] = m->nrho;
}

void bn_mt_set_state(void* h, const uint32_t* s624, const int64_t* imeta,
                     const double* dmeta) {
    BnMT* m = (BnMT*)h;
    std::memcpy(m->s, s624, sizeof(m->s));
    m->next = (int32_t)imeta[0];
    m->left = (int32_t)imeta[1];
    m->nvalid = (int32_t)imeta[2];
    m->seed = (uint64_t)imeta[3];
    m->nx = dmeta[0];
    m->ny = dmeta[1];
    m->nrho = dmeta[2];
}

uint32_t bn_mt_random(void* h) { return mt_next((BnMT*)h); }

double bn_mt_uniform(void* h, double a, double b) {
    return mt_uniform01((BnMT*)h) * (b - a) + a;
}

double bn_mt_normal(void* h, double mean, double stdv) {
    BnMT* m = (BnMT*)h;
    if (!m->nvalid) {
        m->nx = mt_uniform01(m);
        m->ny = mt_uniform01(m);
        m->nrho = std::sqrt(-2.0 * std::log(1.0 - m->ny));
        m->nvalid = 1;
        return m->nrho * std::cos(2.0 * M_PI * m->nx) * stdv + mean;
    }
    m->nvalid = 0;
    return m->nrho * std::sin(2.0 * M_PI * m->nx) * stdv + mean;
}

double bn_mt_exponential(void* h, double lam) {
    return -1.0 / lam * std::log(1.0 - mt_uniform01((BnMT*)h));
}

double bn_mt_cauchy(void* h, double median, double sigma) {
    return median + sigma * std::tan(M_PI * (mt_uniform01((BnMT*)h) - 0.5));
}

int64_t bn_mt_geometric(void* h, double p) {
    return (int64_t)(std::log(1.0 - mt_uniform01((BnMT*)h)) / std::log(p)
                     + 1.0);
}

int32_t bn_mt_bernoulli(void* h, double p) {
    return mt_uniform01((BnMT*)h) <= p ? 1 : 0;
}

void bn_mt_uniform_array(void* h, double a, double b, int64_t n,
                         double* out) {
    BnMT* m = (BnMT*)h;
    for (int64_t i = 0; i < n; ++i)
        out[i] = mt_uniform01(m) * (b - a) + a;
}

void bn_mt_normal_array(void* h, double mean, double stdv, int64_t n,
                        double* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = bn_mt_normal(h, mean, stdv);
}

// Fisher-Yates permutation indices, bit-compatible with
// RandomGenerator.shuffle (j = int(uniform(0, n-i)) + i, swap).
void bn_mt_shuffle_indices(void* h, int64_t n, int64_t* perm) {
    BnMT* m = (BnMT*)h;
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    for (int64_t i = 0; i < n; ++i) {
        int64_t j = (int64_t)(mt_uniform01(m) * (double)(n - i)) + i;
        int64_t t = perm[i];
        perm[i] = perm[j];
        perm[j] = t;
    }
}

// ---------------------------------------------------------------------------
// Image-ingest kernels (float32 HWC, BGR channel order as in
// dataset/image.py).  These are the host hot loops of the seq-file /
// folder ImageNet pipelines (BytesToBGRImg -> crop -> flip -> normalize
// -> HWC->CHW batch pack).
// ---------------------------------------------------------------------------

// uint8 planar CHW (c planes of h*w, the CIFAR/seq-file layout) ->
// float32 HWC scaled by 1/norm.
void bn_bytes_chw_to_hwc(const uint8_t* src, int64_t c, int64_t h, int64_t w,
                         float norm, float* dst) {
    // True division (not multiply-by-reciprocal) to stay bit-identical
    // with the numpy fallback path.
    const int64_t plane = h * w;
    for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x) {
            float* px = dst + (y * w + x) * c;
            const int64_t off = y * w + x;
            for (int64_t ch = 0; ch < c; ++ch)
                px[ch] = (float)src[ch * plane + off] / norm;
        }
}

// Crop a h*w*c HWC image to [y0:y0+ch, x0:x0+cw].
void bn_crop(const float* src, int64_t h, int64_t w, int64_t c,
             int64_t y0, int64_t x0, int64_t ch, int64_t cw, float* dst) {
    (void)h;
    for (int64_t y = 0; y < ch; ++y)
        std::memcpy(dst + y * cw * c,
                    src + ((y0 + y) * w + x0) * c,
                    (size_t)(cw * c) * sizeof(float));
}

// Horizontal flip, HWC.
void bn_hflip(const float* src, int64_t h, int64_t w, int64_t c, float* dst) {
    for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x)
            std::memcpy(dst + (y * w + x) * c,
                        src + (y * w + (w - 1 - x)) * c,
                        (size_t)c * sizeof(float));
}

// In-place per-channel (x - mean) / std over an HWC image.
void bn_normalize(float* img, int64_t npix, int64_t c,
                  const float* mean, const float* std_) {
    for (int64_t i = 0; i < npix; ++i) {
        float* px = img + i * c;
        for (int64_t ch = 0; ch < c; ++ch)
            px[ch] = (px[ch] - mean[ch]) / std_[ch];
    }
}

// Bilinear resize, HWC (align_corners=false convention, matching
// PIL/awt-style sampling closely enough for ingest parity).
void bn_resize_bilinear(const float* src, int64_t sh, int64_t sw, int64_t c,
                        float* dst, int64_t dh, int64_t dw) {
    const double sy = (double)sh / (double)dh;
    const double sx = (double)sw / (double)dw;
    for (int64_t y = 0; y < dh; ++y) {
        double fy = ((double)y + 0.5) * sy - 0.5;
        if (fy < 0) fy = 0;
        int64_t y0 = (int64_t)fy;
        if (y0 > sh - 1) y0 = sh - 1;
        int64_t y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
        double wy = fy - (double)y0;
        for (int64_t x = 0; x < dw; ++x) {
            double fx = ((double)x + 0.5) * sx - 0.5;
            if (fx < 0) fx = 0;
            int64_t x0 = (int64_t)fx;
            if (x0 > sw - 1) x0 = sw - 1;
            int64_t x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
            double wx = fx - (double)x0;
            const float* p00 = src + (y0 * sw + x0) * c;
            const float* p01 = src + (y0 * sw + x1) * c;
            const float* p10 = src + (y1 * sw + x0) * c;
            const float* p11 = src + (y1 * sw + x1) * c;
            float* out = dst + (y * dw + x) * c;
            for (int64_t ch = 0; ch < c; ++ch) {
                double top = p00[ch] * (1 - wx) + p01[ch] * wx;
                double bot = p10[ch] * (1 - wx) + p11[ch] * wx;
                out[ch] = (float)(top * (1 - wy) + bot * wy);
            }
        }
    }
}

// Fused batch-slot pack: HWC float -> CHW slot of an NCHW batch buffer,
// with optional BGR->RGB channel reversal and per-channel normalize.
// This is one image's share of BGRImgToBatch/MTLabeledBGRImgToBatch.
void bn_pack_chw(const float* src, int64_t h, int64_t w, int64_t c,
                 int32_t to_rgb, const float* mean, const float* std_,
                 float* dst) {
    const int64_t plane = h * w;
    for (int64_t ch = 0; ch < c; ++ch) {
        const int64_t sc = to_rgb ? (c - 1 - ch) : ch;
        const float m = mean ? mean[sc] : 0.0f;
        const float s = std_ ? std_[sc] : 1.0f;
        float* out = dst + ch * plane;
        const float inv = 1.0f / s;
        for (int64_t i = 0; i < plane; ++i)
            out[i] = (src[i * c + sc] - m) * inv;
    }
}

// ---------------------------------------------------------------------------
// Packed record-file (BTSF) scanner — the native half of
// dataset/seqfile.py's reader (the Hadoop-SequenceFile ingest analogue,
// dataset/image/LocalSeqFileToBytes.scala).  One buffered pass computes
// every record's key/value offset+length; Python then reads the file once
// and slices, instead of paying per-record struct.unpack/read calls.
// ---------------------------------------------------------------------------

static const unsigned char BTSF_MAGIC[5] = {'B', 'T', 'S', 'F', 0x01};

static inline uint32_t be32(const unsigned char* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// Scan up to max_records records.  Fills (key_off, key_len, val_off,
// val_len) per record (offsets from file start).  Returns the record
// count, or -3 if the file cannot be opened, -1 on bad magic, -2 on a
// truncated record.  Call with max_records = 0 to count only.
int64_t bn_seqfile_scan(const char* path, int64_t max_records,
                        int64_t* key_off, int64_t* key_len,
                        int64_t* val_off, int64_t* val_len) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -3;
    unsigned char magic[5];
    if (std::fread(magic, 1, 5, f) != 5 ||
        std::memcmp(magic, BTSF_MAGIC, 5) != 0) {
        std::fclose(f);
        return -1;
    }
    int64_t n = 0;
    int64_t pos = 5;
    unsigned char head[8];
    for (;;) {
        size_t got = std::fread(head, 1, 8, f);
        if (got == 0) break;
        if (got < 8) { std::fclose(f); return -2; }
        const int64_t klen = (int64_t)be32(head);
        const int64_t vlen = (int64_t)be32(head + 4);
        if (n < max_records) {
            key_off[n] = pos + 8;
            key_len[n] = klen;
            val_off[n] = pos + 8 + klen;
            val_len[n] = vlen;
        }
        if (std::fseek(f, (long)(klen + vlen), SEEK_CUR) != 0) {
            std::fclose(f);
            return -2;
        }
        pos += 8 + klen + vlen;
        ++n;
    }
    // fseek past EOF succeeds; verify the last record really fit
    if (std::fseek(f, 0, SEEK_END) == 0 && std::ftell(f) < pos) {
        std::fclose(f);
        return -2;
    }
    std::fclose(f);
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) — the ingest path's hot loop.  The reference
// decodes via java awt ImageIO (LocalImgReader.scala); the Python-side
// fallback is PIL.  Compiled in only when the build found jpeglib
// (-DBIGDL_WITH_JPEG -ljpeg; bigdl_tpu_torch/native.py tries that first and
// falls back to a jpeg-less build, where bn_has_jpeg() reports 0).
//
// Scaled decode: libjpeg can downscale by 1/2, 1/4, 1/8 DURING decode
// (skipping inverse-DCT work), which is where the big ingest win is —
// ImageNet-sized sources resized to shorter-edge 256 decode ~4x less
// pixel work at denom 2.  bn_jpeg_probe picks the largest denominator
// keeping the shorter edge >= min_short.
// ---------------------------------------------------------------------------

#ifdef BIGDL_WITH_JPEG
#include <jpeglib.h>
#include <csetjmp>

namespace {
struct bn_jpeg_err {
    struct jpeg_error_mgr pub;
    jmp_buf jb;
};

void bn_jpeg_error_exit(j_common_ptr cinfo) {
    // default handler calls exit(); longjmp back to the caller instead
    bn_jpeg_err* e = (bn_jpeg_err*)cinfo->err;
    longjmp(e->jb, 1);
}
}  // namespace

extern "C" int bn_has_jpeg(void) { return 1; }

// Parse the header; pick the largest DCT scale denominator d in
// {8,4,2,1} with min(h,w)/d >= min_short (min_short<=0 -> d=1).
// Writes the SCALED output dims into hw[0]=h, hw[1]=w and the ORIGINAL
// dims into hw[2]=h, hw[3]=w (the resize target must be computed from
// the original geometry or the longer edge can land one pixel off).
// Returns the denominator, or -1 on parse error / unsupported color
// space.
extern "C" int64_t bn_jpeg_probe(const uint8_t* data, int64_t len,
                                 int64_t min_short, int64_t* hw) {
    struct jpeg_decompress_struct cinfo;
    bn_jpeg_err jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = bn_jpeg_error_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, (const unsigned char*)data, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    int64_t h = cinfo.image_height, w = cinfo.image_width;
    int64_t shorter = h < w ? h : w;
    int64_t denom = 1;
    if (min_short > 0) {
        for (int64_t d = 8; d >= 2; d /= 2) {
            if (shorter / d >= min_short) { denom = d; break; }
        }
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned)denom;
    cinfo.out_color_space = JCS_RGB;
    jpeg_calc_output_dimensions(&cinfo);
    if (cinfo.out_color_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    hw[0] = cinfo.output_height;
    hw[1] = cinfo.output_width;
    hw[2] = h;
    hw[3] = w;
    jpeg_destroy_decompress(&cinfo);
    return denom;
}

// Decode at the probed denominator into an RGB u8 HWC buffer of
// hw[0]*hw[1]*3 bytes (from bn_jpeg_probe).  Returns 0, or -1 on error.
extern "C" int bn_jpeg_decode(const uint8_t* data, int64_t len,
                              int64_t denom, uint8_t* out,
                              int64_t out_h, int64_t out_w) {
    struct jpeg_decompress_struct cinfo;
    bn_jpeg_err jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = bn_jpeg_error_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, (const unsigned char*)data, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned)denom;
    cinfo.out_color_space = JCS_RGB;
    // training-ingest speed knobs (PIL uses ISLOW + fancy upsampling):
    // the fast integer DCT and plain chroma upsampling cost ~1 LSB of
    // quality, far below augmentation noise
    cinfo.dct_method = JDCT_IFAST;
    cinfo.do_fancy_upsampling = FALSE;
    jpeg_start_decompress(&cinfo);
    if (cinfo.output_components != 3 ||
        (int64_t)cinfo.output_height != out_h ||
        (int64_t)cinfo.output_width != out_w) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    const int64_t stride = out_w * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = (JSAMPROW)(out + (int64_t)cinfo.output_scanline *
                                  stride);
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    // premature EOF / corrupt scan data are WARNINGS in libjpeg (it
    // gray-fills the remaining rows and reports success) — fail loudly
    // instead so the caller falls back to PIL, which raises on
    // truncated files like the pre-native pipeline did
    long warnings = cinfo.err->num_warnings;
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return warnings > 0 ? -1 : 0;
}

#else  // !BIGDL_WITH_JPEG

extern "C" int bn_has_jpeg(void) { return 0; }
extern "C" int64_t bn_jpeg_probe(const uint8_t*, int64_t, int64_t,
                                 int64_t*) { return -1; }
extern "C" int bn_jpeg_decode(const uint8_t*, int64_t, int64_t, uint8_t*,
                              int64_t, int64_t) { return -1; }

#endif  // BIGDL_WITH_JPEG

// Fused u8-RGB -> resized f32-BGR/normalized: one pass over the decoded
// pixels instead of Python's astype + resize + ::-1 flip + divide chain
// (each a full-image memory pass).  src is (sh, sw, 3) u8 RGB from
// bn_jpeg_decode; dst is (dh, dw, 3) f32 BGR, each value / norm.
extern "C" void bn_u8rgb_resize_bgr(const uint8_t* src, int64_t sh,
                                    int64_t sw, float* dst, int64_t dh,
                                    int64_t dw, float inv_norm) {
    if (sh == dh && sw == dw) {
        for (int64_t i = 0; i < dh * dw; ++i) {
            const uint8_t* p = src + i * 3;
            float* q = dst + i * 3;
            q[0] = (float)p[2] * inv_norm;
            q[1] = (float)p[1] * inv_norm;
            q[2] = (float)p[0] * inv_norm;
        }
        return;
    }
    const double sy = (double)sh / (double)dh;
    const double sx = (double)sw / (double)dw;
    // precompute the column sample/weight tables once (they repeat for
    // every row) — the per-pixel index math dominated the naive loop
    int32_t* x0s = new int32_t[dw];
    int32_t* x1s = new int32_t[dw];
    float* wxs = new float[dw];
    for (int64_t x = 0; x < dw; ++x) {
        double fx = ((double)x + 0.5) * sx - 0.5;
        if (fx < 0) fx = 0;
        int64_t x0 = (int64_t)fx;
        if (x0 > sw - 1) x0 = sw - 1;
        x0s[x] = (int32_t)(x0 * 3);
        x1s[x] = (int32_t)((x0 + 1 < sw ? x0 + 1 : sw - 1) * 3);
        wxs[x] = (float)(fx - (double)x0);
    }
    for (int64_t y = 0; y < dh; ++y) {
        double fy = ((double)y + 0.5) * sy - 0.5;
        if (fy < 0) fy = 0;
        int64_t y0 = (int64_t)fy;
        if (y0 > sh - 1) y0 = sh - 1;
        int64_t y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
        const float wy = (float)(fy - (double)y0);
        const uint8_t* r0 = src + y0 * sw * 3;
        const uint8_t* r1 = src + y1 * sw * 3;
        float* q = dst + y * dw * 3;
        for (int64_t x = 0; x < dw; ++x) {
            const int32_t a = x0s[x], b = x1s[x];
            const float wx = wxs[x];
            const uint8_t* p00 = r0 + a;
            const uint8_t* p01 = r0 + b;
            const uint8_t* p10 = r1 + a;
            const uint8_t* p11 = r1 + b;
            for (int ch = 0; ch < 3; ++ch) {
                float top = (float)p00[ch] +
                            ((float)p01[ch] - (float)p00[ch]) * wx;
                float bot = (float)p10[ch] +
                            ((float)p11[ch] - (float)p10[ch]) * wx;
                q[2 - ch] = (top + (bot - top) * wy) * inv_norm;
            }
            q += 3;
        }
    }
    delete[] x0s;
    delete[] x1s;
    delete[] wxs;
}

