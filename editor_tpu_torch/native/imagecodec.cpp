// Native batch JPEG decode + bicubic resize for the host data loader: the
// PyTorch port's copy of editor_tpu/native/imagecodec.cpp, unchanged below
// this header.
//
// The reference reaches libjpeg through PIL inside torch DataLoader worker
// processes (data/datasets/make_dataloader.py num_workers); here one process
// parallelizes the decode loop with OpenMP threads instead
// (editor_tpu_torch/data/loader.py BatchLoader). Decode each JPEG with
// libjpeg, optionally crop a tile (the wide-JPEG multi-modal layout,
// reference bases.py:21-26), and bicubic-resize (a = -0.5, PIL-style
// clamped+normalized borders) to the model input size. The machine needs no
// PIL for it.
//
// Build: g++ -O3 -fopenmp -shared -fPIC imagecodec.cpp -ljpeg
// Entry: editor_tpu_decode_resize_batch (see signature below).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void on_error(j_common_ptr cinfo) {
    ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
    longjmp(e->jb, 1);
}

// Decode one JPEG file to RGB8. Returns true on success.
bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb,
                 int& w, int& h) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = on_error;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        std::fclose(f);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    w = cinfo.output_width;
    h = cinfo.output_height;
    rgb.resize(static_cast<size_t>(w) * h * 3);
    JSAMPROW rows[32];
    while (cinfo.output_scanline < cinfo.output_height) {
        const int base = cinfo.output_scanline;
        const int n = h - base < 32 ? h - base : 32;
        for (int i = 0; i < n; ++i)
            rows[i] = rgb.data() + static_cast<size_t>(base + i) * w * 3;
        jpeg_read_scanlines(&cinfo, rows, n);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return true;
}

inline double bicubic(double x) {  // a = -0.5 (PIL / Catmull-Rom)
    const double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Precomputed filter taps for one output axis: for each output index,
// a clamped source window [lo, lo+len) and normalized float weights.
struct Taps {
    std::vector<int> lo;
    std::vector<int> len;
    std::vector<float> w;  // [out, max_len] row-major
    int max_len = 0;
};

Taps make_taps(int src_n, int dst_n) {
    const double s = static_cast<double>(src_n) / dst_n;
    const double support = s > 1.0 ? 2.0 * s : 2.0;
    const double inv_f = s > 1.0 ? 1.0 / s : 1.0;
    Taps t;
    t.lo.resize(dst_n);
    t.len.resize(dst_n);
    t.max_len = static_cast<int>(support) * 2 + 2;
    t.w.assign(static_cast<size_t>(dst_n) * t.max_len, 0.0f);
    std::vector<double> wbuf(t.max_len);
    for (int o = 0; o < dst_n; ++o) {
        const double center = (o + 0.5) * s - 0.5;
        int lo = static_cast<int>(std::floor(center - support)) + 1;
        int hi = static_cast<int>(std::floor(center + support));
        double wsum = 0.0;
        const int n = hi - lo + 1;
        for (int i = lo; i <= hi; ++i) {
            double wv = bicubic((i - center) * inv_f);
            wbuf[i - lo] = wv;
            wsum += wv;
        }
        // fold border-clamped taps into the edge weights so the inner loop
        // needs no per-pixel clamp (identical result to index clamping)
        int clo = lo < 0 ? 0 : lo;
        int chi = hi >= src_n ? src_n - 1 : hi;
        t.lo[o] = clo;
        t.len[o] = chi - clo + 1;
        float* wr = t.w.data() + static_cast<size_t>(o) * t.max_len;
        for (int i = lo; i <= hi; ++i) {
            int ci = i < 0 ? 0 : (i >= src_n ? src_n - 1 : i);
            wr[ci - clo] += static_cast<float>(wbuf[i - lo] / wsum);
        }
    }
    return t;
}

// Separable bicubic resize of an interleaved RGB8 region (float math,
// precomputed taps, row-major passes — the per-core hot loop).
void resize_bicubic(const unsigned char* src, int sw, int sh, int x0, int y0,
                    int cw, int ch, unsigned char* dst, int dw, int dh) {
    if (cw == dw && ch == dh) {  // identity: plain (cropped) row copies
        for (int y = 0; y < ch; ++y)
            std::memcpy(dst + static_cast<size_t>(y) * dw * 3,
                        src + (static_cast<size_t>(y0 + y) * sw + x0) * 3,
                        static_cast<size_t>(dw) * 3);
        return;
    }
    const Taps tx = make_taps(cw, dw);
    const Taps ty = make_taps(ch, dh);

    // horizontal pass into a float buffer [ch, dw, 3], row-major
    std::vector<float> tmp(static_cast<size_t>(ch) * dw * 3);
    for (int y = 0; y < ch; ++y) {
        const unsigned char* row =
            src + (static_cast<size_t>(y0 + y) * sw + x0) * 3;
        float* out_row = tmp.data() + static_cast<size_t>(y) * dw * 3;
        for (int ox = 0; ox < dw; ++ox) {
            const float* wr = tx.w.data()
                + static_cast<size_t>(ox) * tx.max_len;
            const unsigned char* px = row
                + static_cast<size_t>(tx.lo[ox]) * 3;
            float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
            for (int i = 0; i < tx.len[ox]; ++i, px += 3) {
                const float wv = wr[i];
                a0 += wv * px[0];
                a1 += wv * px[1];
                a2 += wv * px[2];
            }
            out_row[ox * 3 + 0] = a0;
            out_row[ox * 3 + 1] = a1;
            out_row[ox * 3 + 2] = a2;
        }
    }
    // vertical pass, output-row-major (contiguous reads of tmp rows)
    for (int oy = 0; oy < dh; ++oy) {
        const float* wr = ty.w.data() + static_cast<size_t>(oy) * ty.max_len;
        unsigned char* out_row = dst + static_cast<size_t>(oy) * dw * 3;
        const int n = ty.len[oy];
        const float* base = tmp.data()
            + static_cast<size_t>(ty.lo[oy]) * dw * 3;
        for (int x3 = 0; x3 < dw * 3; ++x3) {
            float acc = 0.0f;
            const float* px = base + x3;
            for (int i = 0; i < n; ++i, px += static_cast<size_t>(dw) * 3)
                acc += wr[i] * *px;
            out_row[x3] = static_cast<unsigned char>(
                acc < 0.0f ? 0 : (acc > 255.0f ? 255
                                  : static_cast<int>(acc + 0.5f)));
        }
    }
}

}  // namespace

extern "C" {

// Decode n JPEGs, crop [crop_x0[i], crop_x0[i]+crop_w) x [0, crop_h)
// (crop_w <= 0: whole image), bicubic-resize to (out_h, out_w) and write
// into out[n, out_h, out_w, 3] u8. Returns the number of FAILED items.
int editor_tpu_decode_resize_batch(const char** paths, int n,
                                   const int* crop_x0, int crop_w,
                                   int crop_h, int out_h, int out_w,
                                   unsigned char* out) {
    int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
    for (int i = 0; i < n; ++i) {
        std::vector<unsigned char> rgb;
        int w = 0, h = 0;
        if (!decode_jpeg(paths[i], rgb, w, h)) {
            ++failures;
            continue;
        }
        int x0 = 0, cw = w, ch = h;
        if (crop_w > 0) {
            x0 = crop_x0 ? crop_x0[i] : 0;
            cw = crop_w;
            ch = crop_h > 0 ? crop_h : h;
            if (x0 < 0 || x0 + cw > w || ch > h) {
                ++failures;
                continue;
            }
        }
        resize_bicubic(rgb.data(), w, h, x0, 0, cw, ch,
                       out + static_cast<size_t>(i) * out_h * out_w * 3,
                       out_w, out_h);
    }
    return failures;
}

// Wide-JPEG tiling: decode each of n_imgs JPEGs ONCE and emit k crops per
// image ([crop_x0[i*k+j], +crop_w) x [0, crop_h)), bicubic-resized into
// out[n_imgs*k, out_h, out_w, 3]. Avoids the k-fold re-decode the per-crop
// entry above would cost for multi-modal tiles (reference bases.py:21-26
// crops one decoded PIL image per modality). Returns FAILED output count.
int editor_tpu_decode_multicrop_batch(const char** paths, int n_imgs, int k,
                                      const int* crop_x0, int crop_w,
                                      int crop_h, int out_h, int out_w,
                                      unsigned char* out) {
    int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
    for (int i = 0; i < n_imgs; ++i) {
        std::vector<unsigned char> rgb;
        int w = 0, h = 0;
        if (!decode_jpeg(paths[i], rgb, w, h)) {
            failures += k;
            continue;
        }
        const int ch = crop_h > 0 ? crop_h : h;
        for (int j = 0; j < k; ++j) {
            const int x0 = crop_x0[i * k + j];
            if (x0 < 0 || x0 + crop_w > w || ch > h) {
                ++failures;
                continue;
            }
            resize_bicubic(rgb.data(), w, h, x0, 0, crop_w, ch,
                           out + static_cast<size_t>(i * k + j) * out_h *
                                     out_w * 3,
                           out_w, out_h);
        }
    }
    return failures;
}

}  // extern "C"
