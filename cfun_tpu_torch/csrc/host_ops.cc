// Host-side kernels of the serving path: the mold (raw volume to the
// molded device layout, optionally z-scored and quantized to the int8
// wire) and the unmold (the mask crop pasted back at the original
// resolution).  OpenMP C++ with a plain C interface, loaded with ctypes by
// cfun_tpu_torch/native.py and built with g++ by cfun_tpu_torch/_build.py
// (host_library; -O3 -march=native -fopenmp -shared -fPIC).
//
// The functions and their arithmetic are those of the JAX package's host
// library (cfun_tpu/native.py), those of heart serving:
//
//   mold_resize_f32: [H,W,D] raw volume -> [Dt,Ht,Wt] molded volume
//     (trilinear, half-pixel convention == skimage order=1 w/o AA),
//     emitting directly in device layout and optionally z-scoring in the
//     same pass.
//   mold_resize_q8: the same, z-scored and quantized to the int8 wire.
//   volume_stats_f32 + mold_resize_slab_q8: the slab-pipelined int8 mold
//     (stats from a strided sample, then z-slabs resized and quantized
//     one at a time so each can upload while the next resizes).
//   unmold_argmax_f32: [mD,mH,mW,C] mask probabilities -> int16 labels
//     pasted into a [D0,H0,W0] volume inside an integer box, sampling
//     trilinearly at every output voxel and taking the channel argmax
//     in-register.
//   unmold_labels_box_i16: nearest paste of an int8 label crop into a box,
//     writing the whole raw-size volume (zeros outside the box).
//
// and of LiTS serving:
//
//   lits_mold_f32: [H,W,D] raw volume -> [Dt,Ht,Wt] molded volume in
//     [0, 1]: the inverted HU window, a virtual centre-pad and a nearest
//     resize in one pass.
//   lits_mold_slab_q8: z rows of the same, quantized to the int8 wire
//     with a fixed affine (no stats pass), one slab at a time.
//   unmold_nearest_i16: the molded int8 label volume mapped back to the
//     raw [H0,W0,D0] geometry through per-axis nearest index maps.
//
// and of training (the epoch's nearest (H, W) rotation composed into the
// mold's gather, emitted as the train wire):
//
//   heart_train_mold_bf16 / _q8: resize + rotate + z-score to bf16 bits or
//     the int8 wire; heart_train_labels_i32 their label companion.
//   lits_train_mold_bf16 / _q8: the raw-slice rotation composed into the
//     virtual-pad nearest resize, HU window, bf16 bits or the int8 wire;
//     lits_train_labels_i32 their label companion.
//   pad_nearest_i32: the virtual-pad nearest resize of a label volume.
//
// The functions the training feeder calls (mold_resize_f32, lits_mold_f32,
// the train molds, their label companions and pad_nearest_i32) take a last
// argument `threads`: the size of the OpenMP team each of their parallel
// regions runs on, or <= 0 for the default (omp_get_max_threads()).  No
// function sets the process's thread count.  The heart train mold's z-score
// sums are per-row partials added in row order, so its output does not
// depend on the team's size.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// The team size of a region: `threads` where positive, else the default.
inline int team_threads(int threads) {
#if defined(_OPENMP)
  return threads > 0 ? threads : omp_get_max_threads();
#else
  (void)threads;
  return 1;
#endif
}

inline void axis_coords(int n_out, int n_in, float* src, int* i0, int* i1,
                        float* frac) {
  const float scale = static_cast<float>(n_in) / static_cast<float>(n_out);
  for (int i = 0; i < n_out; ++i) {
    float s = (static_cast<float>(i) + 0.5f) * scale - 0.5f;
    s = std::min(std::max(s, 0.0f), static_cast<float>(n_in - 1));
    int lo = static_cast<int>(s);
    i0[i] = lo;
    i1[i] = std::min(lo + 1, n_in - 1);
    frac[i] = s - static_cast<float>(lo);
    src[i] = s;
  }
}

struct AxisMap {
  std::vector<int> i0, i1;
  std::vector<float> f;
  AxisMap(int n_out, int n_in) : i0(n_out), i1(n_out), f(n_out) {
    std::vector<float> s(n_out);
    axis_coords(n_out, n_in, s.data(), i0.data(), i1.data(), f.data());
  }
};

// Tiled trilinear-resize core.  Loop order is y-outer (parallel), x-block,
// x, z-inner: for a fixed (y, x) the 4 source corner columns are loaded
// once and the full output-z range is emitted from them, so each source
// cache line is touched O(1) times instead of once per output z-plane (the
// round-1 z-outer order re-streamed ~4 GB for a 380 MB source).  Values
// are staged in a [z_count, XB] tile so the emit callback writes whole
// contiguous rows.  Interpolation order (z, then x, then y) matches the
// original kernel bit-for-bit.
template <typename Emit>
void resize_tiled(const float* src, int h0, int w0, int d0, int dt, int ht,
                  int wt, int z_start, int z_end, double* out_sum,
                  double* out_sumsq, int threads, Emit emit) {
  const AxisMap zm(dt, d0), ym(ht, h0), xm(wt, w0);
  const int64_t src_h_stride = static_cast<int64_t>(w0) * d0;
  const int zc = z_end - z_start;
  constexpr int XB = 128;
  double sum = 0.0, sumsq = 0.0;

#pragma omp parallel num_threads(team_threads(threads)) \
    reduction(+ : sum, sumsq)
  {
    std::vector<float> tile(static_cast<size_t>(zc) * XB);
#if defined(_OPENMP)
#pragma omp for schedule(static)
#endif
    for (int y = 0; y < ht; ++y) {
      const float fy = ym.f[y];
      const float* r00 = src + ym.i0[y] * src_h_stride;
      const float* r10 = src + ym.i1[y] * src_h_stride;
      for (int xb = 0; xb < wt; xb += XB) {
        const int xn = std::min(XB, wt - xb);
        for (int xi = 0; xi < xn; ++xi) {
          const int x = xb + xi;
          const float fx = xm.f[x];
          const float* p00 = r00 + static_cast<int64_t>(xm.i0[x]) * d0;
          const float* p01 = r00 + static_cast<int64_t>(xm.i1[x]) * d0;
          const float* p10 = r10 + static_cast<int64_t>(xm.i0[x]) * d0;
          const float* p11 = r10 + static_cast<int64_t>(xm.i1[x]) * d0;
          float* col = tile.data() + xi;
          for (int z = z_start; z < z_end; ++z) {
            const int dz0 = zm.i0[z], dz1 = zm.i1[z];
            const float fz = zm.f[z];
            const float c00 = p00[dz0] + fz * (p00[dz1] - p00[dz0]);
            const float c01 = p01[dz0] + fz * (p01[dz1] - p01[dz0]);
            const float c10 = p10[dz0] + fz * (p10[dz1] - p10[dz0]);
            const float c11 = p11[dz0] + fz * (p11[dz1] - p11[dz0]);
            const float c0 = c00 + fx * (c01 - c00);
            const float c1 = c10 + fx * (c11 - c10);
            const float v = c0 + fy * (c1 - c0);
            col[static_cast<size_t>(z - z_start) * XB] = v;
            sum += v;
            sumsq += static_cast<double>(v) * v;
          }
        }
        for (int z = 0; z < zc; ++z)
          emit(z + z_start, y, xb, xn,
               tile.data() + static_cast<size_t>(z) * XB);
      }
    }
  }
  if (out_sum != nullptr) {
    *out_sum = sum;
    *out_sumsq = sumsq;
  }
}

// Per-axis nearest map from output index through *virtually padded* space
// to a raw-source index (-1 where the padded voxel lies outside the
// source).  Same convention as data/resample.py::_axis_indices(order=0).
inline void nearest_pad_axis(int n_out, int n_pad, int n_src, int off,
                             int* idx) {
  const double scale = static_cast<double>(n_pad) / n_out;
  for (int i = 0; i < n_out; ++i) {
    double s = (static_cast<double>(i) + 0.5) * scale - 0.5;
    s = std::min(std::max(s, 0.0), static_cast<double>(n_pad - 1));
    const int p = static_cast<int>(std::floor(s + 0.5)) - off;
    idx[i] = (p >= 0 && p < n_src) ? p : -1;
  }
}

}  // namespace

extern "C" {

// src: [h0, w0, d0] C-contiguous float32 (the reference's [H, W, D] layout).
// dst: [dt, ht, wt] C-contiguous float32 (device [D, H, W] layout).
// normalize != 0: z-score the output in a second pass (mean/std of the
// molded volume, reference model.py:1902-1904).
void mold_resize_f32(const float* src, int h0, int w0, int d0, float* dst,
                     int dt, int ht, int wt, int normalize, int threads) {
  double sum = 0.0, sumsq = 0.0;
  resize_tiled(src, h0, w0, d0, dt, ht, wt, 0, dt, &sum, &sumsq, threads,
               [dst, ht, wt](int z, int y, int xb, int n, const float* row) {
                 std::memcpy(dst + (static_cast<int64_t>(z) * ht + y) * wt +
                                 xb,
                             row, static_cast<size_t>(n) * sizeof(float));
               });

  if (normalize) {
    const int64_t n = static_cast<int64_t>(dt) * ht * wt;
    const double mean = sum / n;
    double var = sumsq / n - mean * mean;
    if (var < 1e-12) var = 1.0;
    const float inv = static_cast<float>(1.0 / std::sqrt(var));
    const float m = static_cast<float>(mean);
#pragma omp parallel for schedule(static) num_threads(team_threads(threads))
    for (int64_t i = 0; i < n; ++i) dst[i] = (dst[i] - m) * inv;
  }
}

// As mold_resize_f32(normalize=1) but additionally emits the z-scored
// volume quantized to int8 (clip +-clip_sigma, scale) -- the inference
// wire format -- in the same pass, so the host never touches the f32
// volume again.
void mold_resize_q8(const float* src, int h0, int w0, int d0, float* tmp,
                    int8_t* dst_q8, int dt, int ht, int wt, float clip_sigma,
                    float scale) {
  mold_resize_f32(src, h0, w0, d0, tmp, dt, ht, wt, 1, 0);
  const int64_t n = static_cast<int64_t>(dt) * ht * wt;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float v = tmp[i];
    v = std::min(std::max(v, -clip_sigma), clip_sigma) * scale;
    dst_q8[i] = static_cast<int8_t>(v);  // trunc, matching numpy astype
  }
}

// probs: [md, mh, mw, c] float32 (channels innermost, device output layout).
// out:   [od, oh, ow] int16, already zero-initialized by the caller.
// box:   z1, y1, x1, z2, y2, x2 integer voxel bounds in the output volume.
// Labels are the trilinear-resampled-probability argmax -- identical to the
// reference's resize-paste-argmax without the [D,H,W,C] intermediate.
void unmold_argmax_f32(const float* probs, int md, int mh, int mw, int c,
                       int16_t* out, int od, int oh, int ow, int z1, int y1,
                       int x1, int z2, int y2, int x2) {
  z1 = std::max(z1, 0); y1 = std::max(y1, 0); x1 = std::max(x1, 0);
  z2 = std::min(z2, od); y2 = std::min(y2, oh); x2 = std::min(x2, ow);
  const int bd = z2 - z1, bh = y2 - y1, bw = x2 - x1;
  if (bd <= 0 || bh <= 0 || bw <= 0) return;

  const int64_t sh = static_cast<int64_t>(mw) * c;    // crop h stride
  const int64_t sd = static_cast<int64_t>(mh) * sh;   // crop d stride

#pragma omp parallel for schedule(static)
  for (int z = 0; z < bd; ++z) {
    float sz = (static_cast<float>(z) + 0.5f) * md / bd - 0.5f;
    sz = std::min(std::max(sz, 0.0f), static_cast<float>(md - 1));
    const int z0 = static_cast<int>(sz);
    const int zz1 = std::min(z0 + 1, md - 1);
    const float fz = sz - z0;
    for (int y = 0; y < bh; ++y) {
      float sy = (static_cast<float>(y) + 0.5f) * mh / bh - 0.5f;
      sy = std::min(std::max(sy, 0.0f), static_cast<float>(mh - 1));
      const int y0 = static_cast<int>(sy);
      const int yy1 = std::min(y0 + 1, mh - 1);
      const float fy = sy - y0;
      int16_t* out_row = out + (static_cast<int64_t>(z + z1) * oh + (y + y1))
                             * ow + x1;
      for (int x = 0; x < bw; ++x) {
        float sx = (static_cast<float>(x) + 0.5f) * mw / bw - 0.5f;
        sx = std::min(std::max(sx, 0.0f), static_cast<float>(mw - 1));
        const int x0 = static_cast<int>(sx);
        const int xx1 = std::min(x0 + 1, mw - 1);
        const float fx = sx - x0;

        const float* p000 = probs + z0 * sd + y0 * sh + x0 * c;
        const float* p001 = probs + z0 * sd + y0 * sh + xx1 * c;
        const float* p010 = probs + z0 * sd + yy1 * sh + x0 * c;
        const float* p011 = probs + z0 * sd + yy1 * sh + xx1 * c;
        const float* p100 = probs + zz1 * sd + y0 * sh + x0 * c;
        const float* p101 = probs + zz1 * sd + y0 * sh + xx1 * c;
        const float* p110 = probs + zz1 * sd + yy1 * sh + x0 * c;
        const float* p111 = probs + zz1 * sd + yy1 * sh + xx1 * c;

        float best = -1e30f;
        int best_c = 0;
        for (int ch = 0; ch < c; ++ch) {
          const float c00 = p000[ch] + fx * (p001[ch] - p000[ch]);
          const float c01 = p010[ch] + fx * (p011[ch] - p010[ch]);
          const float c10 = p100[ch] + fx * (p101[ch] - p100[ch]);
          const float c11 = p110[ch] + fx * (p111[ch] - p110[ch]);
          const float c0 = c00 + fy * (c01 - c00);
          const float c1 = c10 + fy * (c11 - c10);
          const float v = c0 + fz * (c1 - c0);
          if (v > best) { best = v; best_c = ch; }
        }
        out_row[x] = static_cast<int16_t>(best_c);
      }
    }
  }
}

// Mean/std estimate of a raw volume from a strided subsample.  Used to
// pick the int8 quantization grid for the slab-pipelined mold: the device
// re-z-scores (z-scoring is affine-invariant), so these stats only need to
// map the data into int8 range, not match the molded-volume stats --
// sampling error of a few permille is irrelevant against the +-5 sigma
// clip margin.  stride=1 gives the exact pass.
void volume_stats_f32(const float* src, int64_t n, int64_t stride,
                      float* out_mean, float* out_std) {
  if (stride < 1) stride = 1;
  double sum = 0.0, sumsq = 0.0;
  int64_t count = 0;
#pragma omp parallel for schedule(static) reduction(+ : sum, sumsq, count)
  for (int64_t i = 0; i < n; i += stride) {
    const double v = src[i];
    sum += v;
    sumsq += v * v;
    ++count;
  }
  const double mean = sum / static_cast<double>(count);
  double var = sumsq / static_cast<double>(count) - mean * mean;
  if (var < 1e-12) var = 1.0;
  *out_mean = static_cast<float>(mean);
  *out_std = static_cast<float>(std::sqrt(var));
}

// Slab variant of mold_resize_q8: resizes output z rows
// [z_start, z_start + z_count) of the [dt, ht, wt] molded volume and emits
// int8 directly into dst (slab buffer [z_count, ht, wt]) using a caller-
// provided affine (mean / inv_std from volume_stats_f32).  No f32
// intermediate exists, so slabs can stream to the device while later slabs
// are still being resized (the mold<->upload overlap that breaks the
// serial mold -> upload -> compute chain of the reference-shaped pipeline,
// reference model.py:1774-1810 + .cuda() at model.py:1612-1619).
void mold_resize_slab_q8(const float* src, int h0, int w0, int d0,
                         int8_t* dst, int dt, int ht, int wt, int z_start,
                         int z_count, float mean, float inv_std,
                         float clip_sigma, float scale) {
  const int z_end = std::min(z_start + z_count, dt);
  resize_tiled(
      src, h0, w0, d0, dt, ht, wt, z_start, z_end, nullptr, nullptr, 0,
      [dst, ht, wt, z_start, mean, inv_std, clip_sigma, scale](
          int z, int y, int xb, int n, const float* row) {
        int8_t* out =
            dst + (static_cast<int64_t>(z - z_start) * ht + y) * wt + xb;
        for (int i = 0; i < n; ++i) {
          float v = (row[i] - mean) * inv_std;
          v = std::min(std::max(v, -clip_sigma), clip_sigma) * scale;
          out[i] = static_cast<int8_t>(v);  // trunc, matching numpy astype
        }
      });
}

// Nearest box-paste for the heart fast path's int8 label crop
// (inference/pipeline.py::unmold labels branch, reference
// model.py:1856-1858): out[z1+z, y1+y, x1+x] = lab[cz[z], cy[y], cx[x]]
// inside the box and 0 everywhere else, as int16 [D0, H0, W0].  Every
// voxel of the volume is written once, so the caller hands in memory as
// it comes (np.empty): zeroing a 93-190 MB volume first (np.zeros, a
// one-thread memset of a reused heap block) cost more than the paste.
// The index maps come from the caller so the nearest convention is
// exactly data/resample.py::_axis_indices(order=0).
//
// Each thread writes a contiguous range of planes: a plane outside the
// box is zeros; one inside is zero rows around rows of [0, x1) zeros, the
// gathered labels and zeros to W0.  A distinct (cz, cy) source row is
// gathered once; a repeated row or plane is a memcpy of the one this
// thread wrote just before it.
//
// The box must start inside the volume: a clipped box that starts at the
// extent (z1 == d0, y1 == h0 or x1 == w0) keeps a target extent of 1 and
// would write one plane past the end, so such a box writes nothing here
// (native.py::unmold_labels_box also checks before the call).
void unmold_labels_box_i16(const int8_t* lab, int md, int mh, int mw,
                           const int32_t* cz, const int32_t* cy,
                           const int32_t* cx, int16_t* out, int d0,
                           int h0, int w0, int z1, int y1, int x1,
                           int td, int th, int tw) {
  (void)md;
  if (z1 < 0 || y1 < 0 || x1 < 0 || z1 >= d0 || y1 >= h0 || x1 >= w0)
    return;
  const int zb = std::min(td, d0 - z1);
  const int yb = std::min(th, h0 - y1);
  const int xb = std::min(tw, w0 - x1);
  const int64_t plane = static_cast<int64_t>(h0) * w0;
  const size_t row_bytes = static_cast<size_t>(w0) * sizeof(int16_t);
#pragma omp parallel
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
    const int nt = omp_get_num_threads();
#else
    const int tid = 0;
    const int nt = 1;
#endif
    const int zlo = static_cast<int>(static_cast<int64_t>(d0) * tid / nt);
    const int zhi = static_cast<int>(static_cast<int64_t>(d0) * (tid + 1)
                                     / nt);
    int prev_sz = -1;  // source plane of this thread's last plane, if boxed
    for (int z = zlo; z < zhi; ++z) {
      int16_t* oplane = out + z * plane;
      const int bz = z - z1;
      if (bz < 0 || bz >= zb) {
        std::memset(oplane, 0, plane * sizeof(int16_t));
        prev_sz = -1;
        continue;
      }
      const int sz = cz[bz];
      if (sz == prev_sz) {
        std::memcpy(oplane, oplane - plane, plane * sizeof(int16_t));
        continue;
      }
      prev_sz = sz;
      std::memset(oplane, 0, static_cast<size_t>(y1) * row_bytes);
      const int8_t* splane = lab + static_cast<int64_t>(sz) * mh * mw;
      int prev_sy = -1;
      for (int y = 0; y < yb; ++y) {
        int16_t* orow = oplane + static_cast<int64_t>(y1 + y) * w0;
        const int sy = cy[y];
        if (sy == prev_sy) {
          std::memcpy(orow, orow - w0, row_bytes);
          continue;
        }
        prev_sy = sy;
        const int8_t* src = splane + static_cast<int64_t>(sy) * mw;
        std::fill_n(orow, x1, int16_t{0});
        int16_t* o = orow + x1;
        for (int x = 0; x < xb; ++x) o[x] = static_cast<int16_t>(src[cx[x]]);
        std::fill(o + xb, orow + w0, int16_t{0});
      }
      std::memset(oplane + static_cast<int64_t>(y1 + yb) * w0, 0,
                  static_cast<size_t>(h0 - y1 - yb) * row_bytes);
    }
  }
}

// Fused LiTS molding (LiTS_2017/model.py:1154-1233 + HU window
// 1875-1886): inverted HU window + virtual center-pad + nearest resize,
// emitting device [D, H, W] layout directly.  Neither the pad buffer
// (PAD_IMAGE_SHAPE [646, 646, 536] f32, 0.9 GB) nor a full-volume window
// pass is ever materialized.  Pad voxels are exactly 0, matching the
// reference's zero-pad of the windowed volume.
void lits_mold_f32(const float* src, int h0, int w0, int d0, int ph, int pw,
                   int pd, int oh, int ow, int od, float* dst, int dt,
                   int ht, int wt, float mn, float mx, int threads) {
  // same staged-column structure as lits_mold_slab_q8: window each source
  // column once over its contiguous span (autovectorized), then the
  // nearest z map is L1 gathers
  std::vector<int> zi(dt), yi(ht), xi(wt);
  nearest_pad_axis(dt, pd, d0, od, zi.data());
  nearest_pad_axis(ht, ph, h0, oh, yi.data());
  nearest_pad_axis(wt, pw, w0, ow, xi.data());
  const float inv = 1.0f / (mx - mn);
  const int64_t hs = static_cast<int64_t>(w0) * d0;
  int zmin = d0, zmax = -1;
  for (int z = 0; z < dt; ++z)
    if (zi[z] >= 0) {
      zmin = std::min(zmin, zi[z]);
      zmax = std::max(zmax, zi[z]);
    }
  const int span = zmax >= zmin ? zmax - zmin + 1 : 0;
  std::vector<int> zrel(dt);
  for (int z = 0; z < dt; ++z)
    zrel[z] = zi[z] >= 0 ? zi[z] - zmin + 1 : 0;
  constexpr int XB = 128;

#pragma omp parallel num_threads(team_threads(threads))
  {
    std::vector<float> tile(static_cast<size_t>(dt) * XB);
    std::vector<float> buf(static_cast<size_t>(span) + 1);
#if defined(_OPENMP)
#pragma omp for schedule(static)
#endif
    for (int y = 0; y < ht; ++y) {
      const int sy = yi[y];
      for (int xb = 0; xb < wt; xb += XB) {
        const int xn = std::min(XB, wt - xb);
        for (int xo = 0; xo < xn; ++xo) {
          const int sx = xi[xb + xo];
          float* col = tile.data() + xo;
          if (sy < 0 || sx < 0) {
            for (int z = 0; z < dt; ++z)
              col[static_cast<size_t>(z) * XB] = 0.0f;
            continue;
          }
          const float* c =
              src + sy * hs + static_cast<int64_t>(sx) * d0 + zmin;
          buf[0] = 0.0f;
          float* b = buf.data() + 1;
          for (int s = 0; s < span; ++s) {  // contiguous: autovectorizes
            const float t = (c[s] - mn) * inv;
            b[s] = std::min(std::max(t, 0.0f), 1.0f);
          }
          for (int z = 0; z < dt; ++z)
            col[static_cast<size_t>(z) * XB] = buf[zrel[z]];
        }
        for (int z = 0; z < dt; ++z)
          std::memcpy(dst + (static_cast<int64_t>(z) * ht + y) * wt + xb,
                      tile.data() + static_cast<size_t>(z) * XB,
                      static_cast<size_t>(xn) * sizeof(float));
      }
    }
  }
}

// Slab variant of lits_mold_f32 emitting the int8 inference wire
// directly: the [0, 1] HU-windowed values quantize with a FIXED affine
// (x scale, e.g. 127), so no stats pass is needed and z-slabs can stream
// to the device while later slabs resize (same overlap trick as
// mold_resize_slab_q8).  dst is the slab buffer [z_count, ht, wt].
//
// Inner structure: instead of gather + window math per output voxel,
// each source z-column is windowed + quantized once over its contiguous
// used span -- a loop g++ autovectorizes -- and the nearest z map then
// reduces to byte gathers from the L1-resident staged column.
void lits_mold_slab_q8(const float* src, int h0, int w0, int d0, int ph,
                       int pw, int pd, int oh, int ow, int od, int8_t* dst,
                       int dt, int ht, int wt, int z_start, int z_count,
                       float mn, float mx, float scale) {
  std::vector<int> zi(dt), yi(ht), xi(wt);
  nearest_pad_axis(dt, pd, d0, od, zi.data());
  nearest_pad_axis(ht, ph, h0, oh, yi.data());
  nearest_pad_axis(wt, pw, w0, ow, xi.data());
  const float inv = 1.0f / (mx - mn);
  const int64_t hs = static_cast<int64_t>(w0) * d0;
  const int z_end = std::min(z_start + z_count, dt);
  const int zc = z_end - z_start;

  // source-z span this slab actually reads; zrel maps output z -> staged
  // index + 1, with 0 the padding slot (buf[0] == 0)
  int zmin = d0, zmax = -1;
  for (int z = z_start; z < z_end; ++z)
    if (zi[z] >= 0) {
      zmin = std::min(zmin, zi[z]);
      zmax = std::max(zmax, zi[z]);
    }
  const int span = zmax >= zmin ? zmax - zmin + 1 : 0;
  std::vector<int> zrel(zc);
  for (int z = 0; z < zc; ++z) {
    const int sz = zi[z + z_start];
    zrel[z] = sz >= 0 ? sz - zmin + 1 : 0;
  }
  constexpr int XB = 128;

#pragma omp parallel
  {
    std::vector<int8_t> tile(static_cast<size_t>(zc) * XB);
    std::vector<int8_t> buf(static_cast<size_t>(span) + 1);
#if defined(_OPENMP)
#pragma omp for schedule(static)
#endif
    for (int y = 0; y < ht; ++y) {
      const int sy = yi[y];
      for (int xb = 0; xb < wt; xb += XB) {
        const int xn = std::min(XB, wt - xb);
        for (int xo = 0; xo < xn; ++xo) {
          const int sx = xi[xb + xo];
          int8_t* col = tile.data() + xo;
          if (sy < 0 || sx < 0) {
            for (int z = 0; z < zc; ++z)
              col[static_cast<size_t>(z) * XB] = 0;
            continue;
          }
          const float* c =
              src + sy * hs + static_cast<int64_t>(sx) * d0 + zmin;
          buf[0] = 0;
          int8_t* b = buf.data() + 1;
          for (int s = 0; s < span; ++s) {  // contiguous: autovectorizes
            float v = (c[s] - mn) * inv;
            v = std::min(std::max(v, 0.0f), 1.0f) * scale;
            b[s] = static_cast<int8_t>(v);  // trunc, matching numpy astype
          }
          for (int z = 0; z < zc; ++z)
            col[static_cast<size_t>(z) * XB] = buf[zrel[z]];
        }
        for (int z = 0; z < zc; ++z)
          std::memcpy(dst + (static_cast<int64_t>(z) * ht + y) * wt + xb,
                      tile.data() + static_cast<size_t>(z) * XB,
                      static_cast<size_t>(xn) * sizeof(int8_t));
      }
    }
  }
}

// Inverse of the (virtual-pad) nearest molding for a molded int8 label
// volume: out[y, x, z] = lab[mz[z], my[y], mx[x]] emitted as int16 in the
// final [H0, W0, D0] host layout, in one pass (numpy's successive
// axis-takes + astype + transpose walk the volume several times).
// Upsampled index maps repeat
// consecutive source indices, so the kernel exploits runs instead of
// gathering per voxel: the z axis is written as ~Dm run fills per fresh
// (y, x), a duplicate x column is one memcpy of the previous column and a
// duplicate y row one memcpy of the previous row.
//
// Every map entry must index the molded volume (mz in [0, dm), my in
// [0, hm), mx in [0, wm)): a map that does not is refused here, before
// anything is read or written (native.py::unmold_nearest_labels also
// checks before the call).
void unmold_nearest_i16(const int8_t* lab, int dm, int hm, int wm,
                        const int32_t* mz, const int32_t* my,
                        const int32_t* mx, int16_t* out, int h0, int w0,
                        int d0) {
  for (int z = 0; z < d0; ++z)
    if (mz[z] < 0 || mz[z] >= dm) return;
  for (int y = 0; y < h0; ++y)
    if (my[y] < 0 || my[y] >= hm) return;
  for (int x = 0; x < w0; ++x)
    if (mx[x] < 0 || mx[x] >= wm) return;
  // z runs: mz constant on [start, start+count); degenerates to d0
  // length-1 runs (== the old per-voxel cost) when mz never repeats
  std::vector<int32_t> rstart, rcount, rsrc;
  for (int z = 0; z < d0;) {
    int z2 = z + 1;
    while (z2 < d0 && mz[z2] == mz[z]) ++z2;
    rstart.push_back(z);
    rcount.push_back(z2 - z);
    rsrc.push_back(mz[z]);
    z = z2;
  }
  const int nruns = static_cast<int>(rstart.size());
#pragma omp parallel
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
    const int nt = omp_get_num_threads();
#else
    const int tid = 0;
    const int nt = 1;
#endif
    // contiguous per-thread y ranges: the duplicate-row memcpy only ever
    // reads a row this same thread already wrote
    const int ylo = static_cast<int>(static_cast<int64_t>(h0) * tid / nt);
    const int yhi = static_cast<int>(static_cast<int64_t>(h0) * (tid + 1)
                                     / nt);
    std::vector<int8_t> plane(static_cast<size_t>(dm) * wm);
    int prev_sy = -1;
    for (int y = ylo; y < yhi; ++y) {
      const int sy = my[y];
      int16_t* orow = out + static_cast<int64_t>(y) * w0 * d0;
      if (sy == prev_sy) {
        std::memcpy(orow, orow - static_cast<int64_t>(w0) * d0,
                    static_cast<size_t>(w0) * d0 * sizeof(int16_t));
        continue;
      }
      prev_sy = sy;
      for (int z = 0; z < dm; ++z)
        std::memcpy(plane.data() + static_cast<size_t>(z) * wm,
                    lab + (static_cast<int64_t>(z) * hm + sy) * wm,
                    static_cast<size_t>(wm));
      int prev_sx = -1;
      for (int x = 0; x < w0; ++x) {
        const int sx = mx[x];
        int16_t* o = orow + static_cast<int64_t>(x) * d0;
        if (sx == prev_sx) {
          std::memcpy(o, o - d0, static_cast<size_t>(d0) * sizeof(int16_t));
          continue;
        }
        prev_sx = sx;
        for (int r = 0; r < nruns; ++r) {
          const int16_t v = static_cast<int16_t>(
              plane[static_cast<size_t>(rsrc[r]) * wm + sx]);
          std::fill_n(o + rstart[r], rcount[r], v);
        }
      }
    }
  }
}

}  // extern "C" -- reopened below; the templated cores need C++ linkage

// ---------------------------------------------------------------------------
// Training molds: the serving molds with the epoch's (H, W) rotation
// composed in, emitting the train wire (bf16 or int8) directly.  Their
// loops hand out rows (or blocks of voxels) dynamically: the feeder's team
// shares the host with the training loop and the workers, and a thread
// the scheduler holds back then delays no barrier by its whole static
// share.  Each row is computed alone, so the output is the same.
// ---------------------------------------------------------------------------

namespace {

// Rotated (H, W) index maps: the reference rotates each (H, W) slice
// nearest with zero fill (model.py:1019-1052, data/resample.py::rotate_hw).
// The nearest rotation picks whole grid points, so rotate(resize(x)) is
// the source sampled at the axis maps of the rotated integer coordinates:
// the rotation composes into the resize gather exactly.  Writes ry / rx
// (-1 where the rotation maps outside the slice).
void rotate_maps(int ht, int wt, float angle_deg, int* ry, int* rx) {
  const double th = angle_deg * 3.14159265358979323846 / 180.0;
  const double c = std::cos(th), s = std::sin(th);
  const double cy = (ht - 1) / 2.0, cx = (wt - 1) / 2.0;
  for (int y = 0; y < ht; ++y) {
    for (int x = 0; x < wt; ++x) {
      const double ys = c * (y - cy) - s * (x - cx) + cy;
      const double xs = s * (y - cy) + c * (x - cx) + cx;
      const bool inside = ys >= -0.5 && ys <= ht - 0.5 && xs >= -0.5 &&
                          xs <= wt - 0.5;
      const int64_t i = static_cast<int64_t>(y) * wt + x;
      // nearbyint rounds half to even, as np.round does in rotate_hw
      ry[i] = inside ? std::min(std::max(
                  static_cast<int>(std::nearbyint(ys)), 0), ht - 1) : -1;
      rx[i] = inside ? std::min(std::max(
                  static_cast<int>(std::nearbyint(xs)), 0), wt - 1) : -1;
    }
  }
}

// float32 -> bfloat16 bits, round to nearest even (numpy's
// astype(bfloat16) and torch's .to(torch.bfloat16))
inline uint16_t to_bf16(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  const uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return static_cast<uint16_t>((bits + rounding) >> 16);
}

// bf16(v), clipped to +-clip_sigma, times scale, truncated toward zero
// (numpy's astype(int8)): the int8 train wire of a bf16 value
inline int8_t q8_of_bf16(float v, float clip_sigma, float scale) {
  const uint32_t b = static_cast<uint32_t>(to_bf16(v)) << 16;
  float f;
  std::memcpy(&f, &b, 4);
  f = std::min(std::max(f, -clip_sigma), clip_sigma);
  return static_cast<int8_t>(f * scale);
}

// Shared body of the heart train molds: trilinear resize + nearest (H, W)
// rotation into tmp ([D, H, W]), returning the z-score (mean, 1/std).
// Rotation fill voxels are 0 before the z-score, the reference's order
// (augment, then mold_image; model.py:1555 + 1902-1904).  Each output row
// y sums its voxels into a partial of its own, and the partials add up in
// row order: the statistics, and so every output bit, are the same on a
// team of any size.
void heart_train_mold_core(const float* src, int h0, int w0, int d0,
                           float* tmp, int dt, int ht, int wt,
                           float angle_deg, int threads, float* out_mean,
                           float* out_inv) {
  std::vector<int> ry(static_cast<size_t>(ht) * wt),
      rx(static_cast<size_t>(ht) * wt);
  rotate_maps(ht, wt, angle_deg, ry.data(), rx.data());
  const AxisMap zm(dt, d0), ym(ht, h0), xm(wt, w0);
  const int64_t hs = static_cast<int64_t>(w0) * d0;
  constexpr int XB = 128;
  std::vector<double> row_sum(ht), row_sumsq(ht);

#pragma omp parallel num_threads(team_threads(threads))
  {
    std::vector<float> tile(static_cast<size_t>(dt) * XB);
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 2)
#endif
    for (int y = 0; y < ht; ++y) {
      double sum = 0.0, sumsq = 0.0;
      for (int xb = 0; xb < wt; xb += XB) {
        const int xn = std::min(XB, wt - xb);
        for (int xo = 0; xo < xn; ++xo) {
          const int64_t oi = static_cast<int64_t>(y) * wt + xb + xo;
          const int my = ry[oi], mx = rx[oi];
          float* col = tile.data() + xo;
          if (my < 0 || mx < 0) {
            for (int z = 0; z < dt; ++z)
              col[static_cast<size_t>(z) * XB] = 0.0f;
            continue;
          }
          const float fy = ym.f[my], fx = xm.f[mx];
          const float* r00 = src + ym.i0[my] * hs;
          const float* r10 = src + ym.i1[my] * hs;
          const float* p00 = r00 + static_cast<int64_t>(xm.i0[mx]) * d0;
          const float* p01 = r00 + static_cast<int64_t>(xm.i1[mx]) * d0;
          const float* p10 = r10 + static_cast<int64_t>(xm.i0[mx]) * d0;
          const float* p11 = r10 + static_cast<int64_t>(xm.i1[mx]) * d0;
          for (int z = 0; z < dt; ++z) {
            const int dz0 = zm.i0[z], dz1 = zm.i1[z];
            const float fz = zm.f[z];
            const float c00 = p00[dz0] + fz * (p00[dz1] - p00[dz0]);
            const float c01 = p01[dz0] + fz * (p01[dz1] - p01[dz0]);
            const float c10 = p10[dz0] + fz * (p10[dz1] - p10[dz0]);
            const float c11 = p11[dz0] + fz * (p11[dz1] - p11[dz0]);
            const float c0 = c00 + fx * (c01 - c00);
            const float c1 = c10 + fx * (c11 - c10);
            const float v = c0 + fy * (c1 - c0);
            col[static_cast<size_t>(z) * XB] = v;
            sum += v;
            sumsq += static_cast<double>(v) * v;
          }
        }
        for (int z = 0; z < dt; ++z)
          std::memcpy(tmp + (static_cast<int64_t>(z) * ht + y) * wt + xb,
                      tile.data() + static_cast<size_t>(z) * XB,
                      static_cast<size_t>(xn) * sizeof(float));
      }
      row_sum[y] = sum;
      row_sumsq[y] = sumsq;
    }
  }

  double sum = 0.0, sumsq = 0.0;
  for (int y = 0; y < ht; ++y) {
    sum += row_sum[y];
    sumsq += row_sumsq[y];
  }
  const int64_t n = static_cast<int64_t>(dt) * ht * wt;
  const double mean = sum / n;
  double var = sumsq / n - mean * mean;
  if (var < 1e-12) var = 1.0;
  *out_inv = static_cast<float>(1.0 / std::sqrt(var));
  *out_mean = static_cast<float>(mean);
}

// Shared core of the LiTS train molds: the reference rotates the RAW
// volume slice-wise (nearest, zero fill) and then pad+resize-molds it
// (LiTS_2017/model.py:1211-1233 + 1154-1233).  Both maps are nearest
// gathers, so they compose into one index plan: output (y, x) -> virtual
// pad nearest source row / column (sy, sx) -> raw rotation map (ry, rx).
// Neither the rotated raw copy nor the molded f32 volume is made; `quant`
// emits the wire type.  Fill: a pad voxel is wire 0; a voxel the rotation
// maps outside the slice is a raw 0, HU-windowed and quantized.
template <typename OutT, typename Quant>
void lits_train_mold_core(const float* src, int h0, int w0, int d0, int ph,
                          int pw, int pd, int oh, int ow, int od, OutT* dst,
                          int dt, int ht, int wt, float angle_deg, float mn,
                          float mx, int threads, Quant quant) {
  std::vector<int> zi(dt), yi(ht), xi(wt);
  nearest_pad_axis(dt, pd, d0, od, zi.data());
  nearest_pad_axis(ht, ph, h0, oh, yi.data());
  nearest_pad_axis(wt, pw, w0, ow, xi.data());
  std::vector<int> ry(static_cast<size_t>(h0) * w0),
      rx(static_cast<size_t>(h0) * w0);
  rotate_maps(h0, w0, angle_deg, ry.data(), rx.data());
  const float inv = 1.0f / (mx - mn);
  const float w0f = std::min(std::max((0.0f - mn) * inv, 0.0f), 1.0f);
  const OutT q_rot = quant(w0f);  // rotation fill, post-window
  const int64_t hs = static_cast<int64_t>(w0) * d0;

  int zmin = d0, zmax = -1;
  for (int z = 0; z < dt; ++z)
    if (zi[z] >= 0) {
      zmin = std::min(zmin, zi[z]);
      zmax = std::max(zmax, zi[z]);
    }
  const int span = zmax >= zmin ? zmax - zmin + 1 : 0;
  std::vector<int> zrel(dt);
  for (int z = 0; z < dt; ++z)
    zrel[z] = zi[z] >= 0 ? zi[z] - zmin + 1 : 0;
  constexpr int XB = 128;

#pragma omp parallel num_threads(team_threads(threads))
  {
    std::vector<OutT> tile(static_cast<size_t>(dt) * XB);
    std::vector<OutT> buf(static_cast<size_t>(span) + 1);
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 2)
#endif
    for (int y = 0; y < ht; ++y) {
      const int sy = yi[y];
      for (int xb = 0; xb < wt; xb += XB) {
        const int xn = std::min(XB, wt - xb);
        for (int xo = 0; xo < xn; ++xo) {
          const int sx = xi[xb + xo];
          OutT* col = tile.data() + xo;
          if (sy < 0 || sx < 0) {  // pad row / column: wire zeros
            for (int z = 0; z < dt; ++z)
              col[static_cast<size_t>(z) * XB] = OutT(0);
            continue;
          }
          const int64_t ri = static_cast<int64_t>(sy) * w0 + sx;
          const int my = ry[ri], mxx = rx[ri];
          if (my < 0 || mxx < 0) {  // rotated outside the raw slice
            for (int z = 0; z < dt; ++z)
              col[static_cast<size_t>(z) * XB] =
                  zrel[z] ? q_rot : OutT(0);
            continue;
          }
          const float* c =
              src + my * hs + static_cast<int64_t>(mxx) * d0 + zmin;
          buf[0] = OutT(0);
          OutT* b = buf.data() + 1;
          for (int s = 0; s < span; ++s) {  // contiguous: autovectorizes
            const float t = (c[s] - mn) * inv;
            b[s] = quant(std::min(std::max(t, 0.0f), 1.0f));
          }
          for (int z = 0; z < dt; ++z)
            col[static_cast<size_t>(z) * XB] = buf[zrel[z]];
        }
        for (int z = 0; z < dt; ++z)
          std::memcpy(dst + (static_cast<int64_t>(z) * ht + y) * wt + xb,
                      tile.data() + static_cast<size_t>(z) * XB,
                      static_cast<size_t>(xn) * sizeof(OutT));
      }
    }
  }
}

// Label gather shared by the heart and LiTS label companions and the
// virtual-pad label mold: out (z, y, x) = src[yi[my], xi[mx], zi[z]] with
// (my, mx) the (y, x) of the output rotated (or itself: ry / rx null), 0
// where any map is -1.  Same y-outer / x-block / z-inner tiling as the
// molds.  For LiTS the rotation acts on the raw slice, after the pad map
// (rot_first = false); for the heart on the output grid, before the
// resize map (rot_first = true).
void gather_labels_i32(const int32_t* src, int w0, int d0, int32_t* dst,
                       int dt, int ht, int wt, const int* zi, const int* yi,
                       const int* xi, const int* ry, const int* rx,
                       int rot_w, bool rot_first, int threads) {
  const int64_t hs = static_cast<int64_t>(w0) * d0;
  constexpr int XB = 128;

#pragma omp parallel num_threads(team_threads(threads))
  {
    std::vector<int32_t> tile(static_cast<size_t>(dt) * XB);
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 2)
#endif
    for (int y = 0; y < ht; ++y) {
      for (int xb = 0; xb < wt; xb += XB) {
        const int xn = std::min(XB, wt - xb);
        for (int xo = 0; xo < xn; ++xo) {
          const int x = xb + xo;
          int sy = -1, sx = -1;
          if (rot_first) {
            const int64_t oi = static_cast<int64_t>(y) * wt + x;
            const int my = ry[oi], mx = rx[oi];
            if (my >= 0 && mx >= 0) {
              sy = yi[my];
              sx = xi[mx];
            }
          } else if (yi[y] >= 0 && xi[x] >= 0) {
            sy = yi[y];
            sx = xi[x];
            if (ry != nullptr) {
              const int64_t ri = static_cast<int64_t>(sy) * rot_w + sx;
              sy = ry[ri];
              sx = rx[ri];
            }
          }
          int32_t* col = tile.data() + xo;
          if (sy < 0 || sx < 0) {
            for (int z = 0; z < dt; ++z)
              col[static_cast<size_t>(z) * XB] = 0;
            continue;
          }
          const int32_t* c = src + sy * hs + static_cast<int64_t>(sx) * d0;
          for (int z = 0; z < dt; ++z) {
            const int sz = zi[z];
            col[static_cast<size_t>(z) * XB] = sz < 0 ? 0 : c[sz];
          }
        }
        for (int z = 0; z < dt; ++z)
          std::memcpy(dst + (static_cast<int64_t>(z) * ht + y) * wt + xb,
                      tile.data() + static_cast<size_t>(z) * XB,
                      static_cast<size_t>(xn) * sizeof(int32_t));
      }
    }
  }
}

}  // namespace

extern "C" {

// Heart train mold to bf16 bits: resize + rotate + z-score, one scale
// pass over tmp (the reference's resize / rotate / normalize / astype
// chain of four full-volume passes).  dst: [dt, ht, wt] uint16.
void heart_train_mold_bf16(const float* src, int h0, int w0, int d0,
                           uint16_t* dst, float* tmp, int dt, int ht,
                           int wt, float angle_deg, int threads) {
  float m, inv;
  heart_train_mold_core(src, h0, w0, d0, tmp, dt, ht, wt, angle_deg, threads,
                        &m, &inv);
  const int64_t n = static_cast<int64_t>(dt) * ht * wt;
#pragma omp parallel for schedule(dynamic, 1 << 16) \
    num_threads(team_threads(threads))
  for (int64_t i = 0; i < n; ++i) dst[i] = to_bf16((tmp[i] - m) * inv);
}

// Heart train mold to the int8 wire (Config.train_wire_int8): the
// z-scored voxel is bf16-rounded first (the wire quantizes the bf16 image
// it would otherwise ship), then clipped, scaled in f32 and truncated.
void heart_train_mold_q8(const float* src, int h0, int w0, int d0,
                         int8_t* dst, float* tmp, int dt, int ht, int wt,
                         float angle_deg, float clip_sigma, float scale,
                         int threads) {
  float m, inv;
  heart_train_mold_core(src, h0, w0, d0, tmp, dt, ht, wt, angle_deg, threads,
                        &m, &inv);
  const int64_t n = static_cast<int64_t>(dt) * ht * wt;
#pragma omp parallel for schedule(dynamic, 1 << 16) \
    num_threads(team_threads(threads))
  for (int64_t i = 0; i < n; ++i)
    dst[i] = q8_of_bf16((tmp[i] - m) * inv, clip_sigma, scale);
}

// Label companion of the heart train molds: nearest resize + the same
// nearest (H, W) rotation, zero (background) fill, int32 [D, H, W].
void heart_train_labels_i32(const int32_t* src, int h0, int w0, int d0,
                            int32_t* dst, int dt, int ht, int wt,
                            float angle_deg, int threads) {
  std::vector<int> ry(static_cast<size_t>(ht) * wt),
      rx(static_cast<size_t>(ht) * wt);
  rotate_maps(ht, wt, angle_deg, ry.data(), rx.data());
  std::vector<int> zi(dt), yi(ht), xi(wt);
  nearest_pad_axis(dt, d0, d0, 0, zi.data());
  nearest_pad_axis(ht, h0, h0, 0, yi.data());
  nearest_pad_axis(wt, w0, w0, 0, xi.data());
  gather_labels_i32(src, w0, d0, dst, dt, ht, wt, zi.data(), yi.data(),
                    xi.data(), ry.data(), rx.data(), wt, true, threads);
}

// LiTS train mold to the int8 wire: rotate_hw(raw) -> lits_mold ->
// astype(bfloat16) -> clip(+-clip_sigma) -> *scale -> astype(int8), in
// one gather.
void lits_train_mold_q8(const float* src, int h0, int w0, int d0, int ph,
                        int pw, int pd, int oh, int ow, int od, int8_t* dst,
                        int dt, int ht, int wt, float angle_deg, float mn,
                        float mx, float clip_sigma, float scale,
                        int threads) {
  lits_train_mold_core<int8_t>(
      src, h0, w0, d0, ph, pw, pd, oh, ow, od, dst, dt, ht, wt, angle_deg,
      mn, mx, threads, [clip_sigma, scale](float v) {
        return q8_of_bf16(v, clip_sigma, scale);
      });
}

// LiTS train mold to bf16 bits (train_wire_int8 off).
void lits_train_mold_bf16(const float* src, int h0, int w0, int d0, int ph,
                          int pw, int pd, int oh, int ow, int od,
                          uint16_t* dst, int dt, int ht, int wt,
                          float angle_deg, float mn, float mx,
                          int threads) {
  lits_train_mold_core<uint16_t>(src, h0, w0, d0, ph, pw, pd, oh, ow, od,
                                 dst, dt, ht, wt, angle_deg, mn, mx, threads,
                                 [](float v) { return to_bf16(v); });
}

// Label companion of the LiTS train molds: the same composed rotation +
// pad + resize nearest plan over the int32 mask, zero fill for both the
// pad and the rotation's outside.
void lits_train_labels_i32(const int32_t* src, int h0, int w0, int d0,
                           int ph, int pw, int pd, int oh, int ow, int od,
                           int32_t* dst, int dt, int ht, int wt,
                           float angle_deg, int threads) {
  std::vector<int> zi(dt), yi(ht), xi(wt);
  nearest_pad_axis(dt, pd, d0, od, zi.data());
  nearest_pad_axis(ht, ph, h0, oh, yi.data());
  nearest_pad_axis(wt, pw, w0, ow, xi.data());
  std::vector<int> ry(static_cast<size_t>(h0) * w0),
      rx(static_cast<size_t>(h0) * w0);
  rotate_maps(h0, w0, angle_deg, ry.data(), rx.data());
  gather_labels_i32(src, w0, d0, dst, dt, ht, wt, zi.data(), yi.data(),
                    xi.data(), ry.data(), rx.data(), w0, false, threads);
}

// Virtual-pad nearest resize of an int32 label volume (no rotation):
// the label mold of LiTS, and of the heart with pad == source shape.
void pad_nearest_i32(const int32_t* src, int h0, int w0, int d0, int ph,
                     int pw, int pd, int oh, int ow, int od, int32_t* dst,
                     int dt, int ht, int wt, int threads) {
  std::vector<int> zi(dt), yi(ht), xi(wt);
  nearest_pad_axis(dt, pd, d0, od, zi.data());
  nearest_pad_axis(ht, ph, h0, oh, yi.data());
  nearest_pad_axis(wt, pw, w0, ow, xi.data());
  gather_labels_i32(src, w0, d0, dst, dt, ht, wt, zi.data(), yi.data(),
                    xi.data(), nullptr, nullptr, 0, false, threads);
}

int cfun_native_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
