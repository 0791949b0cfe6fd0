// Fused pre-affine + LeakyReLU + 3x3x3 conv with output moments, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cfun_tpu/ops/pallas_conv.py::_kernel
// (launched by fused_conv3d there).  Same function, over channel-first
// volumes:
//   act  = bf16(lrelu(x[b, ci] * scale[b, ci] + shift[b, ci]))   (f32 math)
//   y    = conv3x3x3(act, w)       bias-free, stride 1, zero padding 1
//   sums = [sum(y), sum(y^2)] per (b, c_out), from the f32 accumulator
// x [B, C_in, D, H, W] bf16; w [C_out, C_in * 27] bf16 (the port's
// [C_out, C_in, 3, 3, 3] as it lies in memory); scale, shift [B, C_in] f32;
// y [B, C_out, D, H, W] bf16.  A halo position outside the volume
// holds 0, not lrelu(shift): the affine must not leak into the padding.
//
// What bounds it on this card: at the U-Net's shapes the conv does
// 2 * 27 * C_in * C_out flops a voxel against ~2 * (C_in + C_out) bytes,
// so with C_in >= 40 it is bound by the bf16 tensor-core rate (989 TFLOP/s);
// only 20 -> 20 at 96^3 is bound by bytes.  This first version does not
// reach either: it runs on the CUDA cores in f32 (67 TFLOP/s peak), which
// keeps the arithmetic plain (every product of two bf16 values is exact in
// f32, so only the order of the sums differs from the plain version) and
// the kernel short.  Tensor cores (wgmma fed by TMA) are the next step.
//
// Design.  One block of 256 threads computes a 4 x 8 x 8 (z, h, w) output
// tile for 32 output channels of one batch item.  It loops over C_in in
// chunks of 8: for each chunk it stages in shared memory the activated
// halo [8][6][10][10] (f32 values of the bf16-rounded activation, zeros
// outside the volume) and the weights [8][27][32] (f32, zeros past C_in or
// C_out).  Each thread holds 4 consecutive w-voxels x 8 output channels of
// accumulators; per (ci, dz, dy) it reads 6 activations and, per dx, two
// float4 of weights (the same address across the warp, a broadcast).
// The epilogue writes y and reduces the moments within the block (warp
// shuffles, then a fixed-order sum of two warps); each block writes its
// partial moments to partial[b][tile][2][C_out], and the wrapper sums them
// over tiles.  No float atomics, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTD = 4, kTH = 8, kTW = 8;          // output tile
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;  // halo tile
constexpr int kHalo = kHD * kHH * kHW;            // 600
constexpr int kCIB = 8;                           // C_in chunk
constexpr int kCOB = 32;                          // C_out per block
constexpr int kThreads = 256;
constexpr int kVox = 4;                           // w-voxels per thread
constexpr int kCo = 8;                            // out-channels per thread
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fused_conv3d_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, int C, int CO, int D,
                    int H, int W, int tiles_h, int tiles_w, int pre_lrelu,
                    float alpha, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ partial) {
  __shared__ __align__(16) float act[kCIB * kHalo];
  __shared__ __align__(16) float ws[kCIB * 27 * kCOB];
  __shared__ float red[kWarps][kCo][2];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int co0 = blockIdx.y * kCOB;
  const int b = blockIdx.z;
  const int tw = tile % tiles_w;
  const int th = (tile / tiles_w) % tiles_h;
  const int tz = tile / (tiles_w * tiles_h);
  const int z0 = tz * kTD, h0 = th * kTH, w0 = tw * kTW;

  const int cg = tid / 64;                 // out-channel group: 8 channels
  const int vg = tid % 64;                 // voxel group: 4 w-voxels
  const int vz = vg / 16, vh = (vg / 2) % kTH, vw = (vg % 2) * kVox;

  float acc[kVox][kCo];
#pragma unroll
  for (int j = 0; j < kVox; ++j)
#pragma unroll
    for (int c = 0; c < kCo; ++c) acc[j][c] = 0.0f;

  const size_t plane = (size_t)H * W;
  const size_t vol = (size_t)D * plane;
  for (int ci0 = 0; ci0 < C; ci0 += kCIB) {
    const int nci = min(kCIB, C - ci0);
    // stage the activated halo of this C_in chunk
    for (int e = tid; e < kCIB * kHalo; e += kThreads) {
      const int cl = e / kHalo;
      const int r = e - cl * kHalo;
      const int hz = r / (kHH * kHW);
      const int hy = (r / kHW) % kHH;
      const int hx = r % kHW;
      const int gz = z0 + hz - 1, gy = h0 + hy - 1, gx = w0 + hx - 1;
      float v = 0.0f;
      if (cl < nci && gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 &&
          gx < W) {
        const int ci = ci0 + cl;
        const float xv = __bfloat162float(
            x[((size_t)b * C + ci) * vol + gz * plane + (size_t)gy * W + gx]);
        float a = xv * scale[b * C + ci] + shift[b * C + ci];
        if (pre_lrelu) a = a >= 0.0f ? a : alpha * a;
        v = __bfloat162float(__float2bfloat16_rn(a));
      }
      act[e] = v;
    }
    // stage the weights as [ci][tap][c_out] (c_out fastest across the
    // threads, so the shared-memory stores do not collide on one bank)
    for (int e = tid; e < kCOB * kCIB * 27; e += kThreads) {
      const int col = e % kCOB;
      const int rem = e / kCOB;                // cl * 27 + tap
      const int cl = rem / 27;
      const int co = co0 + col;
      float v = 0.0f;
      if (cl < nci && co < CO) {
        v = __bfloat162float(w[(size_t)co * C * 27 + (size_t)ci0 * 27 + rem]);
      }
      ws[rem * kCOB + col] = v;
    }
    __syncthreads();

    for (int cl = 0; cl < nci; ++cl) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* arow =
              &act[cl * kHalo + ((vz + dz) * kHH + vh + dy) * kHW + vw];
          float a[kVox + 2];
#pragma unroll
          for (int j = 0; j < kVox + 2; ++j) a[j] = arow[j];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int tap = dz * 9 + dy * 3 + dx;
            const float4* wp = reinterpret_cast<const float4*>(
                &ws[(cl * 27 + tap) * kCOB + cg * kCo]);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[kCo] = {wa.x, wa.y, wa.z, wa.w,
                                   wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int j = 0; j < kVox; ++j)
#pragma unroll
              for (int c = 0; c < kCo; ++c)
                acc[j][c] = __fmaf_rn(a[j + dx], wv[c], acc[j][c]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: write y, reduce the moments of the valid voxels
  const int gz = z0 + vz, gy = h0 + vh;
  float s0[kCo], s1[kCo];
#pragma unroll
  for (int c = 0; c < kCo; ++c) s0[c] = s1[c] = 0.0f;
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const int gx = w0 + vw + j;
    if (gz >= D || gy >= H || gx >= W) continue;
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
      const int co = co0 + cg * kCo + c;
      if (co >= CO) continue;
      const float v = acc[j][c];
      const size_t o = ((size_t)b * CO + co) * vol + gz * plane +
                       (size_t)gy * W + gx;
      y[o] = __float2bfloat16_rn(v);
      s0[c] += v;
      s1[c] += v * v;
    }
  }
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int c = 0; c < kCo; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0[c] += __shfl_xor_sync(0xffffffffu, s0[c], off);
      s1[c] += __shfl_xor_sync(0xffffffffu, s1[c], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
      red[warp][c][0] = s0[c];
      red[warp][c][1] = s1[c];
    }
  }
  __syncthreads();
  // warps 2g and 2g + 1 hold out-channel group g
  if (tid < kCOB * 2) {
    const int col = tid >> 1, m = tid & 1;
    const int g = col / kCo, c = col % kCo;
    const int co = co0 + col;
    if (co < CO) {
      const int ntiles = gridDim.x;
      partial[(((size_t)b * ntiles + tile) * 2 + m) * CO + co] =
          red[2 * g][c][m] + red[2 * g + 1][c][m];
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Number of output tiles of a D x H x W volume: the wrapper allocates the
// partial-moment buffer [B, tiles, 2, C_out].
int cfun_fused_conv3d_tiles(int D, int H, int W) {
  return cdiv(D, kTD) * cdiv(H, kTH) * cdiv(W, kTW);
}

int cfun_fused_conv3d(const void* x, const void* w, const void* scale,
                      const void* shift, int B, int C, int CO, int D, int H,
                      int W, int pre_lrelu, float alpha, void* y,
                      void* partial, void* stream) {
  if (B < 1 || C < 1 || CO < 1 || D < 1 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int th = cdiv(H, kTH), tw = cdiv(W, kTW);
  const dim3 grid(cfun_fused_conv3d_tiles(D, H, W), cdiv(CO, kCOB), B);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  fused_conv3d_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), C, CO, D, H, W, th, tw, pre_lrelu,
      alpha, static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

}  // extern "C"
