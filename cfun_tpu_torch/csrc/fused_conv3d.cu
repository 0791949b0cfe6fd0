// Fused pre-affine + LeakyReLU + 3x3x3 conv with output moments, for
// Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel cfun_tpu/ops/pallas_conv.py::_kernel
// (launched by fused_conv3d there).  Same function, over channel-first
// volumes:
//   act  = bf16(lrelu(x[b, ci] * scale[b, ci] + shift[b, ci]))   (f32 math)
//   y    = conv3x3x3(act, w)       bias-free, stride 1, zero padding 1
//   sums = [sum(y), sum(y^2)] per (b, c_out), from the f32 accumulator
// x [B, C_in, D, H, W] bf16; w [C_out, C_in, 3, 3, 3] f32 or bf16, repacked
// by the first launch (pack_weights_kernel); scale, shift [B, C_in] f32;
// y [B, C_out, D, H, W] bf16.  A halo position outside the volume holds 0,
// not lrelu(shift): the affine must not leak into the padding.
//
// What bounds it on this card: the conv does 2 * 27 * C_in * C_out flops
// a voxel against ~2 * (C_in + C_out) bytes, so at the U-Net's shapes with
// C_in >= 40 it is bound by the bf16 tensor-core rate (989 TFLOP/s); only
// 20 -> 20 at 96^3 is bound by bytes.  The kernel is an implicit GEMM on
// the tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulation):
// M = the 256 output voxels of a block's tile, N = C_out padded to a
// multiple of 8, K = 27 * C_in padded to a multiple of 8 per 32-channel
// chunk.  Every product of two bf16 values is exact in f32, so only the
// order of the f32 sums differs from the plain version.  It stays well
// above both bounds: what holds it back is the staging of the activated
// halo, then the latency of the shared-memory loads between barriers, more
// than the mma itself (taking each out in turn on the card; PERF.md).
// wgmma fed by TMA, with the activation kept off the critical path, is
// the next step.
//
// Design.
// - A block of 8 * WN warps computes a 4 x 8 x 8 (z, y, x) output tile
//   for up to 80 output channels (10 n8 tiles; more are split over
//   blockIdx.y) of one batch item: 8 warps along M of 32 voxels (two m16
//   tiles) each, WN warps along N of NTW n8 tiles each.  (A 2 x 8 x 8 tile
//   stages 3.1 halo positions a voxel against 2.3 here; it was slower over
//   the U-Net's shapes, though faster at 24^3.)
// - The block walks C_in in chunks of up to 32 channels (G groups of 8).
//   For each chunk it stages the activated halo [6][10][10] positions
//   channel-last in shared memory, 40 bf16 a position: the affine,
//   LeakyReLU and bf16 rounding once per halo element while it is staged,
//   zeros outside the volume and past C_in.  A thread-item is a pair of
//   channels over one halo row, loaded as one 16-byte load of x0 .. x0 + 7
//   (where W is a multiple of 8 and x is 16-byte aligned; one by one
//   otherwise, in this kernel) plus x0 - 1 and x0 + 8, and stored as bf16x2
//   words.  The 40-element stride is 5 groups of 16 bytes, an odd number,
//   so the eight rows of one ldmatrix 8x8 (eight voxels along x) fall in
//   distinct banks; the fifth group of every position holds zeros.
// - K is walked as (tap, group of 8 channels) slices, kg = tap * G +
//   group, two slices a k16 step.  An A fragment comes from one
//   ldmatrix.x4 whose lanes each name their own row, (voxel + tap offset,
//   channel group), so the two k halves of a step may come from different
//   taps and C_in is padded only to a multiple of 8.  When 27 * G is odd
//   the last half-step reads the zero group (its weights are zero too).
// - B: pack_weights_kernel gathers w into the order the mma takes it,
//   [step][n8 tile][lane][4] bf16, zero past C_in and C_out, by the map of
//   ops/fused_conv.py::pack_index.  The block copies the B fragments of 14
//   steps at a time into shared memory with 16-byte loads, then runs those
//   steps from there.  No double buffering: several blocks on an SM
//   overlap one another's staging with their mma.
// - The epilogue reduces the moments from the f32 fragments (shuffles over
//   the lanes that share a column, then a fixed-order sum of the 8 M
//   warps) into partial[b][tile][2][C_out], which the wrapper sums over
//   tiles (no float atomics, so two runs give the same bits), and writes y
//   as bf16 through shared memory, 16 bytes along W where W is a multiple
//   of 8.
//
// ptxas -v (registers, shared memory, spills of each instantiation as
// built on the card): PERF.md, kernel table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTD = 4, kTH = 8, kTW = 8;                   // output tile
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;  // halo tile
constexpr int kHalo = kHD * kHH * kHW;                     // 600
constexpr int kM = kTD * kTH * kTW;                        // 256 voxels
constexpr int kChunk = 32;                                 // C_in chunk
constexpr int kMaxG = kChunk / 8;                          // groups of 8
constexpr int kPos = 40;          // bf16 a halo position: 5 x 16 bytes
constexpr int kZeroGroup = 32;    // offset of the zero group
constexpr int kMaxNB = 10;        // n8 tiles a block
constexpr int kMaxNTW = 5;        // n8 tiles a warp
constexpr int kMWarps = 8;        // warps along M: 32 voxels each
constexpr int kStageBatch = 2;    // staging items in flight a thread
constexpr int kKS = 14;           // K steps of B in shared memory
constexpr int kHaloBytes = kHalo * kPos * 2;
constexpr int kMaxKG = ((27 * kMaxG + 1) / 2) * 2;         // 108
constexpr int kYStride = kM + 8;  // bf16 a channel of the staged y tile

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// NTW n8 tiles a warp and WN warps along N: a block covers NB = NTW * WN
// n8 tiles from blockIdx.y * NB with 8 * WN warps.
template <int NTW, int WN>
__global__ void __launch_bounds__(256 * WN)
fused_conv3d_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint2* __restrict__ wp,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, int C, int CO, int D,
                    int H, int W, int tiles_h, int tiles_w, int ntiles,
                    int vec, int pre_lrelu, float alpha,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ partial) {
  // dynamic: the halo [kHalo][kPos] bf16, then B [kKS][NB][32] uint2
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  uint2* bs = reinterpret_cast<uint2*>(smem + kHaloBytes);
  __shared__ int ktab[kMaxKG];
  __shared__ float red[kMWarps][kMaxNB * 8][2];

  constexpr int kThreadsT = 256 * WN, nb = NTW * WN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % kMWarps, wn = warp / kMWarps;
  const int tile = blockIdx.x;
  const int ntb = blockIdx.y * nb;  // first n8 tile of this block
  const int b = blockIdx.z;
  const int tw = tile % tiles_w;
  const int th = (tile / tiles_w) % tiles_h;
  const int tz = tile / (tiles_w * tiles_h);
  const int z0 = tz * kTD, y0 = th * kTH, x0 = tw * kTW;
  const size_t plane = (size_t)H * W;
  const size_t vol = (size_t)D * plane;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  // the fifth group of every position: zeros (the y tile of the epilogue
  // is the last writer of this memory)
  for (int p = tid; p < kHalo; p += kThreadsT) {
    *reinterpret_cast<uint4*>(&halo[p * kPos + kZeroGroup]) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // this lane's ldmatrix rows: voxel row r of each of the warp's two m16
  // tiles, as the halo position of its (-1, -1, -1) neighbour
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  int rowbase[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int m = wm * 32 + t * 16 + r;
    const int vz = m / (kTH * kTW), vy = (m / kTW) % kTH, vx = m % kTW;
    rowbase[t] = (vz * kHH + vy) * kHW + vx;
  }
  const uint32_t halo_s = (uint32_t)__cvta_generic_to_shared(halo);

  float acc[2][NTW][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.0f;

  int step0 = 0;  // first K step of the chunk in the packed weights
  for (int ci0 = 0; ci0 < C; ci0 += kChunk) {
    const int G = min(kMaxG, (C - ci0 + 7) / 8);
    const int steps = (27 * G + 1) / 2;
    // stage the activated halo.  A thread-item is one pair of channels
    // over one halo row (hz, hy): x0 - 1 and x0 + 8 one by one, x0 .. x0 + 7
    // as one 16-byte load where the rows allow it (vec), else one by one.
    // Consecutive threads take consecutive pairs, so each writes its own
    // bf16x2 word of a position.  kStageBatch items are loaded before any
    // is converted, so their loads overlap.
    const int npair = 4 * G;
    const int nitems = npair * kHD * kHH;
    for (int it0 = tid; it0 < nitems; it0 += kStageBatch * kThreadsT) {
      uint4 mid[kStageBatch][2];
      uint32_t edge[kStageBatch][2];  // x0 - 1 low, x0 + 8 high
      int nval[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int it = it0 + u * kThreadsT;
        const int cp = it % npair, row = it / npair;
        const int gz = z0 + row / kHH - 1, gy = y0 + row % kHH - 1;
        const int c = ci0 + 2 * cp;
        const bool rowok =
            it < nitems && gz >= 0 && gz < D && gy >= 0 && gy < H;
        // channels of this item inside the volume and below C_in
        nval[u] = rowok ? max(0, min(2, C - c)) : 0;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          mid[u][k] = make_uint4(0u, 0u, 0u, 0u);
          edge[u][k] = 0u;
          if (k < nval[u]) {
            const unsigned short* src =
                xs + ((size_t)b * C + c + k) * vol + (size_t)gz * plane +
                (size_t)gy * W + x0;
            const uint32_t lo = x0 > 0 ? __ldg(src - 1) : 0u;
            const uint32_t hi = x0 + kTW < W ? __ldg(src + kTW) : 0u;
            edge[u][k] = lo | (hi << 16);
            if (vec) {
              mid[u][k] = __ldg(reinterpret_cast<const uint4*>(src));
            } else {
              uint32_t m[kTW];
#pragma unroll
              for (int e = 0; e < kTW; ++e) {
                m[e] = x0 + e < W ? __ldg(src + e) : 0u;
              }
              mid[u][k] = make_uint4(m[0] | (m[1] << 16), m[2] | (m[3] << 16),
                                     m[4] | (m[5] << 16), m[6] | (m[7] << 16));
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int it = it0 + u * kThreadsT;
        if (it >= nitems) break;
        const int cp = it % npair, row = it / npair;
        const int c = ci0 + 2 * cp;
        float sc[2], sh[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          sc[k] = k < nval[u] ? __ldg(&scale[b * C + c + k]) : 0.0f;
          sh[k] = k < nval[u] ? __ldg(&shift[b * C + c + k]) : 0.0f;
        }
        __nv_bfloat16* dst = &halo[row * kHW * kPos + 2 * cp];
#pragma unroll
        for (int hx = 0; hx < kHW; ++hx) {
          const int gx = x0 + hx - 1;
          const bool xok = gx >= 0 && gx < W;
          float v[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const uint4 m4 = mid[u][k];
            const uint32_t mw[4] = {m4.x, m4.y, m4.z, m4.w};
            uint32_t bits;
            if (hx == 0) {
              bits = edge[u][k] << 16;
            } else if (hx == kHW - 1) {
              bits = edge[u][k] & 0xffff0000u;
            } else {
              const uint32_t word = mw[(hx - 1) / 2];
              bits = (hx - 1) % 2 == 0 ? word << 16 : word & 0xffff0000u;
            }
            v[k] = 0.0f;
            if (xok && k < nval[u]) {
              float a = __fadd_rn(__fmul_rn(__uint_as_float(bits), sc[k]),
                                  sh[k]);
              if (pre_lrelu && !(a >= 0.0f)) a = __fmul_rn(alpha, a);
              v[k] = a;
            }
          }
          *reinterpret_cast<uint32_t*>(dst + hx * kPos) =
              pack_bf16x2(v[0], v[1]);
        }
      }
    }
    // K slice kg = tap * G + group -> bf16 offset from a row's base; the
    // pad slice of an odd 27 * G reads the zero group
    for (int kg = tid; kg < 2 * steps; kg += kThreadsT) {
      int off = kZeroGroup;
      if (kg < 27 * G) {
        const int tap = kg / G, grp = kg - tap * G;
        const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
        off = ((dz * kHH + dy) * kHW + dx) * kPos + grp * 8;
      }
      ktab[kg] = off;
    }

    // K blocks of up to kKS steps: the block's B fragments of the K block
    // go to shared memory (16-byte loads, zeros past the last n8 tile),
    // then its steps run from there.  The first barrier also ends the
    // halo's staging; the second frees bs (and the halo) for what follows.
    for (int ks0 = 0; ks0 < steps; ks0 += kKS) {
      const int nks = min(kKS, steps - ks0);
      for (int i = tid; i < nks * nb * 16; i += kThreadsT) {
        const int sj = i / 16, q16 = i % 16;  // (step, tile), 16 B of 256
        const int ss = sj / nb, j = sj - ss * nb;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ntb + j < ntiles) {
          v = __ldg(reinterpret_cast<const uint4*>(
                        wp + ((size_t)(step0 + ks0 + ss) * ntiles + ntb + j) *
                                 32) +
                    q16);
        }
        reinterpret_cast<uint4*>(bs)[i] = v;
      }
      __syncthreads();
#pragma unroll 2
      for (int s = 0; s < nks; ++s) {
        const int off = ktab[2 * (ks0 + s) + khalf];
        uint32_t a[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          ldmatrix_x4(a[t],
                      halo_s + (uint32_t)(rowbase[t] * kPos + off) * 2u);
        }
        const uint2* bw = bs + (s * nb + wn * NTW) * 32 + lane;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const uint2 bj = bw[j * 32];
          mma_bf16(acc[0][j], a[0], bj);
          mma_bf16(acc[1][j], a[1], bj);
        }
      }
      __syncthreads();
    }
    step0 += steps;
  }

  // epilogue.  Fragment element e of m16 tile t, n8 tile j: voxel row
  // lane / 4 (+ 8 for e >= 2), channel j * 8 + (lane % 4) * 2 + (e & 1).
  const int q = lane & 3, g8 = lane >> 2;
  bool valid[2][2];
  int mrow[2][2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * 32 + t * 16 + h * 8 + g8;
      const int vz = m / (kTH * kTW), vy = (m / kTW) % kTH, vx = m % kTW;
      mrow[t][h] = m;
      valid[t][h] = z0 + vz < D && y0 + vy < H && x0 + vx < W;
    }
  __nv_bfloat16* ys = halo;  // [nb * 8][kYStride] bf16
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    float s0[2] = {0.0f, 0.0f}, s1[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[t][j][h * 2 + e];
          const int n = (wn * NTW + j) * 8 + q * 2 + e;
          ys[n * kYStride + mrow[t][h]] = __float2bfloat16_rn(v);
          if (valid[t][h]) {
            s0[e] += v;
            s1[e] += v * v;
          }
        }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0[e] += __shfl_xor_sync(0xffffffffu, s0[e], o);
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
      }
      if (g8 == 0) {
        const int n = (wn * NTW + j) * 8 + q * 2 + e;
        red[wm][n][0] = s0[e];
        red[wm][n][1] = s1[e];
      }
    }
  }
  __syncthreads();

  const int ntiles_all = gridDim.x;
  for (int i = tid; i < nb * 8 * 2; i += kThreadsT) {
    const int n = i >> 1, mo = i & 1;
    const int co = ntb * 8 + n;
    if (co < CO) {
      float s = red[0][n][mo];
#pragma unroll
      for (int w = 1; w < kMWarps; ++w) s += red[w][n][mo];
      partial[(((size_t)b * ntiles_all + tile) * 2 + mo) * CO + co] = s;
    }
  }
  // y: one row of 8 x-voxels a thread-item
  const bool yvec = (W % kTW) == 0;  // y is allocated by the wrapper
  for (int i = tid; i < nb * 8 * kTD * kTH; i += kThreadsT) {
    const int n = i / (kTD * kTH), rr = i % (kTD * kTH);
    const int vz = rr / kTH, vy = rr % kTH;
    const int co = ntb * 8 + n, gz = z0 + vz, gy = y0 + vy;
    if (co >= CO || gz >= D || gy >= H) continue;
    const __nv_bfloat16* src = &ys[n * kYStride + (vz * kTH + vy) * kTW];
    __nv_bfloat16* dst =
        y + ((size_t)b * CO + co) * vol + gz * plane + (size_t)gy * W + x0;
    if (yvec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int vx = 0; vx < kTW && x0 + vx < W; ++vx) dst[vx] = src[vx];
    }
  }
}

// pack_weights on the card: wp[i] = bf16(w[idx[i]]), 0 where idx[i] == n
// (ops/fused_conv.py::pack_index gives the map)
__global__ void pack_weights_kernel(const void* __restrict__ w, int w_f32,
                                    const int* __restrict__ idx, int n,
                                    int count,
                                    __nv_bfloat16* __restrict__ wp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int k = idx[i];
  __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
  if (k < n) {
    v = w_f32 ? __float2bfloat16_rn(static_cast<const float*>(w)[k])
              : static_cast<const __nv_bfloat16*>(w)[k];
  }
  wp[i] = v;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int NTW, int WN>
int launch(dim3 grid, cudaStream_t stream, const __nv_bfloat16* x,
           const uint2* wp, const float* scale, const float* shift, int C,
           int CO, int D, int H, int W, int ntiles, int pre_lrelu,
           float alpha, __nv_bfloat16* y, float* partial) {
  const int smem = kHaloBytes + kKS * NTW * WN * 32 * 8;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_conv3d_kernel<NTW, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fused_conv3d_kernel<NTW, WN><<<grid, 256 * WN, smem, stream>>>(
      x, wp, scale, shift, C, CO, D, H, W, cdiv(H, kTH), cdiv(W, kTW), ntiles,
      // 16-byte loads of 8 x-voxels: rows and the base 16-byte aligned
      W % kTW == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0, pre_lrelu,
      alpha, y, partial);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of output tiles of a D x H x W volume: the wrapper allocates the
// partial-moment buffer [B, tiles, 2, C_out].
int cfun_fused_conv3d_tiles(int D, int H, int W) {
  return cdiv(D, kTD) * cdiv(H, kTH) * cdiv(W, kTW);
}

// w [C_out, C_in, 27] f32 (w_f32) or bf16; idx: pack_index's map of
// n_packed entries; wp: scratch for pack_weights' [steps, ceil(C_out / 8),
// 32, 4] bf16, which the first launch writes and the conv reads.
int cfun_fused_conv3d(const void* x, const void* w, int w_f32,
                      const void* idx, int n_packed, void* wp_out,
                      const void* scale, const void* shift, int B, int C,
                      int CO, int D, int H, int W, int pre_lrelu, float alpha,
                      void* y, void* partial, void* stream) {
  if (B < 1 || C < 1 || CO < 1 || D < 1 || H < 1 || W < 1 || n_packed < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = (cudaStream_t)stream;
  pack_weights_kernel<<<cdiv(n_packed, 256), 256, 0, s>>>(
      w, w_f32, static_cast<const int*>(idx), CO * C * 27, n_packed,
      static_cast<__nv_bfloat16*>(wp_out));
  const cudaError_t pe = cudaGetLastError();
  if (pe != cudaSuccess) return (int)pe;
  // n8 tiles: at most 10 a block (80 channels), split over 2 warps along
  // N above 5
  const int ntiles = cdiv(CO, 8);
  int nb = cdiv(ntiles, cdiv(ntiles, kMaxNB));
  const int wn = nb > kMaxNTW ? 2 : 1;
  const int nt = cdiv(nb, wn);
  nb = nt * wn;
  const dim3 grid(cfun_fused_conv3d_tiles(D, H, W), cdiv(ntiles, nb), B);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint2*>(wp_out);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* pt = static_cast<float*>(partial);
#define CFUN_K2_CASE(NTW, WN)                                               \
  if (nt == NTW && wn == WN) {                                              \
    return launch<NTW, WN>(grid, s, xb, wp, sc, sh, C, CO, D, H, W, ntiles, \
                           pre_lrelu, alpha, yb, pt);                       \
  }
  CFUN_K2_CASE(1, 1)
  CFUN_K2_CASE(2, 1)
  CFUN_K2_CASE(3, 1)
  CFUN_K2_CASE(4, 1)
  CFUN_K2_CASE(5, 1)
  CFUN_K2_CASE(3, 2)
  CFUN_K2_CASE(4, 2)
  CFUN_K2_CASE(5, 2)
  return (int)cudaErrorInvalidValue;
#undef CFUN_K2_CASE
}

}  // extern "C"
