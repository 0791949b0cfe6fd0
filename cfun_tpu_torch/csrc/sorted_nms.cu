// Greedy 3D NMS over score-descending boxes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cfun_tpu/ops/pallas_nms.py::_nms_kernel
// (launched by pallas_sorted_nms) together with the cumsum-scatter
// compaction that follows it there.  Same contract: boxes [N, 6] f32
// (z1, y1, x1, z2, y2, x2), sorted by descending score; valid [N] bool.
// Box i is kept iff it is valid, not suppressed by an earlier kept box,
// and fewer than k boxes are kept so far; a kept box suppresses every box
// whose IoU with it is strictly above the threshold.  Outputs idx [k]
// int32 (positions in the sorted array) and keep [k] bool; unfilled slots
// hold idx 0, keep false.  N <= 4096.
//
// What bounds it on this card: not bytes (24 B a box) and not arithmetic
// (the served 1000 -> 64 call needs ~5,000 IoUs), but latency: the launch,
// then a chain of dependent steps, one per kept box at worst.  One launch
// does everything:
//   1. every block of the grid computes one 64 x 64 tile of the upper
//      triangle of the (IoU > thr) relation, the only part greedy NMS
//      reads (a box suppresses later boxes only): 512 threads, warp w
//      rows w, w + 16, ..., lane l columns l and l + 32, so 8 pairs a
//      thread and, at N = 1000, 136 blocks in one wave.  A row's 64 bits
//      are two ballots; the tile goes to a workspace, tile-major.  The
//      diagonal tiles also pack `valid` into words (coalesced byte loads
//      and a ballot).
//   2. each block takes a ticket (one acq_rel atomic); the block that
//      takes the last one sweeps and resets the ticket for the next
//      launch, so the kernel is capturable in a CUDA graph and needs no
//      second launch.  The workspace (ticket included) belongs to one
//      stream: the wrapper holds one per device, stream and N.
//   3. one warp of that block sweeps.  The tiles reach shared memory by
//      TMA bulk copies on mbarriers: row block 0 first, the rest behind
//      it (or, past 96 KB of tiles, a ring of two row blocks, the next
//      one in flight while the warp scans the current one).  The chain
//      reads shared memory only: each step takes the four lowest open
//      boxes of the current word, loads their rows at once and keeps each
//      one that no kept box before it suppresses; lane l ORs the kept
//      rows into suppression words l and l + 32.  Outputs are written a
//      word at a time, one lane a kept box.
//
// Designs timed on the card against the two-pass kernel this replaced
// (k1_compare.py; numbers in PERF.md), each exact on every case:
//   (a) a 16-CTA cluster holding the tiles in distributed shared memory:
//       slowest of the three at 1000 -> 64; 16 SMs issue the IoUs too
//       slowly.
//   (c) lazy rows in one CTA (IoUs with kept boxes only): fastest at
//       64 -> 1, but one SM's issue rate makes it no faster than (b) at
//       1000 -> 64 and 6x slower at N = 4096.
//   (b) a grid with a last-block sweep, which this file grew from: the
//       IoU's zero-intersection shortcut, the tiles staged in shared
//       memory by TMA and four boxes a chain step each took time off it.
// A sweep warp runs one instruction at a time, so its chain costs
// hundreds of cycles a step; two attempts to shorten it lost to the one
// kept: deciding a word in parallel rounds (the served data has long
// chains of keep-suppress) and scanning every position of a word.

// The IoU keeps the operation order of ops/boxes.py::pairwise_iou and the
// file is compiled with -fmad=false, so the bit matrix matches the plain
// PyTorch version's (iou > thr) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int kTile = 64;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 4096;
constexpr int kMaxWords = kMaxN / kTile;
constexpr int kTileStride = 66;         // u64 a tile: 64 rows + pad
constexpr int kStageBytes = 96 * 1024;  // staged tiles of the sweep

struct Box {
  float z1, y1, x1, z2, y2, x2, vol;
};

__device__ __forceinline__ Box box_at(const float (*s)[kTile], int j) {
  return Box{s[0][j], s[1][j], s[2][j], s[3][j], s[4][j], s[5][j], s[6][j]};
}

// IoU(a, b) > thr in ops/boxes.py::pairwise_iou's operation order (a is
// the row box, volumes as (d * h) * w); exact under -fmad=false.
__device__ __forceinline__ bool iou_over(const Box& a, const Box& b,
                                         float thr) {
  const float dz = fmaxf(fminf(a.z2, b.z2) - fmaxf(a.z1, b.z1), 0.0f);
  const float dy = fmaxf(fminf(a.y2, b.y2) - fmaxf(a.y1, b.y1), 0.0f);
  const float dx = fmaxf(fminf(a.x2, b.x2) - fmaxf(a.x1, b.x1), 0.0f);
  const float inter = (dz * dy) * dx;
  const float denom = ((a.vol + b.vol) - inter) + 1e-6f;
  // 0 / denom is +-0, or NaN where denom is 0 or NaN: decided without
  // the division, which most pairs (disjoint boxes) would otherwise pay
  if (inter == 0.0f) return 0.0f > thr && denom == denom && denom != 0.0f;
  return inter / denom > thr;
}

__device__ __forceinline__ int tile_id(int words, int r, int c) {
  return r * words - r * (r - 1) / 2 + (c - r);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// one TMA bulk copy global -> shared, counted as `bytes` on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_expect(u64* bar, unsigned tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(tx)
               : "memory");
}
// Waits for the phase of `bar` with this parity; traps (an error the
// caller sees, not a hang) if the copies never land.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  for (long long tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1ll << 22)) __trap();
  }
}

// Workspace: mask tiles [tiles][66] u64 (tile T = tile_id(r, c) holds
// word c of rows r * 64 + i at [T][i], bits past the row only), valid
// words [words], then the ticket (zeroed once by the caller).
__global__ void __launch_bounds__(kThreads, 2)
sorted_nms_kernel(const float* __restrict__ boxes,
                  const uint8_t* __restrict__ valid, int n, float thr,
                  int k, int words, int ring, u64* __restrict__ mask,
                  u64* __restrict__ vwords, unsigned* __restrict__ ticket,
                  int* __restrict__ idx, bool* __restrict__ keep) {
  // the sweep's stage: every tile, or a ring of two row blocks
  extern __shared__ __align__(128) u64 stage[];
  __shared__ float bx[2][7][kTile];  // row / column boxes and volumes
  __shared__ u64 row_valid;
  __shared__ __align__(8) u64 bars[2];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (words > 0) {
    int rem = blockIdx.x, r = 0;
    while (rem >= words - r) {
      rem -= words - r;
      ++r;
    }
    const int cx = r + rem;
    if (t < 2 * kTile) {
      const int side = t >> 6, jj = t & (kTile - 1);
      const int j = (side ? cx : r) * kTile + jj;
      float v[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) v[c] = j < n ? boxes[j * 6 + c] : 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) bx[side][c][jj] = v[c];
      bx[side][6][jj] = ((v[3] - v[0]) * (v[4] - v[1])) * (v[5] - v[2]);
    } else if (warp == 2 * kTile / 32) {
      const int j = r * kTile + lane;
      const u64 vw =
          (u64)__ballot_sync(0xffffffffu, j < n && valid[j] != 0) |
          ((u64)__ballot_sync(0xffffffffu, j + 32 < n && valid[j + 32] != 0)
           << 32);
      if (lane == 0) {
        row_valid = vw;
        if (r == cx) vwords[r] = vw;
      }
    }
    __syncthreads();
    const Box c0 = box_at(bx[1], lane), c1 = box_at(bx[1], lane + 32);
    const int col0 = cx * kTile;
    u64* out = mask + (size_t)blockIdx.x * kTileStride;
    for (int row = warp; row < kTile; row += kWarps) {
      const int i = r * kTile + row;
      const bool live = (row_valid >> row) & 1ull;
      const Box a = box_at(bx[0], row);
      const bool o0 = live && col0 + lane > i && iou_over(a, c0, thr);
      const bool o1 = live && col0 + lane + 32 > i && iou_over(a, c1, thr);
      const u64 word = (u64)__ballot_sync(0xffffffffu, o0) |
                       ((u64)__ballot_sync(0xffffffffu, o1) << 32);
      if (lane == 0) out[row] = word;
    }
  }
  __syncthreads();
  if (t == 0) {
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(ticket)
                 : "memory");
    last = prev == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || warp != 0) return;
  if (lane == 0) *ticket = 0u;  // ready for the next launch on the stream

  const int tiles = words * (words + 1) / 2;
  constexpr unsigned kTileBytes = kTileStride * 8;
  // all tiles: row block 0 on bars[0], the rest on bars[1]; a ring: row
  // block b in slot b & 1 on bars[b & 1], phase (b >> 1) & 1
  auto issue = [&](int b) {  // lane 0, ring
    const unsigned bytes = (unsigned)(words - b) * kTileBytes;
    mbar_expect(&bars[b & 1], bytes);
    bulk_copy(stage + (size_t)(b & 1) * words * kTileStride,
              mask + (size_t)tile_id(words, b, b) * kTileStride, bytes,
              &bars[b & 1]);
  };
  if (lane == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    if (ring) {
      issue(0);
      if (words > 1) issue(1);
    } else if (words > 0) {
      mbar_expect(&bars[0], words * kTileBytes);
      bulk_copy(stage, mask, words * kTileBytes, &bars[0]);
      if (words > 1) {
        mbar_expect(&bars[1], (tiles - words) * kTileBytes);
        bulk_copy(stage + (size_t)words * kTileStride,
                  mask + (size_t)words * kTileStride,
                  (tiles - words) * kTileBytes, &bars[1]);
      }
    }
  }
  // bit b: a copy issued and not yet waited for (ring: row block b; all
  // tiles: bars[b]); every copy lands before the block exits
  u64 pending = words > 1 ? 3ull : (words > 0 ? 1ull : 0ull);
  u64 supp[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int w = lane + 32 * s;
    supp[s] = w < words ? ~__ldcg(vwords + w) : ~0ull;
  }
  __syncwarp();

  int count = 0;
  for (int w = 0; w < words && count < k; ++w) {
    u64 open = ~__shfl_sync(0xffffffffu, (w >> 5) ? supp[1] : supp[0],
                            w & 31);
    const u64* blk;
    if (ring) {  // slots are refilled in order, so every block is waited
      mbar_wait(&bars[w & 1], (w >> 1) & 1);
      pending &= ~(1ull << w);
      blk = stage + (size_t)(w & 1) * words * kTileStride;
    } else {
      const int u = w > 0;
      if (open != 0ull && ((pending >> u) & 1ull)) {
        mbar_wait(&bars[u], 0);
        pending &= ~(1ull << u);
      }
      blk = stage + (size_t)tile_id(words, w, w) * kTileStride;
    }
    if (open != 0ull) {
      // lane l ORs the kept rows into the later words l and l + 32
      const bool up0 = lane > w && lane < words;
      const bool up1 = lane + 32 > w && lane + 32 < words;
      const u64* p0 = blk + (up0 ? lane - w : 0) * kTileStride;
      const u64* p1 = blk + (up1 ? lane + 32 - w : 0) * kTileStride;
      u64 acc0 = 0ull, acc1 = 0ull, kept = 0ull;
      int c = count;
      // the chain, one 32-bit half of the word at a time: each step takes
      // the four lowest open boxes, loads their rows together and keeps
      // each one that no kept box before it suppresses (at most k - c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned o = (unsigned)(open >> (32 * h));
        while (o != 0u && c < k) {
          const unsigned o1 = o & (o - 1u), o2 = o1 & (o1 - 1u),
                         o3 = o2 & (o2 - 1u);
          const int b0 = 32 * h + __ffs(o) - 1;
          const int b1 = o1 ? 32 * h + __ffs(o1) - 1 : b0;
          const int b2 = o2 ? 32 * h + __ffs(o2) - 1 : b0;
          const int b3 = o3 ? 32 * h + __ffs(o3) - 1 : b0;
          const u64 r0 = blk[b0], r1 = blk[b1], r2 = blk[b2], r3 = blk[b3];
          const u64 q00 = p0[b0], q01 = p0[b1], q02 = p0[b2], q03 = p0[b3];
          const u64 q10 = p1[b0], q11 = p1[b1], q12 = p1[b2], q13 = p1[b3];
          const int need = k - c;
          const bool k1 = o1 != 0u && need > 1 && !((r0 >> b1) & 1ull);
          const u64 s1 = r0 | (k1 ? r1 : 0ull);
          const int n1 = 1 + (int)k1;
          const bool k2 = o2 != 0u && n1 < need && !((s1 >> b2) & 1ull);
          const u64 s2 = s1 | (k2 ? r2 : 0ull);
          const int n2 = n1 + (int)k2;
          const bool k3 = o3 != 0u && n2 < need && !((s2 >> b3) & 1ull);
          const u64 s3 = s2 | (k3 ? r3 : 0ull);
          kept |= (1ull << b0) | (k1 ? 1ull << b1 : 0ull) |
                  (k2 ? 1ull << b2 : 0ull) | (k3 ? 1ull << b3 : 0ull);
          acc0 |= q00 | (k1 ? q01 : 0ull) | (k2 ? q02 : 0ull) |
                  (k3 ? q03 : 0ull);
          acc1 |= q10 | (k1 ? q11 : 0ull) | (k2 ? q12 : 0ull) |
                  (k3 ? q13 : 0ull);
          open &= ~s3;
          o = (o3 & (o3 - 1u)) & ~(unsigned)(s3 >> (32 * h));
          c += n2 + (int)k3;
        }
      }
      if (up0) supp[0] |= acc0;
      if (up1) supp[1] |= acc1;
      const u64 below0 = (1ull << lane) - 1ull;
      const u64 below1 = (1ull << (lane + 32)) - 1ull;
      if ((kept >> lane) & 1ull) {
        const int pos = count + __popcll(kept & below0);
        idx[pos] = w * kTile + lane;
        keep[pos] = true;
      }
      if ((kept >> (lane + 32)) & 1ull) {
        const int pos = count + __popcll(kept & below1);
        idx[pos] = w * kTile + lane + 32;
        keep[pos] = true;
      }
      count = c;
    }
    if (ring && w + 2 < words) {
      __syncwarp();  // every lane is done with slot w & 1
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(w + 2);
      }
      pending |= 1ull << (w + 2);
    }
  }
  for (u64 m = pending; m != 0ull; m &= m - 1ull) {
    const int b = __ffsll((long long)m) - 1;
    mbar_wait(&bars[b & 1], ring ? (b >> 1) & 1 : 0);
  }
  for (int q = count + lane; q < k; q += 32) {
    idx[q] = 0;
    keep[q] = false;
  }
}

bool g_configured = false;

}  // namespace

extern "C" {

int cfun_sorted_nms_max_n() { return kMaxN; }

// mask tiles, valid words, ticket (zeroed by the caller once)
long long cfun_sorted_nms_workspace_bytes(int n) {
  const long long words = (n + kTile - 1) / kTile;
  return (words * (words + 1) / 2 * kTileStride + words) * 8 + 16;
}

int cfun_sorted_nms(const float* boxes, const uint8_t* valid, int n,
                    float thr, int k, void* workspace, int* idx, bool* keep,
                    void* stream) {
  if (n < 0 || k <= 0 || n > kMaxN) return cudaErrorInvalidValue;
  if (!g_configured) {
    cudaError_t err = cudaFuncSetAttribute(
        sorted_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    if (err != cudaSuccess) return err;
    g_configured = true;
  }
  const int words = (n + kTile - 1) / kTile;
  const int tiles = words * (words + 1) / 2;
  const size_t all = (size_t)tiles * kTileStride * 8;
  const int ring = all > (size_t)kStageBytes;
  const size_t smem = ring ? (size_t)2 * words * kTileStride * 8 : all;
  u64* mask = static_cast<u64*>(workspace);
  u64* vwords = mask + (size_t)tiles * kTileStride;
  unsigned* ticket = reinterpret_cast<unsigned*>(vwords + words);
  sorted_nms_kernel<<<tiles > 0 ? tiles : 1, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      boxes, valid, n, thr, k, words, ring, mask, vwords, ticket, idx, keep);
  return cudaGetLastError();
}

}  // extern "C"
