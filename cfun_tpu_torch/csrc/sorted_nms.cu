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
// hold idx 0, keep false.
//
// What bounds it: not bytes (24 B a box) and not arithmetic (N^2 IoU
// pairs, 1e6 at the main path's N = 1000), but the sweep's chain of
// dependent steps.  The design keeps that chain short:
//   pass 1 (iou_mask_kernel) computes the whole IoU > thr relation in
//     parallel as a bit matrix [N, ceil(N/64)] of uint64 words; a block of
//     64 threads owns one 64 x 64 tile and stages its column boxes in
//     shared memory;
//   pass 2 (sweep_kernel) is one warp.  Lane l holds suppression words
//     l and l + 32 in registers (so N <= 64 * 64 = 4096).  The warp jumps
//     from one unsuppressed box to the next with find-first-set on the
//     broadcast word instead of visiting every box, so the chain has one
//     step per kept box plus one per word; a kept box ORs its row into
//     the registers with one coalesced load per lane.  The same warp
//     writes the compacted (idx, keep) output.
//
// The IoU is computed with the operation order of ops/boxes.py::
// pairwise_iou ((d*h)*w volumes, inter / ((v1 + v2 - inter) + 1e-6)), and
// the file is compiled with -fmad=false, so the bit matrix matches the
// plain PyTorch version's (iou > thr) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // boxes per word / per pass-1 tile
constexpr int kWordsPerLane = 2;    // suppression words held by each lane
constexpr int kMaxWords = 32 * kWordsPerLane;

__device__ __forceinline__ float box_iou(const float* a, const float* b) {
  float dz = fmaxf(fminf(a[3], b[3]) - fmaxf(a[0], b[0]), 0.0f);
  float dy = fmaxf(fminf(a[4], b[4]) - fmaxf(a[1], b[1]), 0.0f);
  float dx = fmaxf(fminf(a[5], b[5]) - fmaxf(a[2], b[2]), 0.0f);
  float inter = (dz * dy) * dx;
  float va = ((a[3] - a[0]) * (a[4] - a[1])) * (a[5] - a[2]);
  float vb = ((b[3] - b[0]) * (b[4] - b[1])) * (b[5] - b[2]);
  float uni = (va + vb) - inter;
  return inter / (uni + 1e-6f);
}

// grid (words, words), block kTile: thread t of block (cx, ry) writes word
// cx of row ry * kTile + t, bit j set iff IoU(row, cx * kTile + j) > thr.
__global__ void iou_mask_kernel(const float* __restrict__ boxes, int n,
                                float thr, int words,
                                unsigned long long* __restrict__ mask) {
  __shared__ float cols[kTile * 6];
  const int col0 = blockIdx.x * kTile;
  const int row = blockIdx.y * kTile + threadIdx.x;
  const int ncols = min(kTile, n - col0);
  for (int e = threadIdx.x; e < ncols * 6; e += blockDim.x) {
    cols[e] = boxes[col0 * 6 + e];
  }
  __syncthreads();
  if (row >= n) return;
  float me[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) me[c] = boxes[row * 6 + c];
  unsigned long long bits = 0ull;
  for (int j = 0; j < ncols; ++j) {
    if (box_iou(me, &cols[j * 6]) > thr) bits |= 1ull << j;
  }
  mask[(size_t)row * words + blockIdx.x] = bits;
}

// One warp.  supp[s] is word (lane + 32 s) of the suppression set.
__global__ void sweep_kernel(const unsigned long long* __restrict__ mask,
                             const uint8_t* __restrict__ valid, int n,
                             int words, int k, int* __restrict__ idx,
                             bool* __restrict__ keep) {
  const int lane = threadIdx.x;
  unsigned long long supp[kWordsPerLane];
#pragma unroll
  for (int s = 0; s < kWordsPerLane; ++s) {
    const int w = lane + 32 * s;
    unsigned long long bits = ~0ull;  // past the end: never a candidate
    if (w < words) {
      for (int b = 0; b < kTile; ++b) {
        const int j = w * kTile + b;
        if (j < n && valid[j]) bits &= ~(1ull << b);
      }
    }
    supp[s] = bits;
  }

  int count = 0;
  for (int w = 0; w < words && count < k; ++w) {
    const int owner = w & 31;
    const int slot = w >> 5;
    // bits of word w still open above position `from`
    int from = 0;
    while (count < k) {
      unsigned long long word = 0ull;
#pragma unroll
      for (int s = 0; s < kWordsPerLane; ++s) {
        if (s == slot) word = supp[s];
      }
      word = __shfl_sync(0xffffffffu, word, owner);
      unsigned long long open = ~word;
      if (from > 0) open &= ~0ull << from;
      if (open == 0ull) break;
      const int b = __ffsll((long long)open) - 1;
      const int i = w * kTile + b;
      if (lane == 0) {
        idx[count] = i;
        keep[count] = true;
      }
      ++count;
      const unsigned long long* rowp = mask + (size_t)i * words;
#pragma unroll
      for (int s = 0; s < kWordsPerLane; ++s) {
        const int ww = lane + 32 * s;
        if (ww < words) supp[s] |= rowp[ww];
      }
      from = b + 1;
      if (from >= kTile) break;
    }
  }
  for (int c = count + lane; c < k; c += 32) {
    idx[c] = 0;
    keep[c] = false;
  }
}

}  // namespace

extern "C" {

// Largest N the sweep takes (its suppression set lives in one warp's
// registers).
int cfun_sorted_nms_max_n() { return kMaxWords * kTile; }

// Scratch words the caller allocates: n * ceil(n / 64) uint64.
long long cfun_sorted_nms_scratch_words(int n) {
  const long long words = (n + kTile - 1) / kTile;
  return (long long)n * words;
}

// Launches both passes on `stream`.  Returns cudaGetLastError() after each
// launch (0 on success); the caller raises on anything else.
int cfun_sorted_nms(const float* boxes, const uint8_t* valid, int n,
                    float thr, int k, unsigned long long* scratch, int* idx,
                    bool* keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || k <= 0 || n > kMaxWords * kTile) return cudaErrorInvalidValue;
  const int words = (n + kTile - 1) / kTile;
  if (n > 0) {
    iou_mask_kernel<<<dim3(words, words), kTile, 0, st>>>(boxes, n, thr,
                                                          words, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sweep_kernel<<<1, 32, 0, st>>>(scratch, valid, n, words, k, idx, keep);
  return cudaGetLastError();
}

}  // extern "C"
