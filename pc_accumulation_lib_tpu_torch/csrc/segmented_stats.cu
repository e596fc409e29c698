// Segmented per-group statistics over rows sorted by group key, for the BEV
// raster (pc_accumulation_lib_tpu_torch/ops/segmented_stats.py).
//
// Replaces the Pallas TPU kernel pc_accumulation_lib_tpu/ops/pallas_stats.py
// _kernel_words (entry point segmented_stats_words). Same outputs:
//   sums[g] = [count, sum road (w1 bit 25), sum dyn (w1 bit 24),
//              sum intensity (w2 low 16 bits / 65535)]
//   zmin[g] = min over the group of w2's high 16 bits read as float16
//   meds[c][0][g] = exact median 0.5 * (v[(n-1)/2] + v[n/2]) of rgb byte c of
//     w1 (bits 23..16, 15..8, 7..0) over the group's rows
//   meds[c][1][2k] = the same median over the group pair (2k, 2k+1) when
//     nsplit == 2 (the 'full' split), 0 at odd positions and when nsplit == 1
// Empty groups: sums 0, zmin +inf, medians 0.
//
// Design. Each group is a contiguous run of the sorted rows; the caller
// passes the run boundaries (bounds[g] = first row with key >= g, so keys
// >= num_groups are never read). One warp owns one cell, i.e. nsplit
// consecutive groups: its lanes stride over the cell's rows, accumulate
// the sums in registers (integers, so count/road/dyn/intensity are exact
// and independent of summation order), reduce them with warp shuffles, and
// build 3 x 256-bin u32 histograms per group in shared memory with shared
// atomics. The order statistics come from a warp prefix scan over the
// bins; the 'full' median reads the sum of the pair's two histograms.
// Nothing is carried between warps or blocks, so no block-level sync.
//
// Bound: bytes. Each row is read once (12 B: key bound, w1, w2) and each
// group writes 36 B, so at the bench raster shape (860k rows, 131072
// groups) the floor is ~15 MB of HBM traffic. Empty cells skip the
// histogram zeroing and write their constants only. A later version can
// launch over occupied cells only.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSplit = 2;
constexpr int kChannels = 3;
constexpr int kBins = 256;
constexpr int kBinsPerLane = kBins / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Value at rank k (0-based) of the multiset whose histogram is h0 (+ h1 when
// h1 is not null): the bin b with cum[b-1] <= k < cum[b]. Requires k < the
// histogram total. All 32 lanes must call it.
__device__ int value_at_rank(const unsigned* h0, const unsigned* h1, int lane,
                             unsigned k) {
  unsigned local[kBinsPerLane];
  unsigned s = 0;
  for (int i = 0; i < kBinsPerLane; ++i) {
    const int b = lane * kBinsPerLane + i;
    local[i] = h0[b] + (h1 ? h1[b] : 0u);
    s += local[i];
  }
  unsigned incl = s;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += t;
  }
  unsigned run = incl - s;
  int found = -1;
  if (k >= run && k < incl) {
    for (int i = 0; i < kBinsPerLane; ++i) {
      run += local[i];
      if (k < run) {
        found = lane * kBinsPerLane + i;
        break;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) found = max(found, __shfl_xor_sync(kFullMask, found, off));
  return found;
}

__device__ float median(const unsigned* h0, const unsigned* h1, int lane,
                        unsigned n) {
  if (n == 0) return 0.0f;
  const int v1 = value_at_rank(h0, h1, lane, (n - 1) / 2);
  const int v2 = value_at_rank(h0, h1, lane, n / 2);
  return 0.5f * (static_cast<float>(v1) + static_cast<float>(v2));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segmented_stats_kernel(const int* __restrict__ bounds,
                       const int* __restrict__ w1,
                       const int* __restrict__ w2, int num_cells, int nsplit,
                       int num_groups, float* __restrict__ sums,
                       float* __restrict__ zmin, float* __restrict__ meds) {
  __shared__ unsigned hist[kWarpsPerBlock][kMaxSplit][kChannels][kBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarpsPerBlock + warp;
  if (cell >= num_cells) return;  // whole warp; no block-level sync below
  unsigned(*h)[kChannels][kBins] = hist[warp];
  const int g0 = cell * nsplit;
  const bool occupied = bounds[g0 + nsplit] > bounds[g0];
  if (occupied) {
    unsigned* flat = &h[0][0][0];
    for (int i = lane; i < nsplit * kChannels * kBins; i += 32) flat[i] = 0u;
    __syncwarp();
  }

  unsigned lens[kMaxSplit] = {0u, 0u};
  for (int s = 0; s < nsplit; ++s) {
    const int g = g0 + s;
    const int beg = bounds[g];
    const int end = bounds[g + 1];
    unsigned cnt = 0, road = 0, dyn = 0;
    unsigned long long inten = 0;
    float zm = INFINITY;
    for (int i = beg + lane; i < end; i += 32) {
      const int a = w1[i];
      const int b = w2[i];
      ++cnt;
      road += (a >> 25) & 1;
      dyn += (a >> 24) & 1;
      inten += static_cast<unsigned>(b & 0xFFFF);
      const unsigned short zbits = static_cast<unsigned short>((b >> 16) & 0xFFFF);
      zm = fminf(zm, __half2float(__ushort_as_half(zbits)));
      atomicAdd(&h[s][0][(a >> 16) & 255], 1u);
      atomicAdd(&h[s][1][(a >> 8) & 255], 1u);
      atomicAdd(&h[s][2][a & 255], 1u);
    }
    cnt = warp_sum(cnt);
    road = warp_sum(road);
    dyn = warp_sum(dyn);
    inten = warp_sum64(inten);
    zm = warp_min(zm);
    if (lane == 0) {
      sums[4 * g + 0] = static_cast<float>(cnt);
      sums[4 * g + 1] = static_cast<float>(road);
      sums[4 * g + 2] = static_cast<float>(dyn);
      // Exact integer sum, rounded once: independent of row order.
      sums[4 * g + 3] = __double2float_rn(static_cast<double>(inten) * (1.0 / 65535.0));
      zmin[g] = zm;
    }
    lens[s] = static_cast<unsigned>(end - beg);
  }
  __syncwarp();

  for (int c = 0; c < kChannels; ++c) {
    float* per_group = meds + static_cast<size_t>(2 * c) * num_groups;
    float* pair = meds + static_cast<size_t>(2 * c + 1) * num_groups;
    for (int s = 0; s < nsplit; ++s) {
      const float m = median(h[s][c], nullptr, lane, lens[s]);
      if (lane == 0) per_group[g0 + s] = m;
    }
    if (nsplit == 2) {
      const float m = median(h[0][c], h[1][c], lane, lens[0] + lens[1]);
      if (lane == 0) {
        pair[g0] = m;
        pair[g0 + 1] = 0.0f;
      }
    } else if (lane == 0) {
      pair[g0] = 0.0f;
    }
  }
}

}  // namespace

// bounds: (num_groups + 1,) int32 run boundaries; w1, w2: sorted payload
// words; sums: (num_groups, 4), zmin: (num_groups,), meds: (3, 2,
// num_groups) float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int segmented_stats_words_launch(const int* bounds, const int* w1,
                                            const int* w2, int num_groups,
                                            int nsplit, float* sums,
                                            float* zmin, float* meds,
                                            void* stream) {
  if (nsplit < 1 || nsplit > kMaxSplit || num_groups % nsplit != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int num_cells = num_groups / nsplit;
  const int blocks = (num_cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    segmented_stats_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        bounds, w1, w2, num_cells, nsplit, num_groups, sums, zmin, meds);
  }
  return static_cast<int>(cudaGetLastError());
}
