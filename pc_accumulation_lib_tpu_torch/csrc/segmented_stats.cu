// Segmented per-group statistics over rows sorted by group key, for the BEV
// raster (pc_accumulation_lib_tpu_torch/ops/segmented_stats.py).
//
// One kernel body with two row loaders. It replaces the two Pallas TPU
// kernels of pc_accumulation_lib_tpu/ops/pallas_stats.py:
//   * WordsRows replaces _kernel_words (entry point segmented_stats_words):
//     each row is the two packed payload words of
//     ops/sort_raster.pack_payload_words, decoded here;
//   * FloatRows replaces _kernel (entry points window_stats and
//     segmented_stats): each row arrives unpacked, as up to 4 float32
//     weight rows, one float32 z row and up to 3 u8-valued float32 rows.
// Outputs, per group g:
//   sums[g][k] = sum over the group of weight k (words: count, road (w1
//                bit 25), dyn (w1 bit 24), intensity (w2 low 16 bits /
//                65535))
//   zmin[g]    = min of z over the group (words: w2's high 16 bits read as
//                float16)
//   meds[c][0][g] = exact median 0.5 * (v[(n-1)/2] + v[n/2]) of value c
//                (words: rgb bytes of w1, bits 23..16, 15..8, 7..0)
//   meds[c][1][2k] = the same median over the group pair (2k, 2k+1) when
//                pair medians are asked for (the 'full' split); 0 at odd
//                positions and otherwise
// Empty groups: sums 0, zmin +inf, medians 0.
//
// Design. Each group is a contiguous run of the sorted rows; the caller
// passes the run boundaries (bounds[g] = first row with key >= g, so keys
// >= num_groups are never read). One warp owns one cell, i.e. nsplit
// consecutive groups: its lanes stride over the cell's rows, accumulate
// the weights in float64 registers, reduce them with warp shuffles and
// round once, so a sum does not depend on the row order (the words'
// weights are integers, exact in float64) and build one 256-bin u32
// histogram per value and group in shared memory with shared atomics. The
// order statistics come from a warp prefix scan over the bins; the 'full'
// median reads the sum of the pair's two histograms. Nothing is carried
// between warps or blocks, so no block-level sync.
//
// Bound: bytes. Each row is read once (words: 12 B; float rows: 4 B per
// weight, z and value row, 36 B at the raster's 4 + 1 + 3 rows) and each
// group writes 4 B per output, so at the bench raster shape (860k rows,
// 131072 groups) the floor is ~15 MB (words) and ~37 MB (float rows) of
// HBM traffic. Empty groups skip the reduction, empty cells the histogram
// zeroing; they write their constants only.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSplit = 2;
constexpr int kMaxWeights = 4;
constexpr int kChannels = 3;
constexpr int kBins = 256;
constexpr int kBinsPerLane = kBins / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Row loader of the packed payload words (sort_raster.pack_payload_words).
struct WordsRows {
  const int* w1;
  const int* w2;

  __device__ __forceinline__ void load(int i, int /*n_weights*/, int /*n_values*/,
                                       double (&w)[kMaxWeights], float& z,
                                       int (&v)[kChannels]) const {
    const int a = w1[i];
    const int b = w2[i];
    w[0] = 1.0;
    w[1] = static_cast<double>((a >> 25) & 1);
    w[2] = static_cast<double>((a >> 24) & 1);
    w[3] = static_cast<double>(b & 0xFFFF);
    const unsigned short zbits = static_cast<unsigned short>((b >> 16) & 0xFFFF);
    z = __half2float(__ushort_as_half(zbits));
    v[0] = (a >> 16) & 255;
    v[1] = (a >> 8) & 255;
    v[2] = a & 255;
  }

  // The intensity word holds u16 units of 1/65535.
  __device__ __forceinline__ double scale(int k) const {
    return k == 3 ? 1.0 / 65535.0 : 1.0;
  }
};

// Row loader of unpacked float32 rows: weights (n_weights, n), z (n,),
// values (n_values, n), row-major.
struct FloatRows {
  const float* weights;
  const float* z;
  const float* values;
  int n;

  __device__ __forceinline__ void load(int i, int n_weights, int n_values,
                                       double (&w)[kMaxWeights], float& zi,
                                       int (&v)[kChannels]) const {
    for (int k = 0; k < kMaxWeights; ++k) {
      w[k] = k < n_weights ? static_cast<double>(weights[static_cast<size_t>(k) * n + i]) : 0.0;
    }
    zi = z[i];
    // Truncated toward zero like the TPU kernel's int cast; a value outside
    // [0, 256) matches no bin and is skipped by the caller.
    for (int c = 0; c < kChannels; ++c) {
      v[c] = c < n_values ? __float2int_rz(values[static_cast<size_t>(c) * n + i]) : -1;
    }
  }

  __device__ __forceinline__ double scale(int) const { return 1.0; }
};

// Value at rank k (0-based) of the multiset whose histogram is h0 (+ h1 when
// h1 is not null): the bin b with cum[b-1] <= k < cum[b]; kBins when k is
// not below the histogram total (values outside the bins). All 32 lanes
// must call it.
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
  return found < 0 ? kBins : found;
}

__device__ float median(const unsigned* h0, const unsigned* h1, int lane,
                        unsigned n) {
  if (n == 0) return 0.0f;
  const int v1 = value_at_rank(h0, h1, lane, (n - 1) / 2);
  const int v2 = value_at_rank(h0, h1, lane, n / 2);
  return 0.5f * (static_cast<float>(v1) + static_cast<float>(v2));
}

// nsplit groups per cell (2 only for pair medians); sums is (num_groups,
// n_weights), meds (n_values, 2, num_groups) and unused when n_values == 0.
template <class Rows>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segmented_stats_kernel(const int* __restrict__ bounds, Rows rows,
                       int num_cells, int nsplit, int n_weights, int n_values,
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
  if (occupied && n_values > 0) {
    unsigned* flat = &h[0][0][0];
    for (int i = lane; i < nsplit * kChannels * kBins; i += 32) flat[i] = 0u;
    __syncwarp();
  }

  unsigned lens[kMaxSplit] = {0u, 0u};
  for (int s = 0; s < nsplit; ++s) {
    const int g = g0 + s;
    const int beg = bounds[g];
    const int end = bounds[g + 1];
    lens[s] = static_cast<unsigned>(end - beg);
    if (beg == end) {  // warp-uniform
      if (lane < n_weights) sums[static_cast<size_t>(g) * n_weights + lane] = 0.0f;
      if (lane == 0) zmin[g] = INFINITY;
      continue;
    }
    double acc[kMaxWeights] = {0.0, 0.0, 0.0, 0.0};
    float zm = INFINITY;
    for (int i = beg + lane; i < end; i += 32) {
      double w[kMaxWeights];
      float z;
      int v[kChannels];
      rows.load(i, n_weights, n_values, w, z, v);
      for (int k = 0; k < kMaxWeights; ++k) acc[k] += w[k];
      zm = fminf(zm, z);
      for (int c = 0; c < n_values; ++c) {
        if (v[c] >= 0 && v[c] < kBins) atomicAdd(&h[s][c][v[c]], 1u);
      }
    }
    for (int k = 0; k < kMaxWeights; ++k) acc[k] = warp_sum(acc[k]);
    zm = warp_min(zm);
    if (lane == 0) {
      for (int k = 0; k < n_weights; ++k) {
        // One rounding of the float64 sum: independent of row order.
        sums[static_cast<size_t>(g) * n_weights + k] =
            __double2float_rn(acc[k] * rows.scale(k));
      }
      zmin[g] = zm;
    }
  }
  __syncwarp();

  for (int c = 0; c < n_values; ++c) {
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

template <class Rows>
int launch(const int* bounds, Rows rows, int num_groups, int nsplit,
           int n_weights, int n_values, float* sums, float* zmin, float* meds,
           void* stream) {
  if (nsplit < 1 || nsplit > kMaxSplit || num_groups % nsplit != 0 ||
      n_weights < 0 || n_weights > kMaxWeights || n_values < 0 ||
      n_values > kChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int num_cells = num_groups / nsplit;
  const int blocks = (num_cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    segmented_stats_kernel<Rows><<<blocks, kWarpsPerBlock * 32, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        bounds, rows, num_cells, nsplit, n_weights, n_values, num_groups,
        sums, zmin, meds);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bounds: (num_groups + 1,) int32 run boundaries; w1, w2: sorted payload
// words; sums: (num_groups, 4), zmin: (num_groups,), meds: (3, 2,
// num_groups) float32, written only when n_values is 3 (0 skips the
// medians). nsplit 2 adds the pair medians. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int segmented_stats_words_launch(const int* bounds, const int* w1,
                                            const int* w2, int num_groups,
                                            int nsplit, int n_values,
                                            float* sums, float* zmin,
                                            float* meds, void* stream) {
  if (n_values != 0 && n_values != kChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(bounds, WordsRows{w1, w2}, num_groups, nsplit, kMaxWeights,
                n_values, sums, zmin, meds, stream);
}

// bounds: (num_groups + 1,) int32 run boundaries; weights: (n_weights, n),
// z: (n,), values: (n_values, n) float32 rows in sorted order; sums:
// (num_groups, n_weights), zmin: (num_groups,), meds: (n_values, 2,
// num_groups) float32. nsplit 2 adds the pair medians. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int segmented_stats_rows_launch(const int* bounds,
                                           const float* weights,
                                           int n_weights, const float* z,
                                           const float* values, int n_values,
                                           int n, int num_groups, int nsplit,
                                           float* sums, float* zmin,
                                           float* meds, void* stream) {
  return launch(bounds, FloatRows{weights, z, values, n}, num_groups, nsplit,
                n_weights, n_values, sums, zmin, meds, stream);
}
