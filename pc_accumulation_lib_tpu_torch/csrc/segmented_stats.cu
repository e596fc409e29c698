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
//     weight rows, one float32 z row and up to 3 u8-valued float32 rows,
//     read where the caller holds them.
// Outputs, per group g:
//   sums[g][k] = sum over the group of weight k (words: count, road (w1
//                bit 25), dyn (w1 bit 24), intensity (w2 low 16 bits /
//                65535))
//   zmin[g]    = min of z over the group (words: w2's high 16 bits read as
//                float16)
//   meds[c][0][g] = exact median 0.5 * (v[(n-1)/2] + v[n/2]) of value c
//                (words: rgb bytes of w1, bits 23..16, 15..8, 7..0) over
//                the group's rows whose value lies in [0, 256) after
//                truncation toward zero (words: all of them)
//   meds[c][1][2k] = the same median over the group pair (2k, 2k+1) when
//                pair medians are asked for (nsplit 2); 0 at odd positions
//                and otherwise
// Empty groups: sums 0, zmin +inf, medians 0.
//
// Bound: bytes. The least traffic is the key and payload of each keyed row
// read once (words 12 B, float rows 4 B per row read) and 4 B per output
// written once; sentinel rows (keys >= num_groups) need not be read. At
// the made-up bench raster (645k keyed rows, 131,072 groups) that is
// 13.5 MB, 4.0 us at 3.35 TB/s. The rows are L2-resident at these sizes
// (the sort before the stats stage has just written them); what costs is
// the chain of warp reductions per cell and the warps left with the most
// cells. The design (PERF.md, section 6, has the measurements behind it):
//   * One launch, no group bounds from the caller, a persistent grid sized
//     to the SMs' occupancy. The keyed rows fall into chunks of 32; block b
//     owns chunks b, b + gridDim.x, ..., and its warps draw them one at a
//     time from a shared counter. A warp owns the cells (nsplit consecutive
//     groups) that start in its chunks.
//   * A cell starts a window: the warp reads the 128 keys and the first 32
//     rows from the cell's start at once and finds the cell's end and
//     split by ballots. A cell of up to kMaxRegRows (127) rows is computed
//     from registers (its other rows read when it has more than 32),
//     while the next cell's window is read. A longer cell finds its end
//     by a galloping warp search, sums its rows per group and
//     builds 256-bin u32 histograms of all three channels in one pass, in
//     dynamic shared memory (none when no medians are asked for); one warp
//     scan per histogram yields both middle ranks.
//   * Empty cells cost no search: the owner of an occupied cell writes the
//     empty cells between it and the previous occupied one, and all warps
//     write the cells before the first and after the last occupied one,
//     with vector stores.
//   * Sums are reduced once per group with warp reductions: integer redux
//     for the words' counts, flags and (in a register cell) intensity, 64
//     bits for a longer cell's intensity (exact), float64 for the float
//     rows, rounded once to float32.
//   * Register medians: each row's three u8 values sit in the bytes of one
//     u32, and a radix select walks the 8 bits from the top: per bit one
//     warp reduction counts, in three byte fields at once, the candidates
//     of every channel whose bit is 0, and byte-wise arithmetic picks each
//     channel's bit. The group, the other group and the pair run in the
//     same loop. The second middle rank, when it differs, is the first
//     rank's value or the least value above it.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMinBlocksPerSM = 3;  // at most 80 registers per thread
constexpr int kMaxSplit = 2;
constexpr int kMaxWeights = 4;
constexpr int kChannels = 3;
constexpr int kBins = 256;
constexpr int kBinsPerLane = kBins / 32;
constexpr int kWindow = 4;  // keys and rows read per lane from a cell start
// Cells of up to this many rows are computed from registers, longer ones
// from shared-memory histograms: the most whose counts fit a byte's 7 bits.
constexpr int kMaxRegRows = 32 * kWindow - 1;
// Window slots whose rows are read with the keys; the others only for a
// cell longer than 32 * kEagerSlots rows.
constexpr int kEagerSlots = 1;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kOnes = 0x00010101u;  // bit 0 of each channel's byte
constexpr int kInfKey = 0x7f800000;  // float_key(+inf)
constexpr int kMaxDevices = 64;
constexpr int kChunkRows = 32;  // keyed rows per drawn chunk

// Order-preserving int of a float (-0 below +0): min over the keys is the
// min over the floats, exact for subnormals.
__device__ __forceinline__ int float_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// float_key of the float16 in the payload word's high half.
__device__ __forceinline__ int half_key(unsigned w2) {
  return float_key(
      __half2float(__ushort_as_half(static_cast<unsigned short>(w2 >> 16))));
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// First index in [lo, hi) whose key is >= target, hi if none; keys
// ascending and keys[lo - 1] < target. All 32 lanes call it with the same
// arguments. Each round probes lo, lo + stride, ..., lo + 31 * stride and
// keeps the gap that holds the answer: stride 1 gallops up from lo, a
// stride of (hi - lo) / 32 splits the whole range at once.
__device__ int warp_lower_bound(const int* __restrict__ keys, int lo, int hi,
                                int target, int stride, int lane) {
  for (;;) {
    const long long p = static_cast<long long>(lo) +
                        static_cast<long long>(lane) * stride;
    const bool ge = p >= hi || __ldg(keys + p) >= target;
    const unsigned m = __ballot_sync(kFullMask, ge);
    if (m == 0u) {  // every probe below target
      lo += 31 * stride + 1;
      stride = static_cast<int>(min(32LL * stride,
                                    static_cast<long long>((hi - lo) / 32 + 1)));
      continue;
    }
    const int f = __ffs(m) - 1;
    if (f == 0) return lo;
    const int hit = lo + f * stride;  // keys[hit] >= target (or hit >= hi)
    if (stride == 1) return min(hit, hi);
    lo = lo + (f - 1) * stride + 1;
    hi = min(hit, hi);
    stride = (stride + 31) / 32;
  }
}

__device__ __forceinline__ int split_stride(int len) {
  return max(1, (len + 31) / 32);
}

// pos + the first window index whose key is >= target, -1 if none; the
// window holds keys pos + r * 32 + lane.
__device__ __forceinline__ int window_first(const int (&kw)[kWindow],
                                            int target, int pos) {
#pragma unroll
  for (int r = 0; r < kWindow; ++r) {
    const unsigned m = __ballot_sync(kFullMask, kw[r] >= target);
    if (m != 0u) return pos + r * 32 + __ffs(m) - 1;
  }
  return -1;
}

struct Out {
  float* sums;  // (num_groups, n_weights)
  float* zmin;  // (num_groups,)
  float* meds;  // (n_values, 2, num_groups)
  int num_groups;
  int n_weights;
  int n_values;
};

// Row loader of the packed payload words (sort_raster.pack_payload_words).
struct WordsRows {
  const int* w1;
  const int* w2;

  struct Row {
    int a;
    unsigned b;
  };

  // A register cell's group sums: road and dyn flags in the low and high
  // halves of one word, intensity in u16 units (< 2^32 for <= 127 rows).
  struct Acc {
    unsigned flags = 0u, inten = 0u;
    int zk = kInfKey;

    __device__ __forceinline__ void add(const Row& row, bool take) {
      if (!take) return;
      flags += ((row.a >> 25) & 1) | (((row.a >> 24) & 1) << 16);
      inten += row.b & 0xffffu;
      zk = min(zk, half_key(row.b));
    }

    // Group g0's sums (and g0 + 1's, nsplit 2) of a register cell.
    __device__ __forceinline__ static void write_cell(
        const Out& out, int g0, int nsplit, const Acc& a0, const Acc& a1,
        int n0, int n1, int lane) {
      a0.write(out, g0, n0, lane);
      if (nsplit == 2) a1.write(out, g0 + 1, n1, lane);
    }

    __device__ __forceinline__ void write(const Out& out, int g, int count,
                                          int lane) const {
      const unsigned f = __reduce_add_sync(kFullMask, flags);
      const unsigned s = __reduce_add_sync(kFullMask, inten);
      const int z = __reduce_min_sync(kFullMask, zk);
      if (lane == 0) {
        reinterpret_cast<float4*>(out.sums)[g] = make_float4(
            static_cast<float>(count), static_cast<float>(f & 0xffffu),
            static_cast<float>(f >> 16),
            __double2float_rn(static_cast<double>(s) * (1.0 / 65535.0)));
        out.zmin[g] = key_float(z);
      }
    }
  };

  __device__ Row load(int i, const Out&) const {
    return Row{__ldg(w1 + i), static_cast<unsigned>(__ldg(w2 + i))};
  }

  // The row's three u8 values in bytes 2, 1, 0; `valid` gets kOnes' bit
  // for each channel that holds a value.
  __device__ static unsigned packed(const Row& row, const Out&,
                                    unsigned& valid) {
    valid = kOnes;
    return static_cast<unsigned>(row.a);
  }

  // Sums and z-min of rows [beg, end) into group g. All lanes call it.
  __device__ void group_sums(int beg, int end, int lane, const Out& out,
                             int g) const {
    unsigned road = 0, dyn = 0;
    unsigned long long inten = 0ull;
    int zk = kInfKey;
#pragma unroll 4
    for (int i = beg + lane; i < end; i += 32) {
      const int a = __ldg(w1 + i);
      const unsigned b = static_cast<unsigned>(__ldg(w2 + i));
      road += (a >> 25) & 1;
      dyn += (a >> 24) & 1;
      inten += b & 0xffffu;
      zk = min(zk, half_key(b));
    }
    road = __reduce_add_sync(kFullMask, road);
    dyn = __reduce_add_sync(kFullMask, dyn);
    inten = warp_sum(inten);
    zk = __reduce_min_sync(kFullMask, zk);
    if (lane == 0) {
      // The intensity word holds u16 units of 1/65535: one rounding of
      // the exact integer sum, as the plain version takes it.
      reinterpret_cast<float4*>(out.sums)[g] = make_float4(
          static_cast<float>(end - beg), static_cast<float>(road),
          static_cast<float>(dyn),
          __double2float_rn(static_cast<double>(inten) * (1.0 / 65535.0)));
      out.zmin[g] = key_float(zk);
    }
  }

  // Row i's packed values (as packed()).
  __device__ unsigned values(int i, const Out&, unsigned& valid) const {
    valid = kOnes;
    return static_cast<unsigned>(__ldg(w1 + i));
  }
};

// Row loader of unpacked float32 rows, each a separate (n,) array.
struct FloatRows {
  const float* w[kMaxWeights];
  const float* z;
  const float* v[kChannels];

  struct Row {
    float w[kMaxWeights];
    float z;
    float v[kChannels];
  };

  // Sums in float64, rounded once when written.
  struct Acc {
    double s[kMaxWeights] = {0.0, 0.0, 0.0, 0.0};
    int zk = kInfKey;

    __device__ __forceinline__ void add(const Row& row, bool take) {
      if (!take) return;
#pragma unroll
      for (int k = 0; k < kMaxWeights; ++k) s[k] += static_cast<double>(row.w[k]);
      zk = min(zk, float_key(row.z));
    }

    // Group g0's sums (and g0 + 1's, nsplit 2) of a register cell: the
    // eight float64 sums are reduced together, halving the values each
    // lane holds at each of the first three steps (9 shuffles, not 40);
    // then lane 16 * group + 4 * k holds weight k's sum of the group.
    __device__ __forceinline__ static void write_cell(
        const Out& out, int g0, int nsplit, const Acc& a0, const Acc& a1,
        int /*n0*/, int /*n1*/, int lane) {
      double u[4], w[2];
      const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double send = b4 ? a0.s[j] : a1.s[j];
        u[j] = (b4 ? a1.s[j] : a0.s[j]) + __shfl_xor_sync(kFullMask, send, 16);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double send = b3 ? u[j] : u[j + 2];
        w[j] = (b3 ? u[j + 2] : u[j]) + __shfl_xor_sync(kFullMask, send, 8);
      }
      double x = (b2 ? w[1] : w[0]) +
                 __shfl_xor_sync(kFullMask, b2 ? w[0] : w[1], 4);
      x += __shfl_xor_sync(kFullMask, x, 2);
      x += __shfl_xor_sync(kFullMask, x, 1);
      const int z0 = __reduce_min_sync(kFullMask, a0.zk);
      const int z1 = __reduce_min_sync(kFullMask, a1.zk);
      const int grp = lane >> 4, k = (lane >> 2) & 3;
      if ((lane & 3) == 0 && k < out.n_weights && (grp == 0 || nsplit == 2)) {
        // One rounding of the float64 sum.
        out.sums[static_cast<size_t>(g0 + grp) * out.n_weights + k] =
            __double2float_rn(x);
      }
      if (lane == 0) {
        out.zmin[g0] = key_float(z0);
        if (nsplit == 2) out.zmin[g0 + 1] = key_float(z1);
      }
    }
  };

  __device__ __forceinline__ static void write_sums(const Out& out, int g,
                                    const double (&acc)[kMaxWeights], int zk,
                                    int lane) {
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < kMaxWeights; ++k) {
      if (k < out.n_weights) {
        const double t = warp_sum(acc[k]);
        if (lane == k) a = t;
      }
    }
    zk = __reduce_min_sync(kFullMask, zk);
    if (lane < out.n_weights) {
      // One rounding of the float64 sum: independent of row order.
      out.sums[static_cast<size_t>(g) * out.n_weights + lane] =
          __double2float_rn(a);
    }
    if (lane == 0) out.zmin[g] = key_float(zk);
  }

  __device__ Row load(int i, const Out& out) const {
    Row row;
#pragma unroll
    for (int k = 0; k < kMaxWeights; ++k) {
      row.w[k] = k < out.n_weights ? __ldg(w[k] + i) : 0.0f;
    }
    row.z = __ldg(z + i);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      row.v[c] = c < out.n_values ? __ldg(v[c] + i) : -1.0f;
    }
    return row;
  }

  // Truncated toward zero like the TPU kernel's int cast; a value outside
  // [0, 256) is not part of the median.
  __device__ static int to_bin(float f) {
    const int t = __float2int_rz(f);
    return t >= 0 && t < kBins ? t : -1;
  }

  __device__ static unsigned packed(const Row& row, const Out&,
                                    unsigned& valid) {
    unsigned x = 0u;
    valid = 0u;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const int t = to_bin(row.v[c]);
      if (t >= 0) {
        const int sh = 8 * (2 - c);
        x |= static_cast<unsigned>(t) << sh;
        valid |= 1u << sh;
      }
    }
    return x;
  }

  __device__ void group_sums(int beg, int end, int lane, const Out& out,
                             int g) const {
    double acc[kMaxWeights] = {0.0, 0.0, 0.0, 0.0};
    int zk = kInfKey;
#pragma unroll 4
    for (int i = beg + lane; i < end; i += 32) {
#pragma unroll
      for (int k = 0; k < kMaxWeights; ++k) {
        if (k < out.n_weights) acc[k] += static_cast<double>(__ldg(w[k] + i));
      }
      zk = min(zk, float_key(__ldg(z + i)));
    }
    write_sums(out, g, acc, zk, lane);
  }

  __device__ unsigned values(int i, const Out& out, unsigned& valid) const {
    Row row;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      row.v[c] = c < out.n_values ? __ldg(v[c] + i) : -1.0f;
    }
    return packed(row, out, valid);
  }
};

// Multiset m of a register cell: M == 1, the cell's one group; M == 3,
// the first group, the second, and the pair.
template <int M>
__device__ __forceinline__ bool member(int m, bool in_first) {
  return M == 1 || m == 2 || (m == 0) == in_first;
}

// Medians of M multisets of a register cell (<= 127 rows). x[r] holds the
// packed values of the warp's slot r * 32 + lane, valid[r] kOnes' bits of
// its channels that hold a value (0 for a slot past the cell's end),
// in_first[r] whether the slot's row is in the cell's first group.
template <int R, int M>
__device__ __forceinline__ void radix_medians(const unsigned (&x)[R],
                                              const unsigned (&valid)[R],
                                              const bool (&in_first)[R],
                                              float (&med)[M][kChannels]) {
  unsigned cand[M][R];
  unsigned cnt[M], k[M], res[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    unsigned s = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cand[m][r] = member<M>(m, in_first[r]) ? valid[r] : 0u;
      s += cand[m][r];
    }
    cnt[m] = __reduce_add_sync(kFullMask, s);  // per-channel counts, bytewise
    // Rank (n - 1) / 2 in each byte (0 where n is 0).
    const unsigned nonzero = ((cnt[m] | 0x80808080u) - kOnes) & 0x00808080u;
    const unsigned n1 = cnt[m] + ((~nonzero >> 7) & kOnes);
    k[m] = ((n1 - kOnes) >> 1) & 0x007f7f7fu;
    res[m] = 0u;
  }
  // Radix select of rank k, high bit first: candidates share the chosen
  // prefix; zc counts those whose next bit is 0. Bytes never borrow: every
  // count and rank is below 128. Kept rolled: unrolled, the kernel's code
  // outgrows the instruction caches and runs slower.
#pragma unroll 1
  for (int bit = 7; bit >= 0; --bit) {
    unsigned t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[r] = x[r] >> bit;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      unsigned z = 0u;
#pragma unroll
      for (int r = 0; r < R; ++r) z += ~t[r] & cand[m][r];
      const unsigned zc = __reduce_add_sync(kFullMask, z);
      const unsigned below = ((zc | 0x80808080u) - k[m] - kOnes) & 0x00808080u;
      const unsigned one = (~below >> 7) & kOnes;  // k >= zc: the bit is 1
      k[m] -= zc & (one * 0xffu);
      res[m] |= one << bit;
#pragma unroll
      for (int r = 0; r < R; ++r) cand[m][r] &= ~(t[r] ^ one);
    }
  }
  // cand now marks each channel's rows equal to its rank-k value, and k is
  // the rank among them. Rank n / 2 is the same value while it stays in
  // that run, else the least value above it.
#pragma unroll
  for (int m = 0; m < M; ++m) {
    unsigned s = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) s += cand[m][r];
    const unsigned eq = __reduce_add_sync(kFullMask, s);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const int sh = 8 * (2 - c);
      const unsigned n = (cnt[m] >> sh) & 0xffu;
      const int v1 = static_cast<int>((res[m] >> sh) & 0xffu);
      // Reduced whether needed or not: the nine reductions then overlap.
      int lo = kBins;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int v = static_cast<int>((x[r] >> sh) & 0xffu);
        if (member<M>(m, in_first[r]) && ((valid[r] >> sh) & 1u) && v > v1) {
          lo = min(lo, v);
        }
      }
      lo = __reduce_min_sync(kFullMask, lo);
      const bool next = (n & 1u) == 0u &&
                        ((k[m] >> sh) & 0xffu) + 1u >= ((eq >> sh) & 0xffu);
      const int v2 = next ? lo : v1;
      med[m][c] = n == 0u ? 0.0f
                          : 0.5f * (static_cast<float>(v1) + static_cast<float>(v2));
    }
  }
}

// The cell's medians into the output: per group g0 (and g0 + 1), the pair
// at g0 and 0 at g0 + 1 (nsplit 2), or 0 (nsplit 1). Lane 0 writes.
__device__ __forceinline__ void write_medians(const Out& out, int g0,
                                              int nsplit,
                                              const float (&mg0)[kChannels],
                                              const float (&mg1)[kChannels],
                                              const float (&mp)[kChannels]) {
  const size_t G = static_cast<size_t>(out.num_groups);
  for (int c = 0; c < out.n_values; ++c) {
    float* per_group = out.meds + 2 * c * G;
    float* pair = out.meds + (2 * c + 1) * G;
    if (nsplit == 2) {
      *reinterpret_cast<float2*>(per_group + g0) = make_float2(mg0[c], mg1[c]);
      *reinterpret_cast<float2*>(pair + g0) = make_float2(mp[c], 0.0f);
    } else {
      per_group[g0] = mg0[c];
      pair[g0] = 0.0f;
    }
  }
}

// All statistics of a cell of at most 32 * R rows [b, e), group g0's in
// [b, mid), from its rows already in registers: rw[r] holds row
// b + r * 32 + lane.
template <int R, class Rows>
__device__ __forceinline__ void register_cell(
    const Out& out, int g0, int b, int mid, int e, int nsplit, int lane,
    const typename Rows::Row (&rw)[kWindow]) {
  typename Rows::Acc acc0, acc1;
  unsigned x[R], valid[R];
  bool in_first[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = b + r * 32 + lane;
    x[r] = 0u;
    valid[r] = 0u;
    in_first[r] = i < mid;
    if (i < e) {
      acc0.add(rw[r], i < mid);
      acc1.add(rw[r], i >= mid);
      x[r] = Rows::packed(rw[r], out, valid[r]);
      if (out.n_values == 0) valid[r] = 0u;
    }
  }
  Rows::Acc::write_cell(out, g0, nsplit, acc0, acc1, mid - b, e - mid, lane);
  if (out.n_values == 0) return;
  if (nsplit == 2) {
    float med[3][kChannels];
    radix_medians<R, 3>(x, valid, in_first, med);
    if (lane == 0) write_medians(out, g0, 2, med[0], med[1], med[2]);
  } else {
    float med[1][kChannels];
    radix_medians<R, 1>(x, valid, in_first, med);
    if (lane == 0) write_medians(out, g0, 1, med[0], med[0], med[0]);
  }
}

// Median of the multiset whose histogram is h0 (+ h1 when h1 is not null),
// 0 when it is empty: one warp scan over the bins yields both ranks. All
// lanes call it.
__device__ float hist_median(const unsigned* h0, const unsigned* h1,
                             int lane) {
  unsigned local[kBinsPerLane];
  const uint4* a = reinterpret_cast<const uint4*>(h0) + lane * 2;
  uint4 p = a[0], q = a[1];
  if (h1 != nullptr) {
    const uint4* b = reinterpret_cast<const uint4*>(h1) + lane * 2;
    const uint4 s = b[0], t = b[1];
    p.x += s.x; p.y += s.y; p.z += s.z; p.w += s.w;
    q.x += t.x; q.y += t.y; q.z += t.z; q.w += t.w;
  }
  local[0] = p.x; local[1] = p.y; local[2] = p.z; local[3] = p.w;
  local[4] = q.x; local[5] = q.y; local[6] = q.z; local[7] = q.w;
  unsigned s = 0u;
#pragma unroll
  for (int i = 0; i < kBinsPerLane; ++i) s += local[i];
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += t;
  }
  const unsigned total = __shfl_sync(kFullMask, incl, 31);
  if (total == 0u) return 0.0f;
  const unsigned k1 = (total - 1u) / 2u, k2 = total / 2u;
  unsigned run = incl - s;
  int f1 = -1, f2 = -1;
#pragma unroll
  for (int i = 0; i < kBinsPerLane; ++i) {
    const unsigned next = run + local[i];
    if (k1 >= run && k1 < next) f1 = lane * kBinsPerLane + i;
    if (k2 >= run && k2 < next) f2 = lane * kBinsPerLane + i;
    run = next;
  }
  f1 = __reduce_max_sync(kFullMask, f1);
  f2 = __reduce_max_sync(kFullMask, f2);
  return 0.5f * (static_cast<float>(f1) + static_cast<float>(f2));
}

// All statistics of a cell too long for registers, rows [b, e), group
// g0's in [b, mid): sums read per group, then one pass over the rows that
// fills every channel's histogram of each group in the warp's shared
// memory (hist[(split * 3 + channel) * 256 + value]).
template <class Rows>
__device__ void histogram_cell(const Rows& rows, const Out& out, int g0, int b,
                               int mid, int e, int nsplit, unsigned* hist,
                               int lane) {
  rows.group_sums(b, mid, lane, out, g0);
  if (nsplit == 2) rows.group_sums(mid, e, lane, out, g0 + 1);
  if (out.n_values == 0) return;
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  for (int i = lane; i < nsplit * kChannels * kBins / 4; i += 32) {
    h4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncwarp();
#pragma unroll 4
  for (int i = b + lane; i < e; i += 32) {
    unsigned valid;
    const unsigned x = rows.values(i, out, valid);
    unsigned* h = hist + (i >= mid ? kChannels * kBins : 0);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const int sh = 8 * (2 - c);
      if ((valid >> sh) & 1u) atomicAdd(h + c * kBins + ((x >> sh) & 0xffu), 1u);
    }
  }
  __syncwarp();
  float mg[kMaxSplit][kChannels] = {}, mp[kChannels] = {};
  for (int c = 0; c < out.n_values; ++c) {
    const unsigned* h0 = hist + c * kBins;
    const unsigned* h1 = h0 + kChannels * kBins;
    mg[0][c] = hist_median(h0, nullptr, lane);
    if (nsplit == 2) {
      mg[1][c] = hist_median(h1, nullptr, lane);
      mp[c] = hist_median(h0, h1, lane);
    }
  }
  __syncwarp();
  if (lane == 0) write_medians(out, g0, nsplit, mg[0], mg[1], mp);
}

// Constants of an empty cell, written by one lane.
__device__ void write_empty_cell(const Out& out, int cell, int nsplit) {
  const int g0 = cell * nsplit;
  const size_t G = static_cast<size_t>(out.num_groups);
  if (out.n_weights == kMaxWeights) {
    for (int s = 0; s < nsplit; ++s) {
      reinterpret_cast<float4*>(out.sums)[g0 + s] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int k = 0; k < nsplit * out.n_weights; ++k) {
      out.sums[static_cast<size_t>(g0) * out.n_weights + k] = 0.0f;
    }
  }
  if (nsplit == 2) {
    *reinterpret_cast<float2*>(out.zmin + g0) = make_float2(INFINITY, INFINITY);
    for (int c = 0; c < 2 * out.n_values; ++c) {
      *reinterpret_cast<float2*>(out.meds + c * G + g0) = make_float2(0.f, 0.f);
    }
  } else {
    out.zmin[g0] = INFINITY;
    for (int c = 0; c < 2 * out.n_values; ++c) out.meds[c * G + g0] = 0.0f;
  }
}

// Rows pos + r * 32 + lane of a window for slots r in [R0, R1) (zeros
// from `last` on).
template <int R0, int R1, class Rows>
__device__ __forceinline__ void load_rows(const Rows& rows, const Out& out,
                                          int pos, int last, int lane,
                                          typename Rows::Row (&rw)[kWindow]) {
#pragma unroll
  for (int r = R0; r < R1; ++r) {
    const int i = pos + r * 32 + lane;
    rw[r] = i < last ? rows.load(i, out) : typename Rows::Row{};
  }
}

// The keys pos + r * 32 + lane of a window (INT_MAX from `last` on) and
// the rows of its first kEagerSlots slots.
template <class Rows>
__device__ __forceinline__ void load_window(const int* __restrict__ keys,
                                            const Rows& rows, const Out& out,
                                            int pos, int last, int lane,
                                            int (&kw)[kWindow],
                                            typename Rows::Row (&rw)[kWindow]) {
#pragma unroll
  for (int r = 0; r < kWindow; ++r) {
    const int i = pos + r * 32 + lane;
    kw[r] = i < last ? __ldg(keys + i) : INT_MAX;
  }
  load_rows<0, kEagerSlots>(rows, out, pos, last, lane, rw);
}

// The cells that start in keyed rows [s, s_end) and the empty cells
// before each of them. Each cell starts a window of 128 keys and rows read
// at once; a register cell's successor's window is read before the cell is
// computed, so the two overlap.
template <class Rows>
__device__ void process_chunk(const int* __restrict__ keys, int s, int s_end,
                              int first, int last, const Rows& rows,
                              const Out& out, int nsplit, unsigned* hist,
                              int lane) {
  int pos = s, prev = -1;
  if (s > first) {
    prev = __ldg(keys + s - 1) / nsplit;
    if (__ldg(keys + s) / nsplit == prev) {
      pos = warp_lower_bound(keys, s, last, (prev + 1) * nsplit, 1, lane);
    }
  }
  if (pos >= s_end) return;
  int kw[kWindow];
  typename Rows::Row rw[kWindow];
  load_window(keys, rows, out, pos, last, lane, kw, rw);
  for (;;) {
    const int cell = __shfl_sync(kFullMask, kw[0], 0) / nsplit;
    const int g0 = cell * nsplit;
    int e = window_first(kw, g0 + nsplit, pos);
    int mid = nsplit == 2 ? window_first(kw, g0 + 1, pos) : e;
    if (prev >= 0) {
      for (int c = prev + 1 + lane; c < cell; c += 32) write_empty_cell(out, c, nsplit);
    }
    const int len = e - pos;
    if (e >= 0 && len <= kMaxRegRows) {
      int nkw[kWindow];
      typename Rows::Row nrw[kWindow];
      if (e < s_end) load_window(keys, rows, out, e, last, lane, nkw, nrw);
      // Two register widths only: each is inlined whole, and more of them
      // cost more in instruction fetch than the idle slots they save.
      if (len <= 32 * kEagerSlots) {
        register_cell<kEagerSlots, Rows>(out, g0, pos, mid, e, nsplit, lane,
                                         rw);
      } else {
        load_rows<kEagerSlots, kWindow>(rows, out, pos, last, lane, rw);
        register_cell<kWindow, Rows>(out, g0, pos, mid, e, nsplit, lane, rw);
      }
      if (e >= s_end) return;
#pragma unroll
      for (int r = 0; r < kWindow; ++r) {
        kw[r] = nkw[r];
        rw[r] = nrw[r];
      }
    } else {
      const int past = pos + 32 * kWindow;  // keys below here are in kw
      if (e < 0) e = warp_lower_bound(keys, past, last, g0 + nsplit, 1, lane);
      if (nsplit == 1) {
        mid = e;
      } else if (mid < 0) {
        mid = warp_lower_bound(keys, past, e, g0 + 1, 1, lane);
      }
      histogram_cell(rows, out, g0, pos, mid, e, nsplit, hist, lane);
      if (e >= s_end) return;
      load_window(keys, rows, out, e, last, lane, kw, rw);
    }
    prev = cell;
    pos = e;
  }
}

// nsplit groups per cell (2 only for pair medians); see the design note at
// the top.
template <class Rows>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSM)
segmented_stats_kernel(const int* __restrict__ keys, int n, Rows rows,
                       Out out, int nsplit) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int warp_in_block = threadIdx.x >> 5;
  const int warp = blockIdx.x * kWarpsPerBlock + warp_in_block;
  const int num_warps = gridDim.x * kWarpsPerBlock;
  unsigned* hist = smem + warp_in_block * nsplit * kChannels * kBins;
  const int num_cells = out.num_groups / nsplit;

  const int first = warp_lower_bound(keys, 0, n, 0, 1, lane);
  const int last = warp_lower_bound(keys, first, n, out.num_groups,
                                    split_stride(n - first), lane);

  // Cells before the first occupied one and after the last, grid-strided.
  const int c_first = first < last ? __ldg(keys + first) / nsplit : num_cells;
  const int c_last = first < last ? __ldg(keys + last - 1) / nsplit : num_cells - 1;
  const int n_outer = c_first + (num_cells - 1 - c_last);
  for (int i = warp * 32 + lane; i < n_outer; i += num_warps * 32) {
    write_empty_cell(out, i < c_first ? i : c_last + 1 + (i - c_first), nsplit);
  }

  // The keyed rows fall into chunks of kChunkRows. Block b owns chunks b,
  // b + gridDim.x, b + 2 * gridDim.x, ..., so a dense stretch of small
  // cells spreads over many blocks; its warps draw the block's chunks one
  // at a time from a shared counter, so a warp whose cells are slow draws
  // fewer. A split fixed per warp left the launch waiting on the warps
  // that got the most cells.
  __shared__ int drawn;
  if (threadIdx.x == 0) drawn = 0;
  __syncthreads();
  const int num_chunks = (last - first + kChunkRows - 1) / kChunkRows;
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(&drawn, 1);
    const long long chunk = blockIdx.x + static_cast<long long>(
        __shfl_sync(kFullMask, j, 0)) * gridDim.x;
    if (chunk >= num_chunks) break;
    const int s = first + static_cast<int>(chunk) * kChunkRows;
    process_chunk(keys, s, min(last, s + kChunkRows), first, last, rows, out,
                  nsplit, hist, lane);
  }
}

// Shared memory of a block: nsplit x 3 x 256 u32 histograms per warp
// (48 KB at most), none without medians (nsplit 0 here).
constexpr int smem_bytes(int nsplit) {
  return nsplit * kWarpsPerBlock * kChannels * kBins * 4;
}

template <class Rows>
int launch(const int* keys, int n, Rows rows, int num_groups, int nsplit,
           int n_weights, int n_values, float* out_buf, void* stream) {
  if (n < 0 || num_groups < 0 || nsplit < 1 || nsplit > kMaxSplit ||
      num_groups % nsplit != 0 || n_weights < 0 || n_weights > kMaxWeights ||
      n_values < 0 || n_values > kChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_groups == 0) return static_cast<int>(cudaGetLastError());
  const size_t G = static_cast<size_t>(num_groups);
  const Out out{out_buf, out_buf + G * n_weights, out_buf + G * (n_weights + 1),
                num_groups, n_weights, n_values};
  const int split_smem = n_values > 0 ? nsplit : 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // Once per device: raise the limit of dynamic shared memory (48 KB of
  // histograms and the kernel's own few bytes pass the default) and size
  // the persistent grid for each shared-memory size.
  static int grid[kMaxDevices][kMaxSplit + 1] = {};
  if (grid[dev][0] == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        segmented_stats_kernel<Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kMaxSplit));
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (int i = kMaxSplit; i >= 0; --i) {
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, segmented_stats_kernel<Rows>, kWarpsPerBlock * 32,
          smem_bytes(i));
      grid[dev][i] = max(1, sms * max(per_sm, 1));
    }
  }
  const int blocks = grid[dev][split_smem];
  const int smem = smem_bytes(split_smem);
  segmented_stats_kernel<Rows><<<blocks, kWarpsPerBlock * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      keys, n, rows, out, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: (n,) int32 group keys, ascending (keys outside [0, num_groups) are
// not counted); w1, w2: (n,) payload words in the same order; out: one
// float32 buffer of num_groups * (4 + 1 + 2 * n_values): sums (num_groups,
// 4), zmin (num_groups,), meds (n_values, 2, num_groups). n_values is 3 or
// 0 (no medians); nsplit 2 adds the pair medians. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int segmented_stats_words_launch(const int* keys, int n,
                                            const int* w1, const int* w2,
                                            int num_groups, int nsplit,
                                            int n_values, float* out,
                                            void* stream) {
  if (n_values != 0 && n_values != kChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(keys, n, WordsRows{w1, w2}, num_groups, nsplit, kMaxWeights,
                n_values, out, stream);
}

// keys: (n,) int32 group keys, ascending; rows: 8 device pointers, the
// n_weights weight rows, the z row and the n_values value rows at indices
// 0-3, 4 and 5-7 (unused entries ignored), each (n,) float32 in key order;
// out: one float32 buffer of num_groups * (n_weights + 1 + 2 * n_values):
// sums (num_groups, n_weights), zmin, meds (n_values, 2, num_groups).
extern "C" int segmented_stats_rows_launch(const int* keys, int n,
                                           const float* const* rows,
                                           int n_weights, int n_values,
                                           int num_groups, int nsplit,
                                           float* out, void* stream) {
  FloatRows r{};
  for (int k = 0; k < kMaxWeights; ++k) r.w[k] = rows[k];
  r.z = rows[kMaxWeights];
  for (int c = 0; c < kChannels; ++c) r.v[c] = rows[kMaxWeights + 1 + c];
  return launch(keys, n, r, num_groups, nsplit, n_weights, n_values, out,
                stream);
}
