// Device-side seeding kernels (sm_90a): soft-cap selection, cluster top-C,
// and a stable argsort. Bound with ctypes through ops/cuda_seed.py.
//
// Replaces the three Pallas TPU kernels of vg_tpu/ops/pallas_seed.py:
//   softcap_warp_kernel     <- _softcap_kernel (:195), reached via
//                              softcap_compact (:234, pallas_call :261)
//   cluster_warp_kernel +   <- _cluster_kernel (:275), reached via
//   cluster_block_kernel       cluster_topc (:357, pallas_call :384)
//   argsort_kernel          <- _argsort_kernel (:398), reached via
//                              argsort_i32 (:408, pallas_call :424)
// The TPU kernels sort whole padded rows with (8, 128)-tiled bitonic
// networks because Mosaic needs static shapes. Here each row works on what
// it holds:
//
// softcap_warp_kernel: one warp a read, 8 reads a 256-thread block, E =
//   mpad / 32 columns a lane (4, 8, 16 or 32: the entry picks the
//   instantiation from mpad and counts its launches). What held the first
//   design (a 256-thread block a read) to a tenth of its bytes bound: each
//   thread ranked its column against all mpad columns (quadratic), and a
//   row waited at 56 block barriers. Here:
//   - load: the warp reads its row in 32-column steps (coalesced 4-byte
//     and 1-byte loads), sums it, and splits it with two ballots a step:
//     columns of nonzero score get a 64-bit key, float_order(-score) << 32
//     | (column << 2 | cheap << 1 | keep), in column order; zero columns
//     (either sign; padding columns past m are zeros) get their record in
//     column order. The order (score descending, column ascending, as
//     float compares rank it) is then the sorted positive keys, the zero
//     columns as they stand, and the sorted negative keys: only the
//     nonzero keys are sorted, a bitonic sort of the next power of two in
//     the warp's slice of shared memory with __syncwarp between steps. On
//     the path every kept score is >= 1 and every other score is 0
//     (ops/devseed.softcap_inputs), so the sort covers the kept columns.
//   - sums: the cheap and expensive scores, in sorted order and striped
//     (position lane + 32 q), are scanned in registers with the
//     Hillis-Steele tree of vg_tpu's _prefix_sum (step d adds x[p - d];
//     one shuffle an item for d < 32, an in-lane add above), up to the
//     last kept position only. The row total is each lane's sum in column
//     order, then a butterfly: another order than vg_tpu's jnp.sum, exact
//     on the path's 1/256-quantized scores, as the first design's tree
//     was. take = keep & (cheap | excl_cheap + excl_expensive <
//     score_fraction * total) in float32 only (__fmul_rn, __fadd_rn, the
//     strict <).
//   - compaction: take flags go to their columns in shared memory; ballots
//     over the columns give each its slot (taken: the taken columns
//     before it; otherwise ntake + c - that count); the slot -> column
//     map is written to shared memory and the six (R, mpad) outputs are
//     stored in slot order, 32 neighbouring slots a warp-store.
//   No block barrier: a row needs none. Shared memory 11 mpad bytes a row
//   (22,528 B a block at mpad = 256, 90,112 B at mpad = 1024, set once a
//   device). ptxas: 48 registers at E = 8 (the path's), 32 at E = 4, no
//   spills; 80 registers and 12 B spilled at E = 16, 128 at E = 32. Bound:
//   bytes, the six outputs 72% of them at the path's shape.
//
// cluster top-C: one wrapper call is two launches on one stream.
//   The row body (cluster_row) is run by a thread group, a whole block or
//   one warp, on a row's valid seeds (strand 0/1; invalid slots carry
//   strand 2) compacted in slot order into shared memory, so the two
//   sorts touch only the next power of two above the row's seed count,
//   not the S = 4096 slots the TPU sorts. Each sort is a bitonic sort of
//   one 64-bit key: (strand, diagonal ^ 2^31, slot rank) for sort 1,
//   (cluster id, offset ^ 2^31, sort-1 position) for sort 2 - the
//   reference's lexicographic keys, packed. Cluster breaks (strand change
//   or a diagonal gap > 2B, with int32 wraparound as in vg_tpu), cluster
//   ids (integer scan), middle elements, distinct-offset score totals
//   (Hillis-Steele float scan, then last - (first - contrib[first]) as
//   the reference's segmented broadcasts compute it) and the top-C rounds
//   (argmax: largest total, then lowest cluster id) follow. The float
//   tree depends on the row's seed count only, never on the group, so
//   both paths add the same terms in the same order. Diagonal and offset
//   of invalid slots are never read. Bound: bytes (the strand of every
//   slot, and diagonal, offset and score of each valid seed).
//
//   cluster_warp_kernel: a warp per row, 8 rows a 256-thread block. The
//     warp streams the row's strands with 16-byte loads (4 slots a lane,
//     4 steps of 512 B in flight), compacts the valid slots with three
//     ballots of each lane's count, and gathers diagonal, offset and
//     score of those slots only. A row of at most kWarpT = T = 128 valid
//     seeds runs the row body in the warp's private slice of shared
//     memory (27 B a seed: 3,456 B a warp, 27,648 B a block) with
//     __syncwarp between steps: no block barrier. T from the data: on
//     the main path's batch a row holds 56.05 valid seeds on average,
//     p99 92, max 108 (chip_smoke.py on an NVIDIA H100 80GB HBM3 at
//     700 W), and 128 is the power of two above the largest row. ptxas:
//     40 registers under __launch_bounds__(256, 6), no spills, so six
//     blocks (48 rows) fit an SM in registers and shared memory, and a
//     batch of 6,144 rows runs in one wave on 132 SMs. A row with more
//     seeds stops streaming at the step that passes T, appends its index
//     to a device list (atomicAdd on a count the entry zeroes) and leaves.
//   cluster_block_kernel: a persistent grid (two 512-thread blocks an SM,
//     27 S + 256 B of shared memory: 110,848 B at S = 4096; ptxas: 64
//     registers, 48 B spilled) walks that list with the block-per-row
//     body: compaction in rounds of block ballots, then cluster_row on
//     the whole block. The host never reads the count; an empty list
//     costs one launch whose blocks exit.
//
// argsort_kernel: one block sorts up to 16384 (key, index) pairs - the
//   stable ascending permutation, ties by index - as an LSD radix sort of
//   the biased key (key ^ 2^31) in four 8-bit passes. Each warp holds
//   32 E consecutive positions in registers (E = 8 up to 8192 keys, 16
//   above; position w 32 E + e 32 + lane), ranks them digit by digit in
//   position order (the lanes of a digit from eight ballots, a per-warp
//   histogram in shared memory), the (digit, warp) counts are scanned
//   once, and the words move through shared memory to their next
//   positions; the last pass writes the indices. ptxas: 64 registers, no
//   spills at E = 8; E = 16 spills 180 B (n > 8192 only). Chosen over a
//   register-resident bitonic network: at n = 6144 (8192 padded) the
//   network makes 4096 x 91 = 372,736 compare-exchanges of 64-bit words,
//   about 3 M instructions on the one SM, against some 30 instructions a
//   word a pass here (0.7 M), and every step of a radix pass is stable by
//   construction, so stability needs no index in the comparison. Five
//   block barriers a pass, four in the last: 19 in all (a bitonic sort
//   of 8192 words in shared memory has 91). Padding words
//   (biased key 2^32 - 1, positions >= n) tie only with I32MAX keys and
//   follow them, so they never reach the output. Bound: bytes, far
//   below a launch's latency at the path's n: the time is the chain of
//   dependent steps (ballots, counter, barrier) a pass walks.

#include <atomic>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kClusterThreads = 512;   // block path: threads a row
constexpr int kClusterMaxS = 4096;
constexpr int kClusterIPT = kClusterMaxS / kClusterThreads;
constexpr int kWarpT = 128;            // warp path: most valid seeds a row
constexpr int kWarpIPT = kWarpT / 32;
constexpr int kWarpRows = 8;           // warp path: rows (warps) a block
constexpr int kStreamSteps = 4;        // 128-slot steps a warp has in flight
constexpr int kArgsortMaxN = 16384;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------- thread groups

// The group that runs a row body: a whole block, or one warp on its own
// rows with its own slice of shared memory.
struct BlockGroup {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};

struct WarpGroup {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
};

// In-place inclusive Hillis-Steele scan of a[0, n) in shared memory with
// the addition tree of vg_tpu's _prefix_sum: step d adds a[p - d] to a[p]
// for p >= d and 0 to a[p] below. Rank t owns positions t + q * size
// (q < IPT) and holds them in registers between a step's reads and writes.
template <typename T, int IPT, typename G>
__device__ void hs_scan(const G& g, T* a, int n) {
  for (int d = 1; d < n; d <<= 1) {
    T v[IPT];
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int p = g.rank() + q * g.size();
      if (p < n) v[q] = a[p] + (p >= d ? a[p - d] : T(0));
    }
    g.sync();
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int p = g.rank() + q * g.size();
      if (p < n) a[p] = v[q];
    }
    g.sync();
  }
}

// Exclusive rank of `flag` among the block's threads and the block's count
// of set flags. Every thread of the block calls it; warp_tot holds 32 ints.
__device__ int block_rank(bool flag, int* warp_tot, int* total) {
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const unsigned nwarps = blockDim.x >> 5;
  const unsigned ball = __ballot_sync(kFull, flag);
  if (lane == 0) warp_tot[warp] = __popc(ball);
  __syncthreads();
  int before = 0, all = 0;
  for (unsigned w = 0; w < nwarps; ++w) {
    const int c = warp_tot[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();            // warp_tot is rewritten by the next call
  *total = all;
  return before + __popc(ball & ((1u << lane) - 1u));
}

// Ascending bitonic sort of n (a power of two) 64-bit keys in shared
// memory. The caller synchronises before; the sort ends synchronised.
template <typename G>
__device__ void bitonic_sort(const G& g, uint64_t* key, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = g.rank(); i < (n >> 1); i += g.size()) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t a = key[lo], b = key[hi];
        if ((a > b) == ((lo & k) == 0)) {
          key[lo] = b;
          key[hi] = a;
        }
      }
      g.sync();
    }
  }
}

// Largest value, then lowest index, over the group; the result on rank 0.
__device__ void group_argmax(const WarpGroup&, float& bv, int& bi, int*) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, bv, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__device__ void group_argmax(const BlockGroup& g, float& bv, int& bi,
                             int* scratch) {
  group_argmax(WarpGroup(), bv, bi, scratch);
  float* red_v = reinterpret_cast<float*>(scratch);
  int* red_i = scratch + 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (g.size() >> 5); ++w) {
      if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    }
  }
}

__device__ __forceinline__ uint64_t biased(int32_t x) {
  return (uint64_t)((uint32_t)x ^ 0x80000000u);
}

__device__ __forceinline__ int32_t unbiased(uint64_t x) {
  return (int32_t)((uint32_t)x ^ 0x80000000u);
}

// ------------------------------------------------------ soft-cap select

constexpr int kSoftcapRows = 8;        // rows (warps) a block

// Shared memory of one row of mpad columns: the sort keys of its nonzero
// columns (8 B each; later the slot -> column map), the records of its zero
// columns (2 B) and the take flag of each column (1 B).
__host__ __device__ constexpr int softcap_row_bytes(int mpad) {
  return 11 * mpad;
}

// Order-preserving bits of a float: ascending floats, ascending bits.
__device__ __forceinline__ uint32_t float_order(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One warp a row, E = mpad / 32 columns a lane, striped (column or
// position lane + 32 q). A column's record is (column << 2 | cheap << 1 |
// keep); a nonzero column's sort key is float_order(-score) << 32 | record.
template <int E>
__global__ void __launch_bounds__(kSoftcapRows * 32)
softcap_warp_kernel(const float* __restrict__ ms,
                    const uint8_t* __restrict__ keep,
                    const uint8_t* __restrict__ cheap,
                    const int32_t* __restrict__ hs,
                    const int32_t* __restrict__ cnt,
                    const int32_t* __restrict__ cr, int R, int m,
                    float score_fraction, int32_t* __restrict__ pos_o,
                    int32_t* __restrict__ hs_o, int32_t* __restrict__ cnt_o,
                    int32_t* __restrict__ cr_o, float* __restrict__ ms_o,
                    int32_t* __restrict__ take_o) {
  constexpr int M = 32 * E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kSoftcapRows + warp;
  if (row >= R) return;
  unsigned char* base = smem_raw + warp * softcap_row_bytes(M);
  uint64_t* key = reinterpret_cast<uint64_t*>(base);
  uint16_t* zrec = reinterpret_cast<uint16_t*>(base + 8 * M);
  uint8_t* tk = base + 10 * M;
  uint16_t* inv = reinterpret_cast<uint16_t*>(base);  // after the keys
  const unsigned lt = (1u << lane) - 1u;
  const long long in0 = row * m;
  const WarpGroup g{};

  // Load the row (coalesced: a warp reads 32 neighbouring columns), sum
  // it, and split it by ballots: nonzero columns keyed in column order,
  // zero columns recorded in column order.
  float tot = 0.0f;
  int nnz = 0, npos = 0;
  {
    float v[E];
    uint32_t rec[E];
    unsigned bnz[E];
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int c = lane + 32 * q;
      float x = 0.0f;
      uint32_t f = 0;
      if (c < m) {
        x = ms[in0 + c];
        f = (keep[in0 + c] != 0 ? 1u : 0u) | (cheap[in0 + c] != 0 ? 2u : 0u);
      }
      v[q] = x;
      rec[q] = ((uint32_t)c << 2) | f;
      tot = __fadd_rn(tot, x);
      bnz[q] = __ballot_sync(kFull, x != 0.0f);   // -0.0 is a zero
      npos += __popc(__ballot_sync(kFull, x > 0.0f));
    }
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int before = __popc(bnz[q] & lt);
      if ((bnz[q] >> lane) & 1u) {
        key[nnz + before] =
            ((uint64_t)float_order(-v[q]) << 32) | rec[q];
      } else {
        zrec[(32 * q - nnz) + (lane - before)] = (uint16_t)rec[q];
      }
      nnz += __popc(bnz[q]);
    }
  }
  // the row total: lane sums in column order, then a butterfly (every
  // lane ends with the same bits: float addition commutes)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tot = __fadd_rn(tot, __shfl_xor_sync(kFull, tot, off));
  const int nzero = M - nnz;

  // Sort the nonzero keys: positive scores come first (descending, then
  // by column), negative ones last; the zero columns go between them.
  int np2 = 1;
  while (np2 < nnz) np2 <<= 1;
  for (int p = nnz + lane; p < np2; p += 32) key[p] = ~0ull;
  __syncwarp();
  if (nnz > 1) bitonic_sort(g, key, np2);

  // the record and score of sorted position p
  auto item = [&](int p, uint32_t& r, float& x) {
    if (p < npos || p >= npos + nzero) {
      const uint64_t k = key[p < npos ? p : p - nzero];
      r = (uint32_t)k;
      x = -order_float((uint32_t)(k >> 32));
    } else {
      r = zrec[p - npos];
      x = 0.0f;
    }
  };

  // Cheap and expensive scores in sorted order; P = 1 + the last kept
  // position: no later position is read.
  float cs[E], es[E];
  int P = 0;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int p = lane + 32 * q;
    uint32_t r;
    float x;
    item(p, r, x);
    const bool kp = r & 1u, ch = r & 2u;
    cs[q] = kp && ch ? x : 0.0f;
    es[q] = kp && !ch ? x : 0.0f;
    if (kp) P = p + 1;
  }
  P = __reduce_max_sync(kFull, P);

  // Inclusive Hillis-Steele scans with the tree of vg_tpu's _prefix_sum:
  // step d adds x[p - d] to x[p] (0 below d). Position lane + 32 q takes
  // p - d from lane - d of item q, or of item q - 1 for lane < d; for
  // d >= 32, item q - d / 32 of its own lane.
#pragma unroll
  for (int lg = 0; (1 << lg) < M; ++lg) {
    const int d = 1 << lg;
    if (d >= P) break;
    if (d < 32) {
      const int src = (lane - d) & 31;
      float pc = 0.0f, pe = 0.0f;        // item q - 1 of lane - d
#pragma unroll
      for (int q = 0; q < E; ++q) {
        if (32 * q >= P) break;
        const float yc = __shfl_sync(kFull, cs[q], src);
        const float ye = __shfl_sync(kFull, es[q], src);
        cs[q] = __fadd_rn(cs[q], lane >= d ? yc : pc);
        es[q] = __fadd_rn(es[q], lane >= d ? ye : pe);
        pc = yc;
        pe = ye;
      }
    } else {
      const int k = d >> 5;
#pragma unroll
      for (int q = E - 1; q >= 0; --q) {
        if (32 * q < P) {
          cs[q] = __fadd_rn(cs[q], q >= k ? cs[q >= k ? q - k : 0] : 0.0f);
          es[q] = __fadd_rn(es[q], q >= k ? es[q >= k ? q - k : 0] : 0.0f);
        }
      }
    }
  }

  // take = keep & (cheap | excl_cheap + excl_expensive < fraction * total),
  // float32 only; the flags go to their columns
  const float budget = __fmul_rn(score_fraction, tot);
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int p = lane + 32 * q;
    uint32_t r;
    float x;
    item(p, r, x);
    const bool kp = r & 1u, ch = r & 2u;
    bool take = false;
    if (kp) {
      const float csum = __fsub_rn(cs[q], ch ? x : 0.0f);
      const float esum = __fsub_rn(es[q], ch ? 0.0f : x);
      take = ch || __fadd_rn(csum, esum) < budget;
    }
    tk[r >> 2] = take ? 1 : 0;
  }
  __syncwarp();

  // Compaction: taken columns first, then the rest, each in column order.
  unsigned bt[E];
  int ntake = 0;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    bt[q] = __ballot_sync(kFull, tk[lane + 32 * q] != 0);
    ntake += __popc(bt[q]);
  }
  int taken = 0;                        // taken columns before chunk q
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int c = lane + 32 * q;
    const int before = taken + __popc(bt[q] & lt);
    inv[(bt[q] >> lane) & 1u ? before : ntake + c - before] = (uint16_t)c;
    taken += __popc(bt[q]);
  }
  __syncwarp();

  // the six outputs in slot order, coalesced
  const long long out0 = row * M;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int p = lane + 32 * q;
    const int c = inv[p];
    const bool real = c < m;
    pos_o[out0 + p] = c;
    hs_o[out0 + p] = real ? hs[in0 + c] : 0;
    cnt_o[out0 + p] = real ? cnt[in0 + c] : 0;
    cr_o[out0 + p] = real ? cr[in0 + c] : 0;
    ms_o[out0 + p] = real ? ms[in0 + c] : 0.0f;
    take_o[out0 + p] = p < ntake ? 1 : 0;
  }
}

// -------------------------------------------------------- cluster top-C

// Shared-memory arrays of a row of up to `cap` seeds, 27 B a seed, and
// (block path only) 256 B of scratch after them.
__host__ __device__ constexpr long long cluster_arrays_bytes(int cap) {
  return (27ll * cap + 15) & ~15ll;
}

struct ClusterSmem {
  uint64_t* key;      // [cap] sort keys; later the cluster totals (float)
  int32_t* o_c;       // [cap] offsets by slot rank; later the score scan
  float* sc_c;        // [cap] scores by slot rank
  int32_t* cl_diag;   // [cap] valid slots (warp path), cid scan, then
                      //       each cluster's diagonal
  uint16_t* jarr;     // [cap] sort-1 position -> slot rank
  uint16_t* cid;      // [cap] sort-1 position -> cluster id
  uint16_t* cl_start; // [cap] cluster id -> first sort-1 position
  uint8_t* cl_strand; // [cap] cluster id -> strand
  int* scratch;       // [64] block_rank / argmax scratch (block path)
};

__device__ ClusterSmem cluster_smem(unsigned char* base, int cap) {
  ClusterSmem s;
  s.key = reinterpret_cast<uint64_t*>(base);
  s.o_c = reinterpret_cast<int32_t*>(base + 8ll * cap);
  s.sc_c = reinterpret_cast<float*>(base + 12ll * cap);
  s.cl_diag = reinterpret_cast<int32_t*>(base + 16ll * cap);
  s.jarr = reinterpret_cast<uint16_t*>(base + 20ll * cap);
  s.cid = s.jarr + cap;
  s.cl_start = s.cid + cap;
  s.cl_strand = reinterpret_cast<uint8_t*>(s.cl_start + cap);
  s.scratch = reinterpret_cast<int*>(base + cluster_arrays_bytes(cap));
  return s;
}

// Clustering and top-C of one row, phases B-G, by group g: s.key[0, n)
// holds the sort-1 keys (strand << 48 | (diagonal ^ 2^31) << 16 | slot
// rank j) and s.o_c[j], s.sc_c[j] each seed's offset and score, n >= 1,
// written by the group without a barrier since. Writes the row's C
// candidates from rank 0 and ends synchronised. n <= IPT * g.size().
template <int IPT, typename G>
__device__ void cluster_row(const G& g, const ClusterSmem& s, int n, int C,
                            int gap, long long row,
                            int32_t* __restrict__ cdiag,
                            int32_t* __restrict__ crev,
                            uint8_t* __restrict__ cvalid) {
  const int tid = g.rank(), nt = g.size();
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  for (int p = n + tid; p < np2; p += nt) s.key[p] = ~0ull;
  g.sync();

  // B: sort 1 by (strand, diagonal, slot)
  bitonic_sort(g, s.key, np2);

  // C: cluster breaks -> cluster ids and starts
  for (int p = tid; p < n; p += nt) {
    int brk = 1;
    if (p > 0) {
      const uint64_t k = s.key[p], kp = s.key[p - 1];
      const int32_t dg = unbiased(k >> 16), pdg = unbiased(kp >> 16);
      const int32_t diff = (int32_t)((uint32_t)dg - (uint32_t)pdg);
      brk = ((k >> 48) != (kp >> 48)) || diff > gap;
    }
    s.cl_diag[p] = brk;
  }
  g.sync();
  hs_scan<int32_t, IPT>(g, s.cl_diag, n);
  for (int p = tid; p < n; p += nt) {
    const int c = s.cl_diag[p] - 1;
    s.cid[p] = (uint16_t)c;
    if (p == 0 || s.cl_diag[p - 1] != s.cl_diag[p]) s.cl_start[c] = p;
  }
  g.sync();
  const int nc = s.cid[n - 1] + 1;
  // each cluster's middle element (start + end) / 2 of the sort-1 run
  // gives its diagonal and strand
  for (int c = tid; c < nc; c += nt) {
    const int first = s.cl_start[c];
    const int last = (c + 1 < nc ? s.cl_start[c + 1] : n) - 1;
    const uint64_t k = s.key[(first + last) >> 1];
    s.cl_diag[c] = unbiased(k >> 16);
    s.cl_strand[c] = (uint8_t)(k >> 48);
  }
  g.sync();

  // D: sort 2 by (cluster, read offset, sort-1 position)
  for (int p = tid; p < n; p += nt) {
    const int j = (int)(s.key[p] & 0xffffu);
    s.jarr[p] = (uint16_t)j;
    s.key[p] = ((uint64_t)s.cid[p] << 48) | (biased(s.o_c[j]) << 16)
               | (uint64_t)p;
  }
  g.sync();
  bitonic_sort(g, s.key, np2);

  // E: each distinct (cluster, offset) scores once; scan the scores
  float* ps = reinterpret_cast<float*>(s.o_c);
  for (int p = tid; p < n; p += nt) {
    const uint64_t k = s.key[p];
    bool uniq = p == 0;
    if (!uniq) {
      const uint64_t kp = s.key[p - 1];
      uniq = (k >> 16) != (kp >> 16);      // cluster or offset differ
    }
    ps[p] = uniq ? s.sc_c[s.jarr[k & 0xffffu]] : 0.0f;
  }
  g.sync();
  hs_scan<float, IPT>(g, ps, n);

  // F: cluster totals, ps[last] - (ps[first] - contrib[first]); the
  // cluster's run has the same positions in both sort orders
  float tot[IPT];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const int c = tid + q * nt;
    if (c < nc) {
      const int first = s.cl_start[c];
      const int last = (c + 1 < nc ? s.cl_start[c + 1] : n) - 1;
      const float cf = s.sc_c[s.jarr[s.key[first] & 0xffffu]];
      tot[q] = __fsub_rn(ps[last], __fsub_rn(ps[first], cf));
    }
  }
  g.sync();
  float* val = reinterpret_cast<float*>(s.key);
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const int c = tid + q * nt;
    if (c < nc) val[c] = tot[q];
  }
  g.sync();

  // G: top-C by total, ties to the lower cluster id (lower middle)
  for (int out = 0; out < C; ++out) {
    float bv = __int_as_float(0xff800000);   // -inf
    int bi = 0x7fffffff;
    for (int c = tid; c < nc; c += nt) {
      const float x = val[c];
      if (x > bv) {      // ascending c: a tie keeps the lower id
        bv = x;
        bi = c;
      }
    }
    group_argmax(g, bv, bi, s.scratch);
    if (tid == 0) {
      const bool ok_c = bv > 0.0f;
      cdiag[row * C + out] = ok_c ? s.cl_diag[bi] : 0;
      crev[row * C + out] = ok_c ? (int32_t)s.cl_strand[bi] : 0;
      cvalid[row * C + out] = ok_c ? 1 : 0;
      if (ok_c) val[bi] = -1.0f;
    }
    g.sync();
  }
}

// Warp path: warp w of block b takes row 8 b + w. Rows past kWarpT valid
// seeds go to overflow[1 + i] (i from the count overflow[0]) and add one
// to *block_rows, the caller's running count.
__global__ void __launch_bounds__(kWarpRows * 32, 6)
cluster_warp_kernel(const int32_t* __restrict__ strandk,
                    const int32_t* __restrict__ diagk,
                    const int32_t* __restrict__ ok,
                    const float* __restrict__ score, int R, int S, int C,
                    int gap, int32_t* __restrict__ cdiag,
                    int32_t* __restrict__ crev, uint8_t* __restrict__ cvalid,
                    int32_t* __restrict__ overflow,
                    unsigned long long* __restrict__ block_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpRows + warp;
  if (row >= R) return;
  const int cap = S < kWarpT ? S : kWarpT;
  const ClusterSmem s = cluster_smem(
      smem_raw + warp * cluster_arrays_bytes(cap), cap);
  const long long base = row * S;
  const int32_t* st_row = strandk + base;
  const bool vec = (S & 3) == 0
                   && (reinterpret_cast<uintptr_t>(strandk) & 15u) == 0;
  const unsigned lt = (1u << lane) - 1u;

  // A: stream the strands, compact the valid slots in slot order
  int n = 0;
  for (int c0 = 0; c0 < S && n <= cap; c0 += 128 * kStreamSteps) {
    int st[kStreamSteps][4];
#pragma unroll
    for (int u = 0; u < kStreamSteps; ++u) {
      const int s0 = c0 + u * 128 + lane * 4;
      if (vec && s0 < S) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(st_row + s0));
        st[u][0] = v.x;
        st[u][1] = v.y;
        st[u][2] = v.z;
        st[u][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[u][e] = s0 + e < S ? st_row[s0 + e] : 2;
      }
    }
#pragma unroll
    for (int u = 0; u < kStreamSteps; ++u) {
      const int s0 = c0 + u * 128 + lane * 4;
      unsigned m = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m |= (unsigned)(st[u][e] == 0 || st[u][e] == 1) << e;
      const int cnt = __popc(m);      // 0..4: three ballots rank it
      const unsigned b0 = __ballot_sync(kFull, cnt & 1);
      const unsigned b1 = __ballot_sync(kFull, cnt & 2);
      const unsigned b2 = __ballot_sync(kFull, cnt & 4);
      int j = n + __popc(b0 & lt) + 2 * __popc(b1 & lt)
              + 4 * __popc(b2 & lt);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((m >> e) & 1u) {
          if (j < cap) s.cl_diag[j] = (st[u][e] << 16) | (s0 + e);
          ++j;
        }
      }
      n += __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
    }
  }
  if (n > cap) {                      // a dense row: the block path's
    if (lane == 0) {
      const int i = atomicAdd(overflow, 1);
      overflow[1 + i] = (int32_t)row;
      atomicAdd(block_rows, 1ull);
    }
    return;
  }
  if (n == 0) {
    for (int c = lane; c < C; c += 32) {
      cdiag[row * C + c] = 0;
      crev[row * C + c] = 0;
      cvalid[row * C + c] = 0;
    }
    return;
  }
  __syncwarp();
  // sort-1 keys; diagonal, offset and score of the valid slots only
  for (int p = lane; p < n; p += 32) {
    const int v = s.cl_diag[p];
    const long long at = base + (v & 0xffff);
    s.key[p] = ((uint64_t)(v >> 16) << 48) | (biased(diagk[at]) << 16)
               | (uint64_t)p;
    s.o_c[p] = ok[at];
    s.sc_c[p] = score[at];
  }
  cluster_row<kWarpIPT>(WarpGroup(), s, n, C, gap, row, cdiag, crev,
                        cvalid);
}

// Block path: block b takes the listed rows b, b + grid, ...
__global__ void __launch_bounds__(kClusterThreads)
cluster_block_kernel(const int32_t* __restrict__ strandk,
                     const int32_t* __restrict__ diagk,
                     const int32_t* __restrict__ ok,
                     const float* __restrict__ score, int S, int C, int gap,
                     int32_t* __restrict__ cdiag, int32_t* __restrict__ crev,
                     uint8_t* __restrict__ cvalid,
                     const int32_t* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockGroup g{};
  const ClusterSmem s = cluster_smem(smem_raw, S);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int count = overflow[0];
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const long long row = overflow[1 + i];
    const long long base = row * S;
    // A: compact the valid seeds in slot order; sort-1 keys
    int n = 0;
    for (int t0 = 0; t0 < S; t0 += nt) {
      const int slot = t0 + tid;
      const int st = slot < S ? strandk[base + slot] : 2;
      const bool v = st == 0 || st == 1;
      int tot;
      const int r = block_rank(v, s.scratch, &tot);
      if (v) {
        const int j = n + r;
        s.key[j] = ((uint64_t)st << 48) | (biased(diagk[base + slot]) << 16)
                   | (uint64_t)j;
        s.o_c[j] = ok[base + slot];
        s.sc_c[j] = score[base + slot];
      }
      n += tot;
    }
    cluster_row<kClusterIPT>(g, s, n, C, gap, row, cdiag, crev, cvalid);
  }
}

// ------------------------------------------------------------ argsort

// Shared memory of the argsort block of W warps, E words a lane: the
// words between passes, the (warp, digit) counts, the warp sums.
__host__ __device__ constexpr long long argsort_smem(int W, int E) {
  return 8ll * 32 * W * E + 4ll * 256 * W + 4 * 32;
}

template <int E>
__global__ void __launch_bounds__(1024)
argsort_kernel(const int32_t* __restrict__ keys, int n,
               int32_t* __restrict__ perm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t* words = reinterpret_cast<uint64_t*>(smem_raw);
  int* hist = reinterpret_cast<int*>(smem_raw + 8ll * 32 * W * E);
  int* wsum = hist + 256 * W;
  int* hw = hist + 256 * warp;       // this warp's digit counts
  const unsigned lt = (1u << lane) - 1u;
  const int first = warp * 32 * E + lane;   // position of item e: + 32 e
  // the scan's entries of thread t: 8 t on, entry f at (warp f % W,
  // digit f / W)
  const int d0 = threadIdx.x * 8 / W, w0 = threadIdx.x * 8 - d0 * W;
  uint32_t key[E], idx[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = first + 32 * e;
    key[e] = p < n ? (uint32_t)keys[p] ^ 0x80000000u : 0xffffffffu;
    idx[e] = (uint32_t)p;
  }
  for (int shift = 0; shift < 32; shift += 8) {
    // rank each item among the warp's items of its digit, in position
    // order; count the warp's digits
    for (int d = lane; d < 256; d += 32) hw[d] = 0;
    __syncwarp();
    int rank[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned d = (key[e] >> shift) & 255u;
      unsigned peers = kFull;            // the lanes with digit d
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const unsigned bit = __ballot_sync(kFull, (d >> b) & 1u);
        peers &= ((d >> b) & 1u) ? bit : ~bit;
      }
      const int leader = __ffs(peers) - 1;
      int c = lane == leader ? hw[d] : 0;
      c = __shfl_sync(kFull, c, leader);
      rank[e] = c + __popc(peers & lt);
      if (lane == leader) hw[d] = c + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // exclusive scan of the counts in (digit, warp) order, 8 a thread
    int v[8], sum = 0;
#pragma unroll
    for (int q = 0, d = d0, w = w0; q < 8; ++q) {
      v[q] = hist[w * 256 + d];
      sum += v[q];
      if (++w == W) {
        w = 0;
        ++d;
      }
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int x = lane < W ? wsum[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      wsum[lane] = x;
    }
    __syncthreads();
    int run = incl - sum + (warp > 0 ? wsum[warp - 1] : 0);
#pragma unroll
    for (int q = 0, d = d0, w = w0; q < 8; ++q) {
      hist[w * 256 + d] = run;
      run += v[q];
      if (++w == W) {
        w = 0;
        ++d;
      }
    }
    __syncthreads();
    // move each word to its place: into shared memory for the next
    // pass, or, after the last digit, its index into the output
    if (shift < 24) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        words[hw[(key[e] >> shift) & 255u] + rank[e]] =
            ((uint64_t)key[e] << 32) | idx[e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint64_t w = words[first + 32 * e];
        key[e] = (uint32_t)(w >> 32);
        idx[e] = (uint32_t)w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int pos = hw[key[e] >> 24] + rank[e];
        if (pos < n) perm[pos] = (int32_t)idx[e];
      }
    }
  }
}

// ------------------------------------------------------- device set-up

std::mutex g_setup_mutex;
std::atomic<bool> g_ready[kMaxDevices];
int g_sms[kMaxDevices];
std::atomic<int> g_attr_sets{0};
std::atomic<long long> g_softcap_launches[4];   // by log2(E) - 2

cudaError_t raise_smem(const void* fn, long long bytes) {
  g_attr_sets.fetch_add(1);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Make `device` current and, once per device, raise the kernels' dynamic
// shared-memory limits to the most any call takes and read its SM count.
cudaError_t prepare(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return e;
  if (g_ready[device].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(g_setup_mutex);
  if (g_ready[device].load(std::memory_order_relaxed)) return cudaSuccess;
  if ((e = raise_smem((const void*)cluster_warp_kernel,
                      kWarpRows * cluster_arrays_bytes(kWarpT)))
          != cudaSuccess
      || (e = raise_smem((const void*)cluster_block_kernel,
                         cluster_arrays_bytes(kClusterMaxS) + 256))
             != cudaSuccess
      || (e = raise_smem((const void*)argsort_kernel<8>,
                         argsort_smem(32, 8))) != cudaSuccess
      || (e = raise_smem((const void*)argsort_kernel<16>,
                         argsort_smem(32, 16))) != cudaSuccess
      || (e = raise_smem((const void*)softcap_warp_kernel<32>,
                         kSoftcapRows * softcap_row_bytes(1024)))
             != cudaSuccess)
    return e;
  e = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount,
                             device);
  if (e != cudaSuccess) return e;
  g_ready[device].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <int E>
cudaError_t launch_argsort(const int32_t* keys, int n, int32_t* perm,
                           cudaStream_t stream) {
  const int W = (n + 32 * E - 1) / (32 * E);
  argsort_kernel<E><<<1, 32 * W, argsort_smem(W, E), stream>>>(keys, n,
                                                               perm);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). Pointers are device pointers of
// contiguous tensors on card `device`; each launches on `stream` without
// synchronising and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape the kernel does not take.

// ms (R, m) f32; keep, cheap (R, m) bool; hs, cnt, cr (R, m) int32 ->
// pos, hs, cnt, cr, take (R, mpad) int32 and ms (R, mpad) f32;
// mpad a power of two in [128, 1024], mpad >= m.
extern "C" int seed_softcap(int device, const void* ms, const void* keep,
                            const void* cheap, const void* hs,
                            const void* cnt, const void* cr, int R, int m,
                            int mpad, float score_fraction, void* pos_o,
                            void* hs_o, void* cnt_o, void* cr_o, void* ms_o,
                            void* take_o, void* stream) {
  if (mpad < 128 || mpad > 1024 || (mpad & (mpad - 1)) || m > mpad || m < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const cudaError_t set = prepare(device);
  if (set != cudaSuccess) return (int)set;
  const unsigned grid = (unsigned)((R + kSoftcapRows - 1) / kSoftcapRows);
  const size_t smem = (size_t)kSoftcapRows * softcap_row_bytes(mpad);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* a0 = static_cast<const float*>(ms);
  const auto* a1 = static_cast<const uint8_t*>(keep);
  const auto* a2 = static_cast<const uint8_t*>(cheap);
  const auto* a3 = static_cast<const int32_t*>(hs);
  const auto* a4 = static_cast<const int32_t*>(cnt);
  const auto* a5 = static_cast<const int32_t*>(cr);
  auto* o0 = static_cast<int32_t*>(pos_o);
  auto* o1 = static_cast<int32_t*>(hs_o);
  auto* o2 = static_cast<int32_t*>(cnt_o);
  auto* o3 = static_cast<int32_t*>(cr_o);
  auto* o4 = static_cast<float*>(ms_o);
  auto* o5 = static_cast<int32_t*>(take_o);
  int route = 0;
  switch (mpad) {
    case 128:
      softcap_warp_kernel<4><<<grid, kSoftcapRows * 32, smem, st>>>(
          a0, a1, a2, a3, a4, a5, R, m, score_fraction, o0, o1, o2, o3, o4,
          o5);
      break;
    case 256:
      route = 1;
      softcap_warp_kernel<8><<<grid, kSoftcapRows * 32, smem, st>>>(
          a0, a1, a2, a3, a4, a5, R, m, score_fraction, o0, o1, o2, o3, o4,
          o5);
      break;
    case 512:
      route = 2;
      softcap_warp_kernel<16><<<grid, kSoftcapRows * 32, smem, st>>>(
          a0, a1, a2, a3, a4, a5, R, m, score_fraction, o0, o1, o2, o3, o4,
          o5);
      break;
    default:
      route = 3;
      softcap_warp_kernel<32><<<grid, kSoftcapRows * 32, smem, st>>>(
          a0, a1, a2, a3, a4, a5, R, m, score_fraction, o0, o1, o2, o3, o4,
          o5);
  }
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) g_softcap_launches[route].fetch_add(1);
  return (int)e;
}

// Launches of softcap_warp_kernel with `items` columns a lane (4, 8, 16 or
// 32) so far; -1 for another count.
extern "C" long long seed_softcap_launches(int items) {
  switch (items) {
    case 4: return g_softcap_launches[0].load();
    case 8: return g_softcap_launches[1].load();
    case 16: return g_softcap_launches[2].load();
    case 32: return g_softcap_launches[3].load();
    default: return -1;
  }
}

// Most valid seeds a row may hold and stay on the warp path.
extern "C" int seed_cluster_warp_t() { return kWarpT; }

// Dynamic shared-memory attributes set so far (once per device and
// kernel).
extern "C" int seed_attr_sets() { return g_attr_sets.load(); }

// strandk, diagk, ok (R, S) int32, score (R, S) f32 -> cdiag, crev (R, C)
// int32, cvalid (R, C) bool; S a power of two <= 4096, strandk in {0, 1, 2}.
// overflow: (R + 1,) int32 scratch, the block path's row list;
// block_rows: one uint64 that gains the number of rows the block path took.
extern "C" int seed_cluster(int device, const void* strandk,
                            const void* diagk, const void* ok,
                            const void* score, int R, int S, int C,
                            int band_radius, void* cdiag, void* crev,
                            void* cvalid, void* overflow, void* block_rows,
                            void* stream) {
  if (S < 1 || S > kClusterMaxS || (S & (S - 1)) || C < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || C == 0) return (int)cudaSuccess;
  cudaError_t e = prepare(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(overflow, 0, sizeof(int32_t), st)) != cudaSuccess)
    return (int)e;
  const int cap = S < kWarpT ? S : kWarpT;
  cluster_warp_kernel<<<(R + kWarpRows - 1) / kWarpRows, kWarpRows * 32,
                        kWarpRows * cluster_arrays_bytes(cap), st>>>(
      static_cast<const int32_t*>(strandk),
      static_cast<const int32_t*>(diagk), static_cast<const int32_t*>(ok),
      static_cast<const float*>(score), R, S, C, 2 * band_radius,
      static_cast<int32_t*>(cdiag), static_cast<int32_t*>(crev),
      static_cast<uint8_t*>(cvalid), static_cast<int32_t*>(overflow),
      static_cast<unsigned long long*>(block_rows));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int grid = R < 2 * g_sms[device] ? R : 2 * g_sms[device];
  cluster_block_kernel<<<grid, kClusterThreads,
                         cluster_arrays_bytes(S) + 256, st>>>(
      static_cast<const int32_t*>(strandk),
      static_cast<const int32_t*>(diagk), static_cast<const int32_t*>(ok),
      static_cast<const float*>(score), S, C, 2 * band_radius,
      static_cast<int32_t*>(cdiag), static_cast<int32_t*>(crev),
      static_cast<uint8_t*>(cvalid), static_cast<const int32_t*>(overflow));
  return (int)cudaGetLastError();
}

// keys (n,) int32 -> perm (n,) int32, the stable ascending argsort;
// 1 <= n <= 16384.
extern "C" int seed_argsort(int device, const void* keys, int n, void* perm,
                            void* stream) {
  if (n < 1 || n > kArgsortMaxN) return (int)cudaErrorInvalidValue;
  const cudaError_t set = prepare(device);
  if (set != cudaSuccess) return (int)set;
  const auto* k = static_cast<const int32_t*>(keys);
  auto* p = static_cast<int32_t*>(perm);
  const auto st = static_cast<cudaStream_t>(stream);
  return (int)(n <= 8192 ? launch_argsort<8>(k, n, p, st)
                         : launch_argsort<16>(k, n, p, st));
}
