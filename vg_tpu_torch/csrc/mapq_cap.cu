// The explored-minimizer MAPQ cap of a batch of reads (sm_90a).
//
// Replaces no TPU kernel: vg_tpu computes the cap on the host, one read
// at a time in Python (vg_tpu/map/mapqcap.py:94-171, explored_cap and
// faster_cap, called from GiraffeMapper.apply_mapq_caps,
// vg_tpu/map/giraffe.py:1372). The kernel computes the same function for
// every read of a batch at once; its plain version is mapq_cap_ref in
// vg_tpu_torch/ops/cuda_mapqcap.py. For read r, with the read's codes
// (0-4), its FASTQ quality bytes (quals[qoff[r] .. qoff[r + 1]); none:
// an empty range) and the sorted uint64 keys of the index's minimizers:
//
// (a) the (k, w) minimizers of the read with their agglomerations, as
//     map/mapqcap.minimizer_agglomerations finds them: canonical 2-bit
//     kmers (a kmer with an N is invalid and hashes to ~0), wang_hash_64,
//     w_eff = min(w, m) with m = rlen - k + 1 kmers, the minima of the
//     m - w_eff + 1 windows, each kmer's first and last window in which it
//     is minimal (ties all count); a valid kmer minimal in some window is
//     selected, with agg_start = its first window and agg_end = its last
//     window + w_eff - 1 + k;
// (b) the explored filter of explored_cap: a minimizer is kept when its
//     key occurs in the index (binary search, unsigned 64-bit);
// (c) faster_cap's interval sweep and DP, in float64: the kept minimizers
//     sorted by (agg_end, agg_start), ties in offset order; the stack of
//     the sweep is always the window [bottom, bottom + len) of that order;
//     an interval's columns fold left to right, p = p + cp - p * cp, each
//     column's cp a product over the group in order; log10(p) where
//     p > 0, else -inf; the strict update c[i] < val; the cap -10 c[n],
//     or +inf. The sweep runs to the quality's length, not the read's.
//
// A column's phred probability is phred[byte]: a 256-entry table of
// 10^(-q/10) with q = clip(byte - 33, 0, 93), parse_quality's parse
// folded in, made on the host with Python's **.
//
// Exactness: every add, subtract and multiply is an explicit _rn
// intrinsic, so nvcc contracts none of them into an FMA and each rounds
// as Python's float operation does; float(hash) is __ull2double_rn, one
// rounding as Python's. pow and log10 are CUDA's (within 1-2 ulp, not
// correctly rounded), so a cap may differ from the copy's in its last
// bits: the tests hold the cap to 1e-9 phred and the rounded MAPQ
// exactly. The float64 operations run in the order of the first form of
// this kernel (one lane a read's sweep): a column's product still runs
// over its group g = bottom .. top - 1, an interval's fold over its
// columns left to right, the DP over the intervals in sweep order; only
// which lane runs each chain changed, so every cap is bit-equal to that
// form's. A sweep that reads a quality column at or past the quality's
// length (a quality shorter than its read) gives NaN: the copy raises
// IndexError there, and so does the caller.
//
// What bounds it: operations, float64 ones above all. A (column,
// minimizer) pair outside the minimizer's core costs a pow (tens of
// dependent float64 instructions) and a few more: ~300-900 pairs a
// 150-base read (cuda_mapqcap.cap_work counts them on the inputs). The
// bytes (two a base, the index keys once) take microseconds. On an H100
// (700 W) a 6,144-read mate of 150 bases took 0.155 ms, against 0.76 ms
// for the first form (lane 0 alone ran the sweep), in chip_smoke.py's
// phase_cap_kernel. Stopping every read after a phase splits the time:
// (a) 0.013 ms; (b) 0.041, the binary search's chain of dependent loads
// (17-18 levels of 172,248 keys) and the windows' scans; (c) 0.101, the
// pow chains, 4-5 columns a lane each with its group's pows, and lane 0's
// serial steps between them (the state machine, the DP).
//
// Design: a warp a read, kReads (4) reads a block, every lane busy in
// each phase.
// (a) Lane l rolls the canonical kmer over a contiguous run of positions
//     (one base in a step; the first k - 1 bases once), hashes it and
//     puts hash and key in the read's scratch. A kmer's first and last
//     window come from the hashes: the nearest strictly smaller hash
//     within w_eff - 1 positions on each side bounds the windows in
//     which it is minimal, so no window minimum is stored.
// (b) The lane searches the keys of its selected valid kmers (the key
//     kept from (a)), counts its kept ones, and a warp scan gives each
//     lane its slots: compaction in offset order. A stable rank sort
//     (each lane ranks its slots against all) writes the minimizers in
//     sweep order.
// (c) In batches of at most kPieces intervals and kCols columns: lane 0
//     steps the sweep's integer state machine and writes the intervals
//     (an interval wider than what is left of a batch is cut into pieces;
//     its fold carries over); all lanes compute the batch's column
//     probabilities, a column a lane; a lane a piece folds its columns
//     and takes log10; lane 0 runs the DP's strict updates in order.
// The phred table is read through the read-only cache (__ldg); a copy in
// shared memory measured no faster on an H100.
// Scratch: a warp's batch buffers (WarpBuf) in shared memory, and the
// read's 40 bytes for each of its own m kmer positions (+ 8): hashes and
// keys, then the sorted minimizers (20 m); the minimizers in offset
// order, then c[] (20 m). In shared memory, sized for the batch's widest
// row up to smem_pos positions; a read with more positions takes it from
// ws in global memory at ws_off[r] bytes, so the card takes every read
// length and one long read leaves the others' occupancy alone. How the
// time splits over the phases is measured by stopping every read after
// (a) or after (b): a library built with -DMAPQ_CAP_STOP_AFTER=1 or 2
// (cuda_mapqcap.mapq_cap_stopped, for chip_smoke.phase_cap_kernel and
// scripts/cap_batch_sweep.py), not a runtime argument: no ncu.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

// 3: the whole kernel; 1 or 2: every read stops after phase (a) or (b),
// its cap +inf (a timing build only)
#ifndef MAPQ_CAP_STOP_AFTER
#define MAPQ_CAP_STOP_AFTER 3
#endif

namespace {

constexpr int kMaxK = 31;           // 2k bits of a kmer fit a uint64
constexpr int kReads = 4;           // reads (warps) a block
constexpr int kPieces = 32;         // intervals (pieces) a batch of (c)
constexpr int kCols = 128;          // columns a batch of (c)
constexpr int kScratchBytes = 40;   // a read's scratch a kmer position
constexpr int kMaxSmem = 232448;    // shared memory a block can opt in to
constexpr int kStaticSmem = 48 * 1024;  // without opting in
constexpr double kTwoPowMinus64 = 1.0 / 18446744073709551616.0;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStopAfter = MAPQ_CAP_STOP_AFTER;
static_assert(kStopAfter >= 1 && kStopAfter <= 3, "MAPQ_CAP_STOP_AFTER");

// A warp's buffers for one batch of (c).
struct __align__(16) WarpBuf {
  double cp[kCols];           // the batch's column probabilities
  double here[kPieces];       // log10 of each piece that ends its interval
  double carry[2];            // the fold of a cut interval, by parity
  int4 piece[kPieces];        // left, right, bottom, top
  int colstart[kPieces + 1];  // the pieces' first columns in cp
  int flags[kPieces];         // 1: first piece of its interval; 2: last
};
static_assert(sizeof(WarpBuf) == 2080, "cuda_mapqcap.WARP_BUF_BYTES");

__device__ __forceinline__ uint64_t wang_hash(uint64_t x) {
  x = (~x) + (x << 21);
  x = x ^ (x >> 24);
  x = (x + (x << 3)) + (x << 8);
  x = x ^ (x >> 14);
  x = (x + (x << 2)) + (x << 4);
  x = x ^ (x >> 28);
  x = x + (x << 31);
  return x;
}

// MinimizerIndex.count(key) > 0 on a key set: searchsorted, then equal.
__device__ bool present(const uint64_t* keys, long long nk, uint64_t key) {
  const auto* k64 = reinterpret_cast<const unsigned long long*>(keys);
  long long lo = 0, hi = nk;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(k64 + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo < nk && __ldg(k64 + lo) == key;
}

// The kept minimizers of one read in sweep order.
struct Mins {
  const double* hf;   // float(hash)
  const int* off;
  const int* ast;     // agg_start
  const int* aend;    // agg_end
  int k;
};

// _col_prob: the probability that an error at column idx disrupts every
// minimizer of the group [bottom, top).
__device__ double col_prob(int idx, double p, const Mins& s, int bottom,
                           int top) {
  for (int g = bottom; g < top; ++g) {
    const int core = s.off[g];
    if (core <= idx && idx < core + s.k) continue;
    int possible = min(s.k, min(idx - s.ast[g] + 1, s.aend[g] - idx));
    possible = max(possible, 0);
    const double p_beat = fmin(__dmul_rn(s.hf[g], kTwoPowMinus64), 1.0);
    const double miss = pow(__dsub_rn(1.0, p_beat), (double)possible);
    p = __dmul_rn(p, __dsub_rn(1.0, miss));
  }
  return p;
}

// The sweep's state machine (faster_cap's emit_preceding over the sorted
// minimizers): the stack is [bottom, bottom + len), j the next to push.
struct Sweep {
  int j, bottom, len, left;

  // The next interval (left, right, bottom, top), possibly empty; false
  // once the sweep has reached nq.
  __device__ bool next(const Mins& s, int n, int nq, int4* iv) {
    while (j <= n) {
      const int right = j < n ? s.ast[j] : nq;
      if (left < right) {
        const int top_end = s.aend[bottom];
        *iv = make_int4(left, min(top_end, right), bottom, bottom + len);
        if (top_end <= right) {
          left = len == 1 ? right : top_end;
          ++bottom;
          --len;
        } else {
          left = right;
        }
        return true;
      }
      ++len;                      // push j
      ++j;
    }
    return false;
  }
};

struct CapArgs {
  const uint8_t* codes;   // (R, L)
  int R, L;
  const int32_t* rlen;    // (R,)
  const uint8_t* quals;   // (Q,) FASTQ quality bytes, read after read
  long long Q;
  const long long* qoff;  // (R + 1,)
  const uint64_t* keys;   // (nk,) sorted
  long long nk;
  const double* phred;    // (256,) by quality byte
  int k, w;
  int smem_pos;           // positions a read whose scratch is shared
  int warp_bytes;         // a warp's shared bytes: WarpBuf + scratch
  const long long* ws_off;  // (R,) bytes into ws of a wider read
  unsigned char* ws;      // scratch of the wider reads (global)
  double* cap;            // (R,)
};

__global__ void __launch_bounds__(kReads * 32, 6) mapq_cap_kernel(CapArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kReads + warp;
  if (r >= a.R) return;
  const int k = a.k;
  const long long qa = min(max(a.qoff[r], 0ll), a.Q);
  const long long qb = min(max(a.qoff[r + 1], qa), a.Q);
  const int nq = (int)min(qb - qa, 0x7fffffffll);
  const int n_codes = min(a.rlen[r], a.L);
  if (nq <= 0 || n_codes < k) {
    if (lane == 0) a.cap[r] = CUDART_INF;
    return;
  }
  const uint8_t* row = a.codes + (size_t)r * a.L;
  const uint8_t* qrow = a.quals + qa;
  const int m = n_codes - k + 1;
  const int w_eff = min(a.w, m), nw = m - w_eff + 1;
  WarpBuf* wb = reinterpret_cast<WarpBuf*>(smem + (size_t)warp * a.warp_bytes);
  unsigned char* base = m <= a.smem_pos
      ? reinterpret_cast<unsigned char*>(wb + 1) : a.ws + a.ws_off[r];
  // the first 20 m bytes: hash and key by position, later the sorted
  // minimizers; the next 20 m (from an 8-aligned offset): the minimizers
  // in offset order, later c[0 .. n]
  uint64_t* hash = reinterpret_cast<uint64_t*>(base);
  uint64_t* key = hash + m;
  double* hf_s = reinterpret_cast<double*>(base);
  int* off_s = reinterpret_cast<int*>(base + 8 * (size_t)m);
  int* ast_s = off_s + m;
  int* aend_s = ast_s + m;
  const Mins s{hf_s, off_s, ast_s, aend_s, k};
  unsigned char* ra = base + ((20 * (size_t)m + 7) & ~(size_t)7);
  double* hf = reinterpret_cast<double*>(ra);
  int* off = reinterpret_cast<int*>(ra + 8 * (size_t)m);
  int* ast = off + m;
  int* aend = ast + m;
  double* c = reinterpret_cast<double*>(ra);

  // (a) each lane rolls the kmers of positions [i0, i1)
  const int per = (m + 31) >> 5;
  const int i0 = min(lane * per, m), i1 = min(i0 + per, m);
  {
    const uint64_t mask = (1ull << (2 * k)) - 1;
    const int top = 2 * (k - 1);
    uint64_t fwd = 0, rev = 0;
    int last_n = -1;              // the last N base rolled in
    auto roll = [&](int p) {
      const uint32_t b = row[p];
      if (b >= 4) last_n = p;
      const uint64_t cb = b < 4 ? b : 0;
      fwd = ((fwd << 2) | cb) & mask;
      rev = (rev >> 2) | ((3ull - cb) << top);
    };
    if (i0 < i1)
      for (int p = i0; p < i0 + k - 1; ++p) roll(p);
    for (int i = i0; i < i1; ++i) {
      roll(i + k - 1);
      const bool valid = last_n < i;
      const uint64_t kk = rev < fwd ? rev : fwd;
      hash[i] = valid ? wang_hash(kk) : ~0ull;
      key[i] = valid ? kk : ~0ull;  // no valid key of k <= 31 is ~0
    }
  }
  __syncwarp();
  if (kStopAfter == 1) {         // reads hash[0]: (a)'s stores stay
    if (lane == 0) a.cap[r] = hash[0] == 0 ? 0.0 : CUDART_INF;
    return;
  }
  // (b) first and last window, the explored filter; key[i] becomes the
  // kept kmer's (first, last) or ~0
  int kept = 0;
  for (int i = i0; i < i1; ++i) {
    const uint64_t h = hash[i];
    int first = max(0, i - w_eff + 1), last = min(i, nw - 1);
    for (int j = i - 1; j >= first; --j)
      if (hash[j] < h) {
        first = j + 1;
        break;
      }
    for (int j = i + 1, end = last + w_eff - 1; j <= end; ++j)
      if (hash[j] < h) {
        last = j - w_eff;
        break;
      }
    const uint64_t kk = key[i];
    const bool keep = first <= last && kk != ~0ull &&
                      present(a.keys, a.nk, kk);
    key[i] = keep ? (uint64_t)(uint32_t)first << 32 | (uint32_t)last
                  : ~0ull;
    kept += keep;
  }
  int slot = kept;                // inclusive scan of the lanes' counts
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, slot, d);
    if (lane >= d) slot += v;
  }
  const int n = __shfl_sync(kFull, slot, 31);
  slot -= kept;
  __syncwarp();
  for (int i = i0; i < i1; ++i) {
    const uint64_t rec = key[i];
    if (rec == ~0ull) continue;
    off[slot] = i;
    ast[slot] = (int)(rec >> 32);
    aend[slot] = (int)(uint32_t)rec + w_eff - 1 + k;
    hf[slot] = __ull2double_rn(hash[i]);
    ++slot;
  }
  if (n == 0) {
    if (lane == 0) a.cap[r] = CUDART_INF;
    return;
  }
  __syncwarp();
  // stable sort by (agg_end, agg_start): each slot's rank, then its place
  for (int x = lane; x < n; x += 32) {
    const int ex = aend[x], sx = ast[x];
    int rank = 0;
    for (int y = 0; y < n; ++y) {
      const int ey = aend[y], sy = ast[y];
      rank += ey < ex || (ey == ex && (sy < sx || (sy == sx && y < x)));
    }
    hf_s[rank] = hf[x];
    off_s[rank] = off[x];
    ast_s[rank] = sx;
    aend_s[rank] = ex;
  }
  __syncwarp();
  if (kStopAfter == 2) {
    if (lane == 0) a.cap[r] = CUDART_INF;
    return;
  }
  for (int x = lane; x <= n; x += 32) c[x] = x == 0 ? 0.0 : -CUDART_INF;
  __syncwarp();

  // (c) the sweep in batches
  Sweep sw{1, 0, 1, s.ast[0]};   // lane 0's
  int4 rest = make_int4(0, 0, 0, 0);   // lane 0: the interval being cut
  bool rest_first = false, bad = false;
  int parity = 0;
  for (;;) {
    int nb = 0, ncols = 0, done = 0;
    if (lane == 0) {
      while (nb < kPieces && ncols < kCols) {
        if (rest.x >= rest.y) {
          if (!sw.next(s, n, nq, &rest)) {
            done = 1;
            break;
          }
          if (rest.x >= rest.y) continue;       // an empty interval
          if (rest.y > nq) {      // the copy's quals[idx] raises
            bad = true;
            done = 1;
            break;
          }
          rest_first = true;
        }
        const int take = min(rest.y - rest.x, kCols - ncols);
        wb->piece[nb] = make_int4(rest.x, rest.x + take, rest.z, rest.w);
        wb->colstart[nb] = ncols;
        wb->flags[nb] = (rest_first ? 1 : 0) |
                        (rest.x + take == rest.y ? 2 : 0);
        rest_first = false;
        rest.x += take;
        ncols += take;
        ++nb;
      }
      wb->colstart[nb] = ncols;
    }
    nb = __shfl_sync(kFull, nb, 0);
    ncols = __shfl_sync(kFull, ncols, 0);
    done = __shfl_sync(kFull, done, 0);
    __syncwarp();
    // the column probabilities, a column a lane
    for (int col = lane; col < ncols; col += 32) {
      int lo = 0, hi = nb - 1;    // the piece that holds col
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (wb->colstart[mid] <= col) lo = mid; else hi = mid - 1;
      }
      const int4 pc = wb->piece[lo];
      const int idx = pc.x + col - wb->colstart[lo];
      wb->cp[col] =
          col_prob(idx, __ldg(a.phred + qrow[idx]), s, pc.z, pc.w);
    }
    __syncwarp();
    // a piece a lane: its columns folded left to right
    if (lane < nb) {
      const int f = wb->flags[lane];
      const int c1 = wb->colstart[lane + 1];
      int t = wb->colstart[lane];
      double p;
      if (f & 1) p = wb->cp[t++];
      else p = wb->carry[parity];
      for (; t < c1; ++t) {
        const double cp = wb->cp[t];
        p = __dsub_rn(__dadd_rn(p, cp), __dmul_rn(p, cp));
      }
      if (f & 2) wb->here[lane] = p > 0.0 ? log10(p) : -CUDART_INF;
      else wb->carry[parity ^ 1] = p;
    }
    __syncwarp();
    if (lane == 0) {              // the DP, in sweep order
      for (int q = 0; q < nb; ++q) {
        if (!(wb->flags[q] & 2)) continue;
        const int4 pc = wb->piece[q];
        const double val = __dadd_rn(c[pc.z], wb->here[q]);
        for (int i = pc.z + 1; i <= pc.w; ++i)
          if (c[i] < val) c[i] = val;
      }
    }
    parity ^= 1;
    if (done) break;
  }
  if (lane == 0) {
    const double last = c[n];
    a.cap[r] = bad ? CUDART_NAN
               : isfinite(last) ? __dmul_rn(-10.0, last) : CUDART_INF;
  }
}

cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// mapq_cap: codes (R, L) uint8; rlen (R,) int32; quals (Q,) uint8, the
// reads' FASTQ quality bytes one after another, read r's at qoff[r] ..
// qoff[r + 1] (int64, R + 1); keys (nk,) uint64 sorted; phred (256,)
// float64 by quality byte; cap (R,) float64. A read of more than smem_pos
// kmer positions (with a quality) has 40 m + 8 bytes of ws from ws_off[r]
// (int64, 8-aligned); ws and ws_off may be null when no read has more.
extern "C" int mapq_cap(int device, const void* codes, int R, int L,
                        const void* rlen, const void* quals, long long Q,
                        const void* qoff, const void* keys, long long nk,
                        const void* phred, int k, int w, int smem_pos,
                        const void* ws_off, void* ws, void* cap,
                        void* stream) {
  const long long warp_bytes =
      (sizeof(WarpBuf) + (long long)kScratchBytes * smem_pos + 8 + 15) &
      ~15ll;
  const long long bytes = kReads * warp_bytes;
  if (R < 0 || L < 0 || Q < 0 || nk < 0 || k < 1 || k > kMaxK || w < 1 ||
      smem_pos < 0 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const CapArgs args{static_cast<const uint8_t*>(codes), R, L,
                     static_cast<const int32_t*>(rlen),
                     static_cast<const uint8_t*>(quals), Q,
                     static_cast<const long long*>(qoff),
                     static_cast<const uint64_t*>(keys), nk,
                     static_cast<const double*>(phred), k, w, smem_pos,
                     (int)warp_bytes,
                     static_cast<const long long*>(ws_off),
                     static_cast<unsigned char*>(ws),
                     static_cast<double*>(cap)};
  const int blocks = (R + kReads - 1) / kReads;
  if (bytes > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mapq_cap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  mapq_cap_kernel<<<blocks, kReads * 32, (size_t)bytes,
                    static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
