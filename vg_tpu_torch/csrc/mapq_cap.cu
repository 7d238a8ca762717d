// The explored-minimizer MAPQ cap of a batch of reads (sm_90a).
//
// Replaces no TPU kernel: vg_tpu computes the cap on the host, one read
// at a time in Python (vg_tpu/map/mapqcap.py:94-171, explored_cap and
// faster_cap, called from GiraffeMapper.apply_mapq_caps,
// vg_tpu/map/giraffe.py:1372). The kernel computes the same function for
// every read of a batch at once; its plain version is mapq_cap_ref in
// vg_tpu_torch/ops/cuda_mapqcap.py. For read r, with the read's codes
// (0-4), its phred values (quals, qlen of them; no quality: qlen 0) and
// the sorted uint64 keys of the index's minimizers:
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
//     or +inf. The sweep runs to qlen, not to the read's length.
//
// Exactness: every add, subtract and multiply is an explicit _rn
// intrinsic, so nvcc contracts none of them into an FMA and each rounds
// as Python's float operation does; the phred probabilities 10^(-q/10)
// come from a table computed on the host with Python's ** (the copy's
// own bits); float(hash) is __ull2double_rn, one rounding as Python's.
// pow and log10 are CUDA's (within 1-2 ulp, not correctly rounded), so a
// cap may differ from the copy's in its last bits: the tests hold the cap
// to 1e-9 phred and the rounded MAPQ exactly. A sweep that reads a
// quality column at or past qlen (a quality shorter than its read) gives
// NaN: the copy raises IndexError there, and so does the caller.
//
// What bounds it: operations. The float64 part is a few pow calls for
// each (column, minimizer) pair of each interval: ~900 pairs for a
// 150-base read (cuda_mapqcap.cap_work counts them on the inputs). The
// bytes (two a base, the index keys once) take microseconds.
//
// Design (a first form, right before fast): one warp a read, one block a
// warp. (a) and (b): lanes take the kmer positions (and the windows) in
// strides of 32; the kept minimizers are compacted in offset order by a
// ballot a chunk of 32 positions; a stable rank sort (each lane ranks
// its items against all) orders them. (c): lane 0 runs the sweep and the
// DP alone, the minimizers and c[] in the read's scratch, as the copy
// does read by read. A read's scratch is 48 bytes for each of its own m
// kmer positions (+ 8): in shared memory, sized for the batch's widest
// row up to smem_pos positions; a read with more positions takes its
// scratch from ws in global memory at ws_off[r] bytes, so the card takes
// every read length and one long read leaves the others' occupancy alone.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxK = 31;           // 2k bits of a kmer fit a uint64
constexpr int kStaticSmem = 48 * 1024;  // shared memory without opt-in
constexpr double kTwoPowMinus64 = 1.0 / 18446744073709551616.0;

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

// The canonical key of the kmer at position i; false if it holds an N.
__device__ bool kmer_at(const uint8_t* row, int i, int k, uint64_t* key) {
  uint64_t fwd = 0, rev = 0;
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    const uint32_t b = row[i + j];
    ok &= b < 4;
    const uint64_t c = b < 4 ? b : 0;
    fwd |= c << (2 * (k - 1 - j));
    rev |= (3ull - c) << (2 * j);
  }
  *key = rev < fwd ? rev : fwd;
  return ok;
}

// MinimizerIndex.count(key) > 0 on a key set: searchsorted, then equal.
__device__ bool present(const uint64_t* keys, long long nk, uint64_t key) {
  long long lo = 0, hi = nk;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo < nk && keys[lo] == key;
}

// The kept minimizers of one read, in shared memory: by slot (offset
// order) off, agg_start, agg_end, float(hash); order[] the sorted slots.
struct Mins {
  const int* off;
  const int* ast;
  const int* aend;
  const double* hf;
  const int* order;
  int k;
};

// _col_prob: the probability that an error at column idx disrupts every
// minimizer of the group order[bottom .. top).
__device__ double col_prob(int idx, double p, const Mins& s, int bottom,
                           int top) {
  for (int g = bottom; g < top; ++g) {
    const int x = s.order[g];
    const int core = s.off[x];
    if (core <= idx && idx < core + s.k) continue;
    int possible = min(s.k, min(idx - s.ast[x] + 1, s.aend[x] - idx));
    possible = max(possible, 0);
    const double p_beat = fmin(__dmul_rn(s.hf[x], kTwoPowMinus64), 1.0);
    const double miss = pow(__dsub_rn(1.0, p_beat), (double)possible);
    p = __dmul_rn(p, __dsub_rn(1.0, miss));
  }
  return p;
}

// faster_cap's sweep and DP on lane 0: c[0 .. n] in shared memory.
__device__ double sweep(const Mins& s, int n, const uint8_t* qrow, int nq,
                        const double* phred, double* c) {
  bool bad = false;
  auto interval = [&](int left, int right, int bottom, int top) {
    if (left >= right) return;
    if (right > nq) {             // the copy's quals[idx] raises
      bad = true;
      return;
    }
    double p = col_prob(left, phred[qrow[left]], s, bottom, top);
    for (int i = left + 1; i < right; ++i) {
      const double cp = col_prob(i, phred[qrow[i]], s, bottom, top);
      p = __dsub_rn(__dadd_rn(p, cp), __dmul_rn(p, cp));
    }
    const double here = p > 0.0 ? log10(p) : -CUDART_INF;
    const double val = __dadd_rn(c[bottom], here);
    for (int i = bottom + 1; i <= top; ++i)
      if (c[i] < val) c[i] = val;
  };
  int bottom = 0, len = 1, left = s.ast[s.order[0]];
  for (int j = 1; j <= n; ++j) {
    const int right = j < n ? s.ast[s.order[j]] : nq;
    while (left < right) {
      const int top_end = s.aend[s.order[bottom]];
      if (top_end <= right) {
        interval(left, top_end, bottom, bottom + len);
        left = len == 1 ? right : top_end;
        ++bottom;
        --len;
      } else {
        interval(left, right, bottom, bottom + len);
        left = right;
      }
    }
    ++len;                        // push order[j]
  }
  if (bad) return CUDART_NAN;
  const double last = c[n];
  return isfinite(last) ? __dmul_rn(-10.0, last) : CUDART_INF;
}

struct CapArgs {
  const uint8_t* codes;   // (R, L)
  int L;
  const int32_t* rlen;    // (R,)
  const uint8_t* quals;   // (R, LQ)
  int LQ;
  const int32_t* qlen;    // (R,)
  const uint64_t* keys;   // (nk,) sorted
  long long nk;
  const double* phred;    // (256,) 10^(-q/10)
  int k, w;
  int smem_pos;           // positions a read whose scratch is shared
  const long long* ws_off;  // (R,) bytes into ws of a wider read
  unsigned char* ws;      // scratch of the wider reads (global)
  double* cap;            // (R,)
};

__global__ void __launch_bounds__(32) mapq_cap_kernel(CapArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, lane = threadIdx.x, k = a.k;
  const int n_codes = min(a.rlen[r], a.L), nq = min(a.qlen[r], a.LQ);
  if (nq <= 0 || n_codes < k) {
    if (lane == 0) a.cap[r] = CUDART_INF;
    return;
  }
  const uint8_t* row = a.codes + (size_t)r * a.L;
  const int m = n_codes - k + 1;
  const int w_eff = min(a.w, m), nw = m - w_eff + 1;
  // the read's scratch, 48 m + 8 bytes, laid out by its own m
  unsigned char* base = m <= a.smem_pos ? smem : a.ws + a.ws_off[r];
  uint64_t* hash = reinterpret_cast<uint64_t*>(base);
  uint64_t* wmin = hash + m;
  double* hf = reinterpret_cast<double*>(wmin + m);
  double* c = hf + m;                               // m + 1
  int* off = reinterpret_cast<int*>(c + m + 1);
  int* ast = off + m;
  int* aend = ast + m;
  int* order = aend + m;

  // (a) hashes (invalid kmers ~0), window minima, selection
  for (int i = lane; i < m; i += 32) {
    uint64_t key;
    hash[i] = kmer_at(row, i, k, &key) ? wang_hash(key) : ~0ull;
  }
  __syncwarp();
  for (int t = lane; t < nw; t += 32) {
    uint64_t v = hash[t];
    for (int j = 1; j < w_eff; ++j) v = hash[t + j] < v ? hash[t + j] : v;
    wmin[t] = v;
  }
  __syncwarp();
  // (b) the explored filter, and compaction in offset order
  int n = 0;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    bool keep = false;
    int first = 0, last = -1;
    if (i < m) {
      const int t0 = max(0, i - w_eff + 1), t1 = min(i, nw - 1);
      for (int t = t0; t <= t1; ++t) {
        if (wmin[t] == hash[i]) {
          if (last < 0) first = t;
          last = t;
        }
      }
      uint64_t key;
      keep = last >= 0 && kmer_at(row, i, k, &key) &&
             present(a.keys, a.nk, key);
    }
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int slot = n + __popc(ball & ((1u << lane) - 1u));
      off[slot] = i;
      ast[slot] = first;
      aend[slot] = last + w_eff - 1 + k;
      hf[slot] = __ull2double_rn(hash[i]);
    }
    n += __popc(ball);
  }
  if (n == 0) {
    if (lane == 0) a.cap[r] = CUDART_INF;
    return;
  }
  __syncwarp();
  // (c) stable sort by (agg_end, agg_start): each slot's rank
  for (int x = lane; x < n; x += 32) {
    const int ex = aend[x], sx = ast[x];
    int rank = 0;
    for (int y = 0; y < n; ++y) {
      const int ey = aend[y], sy = ast[y];
      rank += ey < ex || (ey == ex && (sy < sx || (sy == sx && y < x)));
    }
    order[rank] = x;
  }
  for (int x = lane; x <= n; x += 32) c[x] = x == 0 ? 0.0 : -CUDART_INF;
  __syncwarp();
  if (lane == 0) {
    const Mins s{off, ast, aend, hf, order, k};
    a.cap[r] = sweep(s, n, a.quals + (size_t)r * a.LQ, nq, a.phred, c);
  }
}

cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// mapq_cap: codes (R, L) uint8; rlen (R,) int32; quals (R, LQ) uint8;
// qlen (R,) int32; keys (nk,) uint64 sorted; phred (256,) float64; cap
// (R,) float64. A read of more than smem_pos kmer positions (with a
// quality) has 48 m + 8 bytes of ws from ws_off[r] (int64, 8-aligned);
// ws and ws_off may be null when no read has more.
extern "C" int mapq_cap(int device, const void* codes, int R, int L,
                        const void* rlen, const void* quals, int LQ,
                        const void* qlen, const void* keys, long long nk,
                        const void* phred, int k, int w, int smem_pos,
                        const void* ws_off, void* ws, void* cap,
                        void* stream) {
  const long long bytes = 48ll * smem_pos + 8;
  if (R < 0 || L < 0 || LQ < 0 || nk < 0 || k < 1 || k > kMaxK || w < 1 ||
      smem_pos < 0 || bytes > kStaticSmem)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const CapArgs args{static_cast<const uint8_t*>(codes), L,
                     static_cast<const int32_t*>(rlen),
                     static_cast<const uint8_t*>(quals), LQ,
                     static_cast<const int32_t*>(qlen),
                     static_cast<const uint64_t*>(keys), nk,
                     static_cast<const double*>(phred), k, w, smem_pos,
                     static_cast<const long long*>(ws_off),
                     static_cast<unsigned char*>(ws),
                     static_cast<double*>(cap)};
  mapq_cap_kernel<<<R, 32, (size_t)bytes,
                    static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
