// The long-read link engine's fill and walk (sm_90a).
//
// Replaces no TPU kernel: vg_tpu runs the link engine as two lax.scans
// compiled into one XLA program (vg_tpu/ops/device_links.py, the fill
// :110-166 and the walk :186-221). The port ran them as a Python loop of
// torch ops, some 35 small kernels a row or a step: 182,996 launches a
// 496-read batch with the card idle 92-94% (PERF.md). Each kernel below
// computes the same function as its plain version in
// vg_tpu_torch/ops/cuda_links.py (link_fill_ref, link_walk_ref), bit for
// bit.
//
// The problem. N padded link tasks, each a global affine alignment of a
// read slice a (la codes, 8 nibbles a uint32 word) against the text slice
// b = text[ta .. ta + lb), in diagonal space: row i (0..RMAX) and band
// column c (0..WB-1) stand for the cell (i, j = i + base + c). The fill
// writes every cell's decision bits (diag-ok, E-selected, E-extend,
// F-extend, match: bits 0-4) into an (N, RMAX + 1, WB) uint8 array and
// each task's score, H on row la at column clamp(lb - la - base, 0,
// WB - 1); the walk follows the bits back from that cell and emits 4-bit
// ops (0 M, 1 X, 2 I, 3 D, 4 halted) packed 8 a word.
//
// Arithmetic. Every add, subtract and multiply goes through the unsigned
// helpers below, which wrap as torch's int32 ops do (two's complement), and
// every max and comparison is signed, so the kernels equal the plain
// versions on any int32 inputs. On the tasks DeviceLinkAligner builds,
// and with the wrapper's limits (each scoring parameter in [0, 2^16),
// RMAX <= 1024), the DP values stay within [NEG - 2^18, 2^27] and nothing
// wraps; coordinates from other arrays (j, the text position, the walk's
// row and column) wrap as the plain version's do.
//
// link_fill_kernel — one warp per task, the rows in order.
// What bounds it: bytes. At the long-read cell's bucket 256 the output is
// 16,384 x 257 x 65 = 274 MB of decision bits (0.082 ms at 3.35 TB/s);
// the recurrence is 46 int32 operations a cell on the rows a task runs
// (cuda_links.FILL_OPS_PER_CELL, counted on the plain version), about as
// much time at the INT32 rate, so the two bounds are close. Design:
// - The band's H and F of the previous row live in registers: lane l holds
//   columns l, l + 32 and l + 64 (K = 3 segments for WB <= 96; columns
//   past WB hold NEG). H[c + 1] and F[c + 1] of row i - 1 come from one
//   rotating shuffle a segment (lane 31 takes the next segment's lane 0),
//   H[c - 1], E[c - 1] and the row's hn[c - 1] from a rotation the other
//   way.
// - The lazy-E cummax along the row is a warp prefix-max scan
//   (__shfl_up_sync, 5 steps) over each segment, carried from segment to
//   segment through lane 31.
// - The read's words and its KB-byte text window (KB = round_up(RMAX + WB +
//   8, 8), text codes gathered from the 4-bit packed words, 6 outside
//   [0, T)) are loaded once into shared memory; a row reads its read code
//   as a broadcast and its WB text codes as neighbouring bytes.
// - Rows past la hold no band cell (their bits are 0 and H, F are NEG), so
//   the loop runs min(la, RMAX) rows and the rest of the task's bits are
//   zero-filled: padding tasks and short links cost their bytes only.
// - Bits are stored with neighbouring lanes on neighbouring columns (one
//   32-byte segment a warp store).
//
// link_walk_kernel — one thread per task, STEPS = round_up(RMAX + WB + 64,
// 8) steps. What bounds it: latency. Each step is one dependent byte load
// from the fill's output (the path decides the next cell), then some 60
// integer operations (cuda_links.WALK_OPS_PER_STEP); the bytes (the cells the walks visit and the packed
// ops) take microseconds. Design: the state (row, column, gap state,
// halted) in registers, eight ops built in a register and stored as one
// word, and a halted task loads nothing more. The flat index is int64:
// n (RMAX + 1) WB + row WB + clamp(column), wrapped once by the array's
// size when negative (the row reaches -1 through an F move on row 0) and
// clamped into the array, as vg_tpu's int32 gather does but without its
// overflow from 42,960 tasks in bucket 768.
//
// Not done here: fusing the walk into the fill's block with the task's
// bits in shared memory (16.7 KB a task at RMAX 256, 50 KB at 768). The
// walk's index may leave its task (row -1 reads the previous task's last
// row, or the array's end for task 0), so a fused walk would still need
// the whole array for those steps.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);     // ops/cuda_links.NEG
constexpr int kMaxWB = 96;           // three 32-column segments a warp
constexpr int kMaxRmax = 1024;
constexpr int kMaxKB = (kMaxRmax + kMaxWB + 8 + 7) / 8 * 8;
constexpr int kFillWarps = 4;        // tasks a fill block
constexpr int kWalkThreads = 128;
constexpr int kTextCode = 6;         // text code outside [0, T)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wneg(int a) { return (int)(0u - (unsigned)a); }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

struct Scoring {
  int match, mismatch, gap_open, gap_extend;
};

template <int K>
__global__ void __launch_bounds__(kFillWarps * 32)
link_fill_kernel(const uint32_t* __restrict__ a4,
                 const int32_t* __restrict__ la_,
                 const int32_t* __restrict__ ta_,
                 const int32_t* __restrict__ base_,
                 const int32_t* __restrict__ lb_,
                 const uint32_t* __restrict__ text, long long nw,
                 long long T, int N, int RMAX, int WB, Scoring sc,
                 int32_t* __restrict__ score_out,
                 uint8_t* __restrict__ bits) {
  __shared__ uint8_t s_win[kFillWarps][kMaxKB];
  __shared__ uint32_t s_a[kFillWarps][kMaxRmax / 8];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kFillWarps + warp;
  if (n >= N) return;                 // the whole warp leaves together
  const int la = la_[n], ta = ta_[n], base = base_[n], lb = lb_[n];
  const int go = sc.gap_open, ge = sc.gap_extend;
  const int RW = RMAX / 8;
  const int KB = (RMAX + WB + 8 + 7) / 8 * 8;
  uint8_t* const win = s_win[warp];
  uint32_t* const aw = s_a[warp];
  for (int w = lane; w < RW; w += 32) aw[w] = a4[n * RW + w];
  // text window: win[t] = text[ta + base - 1 + t], kTextCode outside [0, T)
  const int b0 = wsub(wadd(ta, base), 1);
  for (int t = lane; t < KB; t += 32) {
    const long long p = (long long)b0 + t;
    const long long wi = p < 0 ? 0 : min(p >> 3, nw - 1);
    const uint32_t nib = (text[wi] >> ((p & 7) * 4)) & 15u;
    win[t] = (p >= 0 && p < T) ? (uint8_t)nib : (uint8_t)kTextCode;
  }
  __syncwarp();

  uint8_t* const out = bits + n * (long long)(RMAX + 1) * WB;
  // row 0: H = 0 at j = 0, -(go + (j - 1) ge) for 0 < j <= lb; F = NEG;
  // bits: E-selected, E-extend while j >= 2
  int H[K], F[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    const int j0 = wadd(base, c);
    const bool in0 = j0 >= 0 && j0 <= lb;
    H[k] = c >= WB ? kNeg
         : j0 == 0 ? 0
         : (in0 && j0 > 0) ? wneg(wadd(go, wmul(wsub(j0, 1), ge))) : kNeg;
    F[k] = kNeg;
    if (c < WB) out[c] = (in0 && j0 > 0) ? (uint8_t)(2 | ((j0 >= 2) << 2)) : 0;
  }

  const int rows = la < 0 ? 0 : min(la, RMAX);
  for (int i = 1; i <= rows; ++i) {
    const int ai = (int)((aw[(i - 1) >> 3] >> (((i - 1) & 7) * 4)) & 15u);
    const int jb = wadd(i, base);
    // column j = 0's H on this row (i <= la on every row the loop runs)
    const int colH = wneg(wadd(go, wmul(i - 1, ge)));
    int rH[K], rF[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rH[k] = __shfl_sync(kFull, H[k], (lane + 1) & 31);
      rF[k] = __shfl_sync(kFull, F[k], (lane + 1) & 31);
    }
    int diag[K], Fn[K], hn[K];
    unsigned mb[K], fext[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + 32 * k;
      // row i - 1's column c + 1 (NEG past the band)
      const int Hup = lane < 31 ? rH[k] : (k + 1 < K ? rH[k + 1] : kNeg);
      const int Fup = lane < 31 ? rF[k] : (k + 1 < K ? rF[k + 1] : kNeg);
      const int bt = c < WB ? win[i + c] : kTextCode;
      mb[k] = (bt == ai) && (ai < 4);
      diag[k] = wadd(H[k], mb[k] ? sc.match : wneg(sc.mismatch));
      const int fo = wsub(Hup, go), fx = wsub(Fup, ge);
      Fn[k] = max(fo, fx);
      fext[k] = (Fn[k] == fx) && (Fn[k] != fo);
      hn[k] = max(diag[k], Fn[k]);
    }
    // lazy E: E[c] = max_{c' <= c}(open[c'] + c' ge) - go - c ge, where
    // open[c] = hn[c - 1] (and column j = 0's H where j = 1)
    int sh[K], g[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      sh[k] = __shfl_sync(kFull, hn[k], (lane + 31) & 31);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + 32 * k;
      const int left = lane > 0 ? sh[k] : (k > 0 ? sh[k - 1] : kNeg);
      const bool j1 = wadd(jb, c) == 1;
      const int opensrc = j1 ? max(left, colH) : left;
      g[k] = wadd(max(opensrc, kNeg), wmul(c, ge));
    }
    int carry = INT_MIN;
    int E[K], Hn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int v = g[k];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v = max(v, t);
      }
      v = max(v, carry);
      carry = __shfl_sync(kFull, v, 31);
      const int c = lane + 32 * k;
      E[k] = max(wsub(wsub(v, go), wmul(c, ge)), kNeg);
      Hn[k] = max(hn[k], E[k]);
    }
    int sE[K], sHn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sE[k] = __shfl_sync(kFull, E[k], (lane + 31) & 31);
      sHn[k] = __shfl_sync(kFull, Hn[k], (lane + 31) & 31);
    }
    uint8_t* const row = out + (long long)i * WB;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + 32 * k;
      const int j = wadd(jb, c);
      const int Esh = lane > 0 ? sE[k] : (k > 0 ? sE[k - 1] : kNeg);
      int Hsh = lane > 0 ? sHn[k] : (k > 0 ? sHn[k - 1] : kNeg);
      if (j == 1) Hsh = max(Hsh, colH);
      const unsigned eext = (E[k] == wsub(Esh, ge)) && (E[k] != wsub(Hsh, go));
      const unsigned esel = Hn[k] == E[k];
      const unsigned dok = Hn[k] == diag[k];
      const bool inb = c < WB && j >= 0 && j <= lb;
      if (c < WB)
        row[c] = inb ? (uint8_t)(dok | (esel << 1) | (eext << 2)
                                 | (fext[k] << 3) | (mb[k] << 4))
                     : (uint8_t)0;
      H[k] = inb ? Hn[k] : kNeg;
      F[k] = inb ? Fn[k] : kNeg;
    }
  }
  // rows past the loop hold no band cell
  const long long tail = (long long)(RMAX - rows) * WB;
  uint8_t* const zero = out + (long long)(rows + 1) * WB;
  for (long long t = lane; t < tail; t += 32) zero[t] = 0;

  if (la >= 1 && la <= RMAX) {        // H of row la at the final column
    const int cf = clampi(wsub(wsub(lb, la), base), 0, WB - 1);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (cf == lane + 32 * k) score_out[n] = H[k];
  } else if (lane == 0) {
    score_out[n] = la != 0 ? kNeg
                 : lb == 0 ? 0
                 : wneg(wadd(go, wmul(wsub(lb, 1), ge)));
  }
}

__global__ void __launch_bounds__(kWalkThreads)
link_walk_kernel(const uint8_t* __restrict__ bits,
                 const int32_t* __restrict__ la_,
                 const int32_t* __restrict__ base_,
                 const int32_t* __restrict__ lb_, int N, int RMAX, int WB,
                 int STEPS, uint32_t* __restrict__ packed,
                 int32_t* __restrict__ n_steps_out,
                 bool* __restrict__ complete_out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long row = (long long)(RMAX + 1) * WB;
  const long long size = row * N;
  const long long lane_base = n * row;
  const int la = la_[n], base = base_[n], lb = lb_[n];
  int ci = la;
  int cc = clampi(wsub(wsub(lb, la), base), 0, WB - 1);
  int st = 0;                          // 0 diagonal/H, 1 in F, 2 in E
  bool done = la == 0 && lb == 0;
  int steps = 0;
  const int SW = STEPS / 8;
  uint32_t* const out = packed + n * SW;
  for (int w = 0; w < SW; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      unsigned op = 4;
      if (!done) {
        const int j = wadd(wadd(ci, base), cc);
        if (ci == 0 && j == 0) {
          done = true;
        } else {
          long long flat = lane_base + (long long)ci * WB
                         + clampi(cc, 0, WB - 1);
          if (flat < 0) flat += size;
          flat = flat < 0 ? 0 : (flat > size - 1 ? size - 1 : flat);
          const unsigned cell = bits[flat];
          const bool take_d = st == 0 && ci > 0 && j > 0 && (cell & 1u);
          const bool in_e = st == 2
                         || (st == 0 && !take_d && j > 0 && (cell & 2u));
          if (take_d) {
            op = (cell & 16u) ? 0 : 1;
            ci = wsub(ci, 1);
            st = 0;
          } else if (in_e) {
            op = 3;
            st = ((cell & 4u) && j > 1) ? 2 : 0;
            cc = wsub(cc, 1);
          } else {                     // F: a read base against a gap
            op = 2;
            st = ((cell & 8u) && ci > 1) ? 1 : 0;
            ci = wsub(ci, 1);
            cc = wadd(cc, 1);
          }
          ++steps;
        }
      }
      word |= op << (4 * q);
    }
    out[w] = word;
  }
  n_steps_out[n] = steps;
  complete_out[n] = done || (ci == 0 && wadd(wadd(ci, base), cc) == 0);
}

cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// C entry points (bound with ctypes). Pointers are device pointers of
// contiguous tensors on card `device`. Each launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success). Outputs
// are written in full: every entry of score and bits, of packed, n_steps
// and complete.

// link_fill: a4 (N, RMAX/8) uint32 words; la, ta, base, lb (N,) int32;
// text (nw,) uint32 packed words of a T-base text; score (N,) int32; bits
// (N, RMAX + 1, WB) uint8. 8 <= RMAX <= 1024, RMAX % 8 == 0, 1 <= WB <= 96.
extern "C" int link_fill(int device, const void* a4, const void* la,
                         const void* ta, const void* base, const void* lb,
                         const void* text, long long nw, long long T, int N,
                         int RMAX, int WB, int match, int mismatch,
                         int gap_open, int gap_extend, void* score,
                         void* bits, void* stream) {
  if (N < 0 || RMAX < 8 || RMAX > kMaxRmax || RMAX % 8 || WB < 1
      || WB > kMaxWB || nw < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  const dim3 grid((unsigned)((N + kFillWarps - 1) / kFillWarps));
  const dim3 block(kFillWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<const uint32_t*>(a4);
  auto* l = static_cast<const int32_t*>(la);
  auto* t = static_cast<const int32_t*>(ta);
  auto* b = static_cast<const int32_t*>(base);
  auto* m = static_cast<const int32_t*>(lb);
  auto* x = static_cast<const uint32_t*>(text);
  auto* o = static_cast<int32_t*>(score);
  auto* d = static_cast<uint8_t*>(bits);
  if (WB <= 32)
    link_fill_kernel<1><<<grid, block, 0, s>>>(a, l, t, b, m, x, nw, T, N,
                                               RMAX, WB, sc, o, d);
  else if (WB <= 64)
    link_fill_kernel<2><<<grid, block, 0, s>>>(a, l, t, b, m, x, nw, T, N,
                                               RMAX, WB, sc, o, d);
  else
    link_fill_kernel<3><<<grid, block, 0, s>>>(a, l, t, b, m, x, nw, T, N,
                                               RMAX, WB, sc, o, d);
  return (int)cudaGetLastError();
}

// link_walk: bits (N, RMAX + 1, WB) uint8 from link_fill; la, base, lb (N,)
// int32; packed (N, STEPS/8) uint32; n_steps (N,) int32; complete (N,)
// bool. STEPS % 8 == 0.
extern "C" int link_walk(int device, const void* bits, const void* la,
                         const void* base, const void* lb, int N, int RMAX,
                         int WB, int STEPS, void* packed, void* n_steps,
                         void* complete, void* stream) {
  if (N < 0 || RMAX < 0 || WB < 1 || STEPS < 8 || STEPS % 8)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((N + kWalkThreads - 1) / kWalkThreads));
  link_walk_kernel<<<grid, kWalkThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int32_t*>(la),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(lb), N,
      RMAX, WB, STEPS, static_cast<uint32_t*>(packed),
      static_cast<int32_t*>(n_steps), static_cast<bool*>(complete));
  return (int)cudaGetLastError();
}
