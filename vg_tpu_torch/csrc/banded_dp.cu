// Banded semiglobal affine DP over haplotype-text windows (sm_90a).
//
// One kernel body, three window sources (the template parameter Source):
//
// - packed words: replaces the TPU kernel vg_tpu/ops/pallas_align.py:47
//   (make_kernel) as reached through banded_scores_packed (:276). For every
//   (read r, candidate c) the window text[start .. start + RL + 2B) is read
//   from the packed words (8 bases per int32, little-endian nibbles) and
//   masked to [lo, hi) ∩ [0, T) with sentinel 6;
// - byte text: the same kernel body as reached through
//   banded_scores_via_pallas (:205), the drop-in for
//   vg_tpu.ops.align.banded_scores. The window is text[p] from a (T,)
//   uint8 array, masked the same way;
// - pre-gathered windows: as reached through banded_scores_pallas (:148).
//   Slot n aligns reads[n] as given against row n of an (N, TW) uint8
//   array, sentinel 6 past column TW; rlen[n] = 0 marks an empty slot.
//
// The DP: band W = 2B + 1, match +m / mismatch -x, gap open o / extend e,
// full-length bonus at both read ends, a zero floor (free soft clips), and
// E as an exact running max along the band. The score is max(best cell,
// end-of-read cell + bonus), floored at 0; the two text sources give
// invalid slots -1. Scores equal vg_tpu.ops.align.banded_scores (text
// sources) and vg_tpu.ops.pallas_align.banded_scores_pallas (windows).
//
// Rows. The text sources run min(rlen, RL) rows, as the XLA scan does.
// The windows source runs min(rlen, RLP) rows with RLP = RL rounded up to
// 8: the TPU kernel pads read rows to RLP with code 5 and keeps a row
// active while its index is below rlen, so a slot with rlen > RL scores
// up to 7 extra mismatch rows (and its end bonus when rlen <= RLP).
//
// Design. One thread per slot, the TPU's lane-per-candidate mapping. The
// band's H and F rows live in registers (arrays sized by the template
// parameter B, fully unrolled), and the row recurrence runs as one
// ascending pass over the band: F and H of band k+1 still hold the
// previous row when band k reads them, so both update in place, and the
// deletion term E is a sequential running max in the same pass. The
// thread slides its window one base per row: it keeps the W current text
// codes in registers and loads one code from its source per row, so no
// window tensor is ever written to device memory by the text sources.
// Rows past the read's length are skipped (they leave the state
// unchanged).
//
// What bounds it. Integer operations, not bytes: a band cell costs 14 int32
// operations (3 for F, 3 for the substitution, 1 diagonal add, 2 for the
// zero floor, 2 for E, 2 for its running max, 1 row max). At the paired
// main path's shape (6144 reads x 8 candidates per mate, 150 bp reads in
// rows of 160, B = 16) one launch fills at most 49,152 x 150 x 33 = 2.4e8
// cells, 3.4e9 operations: 0.10 ms at the H100's issue ceiling of 33.4 T
// lane-operations/s (132 SMs x 4 schedulers x 32 lanes x 1.98 GHz; the
// INT32 pipe alone gives half, the FMA pipe takes IMADs), against ~5 MB
// of input and output with packed text (1.6 us at 3.35 TB/s), ~8 MB with
// byte text and ~19 MB with pre-gathered windows.
//
// What the simple design gives up: three register arrays of W ints (128
// registers a thread at B = 16) limit the resident warps to 16 of 64 an
// SM; the window slide costs one register move per cell; and neighbouring
// threads load from unrelated text words and read rows (uncoalesced,
// served by L1/L2). A band-per-warp layout with coalesced loads and
// three-way integer max (__vimax3_s32) is the later step.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -100000000;   // vg_tpu.ops.align.NEG
constexpr int kSentinel = 6;       // window code that never matches a read
constexpr int kReadPad = 5;        // read code of the TPU kernel's pad rows
constexpr int kThreads = 128;

struct Scoring {
  int match, mismatch, gap_open, gap_extend, bonus;
};

// One slot's inputs: its oriented read, its length and the rows to fill.
struct Slot {
  const uint8_t* rd;
  int rl;
  int rows;
};

// Candidate tables over a haplotype text, packed (kPacked) or bytes.
template <bool kPacked>
struct TextSource {
  using Word = typename std::conditional<kPacked, int32_t, uint8_t>::type;
  const Word* text;
  long long T;
  const uint8_t* reads;
  const uint8_t* reads_rc;
  const int32_t* rlen;
  const int32_t* cstart;
  const int32_t* clo;
  const int32_t* chi;
  const uint8_t* crev;
  const uint8_t* cvalid;
  int C, RL;

  struct Window {
    const Word* text;
    long long start, lo, hi;
    // text code at window column q, sentinel outside [lo, hi) ∩ [0, T)
    __device__ __forceinline__ int code(long long q) const {
      const long long p = start + q;
      if (p < lo || p >= hi) return kSentinel;
      if constexpr (kPacked) {
        const uint32_t w = (uint32_t)__ldg(text + (p >> 3));
        return (int)((w >> ((p & 7) * 4)) & 15u);
      } else {
        return (int)__ldg(text + p);
      }
    }
  };

  // false for an invalid slot (score -1)
  __device__ __forceinline__ bool slot(long long n, Window& w,
                                       Slot& s) const {
    if (!cvalid[n]) return false;
    const long long r = n / C;
    s.rl = rlen[r];
    s.rows = s.rl < RL ? s.rl : RL;
    s.rd = (crev[n] ? reads_rc : reads) + r * RL;
    w.text = text;
    w.start = cstart[n];
    w.lo = clo[n] > 0 ? (long long)clo[n] : 0LL;
    w.hi = (long long)chi[n] < T ? (long long)chi[n] : T;
    return true;
  }
};

// Pre-gathered (N, TW) windows with reads already oriented.
struct WindowSource {
  const uint8_t* windows;
  const uint8_t* reads;
  const int32_t* rlen;
  int TW, RL;

  struct Window {
    const uint8_t* row;
    int TW;
    __device__ __forceinline__ int code(long long q) const {
      return q < TW ? (int)__ldg(row + q) : kSentinel;
    }
  };

  __device__ __forceinline__ bool slot(long long n, Window& w,
                                       Slot& s) const {
    const int rlp = (RL + 7) / 8 * 8;
    s.rl = rlen[n];
    s.rows = s.rl < rlp ? s.rl : rlp;
    s.rd = reads + n * RL;
    w.row = windows + n * TW;
    w.TW = TW;
    return true;
  }
};

template <int B, class Source>
__global__ void __launch_bounds__(kThreads)
banded_dp_kernel(const Source src, int32_t* __restrict__ out, long long N,
                 int RL, const Scoring sc) {
  constexpr int W = 2 * B + 1;
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  typename Source::Window win_src;
  Slot s;
  if (!src.slot(n, win_src, s)) {
    out[n] = -1;
    return;
  }
  const int bonus = sc.bonus;
  const int gap_open = sc.gap_open;
  const int gap_extend = sc.gap_extend;

  // H[W] and F[W] stay kNeg: the cell above the band's last column
  int H[W + 1], F[W + 1], win[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = bonus;        // row "-1": the left full-length bonus
    F[k] = kNeg;
    win[k] = kSentinel;
  }
  H[W] = kNeg;
  F[W] = kNeg;
  // before row i, win holds window columns i - 1 .. i + W - 2
#pragma unroll
  for (int k = 0; k + 1 < W; ++k) win[k + 1] = win_src.code(k);

  int best = 0;
  for (int i = 0; i < s.rows; ++i) {
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) win[k] = win[k + 1];
    win[W - 1] = win_src.code(i + W - 1);
    const int rb = i < RL ? s.rd[i] : kReadPad;
    const bool base = rb < 4;
    int run = kNeg;       // max over j < k of Hn[j] + gap_extend * j
    int row_max = kNeg;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      // band k + 1 still holds row i - 1: the same text column one row up
      const int f = max(H[k + 1] - gap_open, F[k + 1] - gap_extend);
      const int sub = (base && win[k] == rb) ? sc.match : -sc.mismatch;
      const int hn = max(max(H[k] + sub, f), 0);
      const int h = max(hn, run - gap_open - gap_extend * k + gap_extend);
      run = max(run, hn + gap_extend * k);
      H[k] = h;
      F[k] = f;
      row_max = max(row_max, h);
    }
    best = max(best, row_max);
    if (i + 1 == s.rl) best = max(best, row_max + bonus);
  }
  out[n] = best;
}

template <class Source>
cudaError_t launch(const Source& src, int32_t* out, long long N, int RL,
                   int B, const Scoring& sc, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  switch (B) {
    case 8:
      banded_dp_kernel<8, Source><<<blocks, kThreads, 0, stream>>>(
          src, out, N, RL, sc);
      break;
    case 12:
      banded_dp_kernel<12, Source><<<blocks, kThreads, 0, stream>>>(
          src, out, N, RL, sc);
      break;
    case 16:
      banded_dp_kernel<16, Source><<<blocks, kThreads, 0, stream>>>(
          src, out, N, RL, sc);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kPacked>
int launch_text(int device, const void* text, long long T, const void* reads,
                const void* reads_rc, const void* rlen, const void* start,
                const void* lo, const void* hi, const void* rev,
                const void* valid, void* out, int R, int C, int RL, int B,
                int match, int mismatch, int gap_open, int gap_extend,
                int bonus, void* stream) {
  const long long N = (long long)R * C;
  if (N == 0) return (int)cudaSuccess;
  // this library links its own CUDA runtime: select the tensors' card for
  // the calling thread before launching (callers launch from any thread)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  TextSource<kPacked> src;
  src.text = static_cast<const typename TextSource<kPacked>::Word*>(text);
  src.T = T;
  src.reads = static_cast<const uint8_t*>(reads);
  src.reads_rc = static_cast<const uint8_t*>(reads_rc);
  src.rlen = static_cast<const int32_t*>(rlen);
  src.cstart = static_cast<const int32_t*>(start);
  src.clo = static_cast<const int32_t*>(lo);
  src.chi = static_cast<const int32_t*>(hi);
  src.crev = static_cast<const uint8_t*>(rev);
  src.cvalid = static_cast<const uint8_t*>(valid);
  src.C = C;
  src.RL = RL;
  return (int)launch(src, static_cast<int32_t*>(out), N, RL, B,
                     Scoring{match, mismatch, gap_open, gap_extend, bonus},
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points (bound with ctypes). Pointers are device pointers of
// contiguous tensors on card `device`. Each launches on `stream` without
// synchronising and returns cudaGetLastError() (cudaErrorInvalidValue for
// a band radius other than 8, 12 or 16).
//
// banded_dp_packed: text (ceil(T/8)+2,) int32 packed words; reads, reads_rc
// (R, RL) uint8; rlen (R,) int32; start, lo, hi (R, C) int32; rev, valid
// (R, C) bool; out (R, C) int32.
extern "C" int banded_dp_packed(int device, const void* text, long long T,
                                const void* reads, const void* reads_rc,
                                const void* rlen, const void* start,
                                const void* lo, const void* hi,
                                const void* rev, const void* valid, void* out,
                                int R, int C, int RL, int B, int match,
                                int mismatch, int gap_open, int gap_extend,
                                int bonus, void* stream) {
  return launch_text<true>(device, text, T, reads, reads_rc, rlen, start, lo,
                           hi, rev, valid, out, R, C, RL, B, match, mismatch,
                           gap_open, gap_extend, bonus, stream);
}

// banded_dp_bytes: as banded_dp_packed, with text (T,) uint8 codes.
extern "C" int banded_dp_bytes(int device, const void* text, long long T,
                               const void* reads, const void* reads_rc,
                               const void* rlen, const void* start,
                               const void* lo, const void* hi,
                               const void* rev, const void* valid, void* out,
                               int R, int C, int RL, int B, int match,
                               int mismatch, int gap_open, int gap_extend,
                               int bonus, void* stream) {
  return launch_text<false>(device, text, T, reads, reads_rc, rlen, start,
                            lo, hi, rev, valid, out, R, C, RL, B, match,
                            mismatch, gap_open, gap_extend, bonus, stream);
}

// banded_dp_windows: windows (N, TW) uint8; reads (N, RL) uint8, oriented;
// rlen (N,) int32; out (N,) int32.
extern "C" int banded_dp_windows(int device, const void* windows,
                                 const void* reads, const void* rlen,
                                 void* out, long long N, int TW, int RL,
                                 int B, int match, int mismatch,
                                 int gap_open, int gap_extend, int bonus,
                                 void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  WindowSource src;
  src.windows = static_cast<const uint8_t*>(windows);
  src.reads = static_cast<const uint8_t*>(reads);
  src.rlen = static_cast<const int32_t*>(rlen);
  src.TW = TW;
  src.RL = RL;
  return (int)launch(src, static_cast<int32_t*>(out), N, RL, B,
                     Scoring{match, mismatch, gap_open, gap_extend, bonus},
                     static_cast<cudaStream_t>(stream));
}
