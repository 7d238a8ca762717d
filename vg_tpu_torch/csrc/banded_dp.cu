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
// A fourth entry, banded_dp_qual_packed, replaces no TPU kernel: it is the
// quality-adjusted DP that vg_tpu runs as an XLA scan
// (vg_tpu/ops/align.py:164 banded_scores_qual), on the packed words. It
// runs the int32 route with each row's match and mismatch scores read from
// phred-indexed tables (kept in shared memory) at the row's oriented
// quality, and the two full-length bonuses from a third table at the first
// and the last oriented base's quality (QualScores below).
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
// What bounds it: instruction issue on the INT32 pipe. The bytes are
// small (~5 MB with packed text at the paired main path's shape, 1.6 us at
// 3.35 TB/s); the work is one small integer recurrence per band cell,
// 6144 reads x 8 candidates x up to 150 rows x 33 cells a launch. The DPX
// instructions, LOP3, SHF and IADD3 share the INT32 pipe, which issues
// about half a warp instruction a cycle a scheduler (1.93 warp-
// instructions a cycle an SM for VIADDMNMX, s32 or s16x2, 4.23 cycles of
// latency: csrc/int_pipes.cu, run by chip_smoke.py on an NVIDIA H100 80GB
// HBM3 at 700 W); IMAD runs on the FMA pipe beside it. The first design
// (one slot a thread, 14 instructions a cell, every slot a lane) took the
// same time at 51% and 90% valid slots: the busiest scheduler set it.
//
// Design. Rows in order, the band's state in registers. What it does
// about issue:
//
// - Only valid slots occupy lanes. A block owns a fixed range of slots (a
//   multiple of kSlots): it writes the invalid slots' scores (-1 for the
//   text sources, 0 for a windows slot with rlen <= 0), ranks the valid
//   ones with one ballot per 32 slots, and runs only those, in slot order.
//   Threads past the count leave at once, so the warps that run the DP
//   are full but the last; output positions stay fixed, no atomics. The
//   16x2 kernel's range is the batch split over the SMs (pair_threads: 384
//   slots on the main path's 49,152 over 132 SMs, 128 blocks of about
//   three running warps, one a scheduler), so that few warps are partly
//   filled and each scheduler runs about one; at 128 slots a block, the
//   second warp of most blocks held one pair and cost as much issue as a
//   full one.
// - Two slots a thread in the 16-bit halves of each register
//   (banded_dp16_kernel, 64 threads a block): one DPX instruction serves
//   two cells, and half as many warps compete for the schedulers. With H
//   as it is (>= 0), Fo = F + o and R = E' + o (E' the deletion value
//   entering the cell), a pair of cells is
//     fo = max(Fo[k+1] - e, H[k+1])             __viaddmax_s16x2       1
//     the two hit bits at bits 0 and 16         shift, and             2
//     u  = H[k] + (m + x) hit                   IMAD (FMA pipe)        1
//     hn = max(fo - o, u - x, 0)                __viaddmax_s16x2,
//                                               __viaddmax_s16x2_relu  2
//     h  = max(R - o, hn); R = max(R - e, hn)   __viaddmax_s16x2 x 2   2
//     row max, two cells at a time              __vimax3_s16x2       0.5
//   8.5 instructions for two cells (4.25 a cell; the first design: 14).
//   ptxas: 128 registers at B = 16 (all the 512-thread cap allows), no
//   spills; rows run two an iteration.
//   Exact while no value leaves int16: H <= bonus + rows m, u <= H + m +
//   x, and the sentinel -2^14 loses at most o + e (W + 2) in a row, so
//   fits16() takes the route when bonus + (rows + 1) m + x <= 16383 and
//   o + e (2B + 3) <= 16383 (every parameter >= 0; rows = RL, or RLP for
//   the windows source; at the path's scoring and RL = 160: 170 and 41).
//   The IMAD cannot carry between halves since H >= 0 and u <= 16383.
//   The two slots may end at different rows: the loop runs the longer,
//   a half past its rows reads code 5 (no match), and its row maxima are
//   masked out of its best and its last row.
// - Any other call takes the int32 kernel (banded_dp_kernel, one slot a
//   thread, G = H - o): 7.5 instructions a cell with __viaddmax_s32,
//   __viaddmax_s32_relu and __vimax3_s32. Both routes are counted
//   (banded_dp_launches).
// - No window in registers. The band of row i covers window columns
//   i .. i + W - 1. For each base b the thread keeps bit masks of the
//   window columns whose code is b, two 32-column words at a time in its
//   slice of shared memory (word w of the window is built once, when row
//   32 (w - 1) starts); a row reads its read base's two words, funnel-
//   shifts them by i mod 32, and cell k tests bit k. A read code >= 4
//   (N, or the pad rows) reads a zero mask: it matches nothing. The first
//   design moved W registers a row to slide its window. The packed source
//   builds a word from five text words: nibble-wise compares (the zero-
//   nibble test) and a gather of the eight flags of each word, then the
//   [lo, hi) ∩ [0, T) range as a bit mask; the byte and window sources
//   compare 32 codes.
// - The launch sets the device only when it changes (cudaGetDevice first).

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -100000000;   // vg_tpu.ops.align.NEG
constexpr int kSentinel = 6;       // window code that never matches a read
constexpr int kReadPad = 5;        // read code of the TPU kernel's pad rows
constexpr int kSlots = 128;        // slots a block owns
constexpr int kMaxPairThreads = 512;   // 16x2 kernel: two slots a thread
constexpr int kMaskRows = 5;       // bases 0-3, and 4: the empty mask
constexpr int kNeg16 = -16384;     // the 16x2 kernel's -inf
constexpr int kMaxQualTab = 128;   // quality-table entries (cuda_align.py)
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
  int match, mismatch, gap_open, gap_extend, bonus;
};

// One slot's inputs: its oriented read, its length and the rows to fill;
// the read's index and strand (the quality entry reads its qualities).
struct Slot {
  const uint8_t* rd;
  int rl;
  int rows;
  long long read;
  bool rev;
};

// A slot's scores as dp_slot takes them, offset by the gap open (dp_slot
// keeps G = H - o): row(i) gives hit = m + o and miss = o + x for row i (x
// the signed mismatch score), first() the left full-length bonus and
// last() the right one.
struct PlainRows {   // the unadjusted scoring: every row the same
  int hit, miss, bonus;
  __device__ __forceinline__ void row(int, int& h, int& m) const {
    h = hit;
    m = miss;
  }
  __device__ __forceinline__ int first() const { return bonus; }
  __device__ __forceinline__ int last() const { return bonus; }
};

struct PlainScores {
  Scoring sc;
  __device__ __forceinline__ PlainRows of(const Slot&) const {
    return PlainRows{sc.match + sc.gap_open, sc.gap_open - sc.mismatch,
                     sc.bonus};
  }
};

// Base-quality-adjusted scores (vg_tpu.ops.align.banded_scores_qual): row
// i's oriented quality is q[i], or q[clip(rl - 1 - i, 0, RL - 1)] on the
// reverse strand, clipped to the tables' last index; the left bonus is
// taken at row 0's quality, the right one at row rl - 1's.
struct QualRows {
  const uint8_t* q;                    // the read's forward qualities
  const int32_t *mt, *mm, *bt;         // the tables, in shared memory
  int rev, rl, RL, qmax, o;
  __device__ __forceinline__ int qual(int i) const {
    int j = rev ? rl - 1 - i : i;
    j = j < 0 ? 0 : (j > RL - 1 ? RL - 1 : j);
    const int v = (int)__ldg(q + j);
    return v < qmax ? v : qmax;
  }
  __device__ __forceinline__ void row(int i, int& h, int& m) const {
    const int v = qual(i);
    h = mt[v] + o;
    m = o + mm[v];
  }
  __device__ __forceinline__ int first() const { return bt[qual(0)]; }
  __device__ __forceinline__ int last() const { return bt[qual(rl - 1)]; }
};

struct QualScores {
  const uint8_t* quals;                // (R, RL) forward qualities
  const int32_t *mt, *mm, *bt;
  int RL, qmax, o;
  __device__ __forceinline__ QualRows of(const Slot& s) const {
    return QualRows{quals + s.read * RL, mt, mm, bt, s.rev ? 1 : 0, s.rl,
                    RL, qmax, o};
  }
};

// m[b] |= bit for the code c of one window column (b = 0..3).
__device__ __forceinline__ void add_code(int c, uint32_t bit, uint32_t m[4]) {
  m[0] |= c == 0 ? bit : 0u;
  m[1] |= c == 1 ? bit : 0u;
  m[2] |= c == 2 ? bit : 0u;
  m[3] |= c == 3 ? bit : 0u;
}

// The eight flags of a nibble-wise test (bit 4j + 3 of z) as bits 0..7.
__device__ __forceinline__ uint32_t gather_nibble_flags(uint32_t z) {
  uint32_t y = z >> 3;
  y = (y | (y >> 3)) & 0x03030303u;
  y = (y | (y >> 6)) & 0x000f000fu;
  return (y | (y >> 12)) & 0xffu;
}

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
    long long T, start, lo, hi;   // lo, hi already cut to [0, T)

    // Bit j of m[b]: window column 32 word + j holds base b.
    __device__ __forceinline__ void masks(int word, uint32_t m[4]) const {
      m[0] = m[1] = m[2] = m[3] = 0u;
      const long long p0 = start + 32LL * word;
      const long long jl = lo - p0, jh = hi - p0;
      if (jl >= 32 || jh <= 0 || jl >= jh) return;
      uint32_t range = kFull;
      if (jl > 0) range &= ~((1u << jl) - 1u);
      if (jh < 32) range &= (1u << jh) - 1u;
      if constexpr (kPacked) {
        // window columns 8 t .. 8 t + 7 are nibbles of the packed words
        // wi + t and wi + t + 1 funnel-shifted by the start's nibble
        const long long wi = p0 >> 3;
        const long long last = (T - 1) >> 3;
        const int s = (int)(p0 & 7) * 4;
        uint32_t tw[5];
#pragma unroll
        for (int t = 0; t < 5; ++t) {
          long long idx = wi + t;
          idx = idx < 0 ? 0 : (idx > last ? last : idx);
          tw[t] = (uint32_t)__ldg(text + idx);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t nib = __funnelshift_r(tw[t], tw[t + 1], s);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            // zero-nibble test of nib ^ b: bit 4j + 3 set iff nibble j == b
            const uint32_t x = nib ^ (0x11111111u * (uint32_t)b);
            const uint32_t z =
                ~(((x & 0x77777777u) + 0x77777777u) | x) & 0x88888888u;
            m[b] |= gather_nibble_flags(z) << (8 * t);
          }
        }
      } else {
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          if ((range >> j) & 1u) add_code((int)__ldg(text + p0 + j), 1u << j, m);
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) m[b] &= range;
    }
  };

  __device__ __forceinline__ bool valid(long long n) const {
    return cvalid[n] != 0;
  }
  static constexpr int kEmptyScore = -1;

  __device__ __forceinline__ void slot(long long n, Window& w,
                                       Slot& s) const {
    const long long r = n / C;
    s.rl = rlen[r];
    s.rows = s.rl < RL ? s.rl : RL;
    s.read = r;
    s.rev = crev[n] != 0;
    s.rd = (s.rev ? reads_rc : reads) + r * RL;
    w.text = text;
    w.T = T;
    w.start = cstart[n];
    w.lo = clo[n] > 0 ? (long long)clo[n] : 0LL;
    w.hi = (long long)chi[n] < T ? (long long)chi[n] : T;
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
    __device__ __forceinline__ void masks(int word, uint32_t m[4]) const {
      m[0] = m[1] = m[2] = m[3] = 0u;
      const int q0 = 32 * word;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        if (q0 + j < TW) add_code((int)__ldg(row + q0 + j), 1u << j, m);
      }
    }
  };

  __device__ __forceinline__ bool valid(long long n) const {
    return rlen[n] > 0;
  }
  static constexpr int kEmptyScore = 0;

  __device__ __forceinline__ void slot(long long n, Window& w,
                                       Slot& s) const {
    const int rlp = (RL + 7) / 8 * 8;
    s.rl = rlen[n];
    s.rows = s.rl < rlp ? s.rl : rlp;
    s.read = n;
    s.rev = false;
    s.rd = reads + n * RL;
    w.row = windows + n * TW;
    w.TW = TW;
  }
};

// Mask word `word` of the window into a thread's slice (rows `stride`
// apart): row 2 b + (word & 1) for b = 0..3; row 2 (kMaskRows - 1) + h
// stays 0.
template <class Win>
__device__ __forceinline__ void store_masks(const Win& win, int word,
                                            uint32_t* mask, int stride) {
  uint32_t m[4];
  win.masks(word, m);
#pragma unroll
  for (int b = 0; b < 4; ++b) mask[(2 * b + (word & 1)) * stride] = m[b];
}

template <class Win>
__device__ __forceinline__ void init_masks(const Win& win, uint32_t* mask,
                                           int stride) {
  mask[(2 * (kMaskRows - 1)) * stride] = 0u;
  mask[(2 * (kMaskRows - 1) + 1) * stride] = 0u;
  store_masks(win, 0, mask, stride);
  store_masks(win, 1, mask, stride);
}

// Row i's match mask of a read code: bits k = 0..31 (m0) and k = 32 (m1)
// set where window column i + k holds the code (none for a code >= 4).
__device__ __forceinline__ void row_mask(const uint32_t* mask, int stride,
                                         int rb, int i, uint32_t& m0,
                                         uint32_t& m1) {
  const int b = rb < 4 ? rb : kMaskRows - 1;
  const int wd = i >> 5, sh = i & 31;
  const uint32_t lo = mask[(2 * b + (wd & 1)) * stride];
  const uint32_t hi = mask[(2 * b + ((wd + 1) & 1)) * stride];
  m0 = __funnelshift_r(lo, hi, sh);
  m1 = hi >> sh;
}

// The block's compaction: the block owns slots n0 .. n0 + kH T - 1 (T =
// blockDim.x, a multiple of 32), each thread checking kH of them (tid +
// h T). Invalid slots get their score here; s_list[0, count) receives the
// valid slots' offsets in slot order. Returns count; ends synchronised.
template <int kH, class Source>
__device__ __forceinline__ int compact_block(const Source& src,
                                             int32_t* __restrict__ out,
                                             long long N, long long n0,
                                             int* s_list, int* s_count) {
  const int kT = blockDim.x, kW = kT >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned ball[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    const long long n = n0 + tid + h * kT;
    bool live = false;
    if (n < N) {
      live = src.valid(n);
      if (!live) out[n] = Source::kEmptyScore;
    }
    ball[h] = __ballot_sync(kFull, live);
    if (lane == 0) s_count[h * kW + warp] = __popc(ball[h]);
  }
  __syncthreads();
  int count = 0, before[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) before[h] = 0;
  for (int g = 0; g < kH * kW; ++g) {       // 32-slot groups, slot order
    const int c = s_count[g];
#pragma unroll
    for (int h = 0; h < kH; ++h) before[h] += g < h * kW + warp ? c : 0;
    count += c;
  }
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if ((ball[h] >> lane) & 1u)
      s_list[before[h] + __popc(ball[h] & lt)] = tid + h * kT;
  }
  __syncthreads();
  return count;
}

// ---------------------------------------------------------------- 32-bit

// The DP of one valid slot n in int32 (G = H - o), with the row scores of
// `scores` (PlainScores or QualScores). `mask` is the thread's column of a
// (kMaskRows * 2, kT) array.
template <int B, int kT, class Source, class Scores>
__device__ __forceinline__ int dp_slot(const Source& src, long long n,
                                       int RL, const Scoring& sc,
                                       const Scores& scores, uint32_t* mask) {
  constexpr int W = 2 * B + 1;
  typename Source::Window win;
  Slot s;
  src.slot(n, win, s);
  const auto rs = scores.of(s);
  const int o = sc.gap_open, e = sc.gap_extend;
  init_masks(win, mask, kT);

  // G = H - o; G[W], F[W] are the cells above the band's last column
  const int g0 = (s.rows > 0 ? rs.first() : 0) - o;
  int G[W + 1], F[W + 1];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    G[k] = g0;             // row "-1": the left full-length bonus
    F[k] = kNeg;
  }
  G[W] = kNeg - o;
  F[W] = kNeg;

  int best = 0, last = kNeg;   // last: the last row's max of G
  for (int i = 0; i < s.rows; ++i) {
    if ((i & 31) == 0 && i > 0) store_masks(win, (i >> 5) + 1, mask, kT);
    uint32_t m0, m1;
    row_mask(mask, kT, i < RL ? (int)s.rd[i] : kReadPad, i, m0, m1);
    int hit_score, miss_score;
    rs.row(i, hit_score, miss_score);
    int ep = kNeg;         // E': the deletion value entering cell k
    int rmax = kNeg;
    int gprev = kNeg;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      // band k + 1 still holds row i - 1: the same text column one row up
      const int f = __viaddmax_s32(F[k + 1], -e, G[k + 1]);
      const bool hit = k < 32 ? ((m0 >> (k & 31)) & 1u) : (m1 & 1u);
      const int hn = __viaddmax_s32_relu(G[k], hit ? hit_score : miss_score,
                                         f);
      const int x = hn - o;
      const int g = __viaddmax_s32(ep, -o, x);
      ep = __viaddmax_s32(ep, -e, x);
      G[k] = g;
      F[k] = f;
      if (k & 1) {
        rmax = __vimax3_s32(rmax, gprev, g);
      } else if (k == W - 1) {
        rmax = max(rmax, g);
      }
      gprev = g;
    }
    best = __viaddmax_s32(rmax, o, best);
    last = rmax;
  }
  // the end-of-read bonus, when the last row run is the read's last base
  if (s.rows > 0 && s.rows == s.rl) best = max(best, last + o + rs.last());
  return best;
}

template <int B, class Source>
__global__ void __launch_bounds__(kSlots)
banded_dp_kernel(const Source src, int32_t* __restrict__ out, long long N,
                 int RL, const Scoring sc) {
  __shared__ uint32_t s_mask[kMaskRows * 2 * kSlots];
  __shared__ int s_list[kSlots];
  __shared__ int s_count[kSlots / 32];
  const long long n0 = (long long)blockIdx.x * kSlots;
  const int count = compact_block<1>(src, out, N, n0, s_list, s_count);
  const int t = threadIdx.x;
  if (t >= count) return;
  const long long slot = n0 + s_list[t];
  out[slot] = dp_slot<B, kSlots>(src, slot, RL, sc, PlainScores{sc},
                                 s_mask + t);
}

// The quality entry: banded_dp_kernel's int32 body with QualScores. The
// block copies the three tables (nq <= kMaxQualTab entries each) to
// shared memory; compact_block's barriers publish them.
template <int B>
__global__ void __launch_bounds__(kSlots)
banded_dp_qual_kernel(const TextSource<true> src,
                      const uint8_t* __restrict__ quals,
                      const int32_t* __restrict__ mt,
                      const int32_t* __restrict__ mm,
                      const int32_t* __restrict__ bt, int nq,
                      int32_t* __restrict__ out, long long N, int RL,
                      const Scoring sc) {
  __shared__ uint32_t s_mask[kMaskRows * 2 * kSlots];
  __shared__ int s_list[kSlots];
  __shared__ int s_count[kSlots / 32];
  __shared__ int32_t s_tab[3 * kMaxQualTab];
  for (int j = threadIdx.x; j < nq; j += blockDim.x) {
    s_tab[j] = mt[j];
    s_tab[kMaxQualTab + j] = mm[j];
    s_tab[2 * kMaxQualTab + j] = bt[j];
  }
  const long long n0 = (long long)blockIdx.x * kSlots;
  const int count = compact_block<1>(src, out, N, n0, s_list, s_count);
  const int t = threadIdx.x;
  if (t >= count) return;
  const long long slot = n0 + s_list[t];
  const QualScores qs{quals, s_tab, s_tab + kMaxQualTab,
                      s_tab + 2 * kMaxQualTab, RL, nq - 1, sc.gap_open};
  out[slot] = dp_slot<B, kSlots>(src, slot, RL, sc, qs, s_mask + t);
}

// ---------------------------------------------------------------- 16x2

__device__ __forceinline__ uint32_t pair16(int v) {
  return ((uint32_t)v & 0xffffu) * 0x00010001u;
}

__device__ __forceinline__ int low16(uint32_t v) { return (int)(int16_t)v; }
__device__ __forceinline__ int high16(uint32_t v) {
  return (int)(int16_t)(v >> 16);
}

// The DP of two valid slots nA and nB (nB < 0: none) in the two 16-bit
// halves of each register (A low, B high). H is kept as it is (>= 0),
// Fo = F + o, and R = E' + o the deletion value entering a cell:
//   fo = max(Fo[k+1] - e, H[k+1])             __viaddmax_s16x2
//   u  = H[k] + (m + x) * hit(k), per half    IMAD (FMA pipe)
//   hn = max(fo - o, u - x, 0)                __viaddmax_s16x2 (u - x),
//                                             __viaddmax_s16x2_relu
//   h  = max(R - o, hn);  R = max(R - e, hn)  __viaddmax_s16x2 x 2
// Both halves run max(rows A, rows B) rows; a half past its own rows reads
// code 5 (no match) and its row maxima are masked out. Exact while no
// value leaves int16: fits16() checks the scoring and the row count.
template <int B, class Source>
__device__ __forceinline__ void dp_pair(const Source& src, long long nA,
                                        long long nB, int RL,
                                        const Scoring& sc, uint32_t* maskA,
                                        uint32_t* maskB, int kT, int& outA,
                                        int& outB) {
  constexpr int W = 2 * B + 1;
  typename Source::Window wa, wb;
  Slot sa, sb;
  src.slot(nA, wa, sa);
  if (nB >= 0) {
    src.slot(nB, wb, sb);
  } else {
    wb = wa;
    sb = sa;
    sb.rl = sb.rows = 0;
  }
  init_masks(wa, maskA, kT);
  init_masks(wb, maskB, kT);
  const uint32_t neg = pair16(kNeg16), me = pair16(-sc.gap_extend),
                 mo = pair16(-sc.gap_open), mx = pair16(-sc.mismatch);
  const uint32_t dmx = (uint32_t)(sc.match + sc.mismatch);
  uint32_t H[W + 1], Fo[W + 1];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = pair16(sc.bonus);   // row "-1": the left full-length bonus
    Fo[k] = neg;
  }
  H[W] = neg;
  Fo[W] = neg;
  uint32_t best = 0, last = neg;
  const int rows = sa.rows > sb.rows ? sa.rows : sb.rows;
  // two rows an iteration: the scheduler overlaps row i + 1's first cells
  // with row i's last ones (one warp a scheduler leaves latency to hide)
#pragma unroll 2
  for (int i = 0; i < rows; ++i) {
    if ((i & 31) == 0 && i > 0) {
      store_masks(wa, (i >> 5) + 1, maskA, kT);
      store_masks(wb, (i >> 5) + 1, maskB, kT);
    }
    uint32_t a0, a1, b0, b1;
    row_mask(maskA, kT, i < sa.rows && i < RL ? (int)sa.rd[i] : kReadPad, i,
             a0, a1);
    row_mask(maskB, kT, i < sb.rows && i < RL ? (int)sb.rd[i] : kReadPad, i,
             b0, b1);
    // hit bits of cells k (A) and k (B) at bits k and k + 16 of lo (k <
    // 16) and hi (16 <= k < 32); cell 32 in top
    const uint32_t lo = (a0 & 0xffffu) | (b0 << 16);
    const uint32_t hi = (a0 >> 16) | (b0 & 0xffff0000u);
    const uint32_t top = (a1 & 1u) | ((b1 & 1u) << 16);
    uint32_t R = neg, rmax = neg, hprev = neg;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint32_t fo = __viaddmax_s16x2(Fo[k + 1], me, H[k + 1]);
      const uint32_t spread = k < 16 ? (lo >> k) & 0x00010001u
                            : k < 32 ? (hi >> (k - 16)) & 0x00010001u
                                     : top;
      const uint32_t u = spread * dmx + H[k];
      const uint32_t hn = __viaddmax_s16x2_relu(
          fo, mo, __viaddmax_s16x2(u, mx, neg));
      const uint32_t h = __viaddmax_s16x2(R, mo, hn);
      R = __viaddmax_s16x2(R, me, hn);
      H[k] = h;
      Fo[k] = fo;
      if (k & 1) {
        rmax = __vimax3_s16x2(rmax, hprev, h);
      } else if (k == W - 1) {
        rmax = __vimax3_s16x2(rmax, h, h);
      }
      hprev = h;
    }
    // only the halves whose slot still has row i take it
    const uint32_t act = (i < sa.rows ? 0x0000ffffu : 0u)
                       | (i < sb.rows ? 0xffff0000u : 0u);
    best = __vimax3_s16x2(best, (rmax & act) | (neg & ~act), best);
    last = (rmax & act) | (last & ~act);
  }
  outA = low16(best);
  if (sa.rows > 0 && sa.rows == sa.rl)
    outA = max(outA, low16(last) + sc.bonus);
  outB = high16(best);
  if (sb.rows > 0 && sb.rows == sb.rl)
    outB = max(outB, high16(last) + sc.bonus);
}

// Dynamic shared memory of a 16x2 block of T threads (2 T slots): the
// two slots' masks, the list, the group counts.
constexpr int dp16_smem(int T) { return 4 * (2 * kMaskRows * 2 * T + 3 * T); }

// A block of T = blockDim.x threads owns 2 T slots (a multiple of kSlots
// sized by the launch so that the grid about fills the card once).
template <int B, class Source>
__global__ void __launch_bounds__(kMaxPairThreads)
banded_dp16_kernel(const Source src, int32_t* __restrict__ out, long long N,
                   int RL, const Scoring sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = blockDim.x;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem_raw);
  int* s_list = reinterpret_cast<int*>(s_mask + 2 * kMaskRows * 2 * T);
  int* s_count = s_list + 2 * T;
  const long long n0 = (long long)blockIdx.x * 2 * T;
  const int count = compact_block<2>(src, out, N, n0, s_list, s_count);
  const int t = threadIdx.x;
  if (2 * t >= count) return;
  const long long nA = n0 + s_list[2 * t];
  const long long nB = 2 * t + 1 < count ? n0 + s_list[2 * t + 1] : -1;
  int a, b;
  dp_pair<B>(src, nA, nB, RL, sc, s_mask + t,
             s_mask + kMaskRows * 2 * T + t, T, a, b);
  out[nA] = a;
  if (nB >= 0) out[nB] = b;
}

// Whether every value of the DP fits int16 for this scoring and row
// count: H <= bonus + (rows + 1) match + mismatch after the hit add,
// the sentinel -2^14 minus a row's deletion decay and a gap open stays
// above -2^15.
bool fits16(const Scoring& sc, int rows, int B) {
  const long long lim = 16383;
  if (sc.match < 0 || sc.mismatch < 0 || sc.gap_open < 0
      || sc.gap_extend < 0 || sc.bonus < 0)
    return false;
  return (long long)sc.bonus + (long long)(rows + 1) * sc.match
                 + sc.mismatch <= lim
         && (long long)sc.gap_open + (long long)sc.gap_extend * (2 * B + 3)
                <= lim
         && sc.mismatch <= lim;
}

std::atomic<long long> g_launches16{0}, g_launches32{0};
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];   // SM count by device, read once (0: not yet)

// Threads of a 16x2 block: the slots split over the SMs, in kSlots steps,
// two a thread (64 to kMaxPairThreads). At the main path's 49,152 slots
// on 132 SMs: 384 slots, 128 blocks, about three full warps each.
int pair_threads(long long N, int device) {
  int& sms = g_sms[device];
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         device) != cudaSuccess)
    sms = 132;
  long long slots = (N + sms - 1) / sms;
  slots = (slots + kSlots - 1) / kSlots * kSlots;
  if (slots > 2 * kMaxPairThreads) slots = 2 * kMaxPairThreads;
  return (int)(slots / 2);
}

template <int B, class Source>
cudaError_t launch_b(const Source& src, int32_t* out, long long N, int RL,
                     int rows, const Scoring& sc, int device,
                     cudaStream_t stream) {
  if (fits16(sc, rows, B)) {
    const int T = pair_threads(N, device);
    const unsigned blocks = (unsigned)((N + 2 * T - 1) / (2 * T));
    banded_dp16_kernel<B, Source><<<blocks, T, dp16_smem(T), stream>>>(
        src, out, N, RL, sc);
    g_launches16.fetch_add(1);
  } else {
    const unsigned blocks = (unsigned)((N + kSlots - 1) / kSlots);
    banded_dp_kernel<B, Source><<<blocks, kSlots, 0, stream>>>(
        src, out, N, RL, sc);
    g_launches32.fetch_add(1);
  }
  return cudaGetLastError();
}

// rows: the most rows a slot may run (RL for the text sources, RLP for
// the windows source).
template <class Source>
cudaError_t launch(const Source& src, int32_t* out, long long N, int RL,
                   int rows, int B, const Scoring& sc, int device,
                   cudaStream_t stream) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  switch (B) {
    case 8: return launch_b<8>(src, out, N, RL, rows, sc, device, stream);
    case 12: return launch_b<12>(src, out, N, RL, rows, sc, device, stream);
    case 16: return launch_b<16>(src, out, N, RL, rows, sc, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// This library links its own CUDA runtime: make the tensors' card current
// for the calling thread (callers launch from any thread), only when it is
// not already.
cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

template <bool kPacked>
TextSource<kPacked> text_source(const void* text, long long T,
                                const void* reads, const void* reads_rc,
                                const void* rlen, const void* start,
                                const void* lo, const void* hi,
                                const void* rev, const void* valid, int C,
                                int RL) {
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
  return src;
}

template <int B>
cudaError_t launch_qual(const TextSource<true>& src, const uint8_t* quals,
                        const int32_t* mt, const int32_t* mm,
                        const int32_t* bt, int nq, int32_t* out, long long N,
                        int RL, const Scoring& sc, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((N + kSlots - 1) / kSlots);
  banded_dp_qual_kernel<B><<<blocks, kSlots, 0, stream>>>(
      src, quals, mt, mm, bt, nq, out, N, RL, sc);
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
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const auto src = text_source<kPacked>(text, T, reads, reads_rc, rlen,
                                        start, lo, hi, rev, valid, C, RL);
  return (int)launch(src, static_cast<int32_t*>(out), N, RL, RL, B,
                     Scoring{match, mismatch, gap_open, gap_extend, bonus},
                     device, static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points (bound with ctypes). Pointers are device pointers of
// contiguous tensors on card `device`. Each launches on `stream` without
// synchronising and returns cudaGetLastError() (cudaErrorInvalidValue for
// a band radius other than 8, 12 or 16).
//
// Slots a block owns (ops/dp_cases.BLOCK_SLOTS says the same).
extern "C" int banded_dp_block_slots() { return kSlots; }

// Launches so far of the 16x2 kernel (bits = 16) or the int32 one (32).
extern "C" long long banded_dp_launches(int bits) {
  return bits == 16 ? g_launches16.load()
                    : bits == 32 ? g_launches32.load() : -1;
}

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
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  WindowSource src;
  src.windows = static_cast<const uint8_t*>(windows);
  src.reads = static_cast<const uint8_t*>(reads);
  src.rlen = static_cast<const int32_t*>(rlen);
  src.TW = TW;
  src.RL = RL;
  return (int)launch(src, static_cast<int32_t*>(out), N, RL, (RL + 7) / 8 * 8,
                     B, Scoring{match, mismatch, gap_open, gap_extend, bonus},
                     device, static_cast<cudaStream_t>(stream));
}

// banded_dp_qual_packed: the quality-adjusted DP on the packed words. As
// banded_dp_packed, with quals (R, RL) uint8 phred in the reads' forward
// orientation and match_tab, mism_tab, bonus_tab (nq,) int32 (1 <= nq <=
// 128; the mismatch scores signed). Always the int32 kernel; counted by
// the wrapper, not by banded_dp_launches.
extern "C" int banded_dp_qual_packed(
    int device, const void* text, long long T, const void* reads,
    const void* reads_rc, const void* quals, const void* rlen,
    const void* start, const void* lo, const void* hi, const void* rev,
    const void* valid, const void* match_tab, const void* mism_tab,
    const void* bonus_tab, int nq, void* out, int R, int C, int RL, int B,
    int gap_open, int gap_extend, void* stream) {
  const long long N = (long long)R * C;
  if (N == 0) return (int)cudaSuccess;
  if (nq < 1 || nq > kMaxQualTab) return (int)cudaErrorInvalidValue;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const auto src = text_source<true>(text, T, reads, reads_rc, rlen, start,
                                     lo, hi, rev, valid, C, RL);
  const Scoring sc{0, 0, gap_open, gap_extend, 0};
  const auto* q = static_cast<const uint8_t*>(quals);
  const auto* mt = static_cast<const int32_t*>(match_tab);
  const auto* mm = static_cast<const int32_t*>(mism_tab);
  const auto* bt = static_cast<const int32_t*>(bonus_tab);
  auto* o = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (B) {
    case 8: err = launch_qual<8>(src, q, mt, mm, bt, nq, o, N, RL, sc, st);
      break;
    case 12: err = launch_qual<12>(src, q, mt, mm, bt, nq, o, N, RL, sc, st);
      break;
    case 16: err = launch_qual<16>(src, q, mt, mm, bt, nq, o, N, RL, sc, st);
      break;
  }
  return (int)err;
}
