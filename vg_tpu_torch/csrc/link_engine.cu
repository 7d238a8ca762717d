// The long-read link engine (sm_90a): the fill and the walk, and the passes
// that feed and drain them (link_pack, link_runs).
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
// Both kernels order a block's tasks by their rows (min(max(la, 0),
// RMAX)) before handing them to warps, so that a warp's tasks run about as
// many rows or steps (tasks come in DeviceLinkAligner's order, lengths
// mixed; padding, la = 0, at the end).
//
// link_fill_kernel<CPL> — a group of 8 lanes per task, the rows in order.
// What bounds it: operations. At the long-read cell's bucket 256 (N =
// 8,192) the recurrence is 46 int32 operations a cell
// (cuda_links.FILL_OPS_PER_CELL, counted on the plain version) on the
// rows a task runs, 0.075 ms at the card's issue rate; the 137 MB of bits
// take 0.041 ms at 3.35 TB/s. Design:
// - Lane g of the group holds the CPL = ceil(WB / 8) consecutive columns
//   g CPL .. g CPL + CPL - 1 (9 at WB = 65: 72 slots for 65 columns;
//   slots past WB hold NEG). H[c + 1] and F[c + 1] of row i - 1, the
//   row's hn[c - 1], E[c - 1] and H[c - 1] are the lane's own registers
//   except at its edge columns: H and F of the next lane's first column
//   (two shuffles) and hn of the previous lane's last column (one).
// - The lazy-E cummax along the row: a serial max along the lane's
//   columns, then a prefix max of the lane totals across the 8 lanes (3
//   __shfl_up_sync steps and one more for the exclusive carry). The
//   carry is the cummax at the previous lane's last column, so E and H of
//   that column follow from it and the shuffled hn without a shuffle: 7
//   shuffles a row for four tasks.
// - Out-of-band and past-WB cells go unmasked into the shifts and the
//   scan and are masked after, in the plain version's order.
// - The warp runs the longest of its four tasks' row counts, every lane
//   in step (full-mask shuffles); a task's rows past la compute cells
//   that are out of band, so their bits are 0 and H, F NEG, as the plain
//   version's masked rows read. Rows past the warp's count are
//   zero-filled with 16-byte stores: padding tasks cost their bytes only.
// - The read's words and its KB-byte text window (KB = round_up(RMAX + WB
//   + 8, 8), text codes gathered from the 4-bit packed words, 6 outside
//   [0, T)) are loaded once into shared memory; a row reads its read code
//   as a broadcast, and each lane slides its CPL text codes along the
//   window, one shared load a row.
// - The bits of a row go to shared memory, a byte a cell, without a
//   branch (a slot past WB writes 0 over the next row's first bytes,
//   which that row rewrites), and every kStageRows = 16 rows the group
//   writes them out with 16-byte stores (the staged rows lie at the phase
//   of their place in the output): from registers, each byte store of a
//   warp would touch four tasks' rows at a stride of CPL bytes.
// - What is left bounds it: the row's integer instructions, some 40 a
//   column, which keep each scheduler near one issue a cycle at bucket
//   256 (F-extend is one compare, fx > fo, of them). The warps w and
//   w + 4 of a block, which share a scheduler, take the ordered tasks
//   from the two ends, so that each scheduler gets short and long rows
//   alike.
//
// link_walk_kernel — a group of 4 lanes per task, eight tasks a warp,
// STEPS = round_up(RMAX + WB + 64, 8) steps. What bounds a walk: each
// step depends on the cell the step before chose; a thread-per-task walk
// waits on device memory every step. Design:
// - Every move goes up a row or left within one, so the walk reads the
//   task's rows from tiles of kTileRows = 16 rows in shared memory (1,040
//   bytes at WB = 65): when the row leaves the tile, the tile of rows
//   [ci - 15, ci] replaces it. One lane starts a bulk copy (TMA,
//   cp.async.bulk) of the tile's aligned 16-byte chunks, which completes
//   a phase of the buffer's mbarrier, and it starts the next tile's copy
//   (the 16 rows above) into the task's second buffer as soon as a tile
//   is in use, so that the walk waits on device memory once a task, for
//   its first tile: a copy started when the walk needs it would stall the
//   warp, once for each of its tasks, and one lane's bulk copy costs a
//   few instructions where the lanes' own 16-byte copies cost some 100.
// - All lanes of a task run the step on the same state (the shared load
//   is a broadcast, predicated, and the tiles' shared address stays in a
//   register), and the step is written without branches, so that a
//   warp's eight tasks issue as one; a warp's loop ends when its walks
//   have halted, and the rest of each task's words are filled with halted
//   ops. The step loop is not unrolled and a group walks one task: an
//   unrolled loop ran no faster, two walks interleaved in a group slower.
//   Two tiles a task, 32 tasks a block: 70 KB of shared memory, so that
//   the long-read cell's 8,192 tasks fit the card at once.
// - A step whose row lies outside the task's rows 0..RMAX (row -1 through
//   an F move on row 0, or la > RMAX) takes a global load, behind a
//   warp-wide vote, as rare as it is: the int64 flat index n (RMAX + 1) WB
//   + row WB + clamp(column), wrapped once by the array's size when
//   negative and clamped into the array, as vg_tpu's int32 gather does
//   but without its overflow from 42,960 tasks in bucket 768.
//
// Not done here: fusing the walk into the fill's block. The walk's index
// may leave its task (row -1 reads the previous task's last row, which
// another block writes), and the seam is where the plain versions are
// compared.
//
// The two passes around the engine. vg_tpu runs them in numpy on the host
// (vg_tpu/ops/device_links.py:300-307 packs the read slices, :333-377
// turns the walk's step codes into runs; vg_tpu/map/longread.py:656-676
// gathers the oriented slices from a forward + reverse-complement blob).
// Here they run on the card, so that only scores, the certified mask, run
// counts and the runs come back (cuda_links.link_pack_ref and
// link_runs_ref are their plain versions).
//
// link_pack_kernel — a thread per output word of a4 (8 bases). What bounds
// it: bytes, the slices read and the words written (about 2 MB a bucket of
// the long-read cell: under a microsecond at 3.35 TB/s). Design: each
// thread reads its task's row of the table and its 8 bases straight from
// the forward codes, the reverse strand as complements read backwards, so
// the host neither builds a reverse-complement blob nor gathers slices;
// neighbouring threads take neighbouring words of a task.
//
// link_runs_kernel<kWrite> — a warp per task, 32 steps an iteration. What
// bounds it: bytes (each certified task's packed codes read, its runs
// written: some 1.5 MB a bucket). A step s < n_steps starts a run of the
// stored (last-first) order where its op differs from step s - 1's and
// ends one where it differs from step s + 1's; __ballot_sync gathers both
// flags of the warp's 32 steps. The count pass sums the starts. The write
// pass gives the run that ends at step s its index r in stored order (the
// ends before it) and its start (the highest start at or below s, or the
// one carried from an earlier iteration), and writes it to slot
// ends[t] - 1 - r: the forward order, at the offset of the inclusive scan
// of the counts. A run never crosses tasks: each warp sees one task.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);     // ops/cuda_links.NEG
constexpr int kMaxWB = 96;
constexpr int kMaxRmax = 1024;
constexpr int kGroup = 8;            // lanes a fill task
constexpr int kWarpTasks = 32 / kGroup;
constexpr int kFillWarps = 8;        // 32 tasks a fill block
constexpr int kFillTasks = kFillWarps * kWarpTasks;
constexpr int kStageRows = 16;       // rows a fill task stages
constexpr int kWalkLanes = 4;        // lanes a walk task
constexpr int kWalkWarpTasks = 32 / kWalkLanes;
constexpr int kWalkWarps = 4;        // 32 tasks a walk block
constexpr int kWalkTasks = kWalkWarps * kWalkWarpTasks;
constexpr int kTileRows = 16;        // rows of a walk tile
constexpr int kStaticSmem = 48 * 1024;
constexpr int kTextCode = 6;         // text code outside [0, T)
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kHaltedWord = 0x44444444u;   // eight halted ops

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

// The block's tasks n0 .. n0 + count - 1 in ascending order of their rows
// (ties by index; tasks past N last): s_task[r] is the offset of the task
// of rank r. Every thread of the block calls it.
template <int kTasks>
__device__ void order_tasks(const int32_t* __restrict__ la_, long long n0,
                            int N, int RMAX, int* s_key, int* s_task) {
  const int t = threadIdx.x;
  if (t < kTasks)
    s_key[t] = n0 + t < N ? clampi(la_[n0 + t], 0, RMAX) : RMAX + 1;
  __syncthreads();
  if (t < kTasks) {
    const int key = s_key[t];
    int rank = 0;
    for (int u = 0; u < kTasks; ++u) {
      const int k = s_key[u];
      rank += k < key || (k == key && u < t);
    }
    s_task[rank] = t;
  }
  __syncthreads();
}

// len bytes at p set to 0 by the group's lanes, 16 bytes a store where
// aligned.
__device__ void group_zero(uint8_t* p, long long len, int g) {
  const long long head =
      min((long long)((16 - ((uintptr_t)p & 15)) & 15), len);
  for (long long t = g; t < head; t += kGroup) p[t] = 0;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  const long long nv = (len - head) >> 4;
  for (long long t = g; t < nv; t += kGroup) v[t] = make_uint4(0, 0, 0, 0);
  for (long long t = head + nv * 16 + g; t < len; t += kGroup) p[t] = 0;
}

// Shared bytes a fill task holds: its staged rows (kStageRows rows at any
// 16-byte phase, and the 7 bytes past them that slots past WB write), its
// read words, then its text window.
__host__ __device__ inline int fill_stage_bytes(int WB) {
  return (kStageRows * WB + 15 + 7 + 15) / 16 * 16;
}
__host__ __device__ inline int fill_task_bytes(int RMAX, int WB) {
  const int KB = (RMAX + WB + 8 + 7) / 8 * 8;
  return fill_stage_bytes(WB) + (RMAX / 8 * 4 + KB + 15) / 16 * 16;
}

// len bytes from src in shared memory to dst in device memory, src at
// dst's 16-byte phase, by the group's lanes: 16-byte stores where
// aligned, bytes at the two ends.
__device__ void group_store(uint8_t* dst, const uint8_t* src, int len,
                            int g) {
  const int head = min((16 - (int)((uintptr_t)dst & 15)) & 15, len);
  for (int t = g; t < head; t += kGroup) dst[t] = src[t];
  const int nv = (len - head) >> 4;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  for (int t = g; t < nv; t += kGroup) dv[t] = sv[t];
  for (int t = head + nv * 16 + g; t < len; t += kGroup) dst[t] = src[t];
}

template <int CPL>
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
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_key[kFillTasks], s_task[kFillTasks];
  const long long n0 = (long long)blockIdx.x * kFillTasks;
  order_tasks<kFillTasks>(la_, n0, N, RMAX, s_key, s_task);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = warp * kWarpTasks + lane / kGroup;
  const int g = lane % kGroup;
  // warps w and w + kFillWarps / 2 share a scheduler: they take the
  // ordered tasks from the two ends, short and long rows together
  const int pos = warp < kFillWarps / 2 ? warp
                                        : kFillWarps * 3 / 2 - 1 - warp;
  const long long n = n0 + s_task[pos * kWarpTasks + lane / kGroup];
  const bool live = n < N;
  if (!__any_sync(kFull, live)) return;   // the whole warp leaves together
  const int la = live ? la_[n] : 0, ta = live ? ta_[n] : 0;
  const int base = live ? base_[n] : 0, lb = live ? lb_[n] : 0;
  const int go = sc.gap_open, ge = sc.gap_extend;
  const int negmm = wneg(sc.mismatch);
  const int RW = RMAX / 8;
  const int KB = (RMAX + WB + 8 + 7) / 8 * 8;
  uint8_t* const stage = smem + slot * fill_task_bytes(RMAX, WB);
  uint32_t* const aw =
      reinterpret_cast<uint32_t*>(stage + fill_stage_bytes(WB));
  uint8_t* const win = reinterpret_cast<uint8_t*>(aw + RW);
  if (live) {
    for (int w = g; w < RW; w += kGroup) aw[w] = a4[n * RW + w];
    // text window: win[t] = text[ta + base - 1 + t], kTextCode outside
    // [0, T)
    const int b0 = wsub(wadd(ta, base), 1);
    for (int t = g; t < KB; t += kGroup) {
      const long long p = (long long)b0 + t;
      const long long wi = p < 0 ? 0 : min(p >> 3, nw - 1);
      const uint32_t nib = (text[wi] >> ((p & 7) * 4)) & 15u;
      win[t] = (p >= 0 && p < T) ? (uint8_t)nib : (uint8_t)kTextCode;
    }
  }
  __syncwarp();

  uint8_t* const out = bits + (live ? n : 0) * (long long)(RMAX + 1) * WB;
  // rows r0 .. are staged at sbuf[(row - r0) WB + c], sbuf at the 16-byte
  // phase of their place in `out`; flushed every kStageRows rows
  int r0 = 0;
  uint8_t* sbuf = stage + ((uintptr_t)out & 15);
  const auto flush = [&](int last) {
    __syncwarp();
    if (live)
      group_store(out + (long long)r0 * WB, sbuf, (last - r0 + 1) * WB, g);
    __syncwarp();
    r0 = last + 1;
    sbuf = stage + ((uintptr_t)(out + (long long)r0 * WB) & 15);
  };
  const int c0 = g * CPL;
  // row 0: H = 0 at j = 0, -(go + (j - 1) ge) for 0 < j <= lb; F = NEG;
  // bits: E-selected, E-extend while j >= 2
  int H[CPL], F[CPL], tk[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = c0 + k;
    const int j0 = wadd(base, c);
    const bool in0 = j0 >= 0 && j0 <= lb;
    H[k] = c >= WB ? kNeg
         : j0 == 0 ? 0
         : (in0 && j0 > 0) ? wneg(wadd(go, wmul(wsub(j0, 1), ge))) : kNeg;
    F[k] = kNeg;
    sbuf[c] = c < WB && in0 && j0 > 0 ? (uint8_t)(2 | ((j0 >= 2) << 2))
                                      : (uint8_t)0;
    tk[k] = win[1 + c];               // row 1's text codes
  }

  const int rows = la < 0 ? 0 : min(la, RMAX);
  const int wrows = __reduce_max_sync(kFull, rows);
  if (wrows == 0) flush(0);
  const int cf = clampi(wsub(wsub(lb, la), base), 0, WB - 1);
  int score = kNeg;
  for (int i = 1; i <= wrows; ++i) {
    const int ai = (int)((aw[(i - 1) >> 3] >> (((i - 1) & 7) * 4)) & 15u);
    const int aim = ai < 4 ? ai : -1;   // text codes are never -1
    const int jb = wadd(i, base);
    const bool rowin = i <= la && lb >= 0;
    // column j = 0's H on this row
    const int colH = i <= la ? wneg(wadd(go, wmul(i - 1, ge))) : kNeg;
    // row i - 1's H and F at the next lane's first column (NEG past the
    // group's last lane: past the band)
    const int hnx = __shfl_down_sync(kFull, H[0], 1, kGroup);
    const int fnx = __shfl_down_sync(kFull, F[0], 1, kGroup);
    int diag[CPL], Fn[CPL], hn[CPL], j[CPL];
    bool mb[CPL], fext[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int Hup = k + 1 < CPL ? H[k + 1] : (g + 1 < kGroup ? hnx : kNeg);
      const int Fup = k + 1 < CPL ? F[k + 1] : (g + 1 < kGroup ? fnx : kNeg);
      mb[k] = tk[k] == aim;
      diag[k] = wadd(H[k], mb[k] ? sc.match : negmm);
      const int fo = wsub(Hup, go), fx = wsub(Fup, ge);
      Fn[k] = max(fo, fx);
      fext[k] = fx > fo;              // Fn == fx and Fn != fo
      hn[k] = max(diag[k], Fn[k]);
      j[k] = wadd(jb, c0 + k);
    }
    // lazy E: E[c] = max_{c' <= c}(open[c'] + c' ge) - go - c ge, where
    // open[c] = hn[c - 1] (and column j = 0's H where j = 1)
    const int hup = __shfl_up_sync(kFull, hn[CPL - 1], 1, kGroup);
    const int hprev = g > 0 ? hup : kNeg;
    int pre[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int left = k > 0 ? hn[k - 1] : hprev;
      const int os = j[k] == 1 ? max(left, colH) : left;
      const int gk = wadd(max(os, kNeg), wmul(c0 + k, ge));
      pre[k] = k > 0 ? max(pre[k - 1], gk) : gk;
    }
    int incl = pre[CPL - 1];
#pragma unroll
    for (int d = 1; d < kGroup; d <<= 1)   // lanes below d get their own
      incl = max(incl, __shfl_up_sync(kFull, incl, d, kGroup));
    int carry = __shfl_up_sync(kFull, incl, 1, kGroup);
    // the previous lane's last column: its E, and its H before masking
    const int Eprev = g > 0
        ? max(wsub(wsub(carry, go), wmul(c0 - 1, ge)), kNeg) : kNeg;
    const int Hprev = g > 0 ? max(hprev, Eprev) : kNeg;
    if (g == 0) carry = INT_MIN;
    // the lane's bytes of the row; a slot past WB writes 0 over the next
    // row's first bytes, which that row rewrites after the __syncwarp
    uint8_t* const rowp = sbuf + (i - r0) * WB + c0;
    __syncwarp();
    int Ek1 = Eprev, Hk1 = Hprev;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = c0 + k;
      const int E = max(wsub(wsub(max(pre[k], carry), go), wmul(c, ge)),
                        kNeg);
      const int Hn = max(hn[k], E);
      const int Hsh = j[k] == 1 ? max(Hk1, colH) : Hk1;
      const bool eext = (E == wsub(Ek1, ge)) && (E != wsub(Hsh, go));
      const bool esel = Hn == E;
      const bool dok = Hn == diag[k];
      const bool inb = c < WB && rowin && (unsigned)j[k] <= (unsigned)lb;
      const unsigned v = dok | (esel << 1) | (eext << 2) | (fext[k] << 3)
                       | (mb[k] << 4);
      rowp[k] = (uint8_t)(v & (0u - (unsigned)inb));
      Ek1 = E;
      Hk1 = Hn;
      H[k] = inb ? Hn : kNeg;
      F[k] = inb ? Fn[k] : kNeg;
    }
    if (i == la) {                    // H of row la at the final column
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (c0 + k == cf) score = H[k];
    }
    // slide the text codes: row i + 1 reads win[i + 1 + c]
#pragma unroll
    for (int k = 0; k + 1 < CPL; ++k) tk[k] = tk[k + 1];
    tk[CPL - 1] = win[i + 1 + c0 + CPL - 1];
    if (i - r0 + 1 == kStageRows || i == wrows) flush(i);
  }
  if (!live) return;
  // rows past the warp's count hold no band cell
  group_zero(out + (long long)(wrows + 1) * WB,
             (long long)(RMAX - wrows) * WB, g);

  if (la >= 1 && la <= RMAX) {
    if (cf >= c0 && cf < c0 + CPL) score_out[n] = score;
  } else if (g == 0) {
    score_out[n] = la != 0 ? kNeg
                 : lb == 0 ? 0
                 : wneg(wadd(go, wmul(wsub(lb, 1), ge)));
  }
}

// Shared bytes of a walk tile: kTileRows rows in the 16-byte chunks that
// hold them.
__host__ __device__ inline int walk_tile_bytes(int WB) {
  return (kTileRows * WB + 30 + 15) / 16 * 16;
}

// The bulk copy engine (TMA) and its barriers: one lane starts a copy of
// a tile, and its barrier's phase completes when the bytes have landed.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%3], %2;\n\t"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n\t}"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_done(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Starts copying the 16-byte chunks that hold the bytes [src, src + len)
// of device memory to dst (a 16-byte aligned shared address): lane g = 0
// of the task's lanes starts one bulk copy on barrier bar. Returns the
// offset of src's byte from dst. The chunks reach at most 15 bytes past
// either end of the range: bytes that share an aligned 16 bytes with a
// byte of the array, so inside its allocation (PyTorch's allocations are
// 512-byte aligned and sized), and which the walk never reads.
__device__ int tile_fetch(unsigned dst, const uint8_t* src, int len, int g,
                          unsigned bar) {
  const uint8_t* a0 =
      reinterpret_cast<const uint8_t*>((uintptr_t)src & ~(uintptr_t)15);
  const unsigned bytes =
      (unsigned)(((uintptr_t)(src + len) + 15 - (uintptr_t)a0) & ~15u);
  if (g == 0) {
    // the lanes' reads of the buffer (after the __syncwarp before this)
    // come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bulk_copy(dst, a0, bytes, bar);
  }
  return (int)(src - a0);
}

// v = the shared byte at addr where pred holds (a predicated load, no
// branch).
__device__ __forceinline__ void lds_u8_if(unsigned& v, unsigned addr,
                                          bool pred) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q ld.shared.u8 %0, [%1];\n\t}"
      : "+r"(v) : "r"(addr), "r"((unsigned)pred));
}

// x, kept in a register: the compiler would otherwise rebuild a shared
// address from the block's cluster rank at every use.
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm volatile("" : "+r"(x));
  return x;
}

__global__ void __launch_bounds__(kWalkWarps * 32)
link_walk_kernel(const uint8_t* __restrict__ bits,
                 const int32_t* __restrict__ la_,
                 const int32_t* __restrict__ base_,
                 const int32_t* __restrict__ lb_, int N, int RMAX, int WB,
                 int STEPS, uint32_t* __restrict__ packed,
                 int32_t* __restrict__ n_steps_out,
                 bool* __restrict__ complete_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_key[kWalkTasks], s_task[kWalkTasks];
  __shared__ uint64_t s_bar[kWalkTasks][2];
  const long long n0 = (long long)blockIdx.x * kWalkTasks;
  order_tasks<kWalkTasks>(la_, n0, N, RMAX, s_key, s_task);
  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) * kWalkWarpTasks + lane / kWalkLanes;
  const int g = lane % kWalkLanes;
  const long long n = n0 + s_task[slot];
  const bool live = n < N;
  if (!__any_sync(kFull, live)) return;
  const int TB = walk_tile_bytes(WB);
  // two tiles a task, each with its barrier
  const unsigned stiles = opaque((unsigned)__cvta_generic_to_shared(
      smem + slot * 2 * TB));
  const unsigned sbar = (unsigned)__cvta_generic_to_shared(s_bar[slot]);
  if (g == 0) {
    mbar_init(sbar);
    mbar_init(sbar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const long long row = (long long)(RMAX + 1) * WB;
  const long long size = row * N;
  const long long lane_base = (live ? n : 0) * row;
  const uint8_t* const task_bits = bits + lane_base;
  const int la = live ? la_[n] : 0, base = live ? base_[n] : 0;
  const int lb = live ? lb_[n] : 0;
  int ci = la;
  int cc = clampi(wsub(wsub(lb, la), base), 0, WB - 1);
  int st = 0;                          // 0 diagonal/H, 1 in F, 2 in E
  bool done = !live || (la == 0 && lb == 0);
  int steps = 0;
  // the tile the walk reads (rows lo..hi, row r's bytes at tiles[cur +
  // r WB]) and the one in flight (rows nlo..nhi, at tiles[nxt + r WB]),
  // each in one of the task's two buffers
  int lo = RMAX + 1, hi = -1, nlo = RMAX + 1, nhi = -1, buf = 0;
  int cur = 0, nxt = 0;
  unsigned parity = 0;                 // bit b: the phase buffer b awaits
  unsigned pending = 0;                // bit b: a copy into b in flight
  const auto fetch = [&](int tlo, int thi) {
    const int b = buf ^ 1;
    nlo = tlo;
    nhi = thi;
    nxt = b * TB + tile_fetch(stiles + b * TB,
                              task_bits + (long long)tlo * WB,
                              (thi - tlo + 1) * WB, g, sbar + 8 * b)
        - tlo * WB;
    pending |= 1u << b;
  };
  const auto land = [&](int b) {       // the copy into buffer b landed
    while (!mbar_done(sbar + 8 * b, (parity >> b) & 1u)) {
    }
    parity ^= 1u << b;
    pending &= ~(1u << b);
  };
  const int SW = STEPS / 8;
  uint32_t* const out = packed + (live ? n : 0) * SW;
  int w = 0;
  for (; w < SW; ++w) {
    uint32_t word = 0;
    // not unrolled: the loop's code stays small enough for the
    // instruction cache (unrolled, with the tile code inlined 8 times,
    // it took some 40 KB)
#pragma unroll 1
    for (int q = 0; q < 32; q += 4) {
      const int j = wadd(wadd(ci, base), cc);
      const bool moves = !done & !(ci == 0 & j == 0);
      // a row of the task (ci < lo <= RMAX + 1) outside the tile
      const bool need = moves & ((unsigned)ci < (unsigned)lo);
      if (__any_sync(kFull, need)) {   // the walk leaves its tile
        if (need) {
          // the first tile (or, for la > RMAX, the first below RMAX): no
          // copy into the other buffer is in flight then
          if (ci < nlo || ci > nhi) fetch(max(ci - kTileRows + 1, 0), ci);
          land(buf ^ 1);
          buf ^= 1;
          cur = nxt;
          lo = nlo;
          hi = nhi;
        }
        __syncwarp();                  // the tile arrived; the other is free
        if (need && lo > 0) {          // the next tile, ahead of the walk
          fetch(max(lo - kTileRows, 0), lo - 1);
        } else if (need) {
          nlo = RMAX + 1;
          nhi = -1;
        }
      }
      const int col = clampi(cc, 0, WB - 1);
      const bool in_tile = ci >= lo & ci <= hi;
      unsigned cell = 0;
      lds_u8_if(cell, stiles + (unsigned)(cur + ci * WB + col), in_tile);
      const bool off = moves & !in_tile;
      if (__any_sync(kFull, off) && off) {   // outside the task's rows
        long long flat = lane_base + (long long)ci * WB + col;
        if (flat < 0) flat += size;
        flat = flat < 0 ? 0 : (flat > size - 1 ? size - 1 : flat);
        cell = bits[flat];
      }
      // the step, without branches: D (diagonal), E (a text base against
      // a gap, op D) or F (a read base against a gap, op I)
      const bool take_d = (st == 0) & (ci > 0) & (j > 0) & (cell & 1u);
      const bool in_e = (st == 2) | ((st == 0) & !take_d & (j > 0)
                                     & ((cell >> 1) & 1u));
      const bool in_f = !take_d & !in_e;
      const unsigned op = take_d ? 1u - ((cell >> 4) & 1u) : in_e ? 3u : 2u;
      const int nst = in_e ? 2 * (((cell >> 2) & 1u) & (j > 1))
                    : in_f ? (((cell >> 3) & 1u) & (ci > 1)) : 0;
      ci = wsub(ci, moves & !in_e);
      cc = wadd(cc, moves ? (int)in_f - (int)in_e : 0);
      st = moves ? nst : st;
      steps += moves;
      word |= (moves ? op : 4u) << q;
      done = !moves;
    }
    if (live && g == 0) out[w] = word;
    if (__all_sync(kFull, done)) break;
  }
  for (int b = 0; b < 2; ++b)          // no copy outlives the block
    if (pending >> b & 1u) land(b);
  if (!live) return;
  for (int t = w + 1 + g; t < SW; t += kWalkLanes) out[t] = kHaltedWord;
  if (g == 0) {
    n_steps_out[n] = steps;
    complete_out[n] = done || (ci == 0 && wadd(wadd(ci, base), cc) == 0);
  }
}

constexpr int kPackThreads = 256;
constexpr int kRunsWarps = 8;        // tasks a runs block
constexpr unsigned kNoOp = 16u;      // no step: differs from every op

// a4[t, w]: the 4-bit codes of oriented bases 8w .. 8w + 7 of task t
// (tasks[t] = read, reverse, ra, la): base p is 0 from la on and where its
// forward position (ra + p, or len - 1 - (ra + p) on the reverse strand)
// lies outside the read; a reverse base is the complement (3 - c for
// c < 4). Tasks n .. N - 1 are 0.
__global__ void __launch_bounds__(kPackThreads)
link_pack_kernel(const uint8_t* __restrict__ blob,
                 const long long* __restrict__ read_off, int R,
                 const int32_t* __restrict__ tasks, int n, int N, int RW,
                 uint32_t* __restrict__ a4) {
  const long long idx = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  if (idx >= (long long)N * RW) return;
  const long long t = idx / RW;
  const int w = (int)(idx - t * RW);
  uint32_t word = 0;
  const int r = t < n ? tasks[4 * t] : -1;
  if (r >= 0 && r < R) {
    const bool rev = tasks[4 * t + 1] != 0;
    const long long ra = tasks[4 * t + 2];
    const int la = tasks[4 * t + 3];
    const long long off = read_off[r];
    const long long len = read_off[r + 1] - off;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * w + j;
      const long long f = rev ? len - 1 - (ra + p) : ra + p;
      if (p < la && f >= 0 && f < len) {
        unsigned c = blob[off + f];
        if (rev && c < 4) c = 3 - c;
        word |= c << (4 * j);
      }
    }
  }
  a4[idx] = word;
}

// Step s's op: nibble s % 8 of word s / 8 of the task's row.
__device__ __forceinline__ unsigned step_op(const uint32_t* row, int s) {
  return (row[s >> 3] >> ((s & 7) * 4)) & 15u;
}

// kWrite false: counts[t] = the runs of certified task t (0 otherwise).
// kWrite true: task t's runs (op, length, 0) in forward order at rows
// ends[t] - counts[t] .. ends[t] - 1 of runs.
template <bool kWrite>
__global__ void __launch_bounds__(kRunsWarps * 32)
link_runs_kernel(const uint32_t* __restrict__ packed,
                 const int32_t* __restrict__ n_steps,
                 const bool* __restrict__ cert, int N, int SW,
                 long long* __restrict__ counts,
                 const long long* __restrict__ ends,
                 int32_t* __restrict__ runs) {
  const long long t = (long long)blockIdx.x * kRunsWarps + (threadIdx.x >> 5);
  if (t >= N) return;                  // the whole warp: one task
  const int lane = threadIdx.x & 31;
  const int ns = cert[t] ? clampi(n_steps[t], 0, 8 * SW) : 0;
  const uint32_t* const row = packed + t * SW;
  const long long last = kWrite ? ends[t] - 1 : 0;
  long long found = 0;                 // runs started (count) or ended (write)
  int open = 0;                        // start of the run open at s0
  unsigned before = kNoOp;             // op of step s0 - 1
  for (int s0 = 0; s0 < ns; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < ns;
    const unsigned op = in ? step_op(row, s) : kNoOp;
    unsigned prev = __shfl_up_sync(kFull, op, 1);
    if (lane == 0) prev = before;
    before = __shfl_sync(kFull, op, 31);
    const unsigned starts = __ballot_sync(kFull, in && op != prev);
    if (!kWrite) {
      found += __popc(starts);
      continue;
    }
    unsigned next = __shfl_down_sync(kFull, op, 1);
    if (lane == 31) next = s + 1 < ns ? step_op(row, s + 1) : kNoOp;
    const bool is_end = in && op != next;
    const unsigned end_mask = __ballot_sync(kFull, is_end);
    if (is_end) {
      const unsigned at_or_below = starts & (kFull >> (31 - lane));
      const int start = at_or_below ? s0 + 31 - __clz(at_or_below) : open;
      const long long r = found + __popc(end_mask & ((1u << lane) - 1u));
      int32_t* const out = runs + 3 * (last - r);
      out[0] = (int32_t)op;
      out[1] = s - start + 1;
      out[2] = 0;
    }
    if (starts) open = s0 + 31 - __clz(starts);
    found += __popc(end_mask);
  }
  if (!kWrite && lane == 0) counts[t] = found;
}

cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// Shared memory above 48 KB a block needs the kernel's leave (the static
// arrays, under 1 KB, count too).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes + 1024 <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct FillArgs {
  const uint32_t* a;
  const int32_t *la, *ta, *base, *lb;
  const uint32_t* text;
  long long nw, T;
  int N, RMAX, WB;
  Scoring sc;
  int32_t* score;
  uint8_t* bits;
};

template <int CPL>
cudaError_t launch_fill(const FillArgs& f, cudaStream_t s) {
  const int smem = kFillTasks * fill_task_bytes(f.RMAX, f.WB);
  const cudaError_t e = allow_smem(link_fill_kernel<CPL>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((f.N + kFillTasks - 1) / kFillTasks));
  link_fill_kernel<CPL><<<grid, kFillWarps * 32, smem, s>>>(
      f.a, f.la, f.ta, f.base, f.lb, f.text, f.nw, f.T, f.N, f.RMAX, f.WB,
      f.sc, f.score, f.bits);
  return cudaGetLastError();
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
  const FillArgs f{static_cast<const uint32_t*>(a4),
                   static_cast<const int32_t*>(la),
                   static_cast<const int32_t*>(ta),
                   static_cast<const int32_t*>(base),
                   static_cast<const int32_t*>(lb),
                   static_cast<const uint32_t*>(text), nw, T, N, RMAX, WB,
                   Scoring{match, mismatch, gap_open, gap_extend},
                   static_cast<int32_t*>(score),
                   static_cast<uint8_t*>(bits)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((WB + kGroup - 1) / kGroup) {  // columns a lane
    case 1: return (int)launch_fill<1>(f, s);
    case 2: return (int)launch_fill<2>(f, s);
    case 3: return (int)launch_fill<3>(f, s);
    case 4: return (int)launch_fill<4>(f, s);
    case 5: return (int)launch_fill<5>(f, s);
    case 6: return (int)launch_fill<6>(f, s);
    case 7: return (int)launch_fill<7>(f, s);
    case 8: return (int)launch_fill<8>(f, s);
    case 9: return (int)launch_fill<9>(f, s);
    case 10: return (int)launch_fill<10>(f, s);
    case 11: return (int)launch_fill<11>(f, s);
    default: return (int)launch_fill<12>(f, s);
  }
}

// link_walk: bits (N, RMAX + 1, WB) uint8 from link_fill; la, base, lb (N,)
// int32; packed (N, STEPS/8) uint32; n_steps (N,) int32; complete (N,)
// bool. STEPS % 8 == 0, 1 <= WB <= 96.
extern "C" int link_walk(int device, const void* bits, const void* la,
                         const void* base, const void* lb, int N, int RMAX,
                         int WB, int STEPS, void* packed, void* n_steps,
                         void* complete, void* stream) {
  if (N < 0 || RMAX < 0 || WB < 1 || WB > kMaxWB || STEPS < 8 || STEPS % 8)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const int smem = kWalkTasks * 2 * walk_tile_bytes(WB);
  const cudaError_t e = allow_smem(link_walk_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((N + kWalkTasks - 1) / kWalkTasks));
  link_walk_kernel<<<grid, kWalkWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int32_t*>(la),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(lb), N,
      RMAX, WB, STEPS, static_cast<uint32_t*>(packed),
      static_cast<int32_t*>(n_steps), static_cast<bool*>(complete));
  return (int)cudaGetLastError();
}

// link_pack: blob (nb,) uint8 forward read codes; read_off (R + 1,) int64
// (read r is blob[read_off[r] .. read_off[r + 1])); tasks (n, 4) int32
// (read, reverse, ra, la); a4 (N, RW) uint32, n <= N.
extern "C" int link_pack(int device, const void* blob, const void* read_off,
                         int R, const void* tasks, int n, int N, int RW,
                         void* a4, void* stream) {
  if (R < 0 || n < 0 || N < n || RW < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const long long words = (long long)N * RW;
  const dim3 grid((unsigned)((words + kPackThreads - 1) / kPackThreads));
  link_pack_kernel<<<grid, kPackThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blob),
      static_cast<const long long*>(read_off), R,
      static_cast<const int32_t*>(tasks), n, N, RW,
      static_cast<uint32_t*>(a4));
  return (int)cudaGetLastError();
}

// link_runs_count / link_runs_write: packed (N, SW) uint32 op words from
// link_walk; n_steps (N,) int32; cert (N,) bool; counts (N,) int64 (the
// count pass writes it); ends (N,) int64, the inclusive scan of counts,
// and runs (ends[N - 1], 3) int32 (the write pass reads and writes them).
extern "C" int link_runs_count(int device, const void* packed,
                               const void* n_steps, const void* cert, int N,
                               int SW, void* counts, void* stream) {
  if (N < 0 || SW < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((N + kRunsWarps - 1) / kRunsWarps));
  link_runs_kernel<false><<<grid, kRunsWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(n_steps), static_cast<const bool*>(cert),
      N, SW, static_cast<long long*>(counts), nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int link_runs_write(int device, const void* packed,
                               const void* n_steps, const void* cert,
                               const void* ends, int N, int SW, void* runs,
                               void* stream) {
  if (N < 0 || SW < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((N + kRunsWarps - 1) / kRunsWarps));
  link_runs_kernel<true><<<grid, kRunsWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(n_steps), static_cast<const bool*>(cert),
      N, SW, nullptr, static_cast<const long long*>(ends),
      static_cast<int32_t*>(runs));
  return (int)cudaGetLastError();
}
