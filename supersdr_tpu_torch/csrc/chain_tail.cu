// Chain tails for Hopper (sm_90a), per channel, one launch a chunk:
//   chain_tail_fir:  passband FIR → RSSI → demod → DC block → AGC → ×L
//                    resample
//   chain_tail_am_c: the same tail on an already filtered complex64
//                    passband [C, nf], chain-major audio (a warp a channel)
//   chain_tail_am:   the same on two float32 planes [nf, C] by element
//                    strides, time-major audio (8-channel blocks)
//
// Replaces: supersdr_tpu/ops/pallas/chain_tail.py::_kernel_fir (FIR entry;
// chain.process_tail_tmajor(fir_x3=…) on the planar wideband path) and
// ::_kernel (chain_tail_am without `fir`; _process_tail_pallas in
// runtime/chain.py, the chain-major wideband tier and any batch of ≥ 128
// receivers: the chain-major entry; chain.process_tail_tmajor(yT=…): the 8-channel entry),
// all with _tail_core (and its _atan2, _doubling_linear, _doubling_max
// helpers).
//
// What the tail computes, per channel, with y the passband signal:
//   pw     = Σ_n |y[n]|²                             (RSSI power row)
//   a[n]   = AM: |y[n]| − |y[n−1]| + r·a[n−1]  SSB/CW: Re y[n]
//            NBFM: angle(y[n]·conj(y[n−1]))·fs/(2π·max_dev), 0 below 1e-12
//   p[n]   = max(p[n−1] − d, 20·log10(max(|a[n]|, 1e-9)))    peak tracker
//   q[n]   = hang: max(p over the segment so far, the last hang_tiles
//            segments' maxima); else p[n]
//   g[n]   = α·g[n−1] + (1−α)·gain(q[n])                      kneed law
//   out[n·L + k] = Σ_m P[m, k]·s[n+m],  s = [per−1 carried | a·10^(g/20)]
// and the carried state rows (DC/previous sample, peak, gain, resample
// tail, power). The FIR entry adds y[n] = Σ_k h[k]·x[n−k] in front, with the
// last n_taps−1 inputs carried in through `head`.
//
// What bounds it on this card: bytes. At the 2560-channel headline a chunk
// reads ~165 MB of bf16 raw planes (330 MB of float32 planes on the
// quality tier and of float32 y for the non-FIR entry) and writes ~660 MB
// of audio: 0.25-0.30 ms at 3.35 TB/s. The passband FIR (4·n_taps FLOP a
// sample with real taps, ~42 GFLOP a chunk; three times that as the
// quality tier's split product) is small at tensor-core rates (it took
// ~1.5 ms as a sliding window on the CUDA cores), and the recurrences are
// 16128 dependent steps a channel only if they are run as such (one thread
// a channel: ~2.7 ms). Measured (H100 80GB HBM3, 700 W; see PERF.md for
// the runs): the FIR entry's earlier design took 1.03-1.08 ms fast,
// 1.38-1.41 quality; copies with a phase compiled out
// (tools/tail_phases.py) put 0.28-0.31 ms in the resampler and its stores,
// 0.19 in the scans, 0.11 (quality 0.18) in the window's history copy and
// transpose, and nothing (quality 0.26) in the FIR. This design runs the
// FIR into a second y buffer beside the scans, with a ring window read by
// ldmatrix, and reads its taps itself: 0.92-0.94 ms fast, 1.24-1.25
// quality against the earlier design's 1.04-1.06 / 1.39-1.40 in the same
// run. Of that, the core took a tile ~2-3 % less time fast and ~9 %
// quality; reading the taps here removed ~0.03-0.05 ms of small launches a
// call. Without the resampler the core took 0.71-0.77 / 0.98-1.00, and the
// fast tier's FIR and scans no longer showed: copies without either read
// the same, while the quality tier's three FIR passes (0.25-0.28) and
// scans (0.27) still add. In the
// 8-channel non-FIR entry (0.71-0.73 ms) the resampler hides under the
// stores, which cost ~0.27.
//
// Design: a block owns 8 channels and 8 warps and walks time in tiles of
// T = 256 samples, whatever the passband's length; no block carries
// anything to another, and a ragged last block of channels is masked.
//  * FIR, bf16 operands (the fast tier): each tile is the product
//    y[T, 8] = Toeplitz(h)[T, OVP+T]·win[OVP+T, 8] on the tensor cores
//    (mma.sync m16n8k16, bf16 → f32; N = 8 is the block's 8 channels, the
//    re and im planes share the A fragments). A Toeplitz row is a shifted
//    copy of h, so the A fragments are 32-bit loads from a reversed,
//    zero-padded bf16 copy of h in shared memory (two copies, one shifted by
//    an element, keep odd rows aligned); three of a fragment's four
//    registers slide from one k-step to the next, and only the
//    (OVP/16 + 1) k-blocks inside the band are visited. Complex taps run
//    four products a step. The taps are read out of the passband's
//    Toeplitz matrix and rounded here: the wrapper's gathers and bf16
//    round trips were seven small launches in front of every call (a
//    fixed ~45 µs of a call timed alone, most of it idle card).
//  * The window is a ring of R ≥ OVP + T input rows (a power of two), 16
//    bytes a row: the 8 channels' bf16 values of one time step, as the
//    channelizer's planes hold them, copied in by 16-byte cp.async with no
//    pass over them. Input row τ sits at slot τ mod R (the history from
//    `head` at τ < 0). The B fragments are ldmatrix.x4.trans loads: each
//    lane names one of the 32 rows (16 of a k-block, re and im), so the
//    transposed fragment comes out of the hardware and the ring's wrap is
//    an address. The earlier design moved the window's 256 history columns
//    each tile and transposed each row into a channel-major copy; its
//    history copy needed T ≥ n_taps − 1, the ring holds a history longer
//    than a tile, so a long passband keeps T = 256 and its shared area
//    small (601 taps on float32 rows: ~113 KB, where rounding T up to 768
//    took ~247 KB, over the 227 KB a block may have).
//  * FIR, float32 operands (the quality tier): the same product with taps
//    and window each split into a high and a low bf16 piece (x ≈ hi + lo),
//    in three passes into the same accumulators, hi·hi + hi·lo + lo·hi: 108
//    dB against the float32 plain version. A float32 row's 32 bytes land as
//    its two 16-byte halves in the slot of the high and of the low ring, and
//    the thread that copied them splits them there, in place, before the
//    tile's first barrier. The passes stay rolled: unrolled, the split
//    instances spilled 188-364 bytes and ran ~9 % slower.
//  * A tile's order, y double-buffered: one block barrier, then each warp
//    runs its share of the FIR of tile i + 1 (32 of its rows, all 8
//    channels) into one buffer and its channel's scans of tile i on the
//    other, with no barrier between them; a second barrier, then the copies
//    of tile i + 2's rows start (into the slots of tile i, which the FIR of
//    tile i + 1 has read) and tile i is resampled. Two barriers a tile
//    against the earlier design's five. The scans leave the gained audio in
//    y.re in place, and the warp writes its last per−1 samples in front of
//    the other buffer's row as the next tile's resample history. Between
//    tiles a channel's carried state stays in shared memory, not in the
//    registers the FIR needs. Not kept: warps 0-3 running the FIR first and
//    warps 4-7 the scans first, so that the tensor cores and the CUDA cores
//    work at once (`stagger`, see PERF.md for its times).
//  * The recurrences run as scans, one warp a channel: a lane owns 8
//    consecutive samples of a 256-sample piece, scans them in registers,
//    the 32 lane totals are scanned with 5 shuffles and the prefix is
//    applied. The DC block and the attack are first-order linear (powers
//    r^1..r^8, r^16..r^128 from a table built once a block, no powf); the
//    peak tracker keeps the reference's segmented form, p[j] =
//    max(max_{i≤j}(e[i] + i·d), p_prev − d) − j·d over segments of `seg`
//    samples (its tile T): a running max restarted at each segment start,
//    so the decay is one rounded offset a segment (subtracting d once a
//    sample drifts: 70 dB instead of 112 dB against the plain version over
//    a 16128-sample chunk on an H100). Only what chains from segment to
//    segment — p_prev − d, and the hang ring (the held peak is the max of
//    the segment's running raw peak and the previous hang_tiles =
//    ceil((W−1)/T) segment maxima; the ring starts empty each chunk; the
//    state peak at the chunk's end is the held value; params[8] switches it
//    at run time) — is folded by one lane, once a segment. `seg` may be
//    smaller or larger than a piece. The demod's sqrt / atan2, the log, the
//    gain law and the exp run in the same registers, so a tile's passband
//    is read once and its gained audio written once, both conflict-free
//    (rows are channel-major with one pad word every 32 samples).
//  * The resampler runs on all threads and writes time-major audio by
//    element strides, 8 channels side by side; the 8-channel non-FIR entry
//    reads its planes by element strides too, so the time-major [n, C]
//    planes need no transpose pass. It is register-blocked, a thread on 4
//    consecutive input samples of one channel (tail_resample4): the FIR
//    entry 1.06-1.09 → 1.03-1.05 ms fast, 1.42-1.43 → 1.38-1.41 quality,
//    the non-FIR entry 0.755 → 0.71-0.73, with the same sums. Time-major
//    audio rows are 32 bytes a block, a quarter of a 128-byte line: when
//    the four blocks of a line drift a tile or more apart, L2 evicts lines
//    partly written, and the non-FIR entry with time-major audio took 1.19
//    ms against 0.81 with chain-major audio at 2560 channels. That entry
//    therefore launches clusters of four consecutive blocks, which meet at
//    a cluster barrier once a tile, before they store (0.88 ms). The FIR
//    entry's blocks did not gain from it and are launched alone.
//  * Not kept: whole 128-byte lines through the cluster. A warp a channel
//    in the resampler, the four blocks' rows staged in shared memory and
//    stored a quarter each with 16-byte loads over distributed shared
//    memory (PERF.md §6 names the commit that holds it) was correct and
//    slower: FIR fast 1.31-1.34 ms, quality 2.12-2.13, the non-FIR entry
//    1.13-1.16. Its
//    staging alone (no distributed shared memory, block barriers) costs
//    more than the 32-byte stores it replaces (1.15-1.17 / 1.59-1.68 /
//    0.96-0.98), the exchange without any global store more still
//    (1.14-1.17 / 1.94-1.96 / 0.83-0.84). Nor did the non-FIR entry's
//    stores gain from the tensor memory accelerator (the tile's rows
//    stored from shared memory asynchronously: 0.73 ms) or a streaming
//    hint: what they cost is in the memory system, not in issuing them.
//  * The next tile's input rows are copied asynchronously (cp.async) while
//    the resampler runs: the FIR entry's into its ring (above), two tiles
//    ahead; the 8-channel non-FIR entry's, 4 bytes a sample, straight into
//    the passband rows' space, which the resampler does not read.
//  * The scans' per-sample arithmetic is what the non-FIR tail spends most
//    on, and its exact forms cost more than they look: an IEEE division in
//    the gain law is a call to a slow-path routine, which kept the scan's
//    carried state in local memory (a 200-240-byte stack frame in every
//    tail). The gain law multiplies by 1/knee instead, the dB conversions
//    are log2f / exp2f with the constants folded (20·log10 x = 6.0206·log2
//    x, 10^(g/20) = 2^(0.16610·g)), and a piece's carried values come from
//    lane 31 without selects: the chain-major entry 0.75 → 0.51 ms at 2560
//    channels, the FIR entry 1.24 → 1.08 (H100 80GB HBM3, 700 W).
//
// The chain-major non-FIR entry (chain_tail_am_c). Measured at 2560
// channels × 16128 samples, its bound is 0.296 ms (330 MB of complex64 in,
// 660 MB of audio out). The 8-channel entry there took 0.80-0.82 ms: scans
// 0.48, resampler and audio stores 0.31, loads 0.13 and the state, with
// almost no overlap, since a block's 8 warps scan, then resample, in step.
// Its design:
//  * A warp a channel, each on its own. Blocks of 2 warps meet once, after
//    the tables; then a warp syncs only with itself, so warps scanning and
//    warps storing interleave on every SM, no block waits for its slowest
//    channel, and the hardware spreads 1280 blocks over the SMs to within
//    one block (320 blocks of 8 warps left 56 SMs with 3 and 76 with 2).
//  * The passband is read as it lies: a channel's 256-sample tile is 2 KB
//    of contiguous complex64, copied as 16-byte cp.async pieces, lanes
//    along time (512 bytes an instruction), into a ring of 3 stages a
//    warp; the copy of the tile two ahead starts before the current one is
//    scanned. Chunks land XOR-swizzled by 128-byte row, so a lane's four
//    16-byte loads of its 8 samples are conflict-free; re and im part in
//    registers. The ring is the warp's alone: its cp.async groups and a
//    __syncwarp order it, with no block barrier and no mbarrier.
//  * The resampler takes 4 consecutive input samples a lane, so one P row
//    broadcast serves 4 samples and the window slides in registers (3
//    shared loads a sample against 18). Its outputs pass through the ring
//    slot the tile just left, swizzled, and leave as whole 128-byte lines
//    an instruction: stored straight from the lanes (128 bytes a lane
//    apart) the entry took 1.26 ms against 0.75.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 8;                     // channels per block = warps
constexpr int kRT = 8;                     // samples a lane owns in a piece
constexpr int kTile = 32 * kRT;            // 256 samples: the scan piece
constexpr int kPowN = 12;                  // r^1..r^8, r^16, r^32, r^64, r^128
constexpr int kGPad = 16;                  // zeros in front of the tap copy
constexpr int kCluster = 4;  // blocks whose 32-byte audio rows share a line
constexpr int kRS = 4;       // input samples a thread resamples together
constexpr float kNegBig = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

enum { kAM = 0, kSSB = 1, kNBFM = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// kBytes (16 or 4) from global to shared memory, asynchronously; src_bytes
// = 0 fills them with zeros and reads nothing
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}
// All threads of the cluster's blocks arrive before any goes on.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Smallest stride ≥ n that is ≡ 4 (mod 32): 8 channel rows then start in
// banks 0, 4, …, 28.
__host__ __device__ inline int row_stride(int n) {
  return (n + 27) / 32 * 32 + 4;
}

// Position of sample t in a row with one pad word every 32 samples: a
// lane's 8 consecutive samples, 32 lanes side by side, hit 32 banks.
__host__ __device__ __forceinline__ int skew(int t) { return t + (t >> 5); }

// What the entries share: the resampler, parameters, state rows and the
// audio destination (element strides per output sample and per channel).
struct TailArgs {
  const float* P;
  int per, L, rs_bf16;
  const float* params;  // [9]: r_dc | nbfm scale, decay/sample, thresh,
                        // slope, target, man_gain, agc_on, attack, hang_on
  int seg;              // the reference's tail tile T (peak segment)
  int hang_tiles;       // ring length; 0 = no hang
  const float* st_in;
  float* st_out;
  int C;
  float* audio;
  long a_st, a_sc;
  int cluster;          // 1: launched in clusters of kCluster blocks
};

// Shared memory of the 8-channel non-FIR entry (floats; the FIR entry
// takes H and nsegs from it): [per·L] P, [2·kPowN] powers of the DC pole and the attack,
// [kCB][S] y.re, [kCB][S] y.im, [kCB][S1] resample segment (H history
// slots, then the tile), [kCB][4][nsegs] the segment folds (for each warp:
// p_prev − d, ring max, and the running peak and hang peak at each
// segment's end),
// [hang_tiles][kCB] hang ring.
struct Layout {
  int S, H, S1, nsegs;
  __host__ __device__ Layout(int per, int T, int seg) {
    S = row_stride(skew(T));
    H = (per - 1 + 31) / 32 * 32;
    if (H < 32) H = 32;
    S1 = row_stride(skew(H + T));
    nsegs = kTile / seg + 2;
  }
  __host__ __device__ size_t floats(int per, int L, int hang_tiles) const {
    return (size_t)per * L + 2 * kPowN + 2 * (size_t)kCB * S +
           (size_t)kCB * S1 + 4 * (size_t)kCB * nsegs +
           (size_t)hang_tiles * kCB;
  }
};

struct Smem {
  float *ps, *pows, *ya, *yb, *a1, *pb, *ring;
  Layout lay;
  __device__ Smem(float* base, int per, int L, int T, int seg)
      : lay(per, T, seg) {
    ps = base;
    pows = ps + per * L;
    ya = pows + 2 * kPowN;
    yb = ya + kCB * lay.S;
    a1 = yb + kCB * lay.S;
    pb = a1 + kCB * lay.S1;
    ring = pb + 4 * kCB * lay.nsegs;
  }
};

// One channel's recurrence state, the same in every lane of its warp.
struct Carry {
  float s0, s1, peak, g;  // DC x | previous re, DC y | previous im, peak, gain
  float pbase, cm;        // peak segment: p_prev − d, running max
  float m1, hist, held;   // hang: segment's running raw peak, ring max, held
  int head;               // next ring slot
  float pw;               // this lane's share of Σ|y|²
};

// One warp's rows for the scans.
struct ScanRows {
  const float* y;   // the tile's passband: planar, re at y[skew(t)] and im
                    // at y[ys + skew(t)]; or (ys < 0) interleaved complex
                    // chunks at il_chunk positions
  int ys;
  float* out;       // resample segment: tile sample t at out[skew(H + t)]
  int H;
  float *pb, *hb, *pe, *me;  // [nsegs] each
  float* ring;      // hang slot k at ring[k·ring_st]
  int ring_st;
};

__device__ inline ScanRows block_rows(const Smem& sm, int w) {
  const int n = sm.lay.nsegs;
  float* pb = sm.pb + 4 * w * n;
  return ScanRows{sm.ya + w * sm.lay.S, kCB * sm.lay.S, sm.a1 + w * sm.lay.S1,
                  sm.lay.H, pb, pb + n, pb + 2 * n, pb + 3 * n, sm.ring + w,
                  kCB};
}

// Position (in 16-byte chunks) of chunk q — samples 2q, 2q + 1 of a tile
// of interleaved complex64 — in a stage: chunk q ^ row within each row of
// 8 chunks (128 bytes), so the 8 lanes of a 16-byte load phase, each
// reading the k-th of its 4 chunks, hit 8 different bank groups.
__device__ __forceinline__ int il_chunk(int q) { return q ^ ((q >> 3) & 7); }

// P and the powers of the DC pole (params[0]) and the attack ([7]).
__device__ void load_tables(const TailArgs& a, float* ps, float* pows,
                            int tid, int nthr) {
  for (int k = tid; k < a.per * a.L; k += nthr) ps[k] = a.P[k];
  if (tid < 2) {
    const float r = a.params[tid == 0 ? 0 : 7];
    float* pw = pows + tid * kPowN;
    float v = r;
    for (int i = 0; i < 8; ++i) {
      pw[i] = v;
      v *= r;
    }
    for (int i = 8; i < kPowN; ++i) pw[i] = pw[i - 1] * pw[i - 1];
  }
}

// Channel sc's carried state into cr, its resample history into `out`.
__device__ void load_carry(const TailArgs& a, Carry& cr, float* out, int H,
                           int sc, int lane) {
  cr = Carry{0.f, 0.f, 0.f, 0.f, 0.f, kNegBig, kNegBig, kNegBig, 0.f, 0, 0.f};
  const long C = a.C;
  if (sc < a.C) {
    cr.s0 = a.st_in[sc];
    cr.s1 = a.st_in[C + sc];
    cr.peak = a.st_in[2 * C + sc];
    cr.g = a.st_in[3 * C + sc];
  }
  for (int m = lane; m < a.per - 1; m += 32)
    out[skew(H - (a.per - 1) + m)] =
        sc < a.C ? a.st_in[(4 + m) * C + sc] : 0.f;
}

__device__ void tail_init(const TailArgs& a, const Smem& sm, Carry& cr,
                          int c0) {
  const int tid = threadIdx.x;
  load_tables(a, sm.ps, sm.pows, tid, kThreads);
  for (int k = tid; k < a.hang_tiles * kCB; k += kThreads)
    sm.ring[k] = kNegBig;
  const int w = tid >> 5;
  load_carry(a, cr, sm.a1 + w * sm.lay.S1, sm.lay.H, c0 + w, tid & 31);
}

// The last per−1 resample-segment samples of the previous tile become this
// tile's history (disjoint moves: tlen_prev = T > per − 1).
__device__ void shift_history(const TailArgs& a, const Smem& sm,
                              int tlen_prev) {
  const int H = sm.lay.H, n = a.per - 1;
  for (int i = threadIdx.x; i < n * kCB; i += kThreads) {
    const int c = i / n, m = i % n;
    float* a1c = sm.a1 + c * sm.lay.S1;
    a1c[skew(H - n + m)] = a1c[skew(H + tlen_prev - n + m)];
  }
}

// v[pos % 8] of lane pos / 8, in every lane (pos: the same in every
// lane; a whole piece's last sample without the selects).
__device__ __forceinline__ float pick(const float (&v)[kRT], int pos) {
  if (pos == kTile - 1) return __shfl_sync(kFull, v[kRT - 1], 31);
  float x = v[0];
#pragma unroll
  for (int i = 1; i < kRT; ++i) x = (pos & 7) == i ? v[i] : x;
  return __shfl_sync(kFull, x, pos >> 3);
}

// v[i] ← Σ_{k≤i} r^(i−k)·v[k] + r^(i+1)·init over the warp's 256 samples
// (lane l holds samples 8l … 8l+7): a serial pass over the lane's 8, a
// 5-step scan of the 32 lane totals, and the prefix applied. pw: r^1..r^8,
// r^16, r^32, r^64, r^128.
__device__ __forceinline__ void scan_linear(float (&v)[kRT], float init,
                                            const float* pw, int lane) {
  const float r = pw[0];
  float acc = lane == 0 ? init : 0.f;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    acc = r * acc + v[i];
    v[i] = acc;
  }
  float tot = acc;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float up = __shfl_up_sync(kFull, tot, 1 << k);
    if (lane >= (1 << k)) tot += pw[7 + k] * up;
  }
  float pre = __shfl_up_sync(kFull, tot, 1);
  if (lane == 0) pre = 0.f;
#pragma unroll
  for (int i = 0; i < kRT; ++i) v[i] += pw[i] * pre;
}

// Running max restarted wherever a sample's index within its segment is 0:
// v[i] ← max of v over the samples since the last segment start (with
// `init` for the samples before the piece's first start). j0: the index
// within its segment of this lane's first sample.
__device__ __forceinline__ void scan_segmax(float (&v)[kRT], float init,
                                            int j0, int seg, int lane) {
  float run = lane == 0 ? init : kNegBig;
  bool seen = false;
  int j = j0;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    if (j == 0) {
      run = kNegBig;
      seen = true;
    }
    run = fmaxf(run, v[i]);
    v[i] = run;
    j = j + 1 == seg ? 0 : j + 1;
  }
  float tot = run;
  bool fl = seen;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float up = __shfl_up_sync(kFull, tot, 1 << k);
    const bool fu = __shfl_up_sync(kFull, (int)fl, 1 << k) != 0;
    if (lane >= (1 << k)) {
      if (!fl) tot = fmaxf(tot, up);
      fl = fl || fu;
    }
  }
  float pre = __shfl_up_sync(kFull, tot, 1);
  if (lane == 0) pre = kNegBig;
  j = j0;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    if (j == 0) pre = kNegBig;  // past the lane's first start
    v[i] = fmaxf(v[i], pre);
    j = j + 1 == seg ? 0 : j + 1;
  }
}

// v at each segment end of the piece into dst[k], k the segment's index
// from the piece's first (j0, k0: this lane's first sample's index within
// its segment and its segment's index).
__device__ __forceinline__ void store_ends(float* dst, const float (&v)[kRT],
                                           int j0, int k0, int seg,
                                           int nvalid) {
  int j = j0, k = k0;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    if (j + 1 == seg) {
      if (i < nvalid) dst[k] = v[i];
      j = 0;
      ++k;
    } else {
      ++j;
    }
  }
}

// demod → DC → AGC (+hang) → gain on one tile: warp w scans its channel's
// passband rows in pieces of 256 samples and leaves the gained audio in
// its resample segment. t0: the tile's first sample in the chunk (segments
// count from the chunk's start).
template <int kDemod>
__device__ void tail_scan(const TailArgs& a, const float* pows,
                          const ScanRows& rw, Carry& cr, int t0, int tlen,
                          int accum_pow) {
  const int lane = threadIdx.x & 31;
  const float* par = a.params;
  const float r_dc = par[0], d = par[1], thresh = par[2], slope = par[3];
  const float target = par[4], man_gain = par[5], agc_on = par[6];
  const float attack = par[7], hang_on = par[8];
  const float max_gain = target - thresh;
  const float inv_knee = 1.f / fmaxf(-thresh, 1e-6f);
  const int seg = a.seg;
  const bool hang = a.hang_tiles > 0;
  const float* pw_dc = pows;
  const float* pw_at = pows + kPowN;

  for (int s0 = 0; s0 < tlen; s0 += kTile) {
    const int cnt = min(kTile, tlen - s0);  // valid samples in the piece
    const int last = cnt - 1;
    const int tt = s0 + lane * kRT;         // this lane's first sample
    const int nvalid = min(kRT, max(0, cnt - lane * kRT));
    const int n0 = t0 + s0;                 // the piece's first sample
    const int q0 = n0 / seg;
    const int j0 = (n0 + lane * kRT) % seg;
    const int k0 = (n0 + lane * kRT) / seg - q0;
    const bool fresh = n0 % seg == 0;       // the piece opens a segment

    float u[kRT];
    {  // ---- demod: AM envelope + DC block, SSB real part, NBFM angle
      float yr[kRT], yi[kRT];
      if (rw.ys < 0) {  // interleaved: 4 chunks of 2 samples a lane
        const float4* st = reinterpret_cast<const float4*>(rw.y);
#pragma unroll
        for (int k = 0; k < kRT / 2; ++k) {
          const float4 v = st[il_chunk(tt / 2 + k)];
          yr[2 * k] = v.x;
          yi[2 * k] = v.y;
          yr[2 * k + 1] = v.z;
          yi[2 * k + 1] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          yr[i] = i < nvalid ? yr[i] : 0.f;
          yi[i] = i < nvalid ? yi[i] : 0.f;
        }
      } else {
        const int sk = tt + (tt >> 5);
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          yr[i] = i < nvalid ? rw.y[sk + i] : 0.f;
          yi[i] = i < nvalid ? rw.y[rw.ys + sk + i] : 0.f;
        }
      }
      if (accum_pow) {
#pragma unroll
        for (int i = 0; i < kRT; ++i) cr.pw += yr[i] * yr[i] + yi[i] * yi[i];
      }
      if (kDemod == kAM) {
        float env[kRT];
#pragma unroll
        for (int i = 0; i < kRT; ++i)
          env[i] = sqrtf(yr[i] * yr[i] + yi[i] * yi[i]);
        float prev = __shfl_up_sync(kFull, env[kRT - 1], 1);
        if (lane == 0) prev = cr.s0;
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          u[i] = env[i] - prev;
          prev = env[i];
        }
        scan_linear(u, cr.s1, pw_dc, lane);  // a = r·a[n−1] + env − env[n−1]
        cr.s0 = pick(env, last);
        cr.s1 = pick(u, last);
      } else if (kDemod == kNBFM) {
        float qr = __shfl_up_sync(kFull, yr[kRT - 1], 1);
        float qi = __shfl_up_sync(kFull, yi[kRT - 1], 1);
        if (lane == 0) {
          qr = cr.s0;
          qi = cr.s1;
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const float dotp = yr[i] * qr + yi[i] * qi;
          const float cross = yi[i] * qr - yr[i] * qi;
          const float mag = fabsf(dotp) + fabsf(cross);
          u[i] = mag > 1e-12f ? atan2f(cross, dotp) * r_dc : 0.f;
          qr = yr[i];
          qi = yi[i];
        }
        cr.s0 = pick(yr, last);
        cr.s1 = pick(yi, last);
      } else {
#pragma unroll
        for (int i = 0; i < kRT; ++i) u[i] = yr[i];
      }
    }

    // ---- peak tracker: cm = running max of e + j·d within the segment;
    // 20·log10 x = 20·log10(2)·log2 x
    float p[kRT];
    {
      int j = j0;
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const float e =
            6.020599913279624f * log2f(fmaxf(fabsf(u[i]), 1e-9f));
        p[i] = i < nvalid ? e + (float)j * d : kNegBig;
        j = j + 1 == seg ? 0 : j + 1;
      }
    }
    scan_segmax(p, fresh ? kNegBig : cr.cm, j0, seg, lane);
    cr.cm = pick(p, last);
    // p_prev − d of every segment of the piece, folded over its segment
    // ends by one lane, from p at the ends
    store_ends(rw.pe, p, j0, k0, seg, nvalid);
    __syncwarp();
    if (lane == 0) {
      float pbk = fresh ? cr.peak - d : cr.pbase;
      rw.pb[0] = pbk;
      for (int k = 0;; ++k) {
        const long end = (long)(q0 + k + 1) * seg - 1 - n0;
        if (end >= cnt) break;
        pbk = fmaxf(rw.pe[k], pbk) - (float)(seg - 1) * d - d;
        rw.pb[k + 1] = pbk;
      }
    }
    __syncwarp();
    {
      int j = j0, k = k0;
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        if (i < nvalid) p[i] = fmaxf(p[i], rw.pb[k]) - (float)j * d;
        if (j + 1 == seg) {
          j = 0;
          ++k;
        } else {
          ++j;
        }
      }
    }
    const int k_last = (n0 + last) / seg - q0;
    cr.peak = pick(p, last);
    cr.pbase = rw.pb[k_last];

    // ---- hang: held = max(running raw peak of the segment, ring max)
    float used[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) used[i] = p[i];
    if (hang) {
      float m1[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) m1[i] = i < nvalid ? p[i] : kNegBig;
      scan_segmax(m1, fresh ? kNegBig : cr.m1, j0, seg, lane);
      cr.m1 = pick(m1, last);
      store_ends(rw.me, m1, j0, k0, seg, nvalid);
      __syncwarp();
      int head = cr.head;
      if (lane == 0) {
        float h = cr.hist;
        if (fresh) {
          h = kNegBig;
          for (int q = 0; q < a.hang_tiles; ++q)
            h = fmaxf(h, rw.ring[q * rw.ring_st]);
        }
        rw.hb[0] = h;
        for (int k = 0;; ++k) {
          const long end = (long)(q0 + k + 1) * seg - 1 - n0;
          if (end >= cnt) break;
          rw.ring[head * rw.ring_st] = rw.me[k];
          head = head + 1 == a.hang_tiles ? 0 : head + 1;
          h = kNegBig;
          for (int q = 0; q < a.hang_tiles; ++q)
            h = fmaxf(h, rw.ring[q * rw.ring_st]);
          rw.hb[k + 1] = h;
        }
      }
      cr.head = __shfl_sync(kFull, head, 0);
      __syncwarp();
      float held[kRT];
      {
        int j = j0, k = k0;
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          held[i] = i < nvalid ? fmaxf(m1[i], rw.hb[k]) : kNegBig;
          if (j + 1 == seg) {
            j = 0;
            ++k;
          } else {
            ++j;
          }
        }
      }
      cr.hist = rw.hb[k_last];
      cr.held = pick(held, last);
      if (hang_on > 0.f) {
#pragma unroll
        for (int i = 0; i < kRT; ++i) used[i] = held[i];
      }
    }

    // ---- gain law, attack, gain: 10^(g/20) = 2^(log2(10)/20·g)
    float g[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float pu = used[i];
      float gain_db;
      if (agc_on > 0.f) {
        const float above =
            (target - pu) + slope * ((pu - thresh) * inv_knee);
        gain_db = pu <= thresh ? max_gain : above;
      } else {
        gain_db = man_gain - 50.f;
      }
      g[i] = (1.f - attack) * gain_db;
    }
    scan_linear(g, cr.g, pw_at, lane);
    cr.g = pick(g, last);
    const int ho = rw.H + tt;
    const int so = ho + (ho >> 5);
#pragma unroll
    for (int i = 0; i < kRT; ++i)
      if (i < nvalid)
        rw.out[so + i] = u[i] * exp2f(0.16609640474436813f * g[i]);
  }
}

// ×4 polyphase resample of the tile in the resample segment; writes audio
// rows [t0·4, (t0 + tlen)·4), time-major, 8 channels side by side.
// Register-blocked: a thread owns one channel (lane % 8) and runs of kRS
// consecutive input samples, so one P row broadcast serves kRS samples and
// the window slides in registers (21 shared loads for 4 samples' 16
// outputs, against 72 when a thread owned one sample). Tile sample t =
// 128·s + 32·g + kRS·w + r goes to lane 8g + c of warp w: a warp's four
// groups lie 32 samples apart, so with the rows' pad word every 32 samples
// its window loads hit 32 banks, and its stores are 4 rows of 8 channels
// (32-byte pieces). Sums over m in the plain version's order.
__device__ void tail_resample4(const TailArgs& a, const float* ps,
                               const float* rows, int S1, int H, int c0,
                               int t0, int tlen) {
  const int tid = threadIdx.x;
  const int c = tid & (kCB - 1), g = tid >> 3 & 3, w = tid >> 5;
  if (c0 + c >= a.C) return;
  const int hoff = H - (a.per - 1);
  const float* a1c = rows + c * S1;
  float* dst = a.audio + (long)(c0 + c) * a.a_sc;
  for (int s = 0; s < tlen; s += 4 * 32) {
    const int n0 = s + 32 * g + kRS * w;
    float acc[kRS][4], win[kRS];
#pragma unroll
    for (int r = 0; r < kRS; ++r) {
      win[r] = a1c[skew(hoff + n0 + r)];
      if (a.rs_bf16) win[r] = bf16_round(win[r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    }
    for (int m = 0; m < a.per; ++m) {
      // one 16-byte broadcast load (P is 16-byte aligned)
      float4 p4 = reinterpret_cast<const float4*>(ps)[m];
      if (a.rs_bf16)
        p4 = make_float4(bf16_round(p4.x), bf16_round(p4.y),
                         bf16_round(p4.z), bf16_round(p4.w));
#pragma unroll
      for (int r = 0; r < kRS; ++r) {
        acc[r][0] += p4.x * win[r];
        acc[r][1] += p4.y * win[r];
        acc[r][2] += p4.z * win[r];
        acc[r][3] += p4.w * win[r];
      }
      if (m + 1 < a.per) {
#pragma unroll
        for (int r = 0; r < kRS - 1; ++r) win[r] = win[r + 1];
        win[kRS - 1] = a1c[skew(hoff + n0 + kRS + m)];
        if (a.rs_bf16) win[kRS - 1] = bf16_round(win[kRS - 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRS; ++r)
      if (n0 + r < tlen)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dst[(((long)t0 + n0 + r) * 4 + q) * a.a_st] = acc[r][q];
  }
}

// ×L polyphase resample, any L, one output at a time: a thread owns one
// input sample of one channel and its L outputs.
__device__ void tail_resample_l(const TailArgs& a, const float* ps,
                                const float* rows, int S1, int H, int c0,
                                int t0, int tlen) {
  const int tid = threadIdx.x, L = a.L;
  const int hoff = H - (a.per - 1);
  const int c = tid & (kCB - 1);
  if (c0 + c >= a.C) return;
  const float* a1c = rows + c * S1;
  float* dst = a.audio + (long)(c0 + c) * a.a_sc;
  for (int n = tid >> 3; n < tlen; n += kThreads / kCB)
    for (int q = 0; q < L; ++q) {
      float acc = 0.f;
      for (int m = 0; m < a.per; ++m) {
        float pm = ps[m * L + q];
        float v = a1c[skew(hoff + n + m)];
        if (a.rs_bf16) {
          pm = bf16_round(pm);
          v = bf16_round(v);
        }
        acc += pm * v;
      }
      dst[(((long)t0 + n) * L + q) * a.a_st] = acc;
    }
}

// rows: the 8 channels' resample segments, channel c at rows + c·S1 (H
// history slots, then the tile)
__device__ __forceinline__ void tail_resample_any(const TailArgs& a,
                                                  const float* ps,
                                                  const float* rows, int S1,
                                                  int H, int c0, int t0,
                                                  int tlen) {
  if (a.L == 4)
    tail_resample4(a, ps, rows, S1, H, c0, t0, tlen);
  else
    tail_resample_l(a, ps, rows, S1, H, c0, t0, tlen);
}

// Σ|y|² of channel sc from its lanes' shares, then its state rows out.
__device__ void finish_channel(const TailArgs& a, const Carry& cr,
                               const float* out, int H, int sc,
                               int tlen_prev, int accum_pow) {
  const int lane = threadIdx.x & 31;
  float sum = cr.pw;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(kFull, sum, s);
  if (sc >= a.C) return;
  const long C = a.C;
  for (int m = lane; m < a.per - 1; m += 32)
    a.st_out[(4 + m) * C + sc] = out[skew(H + tlen_prev - (a.per - 1) + m)];
  if (lane == 0) {
    a.st_out[sc] = cr.s0;
    a.st_out[C + sc] = cr.s1;
    a.st_out[2 * C + sc] =
        a.hang_tiles && a.params[8] > 0.f ? cr.held : cr.peak;
    a.st_out[3 * C + sc] = cr.g;
    a.st_out[(4 + a.per - 1) * C + sc] = accum_pow ? sum : 0.f;
  }
}

__device__ void tail_finish(const TailArgs& a, const Smem& sm, Carry& cr,
                            int c0, int tlen_prev, int accum_pow) {
  const int w = threadIdx.x >> 5;
  finish_channel(a, cr, sm.a1 + w * sm.lay.S1, sm.lay.H, c0 + w, tlen_prev,
                 accum_pow);
}

// D (16×8, f32) += A (16×16, bf16, row) · B (16×8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8×8 bf16 matrices, transposed: lanes 8j … 8j + 7 give the addresses
// of matrix j's 8 rows (16 bytes each); d[j] holds, in lane 4g + i, its
// elements (2i, g) and (2i + 1, g) — a B fragment of m16n8k16 when the
// rows are k and the columns n. No memory clobber (as the mma): the rows
// it reads are written only before a block barrier.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// Smallest stride ≥ n that is ≡ 4 (mod 8): the 8 channel rows of a y
// buffer then start in banks 4·odd·c apart, so the FIR's accumulator
// stores (channels 2i, 2i + 1 of rows g, g + 8) and the resampler's window
// loads (channel c, 4 samples 32 apart) hit 32 banks.
__host__ __device__ inline int fir_stride(int n) { return (n + 3) / 8 * 8 + 4; }

// The FIR entry's shared area, in order:
//   G     [np][2 (re, im)][2 (shift 0, 1)][glen] bf16 tap copies: G[kGPad +
//         d] = h[OVP − d], zero outside the band; the second copy starts one
//         element later (np = 2: the taps' high and low bf16 pieces)
//   ring  [nr][2 (re, im)][R] input rows of 8 channels, 16 bytes each: input
//         row τ (τ < 0: the history from `head`) at slot τ mod R, as it lies
//         in global memory when the rows are bf16; float32 rows land as
//         channels 0-3 in piece 0 and 4-7 in piece 1 and are split in place
//         into a high (piece 0) and, for the split FIR, a low (piece 1) bf16
//         piece
//   y     [2] buffers of [kCB][Sre] re rows (H resample-history slots, then
//         the tile; the scans overwrite y.re with the gained audio in place)
//         and [kCB][Sim] im rows
//   P [per·L], powers [2·kPowN], segment folds [kCB][4][nsegs], hang ring
//   [hang_tiles][kCB], the channels' carried state [kCB] (between tiles)
struct FirLayout {
  int OVP, glen, R, np, nr, H, Sre, Sim, nsegs;
  __host__ __device__ FirLayout(int ov, int per, int seg, bool split,
                                bool x_bf16) {
    OVP = (ov + 15) / 16 * 16;
    glen = OVP + 64;
    for (R = 256; R < OVP + kTile;) R *= 2;
    np = split ? 2 : 1;
    nr = split || !x_bf16 ? 2 : 1;
    const Layout lay(per, kTile, seg);
    H = lay.H;
    Sre = fir_stride(skew(H + kTile));
    Sim = fir_stride(skew(kTile));
    nsegs = lay.nsegs;
  }
  __host__ __device__ size_t g_elems() const {
    return (size_t)np * 4 * glen;
  }
  __host__ __device__ size_t ring_rows() const { return (size_t)nr * 2 * R; }
  __host__ __device__ size_t ybuf() const { return (size_t)kCB * (Sre + Sim); }
  __host__ __device__ size_t floats(int per, int L, int hang_tiles) const {
    return g_elems() / 2 + 4 * ring_rows() + 2 * ybuf() + (size_t)per * L +
           2 * kPowN + 4 * (size_t)kCB * nsegs + (size_t)hang_tiles * kCB +
           kCB * sizeof(Carry) / sizeof(float);
  }
};

// v's bf16 piece: 0 the value rounded, 1 what that left
__device__ __forceinline__ __nv_bfloat16 bf16_piece(float v, int piece) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  return piece ? __float2bfloat16_rn(v - __bfloat162float(hi)) : hi;
}

// Row `slot` of plane pl: the 8 channels' bf16 pieces of v (np of them).
__device__ void put_row(uint4* ring, const FirLayout& fl, int pl, int slot,
                        const float (&v)[kCB]) {
  for (int pc = 0; pc < fl.np; ++pc) {
    uint32_t wd[kCB / 2];
#pragma unroll
    for (int j = 0; j < kCB / 2; ++j)
      wd[j] = __bfloat16_as_ushort(bf16_piece(v[2 * j], pc)) |
              (uint32_t)__bfloat16_as_ushort(bf16_piece(v[2 * j + 1], pc))
                  << 16;
    ring[(size_t)(2 * pc + pl) * fl.R + slot] =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// One warp's share of a tile's FIR on the tensor cores: y[c][t] = Σ_k
// h[k]·x[t0 + t − k] for its 32 rows t of the tile (rows past the chunk
// read zeros).
// Window column j of the Toeplitz product is input row τ0 + j (τ0 = t0 −
// OVP), read from the ring by ldmatrix: one x4.trans a k-step gives the
// re and im B fragments, each lane naming one of their 32 rows, so the
// wrap of the ring is an address and no row is moved or transposed. The
// warp's row tiles go two at a time: the B fragments loaded for the upper
// tile serve the lower one a step later. kSplit: three passes into the same
// accumulators, hi·hi + hi·lo + lo·hi.
template <bool kCplx, bool kSplit>
__device__ void fir_tile(const __nv_bfloat16* G, const uint4* ring,
                         const FirLayout& fl, float* yre, float* yim,
                         int tau0) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int gw = fl.glen / 2, Rm = fl.R - 1;
  // the tap copy whose pairs are aligned for this row parity, as words
  const uint32_t* G0 = reinterpret_cast<const uint32_t*>(G) + (g & 1) * gw;
  // word of the pair at G[kGPad + Δ + 2·tig − g] for Δ = 0
  const int xw = (kGPad + 2 * tig - g - (g & 1)) / 2;
  // this lane's ldmatrix row: plane lane / 16, row lane % 16 of a k-block
  const uint32_t rbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring)) +
      (lane >> 4) * fl.R * 16;
  constexpr int tiles = kTile / 16 / kCB;  // row tiles a warp: a pair
  for (int rp = 0; rp < tiles; rp += 2) {
    const int m0 = (w * tiles + rp) * 16;
    const int s0 = tau0 + m0 + (lane & 15);  // the lower tile's row, D = 0
    float ar[2][4], ai[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[q][i] = ai[q][i] = 0.f;
    // passes not unrolled: unrolled, the split FIR's instances spilled
    // 188-364 bytes and ran ~9 % slower
#pragma unroll 1
    for (int pass = 0; pass < (kSplit ? 3 : 1); ++pass) {
      // taps: the low piece in the third pass; window: in the second
      const uint32_t* Gr = G0 + (pass == 2 ? 2 * fl.glen : 0);
      const uint32_t* Gi = Gr + 2 * gw;
      const uint32_t wb = rbase + (pass == 1 ? 2 * fl.R * 16 : 0);
      uint32_t hlo = Gr[xw - 4], hmid = Gr[xw];
      uint32_t ilo = 0, imid = 0;
      if (kCplx) {
        ilo = Gi[xw - 4];
        imid = Gi[xw];
      }
      uint32_t b[4], c[4];
      ldsm_x4_trans(b, wb + ((s0 & Rm) << 4));
      for (int D = 0; D <= fl.OVP; D += 16) {
        const int dw = D / 2;
        const uint32_t hhi = Gr[xw + dw + 4];
        // the upper row tile's window rows (= the lower one's a step later)
        ldsm_x4_trans(c, wb + (((s0 + D + 16) & Rm) << 4));
        mma_bf16(ar[0], hmid, hlo, hhi, hmid, b[0], b[1]);
        mma_bf16(ai[0], hmid, hlo, hhi, hmid, b[2], b[3]);
        mma_bf16(ar[1], hmid, hlo, hhi, hmid, c[0], c[1]);
        mma_bf16(ai[1], hmid, hlo, hhi, hmid, c[2], c[3]);
        if (kCplx) {  // y.re −= h.im·x.im, y.im += h.im·x.re
          const uint32_t ihi = Gi[xw + dw + 4];
          const uint32_t kNeg = 0x80008000u;
          mma_bf16(ar[0], imid ^ kNeg, ilo ^ kNeg, ihi ^ kNeg, imid ^ kNeg,
                   b[2], b[3]);
          mma_bf16(ai[0], imid, ilo, ihi, imid, b[0], b[1]);
          mma_bf16(ar[1], imid ^ kNeg, ilo ^ kNeg, ihi ^ kNeg, imid ^ kNeg,
                   c[2], c[3]);
          mma_bf16(ai[1], imid, ilo, ihi, imid, c[0], c[1]);
          ilo = ihi;
          imid = Gi[xw + dw + 8];
        }
        hlo = hhi;
        hmid = Gr[xw + dw + 8];
#pragma unroll
        for (int k = 0; k < 4; ++k) b[k] = c[k];
      }
    }
    // accumulator (row g | g + 8, channels 2·tig, 2·tig + 1)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = m0 + q * 16 + g;
      float* ya = yre + 2 * tig * fl.Sre;
      float* yb = yim + 2 * tig * fl.Sim;
      ya[skew(t)] = ar[q][0];
      ya[fl.Sre + skew(t)] = ar[q][1];
      ya[skew(t + 8)] = ar[q][2];
      ya[fl.Sre + skew(t + 8)] = ar[q][3];
      yb[skew(t)] = ai[q][0];
      yb[fl.Sim + skew(t)] = ai[q][1];
      yb[skew(t + 8)] = ai[q][2];
      yb[fl.Sim + skew(t + 8)] = ai[q][3];
    }
  }
}

// Three blocks an SM: 2560 channels are 320 blocks, one wave on 132 SMs
// only at 3 blocks each (80 registers a thread, the most the allocation
// granularity leaves under 85; ≤ 76800 shared bytes). kFirBf16: the FIR's
// operands are bf16 (one tensor-core pass); else float32, split in two bf16
// pieces (three passes).
//
// A tile's work, with y double-buffered, between two block barriers: each
// warp runs its share of the FIR of tile i + 1 into one y buffer, then its
// channel's scans of tile i on the other, with no barrier between them;
// after the second barrier the copies of tile i + 2's rows start and tile i
// is resampled.
template <bool kCplx, int kDemod, bool kFirBf16>
__global__ void __launch_bounds__(kThreads, 3)
chain_tail_fir_kernel(const void* __restrict__ x_re,
                      const void* __restrict__ x_im, int x_bf16, int nf,
                      int n2,
                      const float* __restrict__ head_re,
                      const float* __restrict__ head_im,
                      const float* __restrict__ w2, int ldw, int nb,
                      int n_taps, TailArgs a) {
  extern __shared__ float4 smem_f4[];
  const int ov = n_taps - 1;
  constexpr int T = kTile;
  const bool xb = x_bf16 != 0;
  const FirLayout fl(ov, a.per, a.seg, !kFirBf16, xb);
  __nv_bfloat16* G = reinterpret_cast<__nv_bfloat16*>(smem_f4);
  uint4* ring = reinterpret_cast<uint4*>(G + fl.g_elems());
  float* ybase = reinterpret_cast<float*>(ring + fl.ring_rows());
  float* ps = ybase + 2 * fl.ybuf();
  float* pows = ps + a.per * a.L;
  float* folds = pows + 2 * kPowN;
  float* hring = folds + 4 * kCB * fl.nsegs;
  Carry* carry = reinterpret_cast<Carry*>(hring + a.hang_tiles * kCB);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c0 = blockIdx.x * kCB;          // first planar channel
  const long plane = (long)(c0 / n2) * nf;  // k1 · nf
  const int col0 = c0 % n2;
  const long C = a.C;
  const int Rm = fl.R - 1;
  // warp w's rows of buffer b: re (H history slots, then the tile), im
  auto re_row = [=](int b) { return ybase + b * fl.ybuf() + w * fl.Sre; };
  auto im_row = [=](int b) {
    return ybase + b * fl.ybuf() + kCB * fl.Sre + w * fl.Sim;
  };

  // tap copies (zero padded), the window's history, the tables, the state
  for (int i = tid; i < fl.np * 4 * fl.glen; i += kThreads) {
    const int pc = i / (4 * fl.glen), part = i / fl.glen % 4;
    const int pos = i % fl.glen;
    const int dd = pos + (part & 1) - kGPad;  // d of this element
    const int k = fl.OVP - dd;                // tap index
    float v = 0.f;
    if (k >= 0 && k <= ov && (part < 2 || kCplx))  // w2's row nb − k
      v = w2[(long)(nb - k) * ldw + (part < 2 ? 0 : ldw / 2)];
    G[i] = bf16_piece(v, pc);
  }
  for (int i = tid; i < 2 * fl.OVP; i += kThreads) {
    const int pl = i / fl.OVP, tau = i % fl.OVP - fl.OVP;
    const int row = tau + ov;  // head row, oldest first
    float v[kCB];
#pragma unroll
    for (int c = 0; c < kCB; ++c)
      v[c] = row >= 0 ? (pl ? head_im : head_re)[(long)row * C + c0 + c]
                      : 0.f;
    put_row(ring, fl, pl, tau & Rm, v);
  }
  load_tables(a, ps, pows, tid, kThreads);
  for (int k = tid; k < a.hang_tiles * kCB; k += kThreads)
    hring[k] = kNegBig;
  // a channel's state stays in shared memory between its scans (the same
  // in every lane, but for the lane's share of the power sum), so the
  // FIR's registers do not hold it
  float pw = 0.f;
  {
    Carry cr;
    load_carry(a, cr, re_row(0), fl.H, c0 + w, lane);
    if (lane == 0) carry[w] = cr;
  }

  // The input rows of the tile at t0 into their ring slots, as 16-byte
  // asynchronous copies (rows past the chunk: zeros). Thread i copies, and
  // `land` splits, rows i, i + 256, …: a thread waits for its own copies.
  auto fetch = [=](int t0) {
    const int rb = xb ? 16 : 32;
    // this loop and land's stay rolled (two rows a thread): unrolled, the
    // FIR instances spilled up to 104 bytes and the quality tier ran ~7 %
    // slower
#pragma unroll 1
    for (int i = tid; i < 2 * T; i += kThreads) {
      const int pl = i / T, row = i % T, slot = (t0 + row) & Rm;
      const bool in = t0 + row < nf;
      const char* src = static_cast<const char*>(pl ? x_im : x_re) +
                        (in ? ((plane + t0 + row) * n2 + col0) * (rb / kCB)
                            : 0);
      cp_async<16>(ring + (size_t)pl * fl.R + slot, src, in ? 16 : 0);
      if (!xb)
        cp_async<16>(ring + (size_t)(2 + pl) * fl.R + slot, src + 16,
                     in ? 16 : 0);
    }
    cp_async_commit();
  };
  // Wait for this thread's copies of the tile at t0; float32 rows become
  // bf16 pieces in place; bf16 rows of the split FIR get a zero low piece.
  auto land = [=](int t0) {
    cp_async_wait_all();
    if (xb && fl.np == 1) return;
#pragma unroll 1
    for (int i = tid; i < 2 * T; i += kThreads) {
      const int pl = i / T, slot = (t0 + i % T) & Rm;
      uint4* lo = ring + (size_t)(2 + pl) * fl.R + slot;
      if (xb) {
        *lo = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const float4 q0 = *reinterpret_cast<const float4*>(
                       ring + (size_t)pl * fl.R + slot),
                   q1 = *reinterpret_cast<const float4*>(lo);
      const float v[kCB] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      put_row(ring, fl, pl, slot, v);
    }
  };

  fetch(0);
  land(0);
  __syncthreads();
  fir_tile<kCplx, !kFirBf16>(G, ring, fl, ybase + skew(fl.H),
                             ybase + kCB * fl.Sre, -fl.OVP);
  __syncthreads();  // the history slots are free: the next rows go there
  if (T < nf) fetch(T);

  for (int t0 = 0, b = 0;; t0 += T, b ^= 1) {
    const int tlen = min(T, nf - t0);
    const bool more = t0 + T < nf;
    if (more) land(t0 + T);
    __syncthreads();
    if (more) {
      float* yn = ybase + (b ^ 1) * fl.ybuf();
      fir_tile<kCplx, !kFirBf16>(G, ring, fl, yn + skew(fl.H),
                                 yn + kCB * fl.Sre, t0 + T - fl.OVP);
    }
    {
      float* re = re_row(b);
      float* y = re + skew(fl.H);
      float* pb = folds + 4 * w * fl.nsegs;
      const int n = fl.nsegs;
      const ScanRows rw{y, (int)(im_row(b) - y), re, fl.H, pb, pb + n,
                        pb + 2 * n, pb + 3 * n, hring + w, kCB};
      Carry cr = carry[w];
      cr.pw = pw;
      tail_scan<kDemod>(a, pows, rw, cr, t0, tlen, 1);
      pw = cr.pw;
      __syncwarp();
      if (lane == 0) carry[w] = cr;
      if (more) {  // its last per − 1 gained samples: the next history
        float* nx = re_row(b ^ 1);
        const int k = a.per - 1;
        for (int m = lane; m < k; m += 32)
          nx[skew(fl.H - k + m)] = re[skew(fl.H + tlen - k + m)];
      }
    }
    __syncthreads();
    if (t0 + 2 * T < nf) fetch(t0 + 2 * T);
    tail_resample_any(a, ps, ybase + b * fl.ybuf(), fl.Sre, fl.H, c0, t0,
                      tlen);
    if (!more) {
      Carry cr = carry[w];
      cr.pw = pw;
      finish_channel(a, cr, re_row(b), fl.H, c0 + w, tlen, 1);
      break;
    }
  }
}

template <int kDemod>
__global__ void __launch_bounds__(kThreads, 3)
chain_tail_am_kernel(const float* __restrict__ y_re,
                     const float* __restrict__ y_im, long y_st, long y_sc,
                     int nf, int accum_pow, TailArgs a) {
  extern __shared__ float4 smem_f4[];
  const Smem sm(reinterpret_cast<float*>(smem_f4), a.per, a.L, kTile, a.seg);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCB;
  Carry cr;
  tail_init(a, sm, cr, c0);
  // The tile of y at t0 into the passband rows, by 4-byte asynchronous
  // copies, 8 channels side by side. The rows are free from the end of a
  // tile's scans, so the next tile arrives under the resampler.
  auto prefetch = [&](int t0) {
    const int tlen = min(kTile, nf - t0);
    const int c = tid & (kCB - 1);
    const bool on = c0 + c < a.C;
    const long base = on ? (long)(c0 + c) * y_sc : 0;
    for (int row = tid >> 3; row < tlen; row += 32) {
      const long idx = on ? (long)(t0 + row) * y_st + base : 0;
      const int at = c * sm.lay.S + skew(row);
      cp_async<4>(sm.ya + at, y_re + idx, on ? 4 : 0);
      cp_async<4>(sm.yb + at, y_im + idx, on ? 4 : 0);
    }
    cp_async_commit();
  };
  prefetch(0);

  int tlen_prev = 0;
  for (int t0 = 0; t0 < nf; t0 += kTile) {
    const int tlen = min(kTile, nf - t0);
    if (t0 > 0) shift_history(a, sm, tlen_prev);
    cp_async_wait_all();
    __syncthreads();
    tail_scan<kDemod>(a, sm.pows, block_rows(sm, tid >> 5), cr, t0, tlen,
                      accum_pow);
    __syncthreads();
    if (a.cluster) cluster_sync();  // the line's four blocks store together
    if (t0 + kTile < nf) prefetch(t0 + kTile);
    tail_resample_any(a, sm.ps, sm.a1, sm.lay.S1, sm.lay.H, c0, t0, tlen);
    tlen_prev = tlen;
    __syncthreads();
  }
  tail_finish(a, sm, cr, c0, tlen_prev, accum_pow);
}

// ---- The chain-major entry: a complex64 passband [C, nf] (contiguous in
// time, rows 16-byte aligned) to chain-major audio [C, nf·L].
constexpr int kAmWarps = 2;             // channels (warps) a block
constexpr int kStages = 3;              // input tiles a warp holds
constexpr int kStageFloats = 2 * kTile;  // 256 interleaved complex samples

// Shared memory of the chain-major entry (floats): [per·L] P and [2·kPowN]
// powers (rounded up to 16 bytes), then for each warp [kStages][512] its
// input ring, [S1] its resample segment, [4][nsegs] its segment folds and
// [hang_tiles] its hang ring (rounded up to 16 bytes).
struct WarpLayout {
  int H, S1, nsegs, hdr, per_warp;
  __host__ __device__ WarpLayout(int per, int L, int seg, int hang_tiles) {
    const Layout lay(per, kTile, seg);
    H = lay.H;
    S1 = lay.S1;
    nsegs = lay.nsegs;
    hdr = (per * L + 2 * kPowN + 3) / 4 * 4;
    per_warp =
        (kStages * kStageFloats + S1 + 4 * nsegs + hang_tiles + 3) / 4 * 4;
  }
  __host__ __device__ size_t floats() const {
    return hdr + (size_t)kAmWarps * per_warp;
  }
};

// ×L polyphase resample of one channel's tile by its warp, in passes of
// 128 input samples: lane l takes samples 4l … 4l+3 of a pass, so each P
// row loaded serves 4 samples and the window slides in registers (3
// shared loads a sample, against 2 a tap and sample when a thread takes
// one sample). Their 16 outputs go to `buf` (the ring slot the tile left,
// in the stage's chunk order: conflict-free), from where the warp stores
// the pass's 2 KB of audio in 16-byte pieces with lanes along time, whole
// 128-byte lines an instruction, as streaming stores (0.49-0.50 ms against
// 0.50-0.52 with plain ones). Any other L: one output at a time.
template <int kL>
__device__ void warp_resample(const TailArgs& a, const float* ps,
                              const float* row, int H, float* buf,
                              float* dst, int t0, int tlen) {
  const int lane = threadIdx.x & 31;
  const int hoff = H - (a.per - 1);
  if (kL != 4) {
    for (int n = lane; n < tlen; n += 32)
      for (int q = 0; q < a.L; ++q) {
        float acc = 0.f;
        for (int m = 0; m < a.per; ++m)
          acc += ps[m * a.L + q] * row[skew(hoff + n + m)];
        dst[((long)t0 + n) * a.L + q] = acc;
      }
    return;
  }
  float4* b4 = reinterpret_cast<float4*>(buf);
  for (int h = 0; h < tlen; h += 32 * kRS) {
    const int n0 = h + lane * kRS;
    float acc[kRS][4], win[kRS];
#pragma unroll
    for (int r = 0; r < kRS; ++r) {
      win[r] = row[skew(hoff + n0 + r)];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    }
    for (int m = 0; m < a.per; ++m) {
      const float4 p4 = reinterpret_cast<const float4*>(ps)[m];
#pragma unroll
      for (int r = 0; r < kRS; ++r) {
        acc[r][0] += p4.x * win[r];
        acc[r][1] += p4.y * win[r];
        acc[r][2] += p4.z * win[r];
        acc[r][3] += p4.w * win[r];
      }
      if (m + 1 < a.per) {
#pragma unroll
        for (int r = 0; r < kRS - 1; ++r) win[r] = win[r + 1];
        win[kRS - 1] = row[skew(hoff + n0 + kRS + m)];
      }
    }
#pragma unroll
    for (int r = 0; r < kRS; ++r)
      b4[il_chunk(lane * kRS + r)] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kRS; ++k) {
      const int q = lane + 32 * k;
      if (h + q < tlen)
        __stcs(reinterpret_cast<float4*>(dst + ((long)t0 + h + q) * 4),
               b4[il_chunk(q)]);  // streaming: written once, evict first
    }
    __syncwarp();
  }
}

// A warp a channel, each on its own: blocks of kAmWarps warps meet once,
// after the tables; from there a warp syncs only with itself, so no block
// waits for its slowest channel and the hardware spreads the C / kAmWarps
// blocks over the SMs to within one block. Each warp keeps kStages tiles
// of its input in a ring of 16-byte asynchronous copies (a lane copies 4
// chunks of 2 samples a tile, lanes along time: 512 bytes an instruction)
// and starts the copy of the tile two ahead before it scans the current
// one, so two tiles are in flight while one is scanned and resampled. The
// ring is the warp's alone, so its own cp.async groups and a __syncwarp
// order it.
template <int kDemod>
__global__ void __launch_bounds__(kAmWarps * 32, 24 / kAmWarps)
chain_tail_am_c_kernel(const float2* __restrict__ y, long y_sc, int nf,
                       int accum_pow, TailArgs a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const WarpLayout wl(a.per, a.L, a.seg, a.hang_tiles);
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = blockIdx.x * kAmWarps + (tid >> 5);
  float* ps = smem;
  float* pows = ps + a.per * a.L;
  load_tables(a, ps, pows, tid, kAmWarps * 32);
  __syncthreads();
  if (c >= a.C) return;
  float* stage = smem + wl.hdr + (tid >> 5) * wl.per_warp;
  float* out = stage + kStages * kStageFloats;
  float* folds = out + wl.S1;
  ScanRows rw{stage, -1, out, wl.H, folds, folds + wl.nsegs,
              folds + 2 * wl.nsegs, folds + 3 * wl.nsegs,
              folds + 4 * wl.nsegs, 1};
  for (int k = lane; k < a.hang_tiles; k += 32) rw.ring[k] = kNegBig;
  Carry cr;
  load_carry(a, cr, out, wl.H, c, lane);
  const float2* src = y + (long)c * y_sc;
  float* dst = a.audio + (long)c * a.a_sc;
  const int ntiles = (nf + kTile - 1) / kTile;
  // tile i into its ring slot; past the chunk: an empty group
  auto prefetch = [&](int i) {
    if (i < ntiles) {
      const int t0 = i * kTile, tlen = min(kTile, nf - t0);
      float* slot = stage + (i % kStages) * kStageFloats;
#pragma unroll
      for (int k = 0; k < kTile / 2 / 32; ++k) {
        const int q = lane + 32 * k;
        const int n = min(2, max(0, tlen - 2 * q));  // samples it holds
        cp_async<16>(slot + 4 * il_chunk(q), n ? src + t0 + 2 * q : src,
                     8 * n);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) prefetch(i);

  int tlen_prev = 0;
  for (int i = 0; i < ntiles; ++i) {
    const int t0 = i * kTile, tlen = min(kTile, nf - t0);
    if (i > 0) {  // the previous tile's last per−1 samples: this history
      const int n = a.per - 1;
      for (int m = lane; m < n; m += 32)
        out[skew(wl.H - n + m)] = out[skew(wl.H + tlen_prev - n + m)];
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncwarp();
    prefetch(i + kStages - 1);  // into the slot tile i − 1 left
    float* slot = stage + (i % kStages) * kStageFloats;
    rw.y = slot;
    tail_scan<kDemod>(a, pows, rw, cr, t0, tlen, accum_pow);
    __syncwarp();  // the slot is free from here: the resampler's buffer
    if (a.L == 4)
      warp_resample<4>(a, ps, out, wl.H, slot, dst, t0, tlen);
    else
      warp_resample<0>(a, ps, out, wl.H, slot, dst, t0, tlen);
    tlen_prev = tlen;
    __syncwarp();
  }
  finish_channel(a, cr, out, wl.H, c, tlen_prev, accum_pow);
}

// The launch of a tail kernel on `blocks` blocks; cluster: in clusters of
// kCluster consecutive blocks (the grid rounded up: a block past the last
// channel masks everything), which keep step tile by tile.
struct TailLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  TailLaunch(int blocks, int threads, size_t smem, cudaStream_t stream,
             bool cluster) {
    cfg = {};
    cfg.gridDim = dim3(cluster ? (blocks + kCluster - 1) / kCluster * kCluster
                               : blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster ? 1 : 0;
  }
};

template <typename... Params, typename... Args>
cudaError_t launch_tail(void (*kern)(Params...), int blocks, int threads,
                        size_t smem, cudaStream_t stream, bool cluster,
                        Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  TailLaunch l(blocks, threads, smem, stream, cluster);
  return cudaLaunchKernelEx(&l.cfg, kern, args...);
}

// What `kern` launches with: out[0] shared bytes a block, [1] blocks, [2]
// threads a block, [3] blocks an SM (the occupancy calculator), [4] blocks
// a cluster, [5] clusters resident at once (0 without clusters), [6]
// registers a thread, [7] local (stack) bytes a thread.
template <typename... Params>
cudaError_t launch_info(void (*kern)(Params...), int blocks, int threads,
                        size_t smem, bool cluster, long* out) {
  const TailLaunch l(blocks, threads, smem, nullptr, cluster);
  int n = 0, nc = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads,
                                                        smem);
  if (err == cudaSuccess && cluster)
    err = cudaOccupancyMaxActiveClusters(&nc, kern, &l.cfg);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  const long v[8] = {(long)smem, (long)l.cfg.gridDim.x, threads, n,
                     cluster ? kCluster : 1, nc, fa.numRegs,
                     (long)fa.localSizeBytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}

// The FIR entry's shared bytes a block (x_bf16: bf16 input rows).
size_t fir_smem(int n_taps, bool fir_bf16, bool x_bf16, const TailArgs& a) {
  const int ov = n_taps - 1;
  return FirLayout(ov, a.per, a.seg, !fir_bf16, x_bf16)
             .floats(a.per, a.L, a.hang_tiles) *
         sizeof(float);
}

template <bool kCplx, int kDemod, bool kFirBf16>
cudaError_t launch_fir(const void* x_re, const void* x_im, int x_bf16,
                       int n1, int nf, int n2, const float* head_re,
                       const float* head_im, const float* w2, int ldw,
                       int nb, int n_taps, const TailArgs& a,
                       cudaStream_t stream) {
  const size_t smem = fir_smem(n_taps, kFirBf16, x_bf16 != 0, a);
  return launch_tail(chain_tail_fir_kernel<kCplx, kDemod, kFirBf16>,
                     n1 * n2 / kCB, kThreads, smem, stream, a.cluster != 0,
                     x_re, x_im, x_bf16, nf, n2, head_re, head_im, w2, ldw,
                     nb, n_taps, a);
}

template <bool kCplx, bool kFirBf16>
cudaError_t fir_by_demod(int demod, const void* x_re, const void* x_im,
                         int x_bf16, int n1, int nf, int n2,
                         const float* head_re, const float* head_im,
                         const float* w2, int ldw, int nb, int n_taps,
                         const TailArgs& a, cudaStream_t s) {
#define SSDR_FIR(D)                                                        \
  return launch_fir<kCplx, D, kFirBf16>(x_re, x_im, x_bf16, n1, nf, n2,   \
                                        head_re, head_im, w2, ldw, nb,    \
                                        n_taps, a, s)
  switch (demod) {
    case kAM:
      SSDR_FIR(kAM);
    case kSSB:
      SSDR_FIR(kSSB);
    case kNBFM:
      SSDR_FIR(kNBFM);
    default:
      return cudaErrorInvalidValue;
  }
#undef SSDR_FIR
}

template <int kDemod>
cudaError_t launch_am(const float* y_re, const float* y_im, long y_st,
                      long y_sc, int nf, int accum_pow, const TailArgs& a,
                      cudaStream_t stream) {
  const Layout lay(a.per, kTile, a.seg);
  const size_t smem =
      lay.floats(a.per, a.L, a.hang_tiles) * sizeof(float);
  return launch_tail(chain_tail_am_kernel<kDemod>, (a.C + kCB - 1) / kCB,
                     kThreads, smem, stream, a.cluster != 0, y_re, y_im, y_st,
                     y_sc, nf, accum_pow, a);
}

template <int kDemod>
cudaError_t am_c_attrs(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_tail_am_c_kernel<kDemod>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chain_tail_am_c_kernel<kDemod>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool kCplx, bool kFirBf16>
cudaError_t fir_info(int demod, int blocks, size_t smem, long* out) {
  switch (demod) {
    case kAM:
      return launch_info(chain_tail_fir_kernel<kCplx, kAM, kFirBf16>,
                         blocks, kThreads, smem, false, out);
    case kSSB:
      return launch_info(chain_tail_fir_kernel<kCplx, kSSB, kFirBf16>,
                         blocks, kThreads, smem, false, out);
    case kNBFM:
      return launch_info(chain_tail_fir_kernel<kCplx, kNBFM, kFirBf16>,
                         blocks, kThreads, smem, false, out);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int kDemod>
cudaError_t launch_am_c(const void* y, long y_sc, int nf, int accum_pow,
                        const TailArgs& a, cudaStream_t stream) {
  const size_t smem =
      WarpLayout(a.per, a.L, a.seg, a.hang_tiles).floats() * sizeof(float);
  const cudaError_t err = am_c_attrs<kDemod>(smem);
  if (err != cudaSuccess) return err;
  return launch_tail(chain_tail_am_c_kernel<kDemod>,
                     (a.C + kAmWarps - 1) / kAmWarps, kAmWarps * 32, smem,
                     stream, false, static_cast<const float2*>(y), y_sc, nf,
                     accum_pow, a);
}

bool tail_args_ok(const TailArgs& a, int nf) {
  return a.per >= 2 && a.L >= 1 && nf >= 1 && a.seg >= 1 && nf % a.seg == 0 &&
         a.hang_tiles >= 0 && a.C >= 1;
}

}  // namespace

extern "C" {

// Channels a block owns: the wrapper checks n2 against it (FIR entry).
int chain_tail_channels_per_block() { return kCB; }

// x_*: raw channelizer planes [n1, nf, n2], f32 (x_bf16 = 0) or bf16;
// head_*: [n_taps−1, C] input history, planar channel order; w2: the
// passband's Toeplitz matrix, contiguous rows of ldw floats, tap k = w2's
// row nb − k at column 0 (re) and, when fir_complex (the complex-folded
// matrix), at column ldw/2 (im); fir_bf16: round the FIR's
// operands to bf16 and run it on the tensor cores; P: [per, L]; params:
// [9] = r_dc | nbfm scale, decay/sample, thresh, slope, target, man_gain,
// agc_on, attack, hang_on; st_in/st_out: [4 + per, C] state rows (dc_x |
// prev re, dc_y | prev im, peak, gain, per−1 resample tail rows, power —
// ignored on input); audio: [nf·L, C] f32; seg: the reference's tail tile
// (peak segment and hang tile), a divisor of nf; hang_tiles: ring length,
// 0 = no hang.
int chain_tail_fir(const void* x_re, const void* x_im, int x_bf16, int n1,
                   int nf, int n2, const float* head_re, const float* head_im,
                   const float* w2, int ldw, int nb, int n_taps,
                   int fir_complex, int fir_bf16, const float* P, int per,
                   int L, int rs_bf16, const float* params, int demod,
                   int seg, int hang_tiles, const float* st_in, float* st_out,
                   float* audio, void* stream) {
  const TailArgs a{P, per, L, rs_bf16, params, seg, hang_tiles, st_in,
                   st_out, n1 * n2, audio, (long)n1 * n2, 1L, 0};
  if (n2 % kCB || n_taps < 2 || nb < n_taps - 1 || ldw < 1 ||
      !tail_args_ok(a, nf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSDR_TAIL(CP, FB)                                                  \
  return (int)fir_by_demod<CP, FB>(demod, x_re, x_im, x_bf16, n1, nf, n2,  \
                                   head_re, head_im, w2, ldw, nb, n_taps,  \
                                   a, s)
  switch ((fir_complex ? 2 : 0) | (fir_bf16 ? 1 : 0)) {
    case 0: SSDR_TAIL(false, false);
    case 1: SSDR_TAIL(false, true);
    case 2: SSDR_TAIL(true, false);
    default: SSDR_TAIL(true, true);
  }
#undef SSDR_TAIL
}

// y_*: the passband's re and im planes, element (i, c) at y_*[i·y_st +
// c·y_sc] for i < nf, c < C; audio sample (k, c) written at audio[k·a_st +
// c·a_sc], k < nf·L, time-major (a_st ≥ a_sc: the kernel stores 8 channels
// side by side, in clusters of four blocks); the rest as chain_tail_fir,
// with the power row written only when accum_pow (else 0). Chain-major
// audio comes from chain_tail_am_c.
int chain_tail_am(const float* y_re, const float* y_im, long y_st, long y_sc,
                  int nf, int C, const float* P, int per, int L,
                  const float* params, int demod, int seg, int hang_tiles,
                  int accum_pow, const float* st_in, float* st_out,
                  float* audio, long a_st, long a_sc, void* stream) {
  const TailArgs a{P, per, L, 0, params, seg, hang_tiles, st_in, st_out,
                   C, audio, a_st, a_sc, 1};
  if (!tail_args_ok(a, nf) || y_st < 1 || y_sc < 1 || a_sc < 1 || a_st < a_sc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (demod) {
    case kAM:
      return (int)launch_am<kAM>(y_re, y_im, y_st, y_sc, nf, accum_pow, a, s);
    case kSSB:
      return (int)launch_am<kSSB>(y_re, y_im, y_st, y_sc, nf, accum_pow, a,
                                  s);
    case kNBFM:
      return (int)launch_am<kNBFM>(y_re, y_im, y_st, y_sc, nf, accum_pow, a,
                                   s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// y: a complex64 passband [C, nf], row c at y + c·y_sc complex elements,
// contiguous in time; y 16-byte aligned and y_sc even (every tile's rows
// are read in 16-byte pieces). audio: chain-major [C, nf·L], row c at
// audio + c·a_sc; with L = 4, audio 16-byte aligned and a_sc a multiple of
// 4. The rest as chain_tail_am.
int chain_tail_am_c(const void* y, long y_sc, int nf, int C, const float* P,
                    int per, int L, const float* params, int demod, int seg,
                    int hang_tiles, int accum_pow, const float* st_in,
                    float* st_out, float* audio, long a_sc, void* stream) {
  const TailArgs a{P, per, L, 0, params, seg, hang_tiles, st_in, st_out,
                   C, audio, 1L, a_sc, 0};
  const bool wide = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                    y_sc % 2 == 0 && y_sc >= nf && a_sc >= (long)nf * L &&
                    (L != 4 || (reinterpret_cast<uintptr_t>(audio) % 16 == 0
                                && a_sc % 4 == 0));
  if (!tail_args_ok(a, nf) || !wide || per - 1 > kTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (demod) {
    case kAM:
      return (int)launch_am_c<kAM>(y, y_sc, nf, accum_pow, a, s);
    case kSSB:
      return (int)launch_am_c<kSSB>(y, y_sc, nf, accum_pow, a, s);
    case kNBFM:
      return (int)launch_am_c<kNBFM>(y, y_sc, nf, accum_pow, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What an entry launches for C channels, as launch_info: entry 0 the FIR
// entry (n_taps taps; variant = demod | fir_complex << 2 | fir_bf16 << 3 |
// x_bf16 << 4, x_bf16: bf16 input rows, as the fast planar path gives
// them, else float32: the quality tier's and the 2-D source's),
// 1 the 8-channel non-FIR entry (clusters of kCluster), 2 the chain-major
// one (both AM).
int chain_tail_launch(int entry, int C, int n_taps, int variant, int per,
                      int L, int seg, int hang_tiles, long* out) {
  const TailArgs a{nullptr, per, L, 0, nullptr, seg, hang_tiles, nullptr,
                   nullptr, C, nullptr, C, 1L, entry == 1};
  if (!tail_args_ok(a, seg) || (entry == 0 && (n_taps < 2 || C % kCB)))
    return (int)cudaErrorInvalidValue;
  switch (entry) {
    case 0: {
      const bool bf16 = variant >> 3 & 1, xb = variant >> 4 & 1;
      const size_t smem = fir_smem(n_taps, bf16, xb, a);
      const int demod = variant & 3, blocks = C / kCB;
      switch (variant >> 2 & 3) {
        case 0: return (int)fir_info<false, false>(demod, blocks, smem, out);
        case 1: return (int)fir_info<true, false>(demod, blocks, smem, out);
        case 2: return (int)fir_info<false, true>(demod, blocks, smem, out);
        default: return (int)fir_info<true, true>(demod, blocks, smem, out);
      }
    }
    case 1:
      return (int)launch_info(
          chain_tail_am_kernel<kAM>, (C + kCB - 1) / kCB, kThreads,
          Layout(per, kTile, seg).floats(per, L, hang_tiles) * sizeof(float),
          true, out);
    case 2: {
      const size_t smem =
          WarpLayout(per, L, seg, hang_tiles).floats() * sizeof(float);
      const cudaError_t err = am_c_attrs<kAM>(smem);  // its carveout
      if (err != cudaSuccess) return (int)err;
      return (int)launch_info(chain_tail_am_c_kernel<kAM>,
                              (C + kAmWarps - 1) / kAmWarps, kAmWarps * 32,
                              smem, false, out);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
