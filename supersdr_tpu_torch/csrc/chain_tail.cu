// Chain tails for Hopper (sm_90a), per channel, one launch a chunk:
//   chain_tail_fir: passband FIR → RSSI → demod → DC block → AGC → ×L resample
//   chain_tail_am:  the same tail on an already filtered passband y
//
// Replaces: supersdr_tpu/ops/pallas/chain_tail.py::_kernel_fir (FIR entry;
// chain.process_tail_tmajor(fir_x3=…) on the planar wideband path) and
// ::_kernel (chain_tail_am without `fir`; chain._process_tail_pallas, the
// chain-major wideband tier and any batch of ≥ 128 receivers), both with
// _tail_core (and its _atan2, _doubling_linear, _doubling_max helpers).
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
// reads ~165 MB of bf16 raw planes (330 MB of float32 y for the non-FIR
// entry) and writes ~660 MB of audio: 0.25-0.30 ms at 3.35 TB/s. The
// passband FIR (4·n_taps FLOP a sample with real taps, ~42 GFLOP a chunk)
// is small at tensor-core rates (it took ~1.5 ms as a sliding window on the
// CUDA cores), and the recurrences are 16128 dependent steps a channel only
// if they are run as such (one thread a channel: ~2.7 ms). As scans, with
// the FIR on the tensor cores, the FIR entry takes ~1.25 ms, of which the
// scans' per-sample arithmetic (sqrt, log, gain law, exp) and the
// resampler with its 32-byte audio rows are ~0.45 ms each, the FIR ~0.2.
//
// Design: a block owns 8 channels and 8 warps and walks time in tiles of
// T ≥ n_taps−1 (FIR) or 256 samples; no block carries anything to another,
// and a ragged last block of channels is masked.
//  * FIR, bf16 operands (the fast tier): each tile is the product
//    y[T, 8] = Toeplitz(h)[T, OVP+T]·win[OVP+T, 8] on the tensor cores
//    (mma.sync m16n8k16, bf16 → f32; N = 8 is the block's 8 channels, the
//    re and im planes share the A fragments). A Toeplitz row is a shifted
//    copy of h, so the A fragments are 32-bit loads from a reversed,
//    zero-padded bf16 copy of h in shared memory (two copies, one shifted by
//    an element, keep odd rows aligned); three of a fragment's four
//    registers slide from one k-step to the next, and only the
//    (OVP/16 + 1) k-blocks inside the band are visited. The window is kept
//    bf16, channel-major, with a row stride that makes the B-fragment loads
//    conflict-free. Complex taps run four products a step.
//  * FIR, float32 operands (the quality tier): the same product with taps
//    and window each split into a high and a low bf16 piece (x ≈ hi + lo),
//    in three passes into the same accumulators, hi·hi + hi·lo + lo·hi: 108
//    dB against the float32 plain version, ~0.6 ms where the sliding
//    register window on the CUDA cores took ~1.5.
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
//  * The resampler runs on all threads and writes audio by element strides
//    (coalesced along the contiguous axis); the non-FIR entry reads y by
//    element strides too, so a chain-major [C, n] source and a time-major
//    [n, C] one need no transpose pass. Time-major audio rows are 32 bytes
//    a block, a quarter of a 128-byte line: when the four blocks of a line
//    drift a tile or more apart, L2 evicts lines partly written, and the
//    non-FIR entry with time-major audio took 1.19 ms against 0.81 with
//    chain-major audio at 2560 channels. That entry therefore launches
//    clusters of four consecutive blocks, which meet at a cluster barrier
//    once a tile, before they store (0.88 ms). The FIR entry's blocks did
//    not gain from it and are launched alone.
//  * The next tile's input rows are copied asynchronously (cp.async) into
//    the passband rows' space while the resampler runs, which reads
//    neither: the FIR entry stages raw rows there (16 bytes a row of 8 bf16
//    channels) and transposes them into the window, the non-FIR entry
//    copies 4 bytes a sample straight into place.

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

__host__ __device__ inline int tile_rows(int ov) {
  return ov <= kTile ? kTile : (ov + kTile - 1) / kTile * kTile;
}

// Smallest stride ≥ n that is ≡ 4 (mod 32): 8 channel rows then start in
// banks 0, 4, …, 28.
__host__ __device__ inline int row_stride(int n) {
  return (n + 27) / 32 * 32 + 4;
}

// Position of sample t in a row with one pad word every 32 samples: a
// lane's 8 consecutive samples, 32 lanes side by side, hit 32 banks.
__host__ __device__ __forceinline__ int skew(int t) { return t + (t >> 5); }

// What both entries share: the resampler, parameters, state rows and the
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
  int a_tfast;          // 1: audio is contiguous in time (chain-major)
  int cluster;          // 1: launched in clusters of kCluster blocks
};

// Shared memory after an entry's own area (floats): [per·L] P, [2·kPowN]
// powers of the DC pole and the attack, [kCB][S] y.re (then the running
// max), [kCB][S] y.im (then the hang's running max), [kCB][S1] resample
// segment (H history slots, then the tile), [kCB][nsegs] p_prev − d and
// [kCB][nsegs] ring max by segment of a piece, [hang_tiles][kCB] hang ring.
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
           (size_t)kCB * S1 + 2 * (size_t)kCB * nsegs +
           (size_t)hang_tiles * kCB;
  }
};

struct Smem {
  float *ps, *pows, *ya, *yb, *a1, *pb, *hb, *ring;
  Layout lay;
  __device__ Smem(float* base, int per, int L, int T, int seg)
      : lay(per, T, seg) {
    ps = base;
    pows = ps + per * L;
    ya = pows + 2 * kPowN;
    yb = ya + kCB * lay.S;
    a1 = yb + kCB * lay.S;
    pb = a1 + kCB * lay.S1;
    hb = pb + kCB * lay.nsegs;
    ring = hb + kCB * lay.nsegs;
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

__device__ void tail_init(const TailArgs& a, const Smem& sm, Carry& cr,
                          int c0) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int k = tid; k < a.per * a.L; k += kThreads) sm.ps[k] = a.P[k];
  for (int k = tid; k < a.hang_tiles * kCB; k += kThreads)
    sm.ring[k] = kNegBig;
  if (tid < 2) {  // powers of the DC pole (params[0]) and the attack ([7])
    const float r = a.params[tid == 0 ? 0 : 7];
    float* pw = sm.pows + tid * kPowN;
    float v = r;
    for (int i = 0; i < 8; ++i) {
      pw[i] = v;
      v *= r;
    }
    for (int i = 8; i < kPowN; ++i) pw[i] = pw[i - 1] * pw[i - 1];
  }
  cr = Carry{0.f, 0.f, 0.f, 0.f, 0.f, kNegBig, kNegBig, kNegBig, 0.f, 0, 0.f};
  const int sc = c0 + w;
  const long C = a.C;
  float* a1c = sm.a1 + w * sm.lay.S1;
  if (sc < a.C) {
    cr.s0 = a.st_in[sc];
    cr.s1 = a.st_in[C + sc];
    cr.peak = a.st_in[2 * C + sc];
    cr.g = a.st_in[3 * C + sc];
  }
  for (int m = lane; m < a.per - 1; m += 32)
    a1c[skew(sm.lay.H - (a.per - 1) + m)] =
        sc < a.C ? a.st_in[(4 + m) * C + sc] : 0.f;
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

// v[pos % 8] of lane pos / 8, in every lane.
__device__ __forceinline__ float pick(const float (&v)[kRT], int pos) {
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

// demod → DC → AGC (+hang) → gain on one tile whose passband rows are in
// sm.ya / sm.yb (channel-major, skewed): warp w scans channel w in pieces
// of 256 samples and leaves the gained audio in the resample segment.
// t0: the tile's first sample in the chunk (segments count from the chunk's
// start).
template <int kDemod>
__device__ void tail_scan(const TailArgs& a, const Smem& sm, Carry& cr,
                          int t0, int tlen, int accum_pow) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* par = a.params;
  const float r_dc = par[0], d = par[1], thresh = par[2], slope = par[3];
  const float target = par[4], man_gain = par[5], agc_on = par[6];
  const float attack = par[7], hang_on = par[8];
  const float max_gain = target - thresh;
  const float knee = fmaxf(-thresh, 1e-6f);
  const int seg = a.seg;
  const bool hang = a.hang_tiles > 0;
  float* yr_row = sm.ya + w * sm.lay.S;
  float* yi_row = sm.yb + w * sm.lay.S;
  float* out_row = sm.a1 + w * sm.lay.S1;
  float* pb = sm.pb + w * sm.lay.nsegs;
  float* hb = sm.hb + w * sm.lay.nsegs;
  float* ring = sm.ring + w;  // slot k at ring[k·kCB]
  const float* pw_dc = sm.pows;
  const float* pw_at = sm.pows + kPowN;

  for (int s0 = 0; s0 < tlen; s0 += kTile) {
    const int cnt = min(kTile, tlen - s0);  // valid samples in the piece
    const int last = cnt - 1;
    const int tt = s0 + lane * kRT;         // this lane's first sample
    const int sk = tt + (tt >> 5);          // its skewed position
    const int nvalid = min(kRT, max(0, cnt - lane * kRT));
    const int n0 = t0 + s0;                 // the piece's first sample
    const int q0 = n0 / seg;
    const int j0 = (n0 + lane * kRT) % seg;
    const bool fresh = n0 % seg == 0;       // the piece opens a segment

    float u[kRT];
    {  // ---- demod: AM envelope + DC block, SSB real part, NBFM angle
      float yr[kRT], yi[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        yr[i] = i < nvalid ? yr_row[sk + i] : 0.f;
        yi[i] = i < nvalid ? yi_row[sk + i] : 0.f;
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

    // ---- peak tracker: cm = running max of e + j·d within the segment
    float p[kRT];
    {
      int j = j0;
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const float e =
            8.685889638065035f * logf(fmaxf(fabsf(u[i]), 1e-9f));
        p[i] = i < nvalid ? e + (float)j * d : kNegBig;
        j = j + 1 == seg ? 0 : j + 1;
      }
    }
    scan_segmax(p, fresh ? kNegBig : cr.cm, j0, seg, lane);
    cr.cm = pick(p, last);
    // p_prev − d of every segment of the piece, folded over its segment
    // ends by one lane
#pragma unroll
    for (int i = 0; i < kRT; ++i)
      if (i < nvalid) yr_row[sk + i] = p[i];
    __syncwarp();
    if (lane == 0) {
      float pbk = fresh ? cr.peak - d : cr.pbase;
      pb[0] = pbk;
      for (int k = 0;; ++k) {
        const long end = (long)(q0 + k + 1) * seg - 1 - n0;
        if (end >= cnt) break;
        const int e = s0 + (int)end;
        pbk = fmaxf(yr_row[skew(e)], pbk) - (float)(seg - 1) * d - d;
        pb[k + 1] = pbk;
      }
    }
    __syncwarp();
    {
      int j = j0, k = (n0 + lane * kRT) / seg - q0;
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        if (i < nvalid) p[i] = fmaxf(p[i], pb[k]) - (float)j * d;
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
    cr.pbase = pb[k_last];

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
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        if (i < nvalid) yi_row[sk + i] = m1[i];
      __syncwarp();
      int head = cr.head;
      if (lane == 0) {
        float h = cr.hist;
        if (fresh) {
          h = kNegBig;
          for (int q = 0; q < a.hang_tiles; ++q)
            h = fmaxf(h, ring[q * kCB]);
        }
        hb[0] = h;
        for (int k = 0;; ++k) {
          const long end = (long)(q0 + k + 1) * seg - 1 - n0;
          if (end >= cnt) break;
          ring[head * kCB] = yi_row[skew(s0 + (int)end)];
          head = head + 1 == a.hang_tiles ? 0 : head + 1;
          h = kNegBig;
          for (int q = 0; q < a.hang_tiles; ++q)
            h = fmaxf(h, ring[q * kCB]);
          hb[k + 1] = h;
        }
      }
      cr.head = __shfl_sync(kFull, head, 0);
      __syncwarp();
      float held[kRT];
      {
        int j = j0, k = (n0 + lane * kRT) / seg - q0;
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          held[i] = i < nvalid ? fmaxf(m1[i], hb[k]) : kNegBig;
          if (j + 1 == seg) {
            j = 0;
            ++k;
          } else {
            ++j;
          }
        }
      }
      cr.hist = hb[k_last];
      cr.held = pick(held, last);
      if (hang_on > 0.f) {
#pragma unroll
        for (int i = 0; i < kRT; ++i) used[i] = held[i];
      }
    }

    // ---- gain law, attack, gain
    float g[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float pu = used[i];
      float gain_db;
      if (agc_on > 0.f) {
        const float above = (target - pu) + slope * ((pu - thresh) / knee);
        gain_db = pu <= thresh ? max_gain : above;
      } else {
        gain_db = man_gain - 50.f;
      }
      g[i] = (1.f - attack) * gain_db;
    }
    scan_linear(g, cr.g, pw_at, lane);
    cr.g = pick(g, last);
    const int ho = sm.lay.H + tt;
    const int so = ho + (ho >> 5);
#pragma unroll
    for (int i = 0; i < kRT; ++i)
      if (i < nvalid)
        out_row[so + i] = u[i] * expf(0.11512925464970229f * g[i]);
  }
}

// ×L polyphase resample of the tile in the resample segment; writes audio
// rows [t0·L, (t0 + tlen)·L). A thread owns one input sample of one channel
// and its L outputs, so the per samples it reads serve all of them. kL: L at
// compile time (the accumulators stay in registers), or 0: any L, one
// output at a time.
template <int kL>
__device__ void tail_resample(const TailArgs& a, const Smem& sm, int c0,
                              int t0, int tlen) {
  const int tid = threadIdx.x;
  const int L = kL ? kL : a.L;
  const int hoff = sm.lay.H - (a.per - 1);
  // chain-major audio: a warp a channel, lanes along time (coalesced in
  // time); time-major audio: 8 channels side by side (32-byte rows)
  const int c = a.a_tfast ? tid >> 5 : tid & (kCB - 1);
  const int n_first = a.a_tfast ? tid & 31 : tid >> 3;
  if (c0 + c >= a.C) return;
  const float* a1c = sm.a1 + c * sm.lay.S1;
  float* dst = a.audio + (long)(c0 + c) * a.a_sc;
  for (int n = n_first; n < tlen; n += 32) {
    const long o = ((long)t0 + n) * L;
    if (kL) {
      float acc[kL ? kL : 1];
#pragma unroll
      for (int q = 0; q < kL; ++q) acc[q] = 0.f;
      for (int m = 0; m < a.per; ++m) {
        float v = a1c[skew(hoff + n + m)];
        if (a.rs_bf16) v = bf16_round(v);
        float pm[kL ? kL : 1];
        if (kL == 4) {  // one 16-byte broadcast load (P is 16-byte aligned)
          const float4 p4 = reinterpret_cast<const float4*>(sm.ps)[m];
          pm[0] = p4.x, pm[1] = p4.y, pm[2] = p4.z, pm[3] = p4.w;
        } else {
#pragma unroll
          for (int q = 0; q < kL; ++q) pm[q] = sm.ps[m * kL + q];
        }
#pragma unroll
        for (int q = 0; q < kL; ++q)
          acc[q] += (a.rs_bf16 ? bf16_round(pm[q]) : pm[q]) * v;
      }
      if (kL == 4 && a.a_st == 1 && (a.a_sc & 3) == 0) {  // 16-byte aligned
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int q = 0; q < kL; ++q) dst[(o + q) * a.a_st] = acc[q];
      }
    } else {
      for (int q = 0; q < L; ++q) {
        float acc = 0.f;
        for (int m = 0; m < a.per; ++m) {
          float pm = sm.ps[m * L + q];
          float v = a1c[skew(hoff + n + m)];
          if (a.rs_bf16) {
            pm = bf16_round(pm);
            v = bf16_round(v);
          }
          acc += pm * v;
        }
        dst[(o + q) * a.a_st] = acc;
      }
    }
  }
}

__device__ __forceinline__ void tail_resample_any(const TailArgs& a,
                                                  const Smem& sm, int c0,
                                                  int t0, int tlen) {
  if (a.L == 4)
    tail_resample<4>(a, sm, c0, t0, tlen);
  else
    tail_resample<0>(a, sm, c0, t0, tlen);
}

// Σ|y|² per channel from the lanes' shares, then the state rows out.
__device__ void tail_finish(const TailArgs& a, const Smem& sm, Carry& cr,
                            int c0, int tlen_prev, int accum_pow) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float sum = cr.pw;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(kFull, sum, s);
  const int sc = c0 + w;
  if (sc >= a.C) return;
  const long C = a.C;
  const float* a1c = sm.a1 + w * sm.lay.S1;
  for (int m = lane; m < a.per - 1; m += 32)
    a.st_out[(4 + m) * C + sc] =
        a1c[skew(sm.lay.H + tlen_prev - (a.per - 1) + m)];
  if (lane == 0) {
    a.st_out[sc] = cr.s0;
    a.st_out[C + sc] = cr.s1;
    a.st_out[2 * C + sc] =
        a.hang_tiles && a.params[8] > 0.f ? cr.held : cr.peak;
    a.st_out[3 * C + sc] = cr.g;
    a.st_out[(4 + a.per - 1) * C + sc] = accum_pow ? sum : 0.f;
  }
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

// The FIR's shared area: the tap copies and the window, in bf16 pieces (one
// when the operands are bf16; float32 operands are split in a high and a
// low piece, x ≈ hi + lo, and the product runs in three passes).
//   G   [pieces][2 (re, im)][2 (shift 0, 1)][glen] bf16: G[kGPad + d] =
//       h[OVP − d], zero outside the band; the second copy starts one
//       element later
//   win [pieces][2 (re, im)][kCB][Sb] bf16: column OVP + r holds input row
//       t0 + r, the ov columns before it the history
struct FirLayout {
  int OVP, glen, Sb, np;
  __host__ __device__ FirLayout(int ov, int T, int pieces) {
    OVP = (ov + 15) / 16 * 16;
    glen = OVP + 64;
    Sb = 2 * ((OVP + T) / 2 / 8 * 8 + 12);  // words a row ≡ 4 (mod 8)
    np = pieces;
  }
  __host__ __device__ size_t g_piece() const { return 4 * (size_t)glen; }
  __host__ __device__ size_t w_piece() const { return 2 * (size_t)kCB * Sb; }
  // the area in floats, a multiple of 4: what follows stays 16-byte aligned
  __host__ __device__ size_t floats() const {
    return (np * (g_piece() + w_piece()) + 7) / 8 * 4;
  }
};

// v's bf16 piece: 0 the value rounded, 1 what that left
__device__ __forceinline__ __nv_bfloat16 bf16_piece(float v, int piece) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  return piece ? __float2bfloat16_rn(v - __bfloat162float(hi)) : hi;
}

// One tile's FIR on the tensor cores: ya/yb[c][t] = Σ_k h[k]·win[c][OVP+t−k]
// for all T rows (rows past the tile's length read zeros). Warp w owns row
// tiles w·T/128 … (w+1)·T/128 − 1, two at a time, so a B fragment loaded
// for the upper tile serves the lower one a step later. kSplit: three
// passes into the same accumulators, hi·hi + hi·lo + lo·hi.
template <bool kCplx, bool kSplit>
__device__ void fir_mma(const __nv_bfloat16* G, const __nv_bfloat16* win,
                        const FirLayout& fl, const Smem& sm, int T) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int Sw = fl.Sb / 2, gw = fl.glen / 2;
  // the tap copy whose pairs are aligned for this row parity, as words
  const uint32_t* G0 = reinterpret_cast<const uint32_t*>(G) + (g & 1) * gw;
  const uint32_t* W0 = reinterpret_cast<const uint32_t*>(win) + g * Sw + tig;
  // word of the pair at G[kGPad + Δ + 2·tig − g] for Δ = 0
  const int xw = (kGPad + 2 * tig - g - (g & 1)) / 2;
  const int tiles = T / 16 / kCB;  // row tiles a warp (even: T % 256 == 0)
  for (int rp = 0; rp < tiles; rp += 2) {
    const int m0 = (w * tiles + rp) * 16;
    float ar[2][4], ai[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[q][i] = ai[q][i] = 0.f;
#pragma unroll
    for (int pass = 0; pass < (kSplit ? 3 : 1); ++pass) {
      // taps: the low piece in the third pass; window: in the second
      const uint32_t* Gr = G0 + (pass == 2 ? fl.g_piece() / 2 : 0);
      const uint32_t* Gi = Gr + 2 * gw;
      const uint32_t* Wr = W0 + (pass == 1 ? fl.w_piece() / 2 : 0);
      const uint32_t* Wi = Wr + kCB * Sw;
      uint32_t hlo = Gr[xw - 4], hmid = Gr[xw];
      uint32_t ilo = 0, imid = 0;
      if (kCplx) {
        ilo = Gi[xw - 4];
        imid = Gi[xw];
      }
      const uint32_t* wr = Wr + m0 / 2;
      const uint32_t* wi = Wi + m0 / 2;
      uint32_t br0 = wr[0], br1 = wr[4], bi0 = wi[0], bi1 = wi[4];
      for (int D = 0; D <= fl.OVP; D += 16) {
        const int dw = D / 2;
        const uint32_t hhi = Gr[xw + dw + 4];
        // the upper row tile's window rows (= the lower one's a step later)
        const uint32_t cr0 = wr[dw + 8], cr1 = wr[dw + 12];
        const uint32_t ci0 = wi[dw + 8], ci1 = wi[dw + 12];
        mma_bf16(ar[0], hmid, hlo, hhi, hmid, br0, br1);
        mma_bf16(ai[0], hmid, hlo, hhi, hmid, bi0, bi1);
        mma_bf16(ar[1], hmid, hlo, hhi, hmid, cr0, cr1);
        mma_bf16(ai[1], hmid, hlo, hhi, hmid, ci0, ci1);
        if (kCplx) {  // y.re −= h.im·x.im, y.im += h.im·x.re
          const uint32_t ihi = Gi[xw + dw + 4];
          const uint32_t kNeg = 0x80008000u;
          mma_bf16(ar[0], imid ^ kNeg, ilo ^ kNeg, ihi ^ kNeg, imid ^ kNeg,
                   bi0, bi1);
          mma_bf16(ai[0], imid, ilo, ihi, imid, br0, br1);
          mma_bf16(ar[1], imid ^ kNeg, ilo ^ kNeg, ihi ^ kNeg, imid ^ kNeg,
                   ci0, ci1);
          mma_bf16(ai[1], imid, ilo, ihi, imid, cr0, cr1);
          ilo = ihi;
          imid = Gi[xw + dw + 8];
        }
        hlo = hhi;
        hmid = Gr[xw + dw + 8];
        br0 = cr0;
        br1 = cr1;
        bi0 = ci0;
        bi1 = ci1;
      }
    }
    // accumulator (row g | g + 8, channels 2·tig, 2·tig + 1)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = m0 + q * 16 + g;
      float* ya = sm.ya + 2 * tig * sm.lay.S;
      float* yb = sm.yb + 2 * tig * sm.lay.S;
      ya[skew(t)] = ar[q][0];
      ya[sm.lay.S + skew(t)] = ar[q][1];
      ya[skew(t + 8)] = ar[q][2];
      ya[sm.lay.S + skew(t + 8)] = ar[q][3];
      yb[skew(t)] = ai[q][0];
      yb[sm.lay.S + skew(t)] = ai[q][1];
      yb[skew(t + 8)] = ai[q][2];
      yb[sm.lay.S + skew(t + 8)] = ai[q][3];
    }
  }
}

// The input rows of the tile at t0, [2 (re, im)][T][8 channels] as they lie
// in global memory (16 bytes a row in bf16, 32 in f32), copied asynchronously
// into `stage`; rows past the chunk are zeros. Thread i copies, and
// `load_window` later reads, rows i, i + 256, …: a thread waits for its own
// copies only.
__device__ void prefetch_rows(char* stage, const void* x_re, const void* x_im,
                              bool x_bf16, long plane, int n2, int col0,
                              int t0, int T, int nf) {
  const int rb = x_bf16 ? 16 : 32;
  for (int i = threadIdx.x; i < 2 * T; i += kThreads) {
    const int pl = i / T, row = i % T;
    const bool in = t0 + row < nf;
    const char* src =
        static_cast<const char*>(pl ? x_im : x_re) +
        (in ? ((plane + t0 + row) * n2 + col0) * (rb / kCB) : 0);
    cp_async<16>(stage + (size_t)i * rb, src, in ? 16 : 0);
    if (!x_bf16)
      cp_async<16>(stage + (size_t)i * rb + 16, src + 16, in ? 16 : 0);
  }
  cp_async_commit();
}

// Fill the window's columns [OVP, OVP + T) from the staged input rows, in
// fl.np bf16 pieces.
__device__ void load_window(__nv_bfloat16* win, const FirLayout& fl,
                            const char* stage, bool x_bf16, int T) {
  cp_async_wait_all();
  const int rb = x_bf16 ? 16 : 32;
  for (int i = threadIdx.x; i < 2 * T; i += kThreads) {
    const int pl = i / T, row = i % T;
    float v[kCB];
    if (x_bf16) {
      alignas(16) __nv_bfloat16 b[kCB];
      *reinterpret_cast<uint4*>(b) =
          *reinterpret_cast<const uint4*>(stage + (size_t)i * rb);
#pragma unroll
      for (int c = 0; c < kCB; ++c) v[c] = __bfloat162float(b[c]);
    } else {
      const float4* p =
          reinterpret_cast<const float4*>(stage + (size_t)i * rb);
      const float4 q0 = p[0], q1 = p[1];
      v[0] = q0.x, v[1] = q0.y, v[2] = q0.z, v[3] = q0.w;
      v[4] = q1.x, v[5] = q1.y, v[6] = q1.z, v[7] = q1.w;
    }
    for (int pc = 0; pc < fl.np; ++pc) {
      __nv_bfloat16* dst = win + pc * fl.w_piece() +
                           (size_t)pl * kCB * fl.Sb + fl.OVP + row;
#pragma unroll
      for (int c = 0; c < kCB; ++c) dst[c * fl.Sb] = bf16_piece(v[c], pc);
    }
  }
}

// Three blocks an SM: 2560 channels are 320 blocks, one wave on 132 SMs
// only at 3 blocks each (≤ 85 registers a thread). kFirBf16: the FIR's
// operands are bf16 (one tensor-core pass); else float32, split in two bf16
// pieces (three passes).
template <bool kCplx, int kDemod, bool kFirBf16>
__global__ void __launch_bounds__(kThreads, 3)
chain_tail_fir_kernel(const void* __restrict__ x_re,
                      const void* __restrict__ x_im, int x_bf16, int nf,
                      int n2,
                      const float* __restrict__ head_re,
                      const float* __restrict__ head_im,
                      const float* __restrict__ h_re,
                      const float* __restrict__ h_im, int n_taps,
                      TailArgs a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int ov = n_taps - 1;
  const int T = tile_rows(ov);
  const FirLayout fl(ov, T, kFirBf16 ? 1 : 2);
  __nv_bfloat16* G = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win = G + fl.np * fl.g_piece();
  const Smem sm(smem + fl.floats(), a.per, a.L, T, a.seg);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCB;          // first planar channel
  const long plane = (long)(c0 / n2) * nf;  // k1 · nf
  const int col0 = c0 % n2;
  const long C = a.C;

  // tap copies (zero padded), the window's history, zeros before it
  for (int i = tid; i < fl.np * 4 * fl.glen; i += kThreads) {
    const int pc = i / (4 * fl.glen), part = i / fl.glen % 4;
    const int pos = i % fl.glen;
    const int dd = pos + (part & 1) - kGPad;  // d of this element
    const int k = fl.OVP - dd;                // tap index
    float v = 0.f;
    if (k >= 0 && k <= ov && (part < 2 || kCplx))
      v = part < 2 ? h_re[k] : h_im[k];
    G[i] = bf16_piece(v, pc);
  }
  for (int i = tid; i < fl.np * 2 * kCB * fl.OVP; i += kThreads) {
    const int pc = i / (2 * kCB * fl.OVP), pl = i / (kCB * fl.OVP) % 2;
    const int c = i / fl.OVP % kCB, col = i % fl.OVP;
    const int row = col - (fl.OVP - ov);  // history row, oldest first
    float v = 0.f;
    if (row >= 0) v = (pl ? head_im : head_re)[(long)row * C + c0 + c];
    win[pc * fl.w_piece() + (size_t)(pl * kCB + c) * fl.Sb + col] =
        bf16_piece(v, pc);
  }
  Carry cr;
  tail_init(a, sm, cr, c0);
  // A tile's input rows are staged in the passband rows' space (16-byte
  // aligned; ≥ 64·T bytes), which is free from the end of the scans to the
  // FIR of the next tile: the copies run under the resampler.
  char* stage = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(sm.ya) + 15) & ~uintptr_t(15));
  prefetch_rows(stage, x_re, x_im, x_bf16 != 0, plane, n2, col0, 0, T, nf);

  int tlen_prev = 0;
  for (int t0 = 0; t0 < nf; t0 += T) {
    const int tlen = min(T, nf - t0);
    if (t0 > 0) {
      // this tile's FIR history = the previous tile's last input rows
      const int hw = fl.OVP / 2, Sw = fl.Sb / 2;
      uint32_t* ww = reinterpret_cast<uint32_t*>(win);
      for (int i = tid; i < fl.np * 2 * kCB * hw; i += kThreads) {
        uint32_t* rowp = ww + (size_t)(i / hw) * Sw;
        rowp[i % hw] = rowp[i % hw + T / 2];
      }
      shift_history(a, sm, tlen_prev);
      __syncthreads();
    }
    load_window(win, fl, stage, x_bf16 != 0, T);
    __syncthreads();
    fir_mma<kCplx, !kFirBf16>(G, win, fl, sm, T);
    __syncthreads();
    tail_scan<kDemod>(a, sm, cr, t0, tlen, 1);
    __syncthreads();
    if (t0 + T < nf)
      prefetch_rows(stage, x_re, x_im, x_bf16 != 0, plane, n2, col0, t0 + T,
                    T, nf);
    tail_resample_any(a, sm, c0, t0, tlen);
    tlen_prev = tlen;
    __syncthreads();
  }
  tail_finish(a, sm, cr, c0, tlen_prev, 1);
}

template <int kDemod>
__global__ void __launch_bounds__(kThreads, 3)
chain_tail_am_kernel(const float* __restrict__ y_re,
                     const float* __restrict__ y_im, long y_st, long y_sc,
                     int y_tfast, int nf, int accum_pow, TailArgs a) {
  extern __shared__ float4 smem_f4[];
  const Smem sm(reinterpret_cast<float*>(smem_f4), a.per, a.L, kTile, a.seg);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCB;
  Carry cr;
  tail_init(a, sm, cr, c0);
  // The tile of y at t0 into the passband rows, by 4-byte asynchronous
  // copies, read along whichever axis is contiguous: a warp a channel with
  // lanes along time, or 8 channels side by side. The rows are free from
  // the end of a tile's scans, so the next tile arrives under the resampler.
  auto prefetch = [&](int t0) {
    const int tlen = min(kTile, nf - t0);
    const int c = y_tfast ? tid >> 5 : tid & (kCB - 1);
    const bool on = c0 + c < a.C;
    const long base = on ? (long)(c0 + c) * y_sc : 0;
    for (int row = y_tfast ? tid & 31 : tid >> 3; row < tlen; row += 32) {
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
    tail_scan<kDemod>(a, sm, cr, t0, tlen, accum_pow);
    __syncthreads();
    if (a.cluster) cluster_sync();  // the line's four blocks store together
    if (t0 + kTile < nf) prefetch(t0 + kTile);
    tail_resample_any(a, sm, c0, t0, tlen);
    tlen_prev = tlen;
    __syncthreads();
  }
  tail_finish(a, sm, cr, c0, tlen_prev, accum_pow);
}

// Launch a tail kernel on `blocks` blocks; a.cluster: in clusters of
// kCluster consecutive blocks (the grid rounded up: a block past the last
// channel masks everything), which keep step tile by tile.
template <typename... Params, typename... Args>
cudaError_t launch_tail(void (*kern)(Params...), int blocks, size_t smem,
                        cudaStream_t stream, bool cluster, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster ? (blocks + kCluster - 1) / kCluster * kCluster
                             : blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <bool kCplx, int kDemod, bool kFirBf16>
cudaError_t launch_fir(const void* x_re, const void* x_im, int x_bf16,
                       int n1, int nf, int n2, const float* head_re,
                       const float* head_im,
                       const float* h_re, const float* h_im, int n_taps,
                       const TailArgs& a, cudaStream_t stream) {
  const int ov = n_taps - 1;
  const int T = tile_rows(ov);
  const size_t fir = FirLayout(ov, T, kFirBf16 ? 1 : 2).floats();
  const Layout lay(a.per, T, a.seg);
  const size_t smem =
      (fir + lay.floats(a.per, a.L, a.hang_tiles)) * sizeof(float);
  return launch_tail(chain_tail_fir_kernel<kCplx, kDemod, kFirBf16>,
                     n1 * n2 / kCB, smem, stream, a.cluster != 0, x_re, x_im,
                     x_bf16, nf, n2, head_re, head_im, h_re, h_im, n_taps, a);
}

template <bool kCplx, bool kFirBf16>
cudaError_t fir_by_demod(int demod, const void* x_re, const void* x_im,
                         int x_bf16, int n1, int nf, int n2,
                         const float* head_re, const float* head_im,
                         const float* h_re, const float* h_im, int n_taps,
                         const TailArgs& a, cudaStream_t s) {
#define SSDR_FIR(D)                                                        \
  return launch_fir<kCplx, D, kFirBf16>(x_re, x_im, x_bf16, n1, nf, n2,   \
                                        head_re, head_im, h_re, h_im,     \
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
                     smem, stream, a.cluster != 0, y_re, y_im, y_st, y_sc,
                     y_st < y_sc ? 1 : 0, nf, accum_pow, a);
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
// head_*: [n_taps−1, C] input history, planar channel order; h_*: taps
// [n_taps] (h_im read only when fir_complex); fir_bf16: round the FIR's
// operands to bf16 and run it on the tensor cores; P: [per, L]; params:
// [9] = r_dc | nbfm scale, decay/sample, thresh, slope, target, man_gain,
// agc_on, attack, hang_on; st_in/st_out: [4 + per, C] state rows (dc_x |
// prev re, dc_y | prev im, peak, gain, per−1 resample tail rows, power —
// ignored on input); audio: [nf·L, C] f32; seg: the reference's tail tile
// (peak segment and hang tile), a divisor of nf; hang_tiles: ring length,
// 0 = no hang.
int chain_tail_fir(const void* x_re, const void* x_im, int x_bf16, int n1,
                   int nf, int n2, const float* head_re, const float* head_im,
                   const float* h_re, const float* h_im, int n_taps,
                   int fir_complex, int fir_bf16, const float* P, int per,
                   int L, int rs_bf16, const float* params, int demod,
                   int seg, int hang_tiles, const float* st_in, float* st_out,
                   float* audio, void* stream) {
  const TailArgs a{P, per, L, rs_bf16, params, seg, hang_tiles, st_in,
                   st_out, n1 * n2, audio, (long)n1 * n2, 1L, 0, 0};
  if (n2 % kCB || n_taps < 2 || !tail_args_ok(a, nf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSDR_TAIL(CP, FB)                                                  \
  return (int)fir_by_demod<CP, FB>(demod, x_re, x_im, x_bf16, n1, nf, n2,  \
                                   head_re, head_im, h_re, h_im, n_taps,   \
                                   a, s)
  switch ((fir_complex ? 2 : 0) | (fir_bf16 ? 1 : 0)) {
    case 0: SSDR_TAIL(false, false);
    case 1: SSDR_TAIL(false, true);
    case 2: SSDR_TAIL(true, false);
    default: SSDR_TAIL(true, true);
  }
#undef SSDR_TAIL
}

// y_*: the passband's re and im, element (i, c) at y_*[i·y_st + c·y_sc] for
// i < nf, c < C (a complex64 tensor's two views, or two f32 planes); audio
// sample (k, c) written at audio[k·a_st + c·a_sc], k < nf·L; the rest as
// chain_tail_fir, with the power row written only when accum_pow (else 0).
int chain_tail_am(const float* y_re, const float* y_im, long y_st, long y_sc,
                  int nf, int C, const float* P, int per, int L,
                  const float* params, int demod, int seg, int hang_tiles,
                  int accum_pow, const float* st_in, float* st_out,
                  float* audio, long a_st, long a_sc, void* stream) {
  const TailArgs a{P, per, L, 0, params, seg, hang_tiles, st_in, st_out,
                   C, audio, a_st, a_sc, a_st < a_sc ? 1 : 0,
                   a_st < a_sc ? 0 : 1};
  if (!tail_args_ok(a, nf) || y_st < 1 || y_sc < 1 || a_st < 1 || a_sc < 1)
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

}  // extern "C"
