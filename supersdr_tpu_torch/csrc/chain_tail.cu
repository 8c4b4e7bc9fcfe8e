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
// The recurrences run sequentially in time; the reference evaluates them
// with in-tile doubling scans, which round differently (a few ulp; see the
// plain versions and the tests' tolerance). The peak tracker keeps the
// reference's form over segments of `seg` samples (its tile T):
// p[j] = max(max_{i≤j}(e[i] + i·d), p_prev − d) − j·d, so the decay is one
// rounded offset a segment — subtracting d once a sample drifts (over a
// 16128-sample chunk the audio then agreed with the plain version to 70 dB
// instead of 112 dB on an H100). The hang is the reference's tile-granular
// ring: the held peak is the max of the segment's running raw peak and the
// previous hang_tiles = ceil((W−1)/T) segment maxima, the ring starts empty
// each chunk, later segments chain the raw peak, and the state peak at the
// chunk's end is the held value. params[8] switches it on at run time; both
// entries honour it.
//
// What bounds it on this card: the FIR entry, the passband FIR (4·n_taps
// FLOP a sample with real taps, 8·n_taps complex: ~42 GFLOP a chunk at the
// 2560-channel headline) and the three recurrences; the non-FIR entry, the
// recurrences alone — 16128 dependent steps a channel a chunk at the
// headline — against ~330 MB of y read and ~660 MB of audio written.
//
// Design: a block owns 8 channels and walks time in tiles of T ≥ n_taps−1
// (FIR) or 256 samples. The FIR entry keeps each tile's input rows and the
// n_taps−1 history rows in shared memory and computes the FIR on all 256
// threads (8 outputs a thread, a sliding register window), so y never
// reaches device memory; the non-FIR entry loads the tile of y by element
// strides in time and in channel, so a chain-major [C, n] source and a
// time-major [n, C] one are both read without a transpose pass, along
// whichever axis is contiguous. What needs no carried state runs on all
// threads: the demod's sqrt or atan2, the envelope's log, the gain's exp and
// the resampler, which writes audio by element strides too (coalesced along
// the contiguous axis). Only the recurrences' cheap arithmetic (DC block;
// peak, hang, gain law and attack) runs one thread a channel. No block
// carries anything to another; a ragged last block of channels is masked.
// The serial loops keep only 8 threads a block busy; a time-segmented scan
// (all three recurrences are associative) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 8;                     // channels per block
constexpr int kLanes = kThreads / kCB;     // time lanes in the FIR phase
constexpr int kRT = 8;                     // FIR outputs per thread per pass
constexpr int kTile = kLanes * kRT;        // 256 samples: the tile unit
constexpr float kNegBig = -3.0e38f;

enum { kAM = 0, kSSB = 1, kNBFM = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kXBf16>
__device__ __forceinline__ float load_x(const void* p, long idx) {
  if (kXBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
  return static_cast<const float*>(p)[idx];
}

__host__ __device__ inline int tile_rows(int ov) {
  return ov <= kTile ? kTile : (ov + kTile - 1) / kTile * kTile;
}

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
};

// Shared memory after an entry's own area: [per·L] P, [T][kCB] y.re (then
// envelope dB), [T][kCB] y.im (then gain dB), [per−1 + T][kCB] resample
// segment, [2][kCB] NBFM previous sample, [hang_tiles][kCB] hang ring.
__host__ __device__ inline size_t common_floats(int per, int L, int T,
                                                int hang_tiles) {
  return (size_t)per * L + 2 * (size_t)T * kCB + (size_t)(per - 1 + T) * kCB +
         2 * kCB + (size_t)hang_tiles * kCB;
}

struct Smem {
  float *ps, *ys_r, *ys_i, *a1, *u, *pv, *ring;
  __device__ Smem(float* base, int per, int L, int T) {
    ps = base;
    ys_r = ps + per * L;
    ys_i = ys_r + T * kCB;
    a1 = ys_i + T * kCB;
    u = a1 + (per - 1) * kCB;  // the tile's rows of a1
    pv = a1 + (per - 1 + T) * kCB;
    ring = pv + 2 * kCB;
  }
};

// One channel's recurrence state, held by its serial thread (tid < kCB).
struct Serial {
  float s0, s1, peak, g;  // DC x | previous re, DC y | previous im, peak, gain
  float pbase, cm;        // peak segment: p_prev − d, running max
  float m1, hist, held;   // hang: segment's running raw peak, ring max, held
  int j, head;            // index within the segment; next ring slot
  float pw;               // this thread's share of Σ|y|² (all threads)
};

__device__ void tail_init(const TailArgs& a, const Smem& sm, Serial& s,
                          int c0) {
  const int tid = threadIdx.x;
  for (int k = tid; k < a.per * a.L; k += kThreads) sm.ps[k] = a.P[k];
  for (int k = tid; k < a.hang_tiles * kCB; k += kThreads)
    sm.ring[k] = kNegBig;
  s = Serial{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, kNegBig, kNegBig, 0.f, 0, 0, 0.f};
  const int sc = c0 + tid;
  if (tid < kCB && sc < a.C) {
    const long C = a.C;
    s.s0 = a.st_in[sc];
    s.s1 = a.st_in[C + sc];
    s.peak = a.st_in[2 * C + sc];
    s.g = a.st_in[3 * C + sc];
    for (int m = 0; m < a.per - 1; ++m)
      sm.a1[m * kCB + tid] = a.st_in[(4 + m) * C + sc];
  } else if (tid < kCB) {  // a masked channel past C
    for (int m = 0; m < a.per - 1; ++m) sm.a1[m * kCB + tid] = 0.f;
  }
  if (tid < kCB) {
    sm.pv[tid] = s.s0;
    sm.pv[kCB + tid] = s.s1;
  }
}

// The last per−1 resample-segment rows of the previous tile become this
// tile's history (disjoint moves: tlen_prev = T > per − 1).
__device__ void shift_history(const TailArgs& a, const Smem& sm,
                              int tlen_prev) {
  for (int i = threadIdx.x; i < (a.per - 1) * kCB; i += kThreads)
    sm.a1[i] = sm.a1[i + tlen_prev * kCB];
}

// demod → DC → AGC (+hang) → gain → resample on one tile whose passband rows
// are in sm.ys_r / sm.ys_i; writes audio rows [t0·L, (t0 + tlen)·L). kHang
// compiles the hang ring in (a.hang_tiles > 0), so the loop without it is
// no longer than before hang existed.
template <int kDemod, bool kHang>
__device__ void tail_tile(const TailArgs& a, const Smem& sm, Serial& s,
                          int c0, int t0, int tlen) {
  const int tid = threadIdx.x;
  const float* par = a.params;
  const float r_dc = par[0], d = par[1], thresh = par[2], slope = par[3];
  const float target = par[4], man_gain = par[5], agc_on = par[6];
  const float attack = par[7], hang_on = par[8];
  float* u = sm.u;
  // ---- demod: AM envelope, SSB real part, NBFM discriminator
  for (int i = tid; i < tlen * kCB; i += kThreads) {
    const float yr = sm.ys_r[i], yi = sm.ys_i[i];
    if (kDemod == kAM) {
      u[i] = sqrtf(yr * yr + yi * yi);
    } else if (kDemod == kNBFM) {
      const int c = i % kCB;
      const float qr = i >= kCB ? sm.ys_r[i - kCB] : sm.pv[c];
      const float qi = i >= kCB ? sm.ys_i[i - kCB] : sm.pv[kCB + c];
      const float dotp = yr * qr + yi * qi;
      const float cross = yi * qr - yr * qi;
      const float mag = fabsf(dotp) + fabsf(cross);
      u[i] = mag > 1e-12f ? atan2f(cross, dotp) * r_dc : 0.f;
    } else {
      u[i] = yr;
    }
  }
  __syncthreads();
  if (tid < kCB) {
    if (kDemod == kAM) {  // DC block: a = env − env[n−1] + r·a[n−1]
      for (int t = 0; t < tlen; ++t) {
        const float env = u[t * kCB + tid];
        const float a0 = (env - s.s0) + r_dc * s.s1;
        s.s0 = env;
        s.s1 = a0;
        u[t * kCB + tid] = a0;
      }
    } else if (kDemod == kNBFM) {
      s.s0 = sm.ys_r[(tlen - 1) * kCB + tid];
      s.s1 = sm.ys_i[(tlen - 1) * kCB + tid];
      sm.pv[tid] = s.s0;
      sm.pv[kCB + tid] = s.s1;
    }
  }
  __syncthreads();

  // ---- AGC: envelope in dB, then peak tracker, hang, gain law and attack
  for (int i = tid; i < tlen * kCB; i += kThreads)
    sm.ys_r[i] = 8.685889638065035f * logf(fmaxf(fabsf(u[i]), 1e-9f));
  __syncthreads();
  if (tid < kCB) {
    const float max_gain = target - thresh;
    const float knee = fmaxf(-thresh, 1e-6f);
    for (int t = 0; t < tlen; ++t) {
      const float env_db = sm.ys_r[t * kCB + tid];
      const bool start = s.j == 0;  // a new segment (the same for all 8)
      if (kHang && start) {
        float h = kNegBig;
        for (int k = 0; k < a.hang_tiles; ++k)
          h = fmaxf(h, sm.ring[k * kCB + tid]);
        s.hist = h;
        s.m1 = kNegBig;
      }
      s.pbase = start ? s.peak - d : s.pbase;
      s.cm = start ? kNegBig : s.cm;
      const float jd = (float)s.j * d;
      s.cm = fmaxf(s.cm, env_db + jd);
      s.peak = fmaxf(s.cm, s.pbase) - jd;
      float pu = s.peak;
      if (kHang) {
        s.m1 = fmaxf(s.m1, s.peak);
        s.held = fmaxf(s.m1, s.hist);
        pu = hang_on > 0.f ? s.held : s.peak;
        if (s.j + 1 == a.seg) {
          sm.ring[s.head * kCB + tid] = s.m1;
          s.head = s.head + 1 == a.hang_tiles ? 0 : s.head + 1;
        }
      }
      s.j = s.j + 1 == a.seg ? 0 : s.j + 1;
      float gain_db;
      if (agc_on > 0.f) {
        const float above = (target - pu) + slope * ((pu - thresh) / knee);
        gain_db = pu <= thresh ? max_gain : above;
      } else {
        gain_db = man_gain - 50.f;
      }
      s.g = attack * s.g + (1.f - attack) * gain_db;
      sm.ys_i[t * kCB + tid] = s.g;
    }
  }
  __syncthreads();
  for (int i = tid; i < tlen * kCB; i += kThreads)
    u[i] *= expf(0.11512925464970229f * sm.ys_i[i]);
  __syncthreads();

  // ---- ×L polyphase resample of the tile
  const int L = a.L, n_out = tlen * L;
  for (int i = tid; i < n_out * kCB; i += kThreads) {
    const int c = a.a_tfast ? i / n_out : i % kCB;
    const int o = a.a_tfast ? i % n_out : i / kCB;
    if (c0 + c >= a.C) continue;
    const int n = o / L, q = o % L;
    float acc = 0.f;
    for (int m = 0; m < a.per; ++m) {
      float pm = sm.ps[m * L + q];
      float v = sm.a1[(n + m) * kCB + c];
      if (a.rs_bf16) {
        pm = bf16_round(pm);
        v = bf16_round(v);
      }
      acc += pm * v;
    }
    a.audio[((long)t0 * L + o) * a.a_st + (long)(c0 + c) * a.a_sc] = acc;
  }
}

// Σ|y|² per channel from the threads' shares (thread tid holds channel
// tid % kCB), then the state rows out.
__device__ void tail_finish(const TailArgs& a, const Smem& sm, Serial& s,
                            int c0, int tlen_prev, int accum_pow) {
  const int tid = threadIdx.x;
  sm.ys_r[tid] = s.pw;
  __syncthreads();
  const int sc = c0 + tid;
  if (tid < kCB && sc < a.C) {
    float sum = 0.f;
    for (int l = 0; l < kLanes; ++l) sum += sm.ys_r[l * kCB + tid];
    const long C = a.C;
    a.st_out[sc] = s.s0;
    a.st_out[C + sc] = s.s1;
    a.st_out[2 * C + sc] =
        a.hang_tiles && a.params[8] > 0.f ? s.held : s.peak;
    a.st_out[3 * C + sc] = s.g;
    for (int m = 0; m < a.per - 1; ++m)
      a.st_out[(4 + m) * C + sc] = sm.a1[(tlen_prev + m) * kCB + tid];
    a.st_out[(4 + a.per - 1) * C + sc] = accum_pow ? sum : 0.f;
  }
}

// Three blocks an SM: 2560 channels are 320 blocks, one wave on 132 SMs
// only at 3 blocks each. Unbounded, the hang variant took 108 registers a
// thread (2 blocks an SM, two waves) and ran 7.2 ms a chunk against 4.8 ms
// with this bound (H100 80GB HBM3, 700 W); the bound costs the others
// nothing.
template <bool kXBf16, bool kCplx, int kDemod, bool kHang>
__global__ void __launch_bounds__(kThreads, 3)
chain_tail_fir_kernel(const void* __restrict__ x_re,
                      const void* __restrict__ x_im, int nf, int n2,
                      const float* __restrict__ head_re,
                      const float* __restrict__ head_im,
                      const float* __restrict__ h_re,
                      const float* __restrict__ h_im, int n_taps,
                      int fir_bf16, TailArgs a) {
  extern __shared__ float smem[];
  const int ov = n_taps - 1;
  const int T = tile_rows(ov);
  float* hs_r = smem;
  float* hs_i = hs_r + n_taps;
  float* win_r = hs_i + n_taps;
  float* win_i = win_r + (ov + T) * kCB;
  const Smem sm(win_i + (ov + T) * kCB, a.per, a.L, T);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCB;          // first planar channel
  const long plane = (long)(c0 / n2) * nf;  // k1 · nf
  const int col0 = c0 % n2;
  const long C = a.C;

  for (int k = tid; k < n_taps; k += kThreads) {
    hs_r[k] = h_re[k];
    hs_i[k] = kCplx ? h_im[k] : 0.f;
  }
  for (int i = tid; i < ov * kCB; i += kThreads) {
    const int row = i / kCB, c = i % kCB;
    float hr = head_re[(long)row * C + c0 + c];
    float hi = head_im[(long)row * C + c0 + c];
    win_r[i] = fir_bf16 ? bf16_round(hr) : hr;
    win_i[i] = fir_bf16 ? bf16_round(hi) : hi;
  }
  Serial s;
  tail_init(a, sm, s, c0);

  int tlen_prev = 0;
  for (int t0 = 0; t0 < nf; t0 += T) {
    const int tlen = min(T, nf - t0);
    if (t0 > 0) {
      // this tile's FIR history = the previous tile's last ov input rows
      for (int i = tid; i < ov * kCB; i += kThreads) {
        win_r[i] = win_r[i + tlen_prev * kCB];
        win_i[i] = win_i[i + tlen_prev * kCB];
      }
      shift_history(a, sm, tlen_prev);
      __syncthreads();
    }
    for (int i = tid; i < tlen * kCB; i += kThreads) {
      const int row = i / kCB, c = i % kCB;
      const long idx = (plane + t0 + row) * n2 + col0 + c;
      float xr = load_x<kXBf16>(x_re, idx);
      float xi = load_x<kXBf16>(x_im, idx);
      win_r[ov * kCB + i] = fir_bf16 ? bf16_round(xr) : xr;
      win_i[ov * kCB + i] = fir_bf16 ? bf16_round(xi) : xi;
    }
    __syncthreads();

    // ---- passband FIR: y[t] = Σ_k h[k]·win[ov + t − k]
    {
      const int c = tid % kCB;
      const int lane = tid / kCB;
      for (int base = lane * kRT; base < tlen; base += kLanes * kRT) {
        float ar[kRT], ai[kRT], xr[kRT], xi[kRT];
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          ar[i] = ai[i] = 0.f;
          xr[i] = win_r[(ov + base + i) * kCB + c];
          xi[i] = win_i[(ov + base + i) * kCB + c];
        }
        for (int k = 0; k < n_taps; ++k) {
          const float hr = hs_r[k];
          const float hi = hs_i[k];
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            if (kCplx) {
              ar[i] += hr * xr[i] - hi * xi[i];
              ai[i] += hr * xi[i] + hi * xr[i];
            } else {
              ar[i] += hr * xr[i];
              ai[i] += hr * xi[i];
            }
          }
#pragma unroll
          for (int i = kRT - 1; i > 0; --i) {
            xr[i] = xr[i - 1];
            xi[i] = xi[i - 1];
          }
          if (k + 1 < n_taps) {
            xr[0] = win_r[(ov + base - k - 1) * kCB + c];
            xi[0] = win_i[(ov + base - k - 1) * kCB + c];
          }
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          if (base + i < tlen) {
            sm.ys_r[(base + i) * kCB + c] = ar[i];
            sm.ys_i[(base + i) * kCB + c] = ai[i];
            s.pw += ar[i] * ar[i] + ai[i] * ai[i];
          }
        }
      }
    }
    __syncthreads();
    tail_tile<kDemod, kHang>(a, sm, s, c0, t0, tlen);
    tlen_prev = tlen;
    __syncthreads();
  }
  tail_finish(a, sm, s, c0, tlen_prev, 1);
}

template <int kDemod, bool kHang>
__global__ void __launch_bounds__(kThreads)
chain_tail_am_kernel(const float* __restrict__ y_re,
                     const float* __restrict__ y_im, long y_st, long y_sc,
                     int y_tfast, int nf, int accum_pow, TailArgs a) {
  extern __shared__ float smem[];
  const Smem sm(smem, a.per, a.L, kTile);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCB;
  Serial s;
  tail_init(a, sm, s, c0);

  int tlen_prev = 0;
  for (int t0 = 0; t0 < nf; t0 += kTile) {
    const int tlen = min(kTile, nf - t0);
    if (t0 > 0) {
      shift_history(a, sm, tlen_prev);
      __syncthreads();
    }
    // the tile of y, read along whichever axis is contiguous
    for (int i = tid; i < tlen * kCB; i += kThreads) {
      const int c = y_tfast ? i / tlen : i % kCB;
      const int row = y_tfast ? i % tlen : i / kCB;
      float yr = 0.f, yi = 0.f;
      if (c0 + c < a.C) {
        const long idx = (long)(t0 + row) * y_st + (long)(c0 + c) * y_sc;
        yr = y_re[idx];
        yi = y_im[idx];
      }
      sm.ys_r[row * kCB + c] = yr;
      sm.ys_i[row * kCB + c] = yi;
    }
    __syncthreads();
    if (accum_pow) {  // thread tid sums channel tid % kCB
      for (int i = tid; i < tlen * kCB; i += kThreads)
        s.pw += sm.ys_r[i] * sm.ys_r[i] + sm.ys_i[i] * sm.ys_i[i];
    }
    tail_tile<kDemod, kHang>(a, sm, s, c0, t0, tlen);
    tlen_prev = tlen;
    __syncthreads();
  }
  tail_finish(a, sm, s, c0, tlen_prev, accum_pow);
}

template <bool kXBf16, bool kCplx, int kDemod>
cudaError_t launch_fir(const void* x_re, const void* x_im, int n1, int nf,
                       int n2, const float* head_re, const float* head_im,
                       const float* h_re, const float* h_im, int n_taps,
                       int fir_bf16, const TailArgs& a, cudaStream_t stream) {
  const int T = tile_rows(n_taps - 1);
  const size_t fir = 2 * (size_t)n_taps + 2 * (size_t)(n_taps - 1 + T) * kCB;
  const size_t smem =
      (fir + common_floats(a.per, a.L, T, a.hang_tiles)) * sizeof(float);
  auto kern = chain_tail_fir_kernel<kXBf16, kCplx, kDemod, false>;
  if (a.hang_tiles)
    kern = chain_tail_fir_kernel<kXBf16, kCplx, kDemod, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<n1 * n2 / kCB, kThreads, smem, stream>>>(
      x_re, x_im, nf, n2, head_re, head_im, h_re, h_im, n_taps, fir_bf16, a);
  return cudaGetLastError();
}

template <bool kXBf16, bool kCplx>
cudaError_t fir_by_demod(int demod, const void* x_re, const void* x_im,
                         int n1, int nf, int n2, const float* head_re,
                         const float* head_im, const float* h_re,
                         const float* h_im, int n_taps, int fir_bf16,
                         const TailArgs& a, cudaStream_t s) {
  switch (demod) {
    case kAM:
      return launch_fir<kXBf16, kCplx, kAM>(x_re, x_im, n1, nf, n2, head_re,
                                            head_im, h_re, h_im, n_taps,
                                            fir_bf16, a, s);
    case kSSB:
      return launch_fir<kXBf16, kCplx, kSSB>(x_re, x_im, n1, nf, n2, head_re,
                                             head_im, h_re, h_im, n_taps,
                                             fir_bf16, a, s);
    case kNBFM:
      return launch_fir<kXBf16, kCplx, kNBFM>(x_re, x_im, n1, nf, n2,
                                              head_re, head_im, h_re, h_im,
                                              n_taps, fir_bf16, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int kDemod>
cudaError_t launch_am(const float* y_re, const float* y_im, long y_st,
                      long y_sc, int nf, int accum_pow, const TailArgs& a,
                      cudaStream_t stream) {
  const size_t smem =
      common_floats(a.per, a.L, kTile, a.hang_tiles) * sizeof(float);
  auto kern = chain_tail_am_kernel<kDemod, false>;
  if (a.hang_tiles) kern = chain_tail_am_kernel<kDemod, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(a.C + kCB - 1) / kCB, kThreads, smem, stream>>>(
      y_re, y_im, y_st, y_sc, y_st < y_sc ? 1 : 0, nf, accum_pow, a);
  return cudaGetLastError();
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
// [n_taps] (h_im read only when fir_complex); P: [per, L]; params: [9] =
// r_dc | nbfm scale, decay/sample, thresh, slope, target, man_gain, agc_on,
// attack, hang_on; st_in/st_out: [4 + per, C] state rows (dc_x | prev re,
// dc_y | prev im, peak, gain, per−1 resample tail rows, power — ignored on
// input); audio: [nf·L, C] f32; seg: the reference's tail tile (peak
// segment and hang tile), a divisor of nf; hang_tiles: ring length, 0 = no
// hang.
int chain_tail_fir(const void* x_re, const void* x_im, int x_bf16, int n1,
                   int nf, int n2, const float* head_re, const float* head_im,
                   const float* h_re, const float* h_im, int n_taps,
                   int fir_complex, int fir_bf16, const float* P, int per,
                   int L, int rs_bf16, const float* params, int demod,
                   int seg, int hang_tiles, const float* st_in, float* st_out,
                   float* audio, void* stream) {
  const TailArgs a{P, per, L, rs_bf16, params, seg, hang_tiles, st_in,
                   st_out, n1 * n2, audio, (long)n1 * n2, 1L, 0};
  if (n2 % kCB || n_taps < 2 || !tail_args_ok(a, nf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && fir_complex)
    return (int)fir_by_demod<true, true>(demod, x_re, x_im, n1, nf, n2,
                                         head_re, head_im, h_re, h_im, n_taps,
                                         fir_bf16, a, s);
  if (x_bf16)
    return (int)fir_by_demod<true, false>(demod, x_re, x_im, n1, nf, n2,
                                          head_re, head_im, h_re, h_im,
                                          n_taps, fir_bf16, a, s);
  if (fir_complex)
    return (int)fir_by_demod<false, true>(demod, x_re, x_im, n1, nf, n2,
                                          head_re, head_im, h_re, h_im,
                                          n_taps, fir_bf16, a, s);
  return (int)fir_by_demod<false, false>(demod, x_re, x_im, n1, nf, n2,
                                         head_re, head_im, h_re, h_im, n_taps,
                                         fir_bf16, a, s);
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
                   C, audio, a_st, a_sc, a_st < a_sc ? 1 : 0};
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
