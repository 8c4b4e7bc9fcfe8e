// FIR-fused chain tail for Hopper (sm_90a): passband FIR → RSSI → demod →
// DC block → AGC → ×L polyphase resample, per channel, in one launch.
//
// Replaces: supersdr_tpu/ops/pallas/chain_tail.py::_kernel_fir with
// _tail_core (and its _atan2, _doubling_linear, _doubling_max helpers), as
// called by chain.process_tail_tmajor(fir_x3=…) on the planar wideband path.
//
// What it computes, per planar channel c = k1·n2 + col (read from the
// channelizer's raw planes x[k1, :, col]), with the history of the last
// n_taps−1 inputs carried in through `head`:
//   y[n]   = Σ_k h[k]·x[n−k]                         (real or complex taps)
//   pw     = Σ_n |y[n]|²                             (RSSI power row)
//   a[n]   = AM: |y[n]| − |y[n−1]| + r·a[n−1]  SSB/CW: Re y[n]
//            NBFM: angle(y[n]·conj(y[n−1]))·fs/(2π·max_dev), 0 below 1e-12
//   p[n]   = max(p[n−1] − d, 20·log10(max(|a[n]|, 1e-9)))    peak tracker
//   g[n]   = α·g[n−1] + (1−α)·gain(p[n])                      kneed law
//   out[n·L + q] = Σ_m P[m, q]·s[n+m],  s = [per−1 carried | a·10^(g/20)]
// and the carried state rows (DC/previous sample, peak, gain, resample
// tail, power). The recurrences run sequentially in time; the reference
// evaluates them with in-tile doubling scans, which round differently (a
// few ulp; see the plain version and the tests' tolerance). The peak
// tracker keeps the reference's form over segments of `seg` samples (its
// tile): p[j] = max(max_{i≤j}(e[i] + i·d), p_prev − d) − j·d, so the decay
// is one rounded offset a segment. Subtracting d once a sample instead
// drifts: over a 16128-sample chunk the f32 roundings of p − d add up, and
// on an H100 the audio then agreed with the plain version to 70 dB instead
// of 112 dB.
//
// What bounds it on this card: the passband FIR, n_taps complex×real MACs a
// sample (4·n_taps FLOP real taps, 8·n_taps complex) — about 42 GFLOP a
// chunk at the 2560-channel headline against 165–330 MB of input and
// 660 MB of audio written — and the three recurrences, which are
// sequential per channel: 16128 dependent steps a chunk.
//
// Design: a block owns 8 channels and walks time in tiles of T ≥ n_taps−1
// samples. Each tile's input rows (plus the n_taps−1 history rows carried in
// shared memory from the previous tile, or from `head` on the first) sit in
// shared memory; all 256 threads compute the FIR for the tile (8 outputs a
// thread with a sliding register window: one shared load a tap per plane),
// so y never reaches device memory. What needs no carried state runs on
// all threads: the demod's sqrt or atan2, the envelope's log, the gain's
// exp and the resampler, which writes audio coalesced across the 8
// channels. Only the recurrences' cheap arithmetic (DC block; peak, gain
// law and attack) runs one thread a channel. No block carries anything to
// another. The serial loops keep only 8 threads a block busy (320 blocks at
// 2560 channels); a time-segmented scan (DC and attack are linear
// recurrences, the peak tracker is max-plus, all associative) is the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 8;                     // channels per block
constexpr int kLanes = kThreads / kCB;     // time lanes in the FIR phase
constexpr int kRT = 8;                     // FIR outputs per thread per pass
constexpr int kTile = kLanes * kRT;        // 256 samples: the tile unit

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

__host__ __device__ inline size_t smem_floats(int n_taps, int per, int L,
                                              int T) {
  const int ov = n_taps - 1;
  return 2 * (size_t)n_taps + (size_t)per * L + 2 * (size_t)(ov + T) * kCB +
         2 * (size_t)T * kCB + (size_t)(per - 1 + T) * kCB + 2 * kCB;
}

template <bool kXBf16, bool kCplx, int kDemod>
__global__ void __launch_bounds__(kThreads)
chain_tail_kernel(const void* __restrict__ x_re, const void* __restrict__ x_im,
                  int nf, int n2, const float* __restrict__ head_re,
                  const float* __restrict__ head_im,
                  const float* __restrict__ h_re,
                  const float* __restrict__ h_im, int n_taps, int fir_bf16,
                  const float* __restrict__ P, int per, int L, int rs_bf16,
                  const float* __restrict__ params, int seg,
                  const float* __restrict__ st_in, float* __restrict__ st_out,
                  float* __restrict__ audio, int C) {
  extern __shared__ float smem[];
  const int ov = n_taps - 1;
  const int T = tile_rows(ov);
  float* hs_r = smem;
  float* hs_i = hs_r + n_taps;
  float* ps = hs_i + n_taps;
  float* win_r = ps + per * L;
  float* win_i = win_r + (ov + T) * kCB;
  float* ys_r = win_i + (ov + T) * kCB;  // [T][kCB] y.re, then env dB
  float* ys_i = ys_r + T * kCB;          // [T][kCB] y.im, then gain dB
  float* a1 = ys_i + T * kCB;  // [per−1 + T][kCB]: resample segment
  float* u = a1 + (per - 1) * kCB;       // the tile's rows of a1
  float* pv = a1 + (per - 1 + T) * kCB;  // [2][kCB] NBFM previous sample

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCB;          // first planar channel
  const long plane = (long)(c0 / n2) * nf;  // k1 · nf
  const int col0 = c0 % n2;

  for (int k = tid; k < n_taps; k += kThreads) {
    hs_r[k] = h_re[k];
    hs_i[k] = kCplx ? h_im[k] : 0.f;
  }
  for (int k = tid; k < per * L; k += kThreads) ps[k] = P[k];
  for (int i = tid; i < ov * kCB; i += kThreads) {
    const int row = i / kCB, c = i % kCB;
    float hr = head_re[(long)row * C + c0 + c];
    float hi = head_im[(long)row * C + c0 + c];
    win_r[i] = fir_bf16 ? bf16_round(hr) : hr;
    win_i[i] = fir_bf16 ? bf16_round(hi) : hi;
  }

  // serial-phase state (threads tid < kCB, channel c0 + tid)
  const float r_dc = params[0], d = params[1], thresh = params[2];
  const float slope = params[3], target = params[4], man_gain = params[5];
  const float agc_on = params[6], attack = params[7];
  const int sc = c0 + tid;
  float s0 = 0.f, s1 = 0.f, peak = 0.f, g = 0.f;
  float pbase = 0.f, cm = 0.f;  // peak segment: p_prev − d, running max
  int j = 0;                    // sample index within the segment
  float pw = 0.f;               // this thread's share of Σ|y|² (all threads)
  if (tid < kCB) {
    s0 = st_in[sc];
    s1 = st_in[(long)C + sc];
    peak = st_in[2L * C + sc];
    g = st_in[3L * C + sc];
    for (int m = 0; m < per - 1; ++m)
      a1[m * kCB + tid] = st_in[(long)(4 + m) * C + sc];
    pv[tid] = s0;
    pv[kCB + tid] = s1;
  }

  int tlen_prev = 0;
  for (int t0 = 0; t0 < nf; t0 += T) {
    const int tlen = min(T, nf - t0);
    if (t0 > 0) {
      // history of this tile = the previous tile's last ov input rows and
      // last per−1 audio rows (disjoint moves: tlen_prev = T > per − 1)
      for (int i = tid; i < ov * kCB; i += kThreads) {
        win_r[i] = win_r[i + tlen_prev * kCB];
        win_i[i] = win_i[i + tlen_prev * kCB];
      }
      for (int i = tid; i < (per - 1) * kCB; i += kThreads)
        a1[i] = a1[i + tlen_prev * kCB];
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
            ys_r[(base + i) * kCB + c] = ar[i];
            ys_i[(base + i) * kCB + c] = ai[i];
            pw += ar[i] * ar[i] + ai[i] * ai[i];
          }
        }
      }
    }
    __syncthreads();

    // The transcendental steps run on all threads; the two serial loops
    // (one thread a channel) carry only the recurrences' cheap arithmetic.
    // ---- demod: AM envelope, SSB real part, NBFM discriminator
    for (int i = tid; i < tlen * kCB; i += kThreads) {
      const float yr = ys_r[i], yi = ys_i[i];
      if (kDemod == kAM) {
        u[i] = sqrtf(yr * yr + yi * yi);
      } else if (kDemod == kNBFM) {
        const int c = i % kCB;
        const float qr = i >= kCB ? ys_r[i - kCB] : pv[c];
        const float qi = i >= kCB ? ys_i[i - kCB] : pv[kCB + c];
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
          const float a0 = (env - s0) + r_dc * s1;
          s0 = env;
          s1 = a0;
          u[t * kCB + tid] = a0;
        }
      } else if (kDemod == kNBFM) {
        s0 = ys_r[(tlen - 1) * kCB + tid];
        s1 = ys_i[(tlen - 1) * kCB + tid];
        pv[tid] = s0;
        pv[kCB + tid] = s1;
      }
    }
    __syncthreads();

    // ---- AGC: envelope in dB, then peak tracker, gain law and attack
    for (int i = tid; i < tlen * kCB; i += kThreads)
      ys_r[i] = 8.685889638065035f * logf(fmaxf(fabsf(u[i]), 1e-9f));
    __syncthreads();
    if (tid < kCB) {
      const float max_gain = target - thresh;
      const float knee = fmaxf(-thresh, 1e-6f);
      for (int t = 0; t < tlen; ++t) {
        const float env_db = ys_r[t * kCB + tid];
        const bool start = j == 0;
        pbase = start ? peak - d : pbase;
        cm = start ? -3.0e38f : cm;
        const float jd = (float)j * d;
        cm = fmaxf(cm, env_db + jd);
        peak = fmaxf(cm, pbase) - jd;
        j = j + 1 == seg ? 0 : j + 1;
        float gain_db;
        if (agc_on > 0.f) {
          const float above =
              (target - peak) + slope * ((peak - thresh) / knee);
          gain_db = peak <= thresh ? max_gain : above;
        } else {
          gain_db = man_gain - 50.f;
        }
        g = attack * g + (1.f - attack) * gain_db;
        ys_i[t * kCB + tid] = g;
      }
    }
    __syncthreads();
    for (int i = tid; i < tlen * kCB; i += kThreads)
      u[i] *= expf(0.11512925464970229f * ys_i[i]);
    __syncthreads();

    // ---- ×L polyphase resample of the tile, coalesced across channels
    for (int i = tid; i < tlen * L * kCB; i += kThreads) {
      const int c = i % kCB;
      const int o = i / kCB;
      const int n = o / L, q = o % L;
      float acc = 0.f;
      for (int m = 0; m < per; ++m) {
        float pm = ps[m * L + q];
        float s = a1[(n + m) * kCB + c];
        if (rs_bf16) {
          pm = bf16_round(pm);
          s = bf16_round(s);
        }
        acc += pm * s;
      }
      audio[((long)t0 * L + o) * C + c0 + c] = acc;
    }
    tlen_prev = tlen;
    __syncthreads();
  }

  // ---- Σ|y|² a channel from the threads' shares (FIR thread tid holds
  // channel tid % kCB)
  ys_r[tid] = pw;
  __syncthreads();
  if (tid < kCB) {
    float sum = 0.f;
    for (int l = 0; l < kLanes; ++l) sum += ys_r[l * kCB + tid];
    st_out[sc] = s0;
    st_out[(long)C + sc] = s1;
    st_out[2L * C + sc] = peak;
    st_out[3L * C + sc] = g;
    for (int m = 0; m < per - 1; ++m)
      st_out[(long)(4 + m) * C + sc] = a1[(tlen_prev + m) * kCB + tid];
    st_out[(long)(4 + per - 1) * C + sc] = sum;
  }
}

template <bool kXBf16, bool kCplx, int kDemod>
cudaError_t launch(const void* x_re, const void* x_im, int n1, int nf, int n2,
                   const float* head_re, const float* head_im,
                   const float* h_re, const float* h_im, int n_taps,
                   int fir_bf16, const float* P, int per, int L, int rs_bf16,
                   const float* params, int seg, const float* st_in,
                   float* st_out, float* audio, cudaStream_t stream) {
  const int C = n1 * n2;
  const size_t smem =
      smem_floats(n_taps, per, L, tile_rows(n_taps - 1)) * sizeof(float);
  auto kern = chain_tail_kernel<kXBf16, kCplx, kDemod>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<C / kCB, kThreads, smem, stream>>>(
      x_re, x_im, nf, n2, head_re, head_im, h_re, h_im, n_taps, fir_bf16, P,
      per, L, rs_bf16, params, seg, st_in, st_out, audio, C);
  return cudaGetLastError();
}

template <bool kXBf16, bool kCplx>
cudaError_t by_demod(int demod, const void* x_re, const void* x_im, int n1,
                     int nf, int n2, const float* head_re,
                     const float* head_im, const float* h_re,
                     const float* h_im, int n_taps, int fir_bf16,
                     const float* P, int per, int L, int rs_bf16,
                     const float* params, int seg, const float* st_in,
                     float* st_out, float* audio, cudaStream_t s) {
  switch (demod) {
    case kAM:
      return launch<kXBf16, kCplx, kAM>(x_re, x_im, n1, nf, n2, head_re,
                                        head_im, h_re, h_im, n_taps, fir_bf16,
                                        P, per, L, rs_bf16, params, seg, st_in,
                                        st_out, audio, s);
    case kSSB:
      return launch<kXBf16, kCplx, kSSB>(x_re, x_im, n1, nf, n2, head_re,
                                         head_im, h_re, h_im, n_taps,
                                         fir_bf16, P, per, L, rs_bf16, params,
                                         seg, st_in, st_out, audio, s);
    case kNBFM:
      return launch<kXBf16, kCplx, kNBFM>(x_re, x_im, n1, nf, n2, head_re,
                                          head_im, h_re, h_im, n_taps,
                                          fir_bf16, P, per, L, rs_bf16,
                                          params, seg, st_in, st_out, audio,
                                          s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Channels a block owns: the wrapper checks n2 against it.
int chain_tail_channels_per_block() { return kCB; }

// x_*: raw channelizer planes [n1, nf, n2], f32 (x_bf16 = 0) or bf16;
// head_*: [n_taps−1, C] input history, planar channel order; h_*: taps
// [n_taps] (h_im read only when fir_complex); P: [per, L];
// params: [8] = r_dc | nbfm scale, decay/sample, thresh, slope, target,
// man_gain, agc_on, attack; st_in/st_out: [4 + per, C] state rows
// (dc_x | prev re, dc_y | prev im, peak, gain, per−1 resample tail rows,
// power — ignored on input); audio: [nf·L, C] f32; seg: the peak
// tracker's segment (the reference's tail tile), a divisor of nf.
int chain_tail_fir(const void* x_re, const void* x_im, int x_bf16, int n1,
                   int nf, int n2, const float* head_re, const float* head_im,
                   const float* h_re, const float* h_im, int n_taps,
                   int fir_complex, int fir_bf16, const float* P, int per,
                   int L, int rs_bf16, const float* params, int demod,
                   int seg, const float* st_in, float* st_out, float* audio,
                   void* stream) {
  if (n2 % kCB || n_taps < 2 || per < 2 || L < 1 || nf < 1 || seg < 1 ||
      nf % seg)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && fir_complex)
    return (int)by_demod<true, true>(demod, x_re, x_im, n1, nf, n2, head_re,
                                     head_im, h_re, h_im, n_taps, fir_bf16, P,
                                     per, L, rs_bf16, params, seg, st_in,
                                     st_out, audio, s);
  if (x_bf16)
    return (int)by_demod<true, false>(demod, x_re, x_im, n1, nf, n2, head_re,
                                      head_im, h_re, h_im, n_taps, fir_bf16,
                                      P, per, L, rs_bf16, params, seg, st_in,
                                      st_out, audio, s);
  if (fir_complex)
    return (int)by_demod<false, true>(demod, x_re, x_im, n1, nf, n2, head_re,
                                      head_im, h_re, h_im, n_taps, fir_bf16,
                                      P, per, L, rs_bf16, params, seg, st_in,
                                      st_out, audio, s);
  return (int)by_demod<false, false>(demod, x_re, x_im, n1, nf, n2, head_re,
                                     head_im, h_re, h_im, n_taps, fir_bf16, P,
                                     per, L, rs_bf16, params, seg, st_in,
                                     st_out, audio, s);
}

}  // extern "C"
