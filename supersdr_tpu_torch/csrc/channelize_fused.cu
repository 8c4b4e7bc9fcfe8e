// Fused polyphase channelizer for Hopper (sm_90a): K-tap fold, DIF stage A
// and the stage-B DFT in one launch.
//
// Replaces: supersdr_tpu/ops/pallas/channelize_fused.py::_kernel, as called
// by channelize_fused_c(out_layout="raw3") on the planar wideband path.
//
// What it computes (M = n1·n2 channels, K taps a branch, nf frames):
//   seg   = [K−1 carry rows (head) | x rows]                    [K−1+nf, M]
//   fold[t, r]     = Σ_k g2[k, r]·seg[t+k, r]
//   Y[k1, t, j2]   = Σ_j1 At[j1·n1+k1, j2]·fold[t, j1·n2+j2]   (twiddle folded)
//   out[k1, t, k2] = Σ_j2 Y[k1, t, j2]·C2[j2, k2]               (complex)
// The output is the reference's raw planar layout [n1, nf, n2] (planar
// channel k1·n2 + k2 is PFB bin k2·n1 + k1), or its out_layout="time",
// [nf, M] with bin k2·n1 + k1 in column order (the wideband time-major tier
// off the planar coupling), whose stores are n1 elements apart across a
// warp: a first, uncoalesced version. The layout is a template parameter:
// output strides passed as kernel arguments slowed the float32 tier ~5 % at
// the headline shape on an H100. int16 input is dequantized
// ×in_scale on load; the bf16 tier rounds stage B's operands to bf16
// (Y here, C2 in the host table) and accumulates in f32.
//
// What bounds it on this card: stage B. Per frame it is an [n1, n2]×[n2, n2]
// complex product, 4·M·n2 real MACs against 8·M input bytes (f32) — at the
// 2560-channel headline about 85 GFLOP a chunk for 330 MB read, well above
// the HBM/FP32 balance point, so the kernel is compute bound on the CUDA
// cores' FP32 FMAs (this first version does not use the tensor cores).
//
// Design: one block owns T consecutive frames (T = 8 at 2560 channels) and
// keeps the whole stage-A output Y[n1·T, n2] in shared memory, so neither
// the fold nor Y touches device memory. Phase 1: thread j2 folds column
// j1·n2+j2 for its T frames (coalesced across j2) and accumulates the n1
// stage-A outputs it feeds into Y. Every block reads its own K−1 history
// rows (from the head for the first frames), so blocks are independent and
// run in any order; frames past nf are masked. A column's T+K−1 segment
// rows are loaded into registers at once, so their global-load latencies
// overlap (taps_per ≤ 8; the wrapper refuses more). Phase 2: stage B as a
// register-tiled product: each thread owns one output column and up to 40
// rows, reads each C2 element once (coalesced, L2-resident, prefetched one
// step ahead) and broadcasts 2 rows of Y per 16-byte shared load, so one
// C2 load feeds 160 FMAs. Y is stored [j2][row] with a row stride ≡ 2
// (mod 16) to keep phase 1's column writes at a 2-way bank conflict.
// Tensor-core stage B (mma.sync / wgmma) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTx = 128;             // phase-2 output columns per pass
constexpr int kRT = 8;               // phase-2 rows per thread
constexpr int kRowChunk = 2 * kRT;   // rows per chunk (2 row groups)
constexpr int kMaxChunks = 5;       // chunks a thread holds in registers
constexpr int kKMax = 8;            // most fold taps a branch (registers)
constexpr int kSmemBudget = 200 * 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kI16>
__device__ __forceinline__ float load_x(const void* p, long idx, float s) {
  if (kI16) return float(static_cast<const int16_t*>(p)[idx]) * s;
  return static_cast<const float*>(p)[idx];
}

__host__ __device__ __forceinline__ int rows_padded(int n1, int T) {
  return (n1 * T + kRowChunk - 1) / kRowChunk * kRowChunk;
}

template <int T, bool kI16, bool kOutBf16, bool kTime>
__global__ void __launch_bounds__(kThreads)
channelize_kernel(const void* __restrict__ x_re, const void* __restrict__ x_im,
                  float in_scale, const float* __restrict__ head_re,
                  const float* __restrict__ head_im,
                  const float* __restrict__ g2, const float* __restrict__ at_r,
                  const float* __restrict__ at_i,
                  const float2* __restrict__ c2, void* out_r, void* out_i,
                  int nf, int M, int K, int n1, int n2, int bf16_b) {
  extern __shared__ float4 smem_f4[];
  float2* ys = reinterpret_cast<float2*>(smem_f4);
  const int t0 = blockIdx.x * T;
  const int R = n1 * T;
  const int Rpad = rows_padded(n1, T);
  const int Rs = Rpad + 2;  // row stride of ys (complex elements)
  const int tid = threadIdx.x;

  for (int i = tid; i < n2 * Rs; i += kThreads) ys[i] = make_float2(0.f, 0.f);
  __syncthreads();

  // ---- phase 1: fold + stage A into ys[j2][k1·T + t]
  const int hk = K - 1;
  // virtual segment row v of column r: carry head, input, or 0 past nf
  auto seg = [&](int v, int r, float& xr, float& xi) {
    xr = xi = 0.f;
    if (v < hk) {
      xr = head_re[(long)v * M + r];
      xi = head_im[(long)v * M + r];
    } else if (v - hk < nf) {
      const long idx = (long)(v - hk) * M + r;
      xr = load_x<kI16>(x_re, idx, in_scale);
      xi = load_x<kI16>(x_im, idx, in_scale);
    }
  };
  for (int j2 = tid; j2 < n2; j2 += kThreads) {
    float2* ycol = ys + (long)j2 * Rs;
    for (int j1 = 0; j1 < n1; ++j1) {
      const int r = j1 * n2 + j2;
      float fr[T], fi[T];
#pragma unroll
      for (int t = 0; t < T; ++t) fr[t] = fi[t] = 0.f;
      // all T+K−1 rows of the column in flight at once, then the fold
      float sr[T + kKMax - 1], si[T + kKMax - 1];
#pragma unroll
      for (int v = 0; v < T + kKMax - 1; ++v) {
        sr[v] = si[v] = 0.f;
        if (v < T + hk) seg(t0 + v, r, sr[v], si[v]);
      }
#pragma unroll
      for (int k = 0; k < kKMax; ++k) {
        if (k < K) {
          const float g = g2[(long)k * M + r];
#pragma unroll
          for (int t = 0; t < T; ++t) {
            fr[t] += g * sr[t + k];
            fi[t] += g * si[t + k];
          }
        }
      }
      for (int k1 = 0; k1 < n1; ++k1) {
        const long a = (long)(j1 * n1 + k1) * n2 + j2;
        const float ar = at_r[a], ai = at_i[a];
        float4* yp = reinterpret_cast<float4*>(ycol + k1 * T);
#pragma unroll
        for (int q = 0; q < T / 2; ++q) {
          float4 y = yp[q];
          y.x += ar * fr[2 * q] - ai * fi[2 * q];
          y.y += ar * fi[2 * q] + ai * fr[2 * q];
          y.z += ar * fr[2 * q + 1] - ai * fi[2 * q + 1];
          y.w += ar * fi[2 * q + 1] + ai * fr[2 * q + 1];
          yp[q] = y;
        }
      }
    }
  }
  __syncthreads();
  if (bf16_b) {
    for (int i = tid; i < n2 * Rs; i += kThreads) {
      float2 v = ys[i];
      ys[i] = make_float2(bf16_round(v.x), bf16_round(v.y));
    }
    __syncthreads();
  }

  // ---- phase 2: out[row, k2] = Σ_j2 ys[j2][row]·c2[j2][k2]. A thread
  // owns one column and up to kMaxChunks 8-row chunks (rows s0 + q·16 +
  // ty·8 + i), so each C2 element is read once per pass and feeds up to
  // 40 complex MACs; the next j2's C2 element is loaded ahead.
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  for (int cb = 0; cb < n2; cb += kTx) {
    const int col = cb + tx;
    for (int s0 = 0; s0 < Rpad; s0 += kMaxChunks * kRowChunk) {
      const int nq = min(kMaxChunks, (Rpad - s0) / kRowChunk);
      float2 acc[kMaxChunks][kRT];
#pragma unroll
      for (int q = 0; q < kMaxChunks; ++q)
#pragma unroll
        for (int i = 0; i < kRT; ++i) acc[q][i] = make_float2(0.f, 0.f);
      const float2* ybase = ys + s0 + ty * kRT;
      float2 c = __ldg(c2 + col);
      for (int j2 = 0; j2 < n2; ++j2) {
        const float2 cn =
            j2 + 1 < n2 ? __ldg(c2 + (long)(j2 + 1) * n2 + col) : c;
        const float2* yb = ybase + (long)j2 * Rs;
#pragma unroll
        for (int q = 0; q < kMaxChunks; ++q) {
          if (q < nq) {
            const float4* yp =
                reinterpret_cast<const float4*>(yb + q * kRowChunk);
#pragma unroll
            for (int h = 0; h < kRT / 2; ++h) {
              const float4 y = yp[h];
              acc[q][2 * h].x += y.x * c.x - y.y * c.y;
              acc[q][2 * h].y += y.x * c.y + y.y * c.x;
              acc[q][2 * h + 1].x += y.z * c.x - y.w * c.y;
              acc[q][2 * h + 1].y += y.z * c.y + y.w * c.x;
            }
          }
        }
        c = cn;
      }
#pragma unroll
      for (int q = 0; q < kMaxChunks; ++q) {
        if (q >= nq) continue;
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const int row = s0 + q * kRowChunk + ty * kRT + i;
          if (row >= R) continue;
          const int k1 = row / T;
          const int tg = t0 + row % T;
          if (tg >= nf) continue;
          // raw planes [n1, nf, n2], or time-major [nf, M] at bin k2·n1 + k1
          const long o = kTime ? (long)tg * M + (long)col * n1 + k1
                               : ((long)k1 * nf + tg) * n2 + col;
          if (kOutBf16) {
            static_cast<__nv_bfloat16*>(out_r)[o] =
                __float2bfloat16_rn(acc[q][i].x);
            static_cast<__nv_bfloat16*>(out_i)[o] =
                __float2bfloat16_rn(acc[q][i].y);
          } else {
            static_cast<float*>(out_r)[o] = acc[q][i].x;
            static_cast<float*>(out_i)[o] = acc[q][i].y;
          }
        }
      }
    }
  }
}

template <int T, bool kI16, bool kOutBf16, bool kTime>
cudaError_t launch(const void* x_re, const void* x_im, float in_scale,
                   const float* head_re, const float* head_im, const float* g2,
                   const float* at_r, const float* at_i, const float2* c2,
                   void* out_r, void* out_i, int nf, int M, int K, int n1,
                   int n2, int bf16_b, cudaStream_t stream) {
  const size_t smem = (size_t)n2 * (rows_padded(n1, T) + 2) * sizeof(float2);
  auto kern = channelize_kernel<T, kI16, kOutBf16, kTime>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (nf + T - 1) / T;
  kern<<<blocks, kThreads, smem, stream>>>(x_re, x_im, in_scale, head_re,
                                           head_im, g2, at_r, at_i, c2, out_r,
                                           out_i, nf, M, K, n1, n2, bf16_b);
  return cudaGetLastError();
}

template <int T>
cudaError_t dispatch_io(int in_i16, int out_bf16, int out_time,
                        const void* x_re, const void* x_im, float in_scale,
                        const float* head_re, const float* head_im,
                        const float* g2, const float* at_r, const float* at_i,
                        const float2* c2, void* out_r, void* out_i, int nf,
                        int M, int K, int n1, int n2, int bf16_b,
                        cudaStream_t s) {
#define SSDR_LAUNCH(I16, BF16, TIME)                                        \
  return launch<T, I16, BF16, TIME>(x_re, x_im, in_scale, head_re, head_im, \
                                    g2, at_r, at_i, c2, out_r, out_i, nf, M, \
                                    K, n1, n2, bf16_b, s)
  if (out_time) {  // the time-major store writes float32
    if (in_i16) SSDR_LAUNCH(true, false, true);
    SSDR_LAUNCH(false, false, true);
  }
  if (in_i16 && out_bf16) SSDR_LAUNCH(true, true, false);
  if (in_i16) SSDR_LAUNCH(true, false, false);
  if (out_bf16) SSDR_LAUNCH(false, true, false);
  SSDR_LAUNCH(false, false, false);
#undef SSDR_LAUNCH
}

}  // namespace

extern "C" {

// Frames per block for a config (0: stage-A output does not fit in
// shared memory). The wrapper reads it to refuse such shapes up front.
int channelize_fused_tile(int n1, int n2) {
  for (int T = 8; T >= 2; T /= 2)
    if ((size_t)n2 * (rows_padded(n1, T) + 2) * sizeof(float2) <= kSmemBudget)
      return T;
  return 0;
}

// x_re/x_im: [nf, M] float32 (in_i16 = 0) or int16 (in_i16 = 1, ×in_scale);
// head_*: [K−1, M] f32 carry rows; g2: [K, M]; at_*: [n1·n1, n2];
// c2: [n2, n2] interleaved complex; out_*: the raw planes [n1, nf, n2], f32
// or bf16 (out_time = 0), or the time-major bin-ordered planes [nf, M], f32
// (out_time = 1: element (k1, t, k2) at t·M + k2·n1 + k1).
int channelize_fused_raw3(const void* x_re, const void* x_im, int in_i16,
                          float in_scale, const float* head_re,
                          const float* head_im, const float* g2,
                          const float* at_r, const float* at_i,
                          const float* c2, void* out_r, void* out_i,
                          int out_bf16, int nf, int M, int K, int n1, int n2,
                          int bf16_b, int out_time, void* stream) {
  if (n1 * n2 != M || n2 % kTx || K < 1 || K > kKMax || nf < 1 ||
      (out_time && out_bf16))
    return (int)cudaErrorInvalidValue;
  const int T = channelize_fused_tile(n1, n2);
  const float2* c2c = reinterpret_cast<const float2*>(c2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 8:
      return (int)dispatch_io<8>(in_i16, out_bf16, out_time, x_re, x_im,
                                 in_scale, head_re, head_im, g2, at_r, at_i,
                                 c2c, out_r, out_i, nf, M, K, n1, n2, bf16_b,
                                 s);
    case 4:
      return (int)dispatch_io<4>(in_i16, out_bf16, out_time, x_re, x_im,
                                 in_scale, head_re, head_im, g2, at_r, at_i,
                                 c2c, out_r, out_i, nf, M, K, n1, n2, bf16_b,
                                 s);
    case 2:
      return (int)dispatch_io<2>(in_i16, out_bf16, out_time, x_re, x_im,
                                 in_scale, head_re, head_im, g2, at_r, at_i,
                                 c2c, out_r, out_i, nf, M, K, n1, n2, bf16_b,
                                 s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
