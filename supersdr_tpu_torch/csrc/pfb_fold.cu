// Polyphase filterbank fold for Hopper (sm_90a):
//   fold[t, r] = Σ_k G[k, r]·rows[t + k, r],  rows = carry ‖ x as [nf+K−1, M]
// for a critically sampled PFB (hop = M), complex input as two float planes.
//
// Replaces: supersdr_tpu/ops/pallas/pfb_fold.py::_fold_kernel (pfb_fold_c,
// and through it channelize_pallas_c), which the wideband chan-major tier
// reaches with WidebandConfig.pallas_fold.
//
// What bounds it on this card: memory. A chunk reads two f32 planes and
// writes the complex64 fold, 8 bytes a sample each way (~330 MB each way at
// 2560 channels × 16128 frames, ~0.2 ms at 3.35 TB/s); the K multiply-adds a
// sample are nothing beside that.
//
// Design: a thread owns one column r and walks a run of kFrames frames with a
// K-deep sliding window of rows in registers, so each input row is read once
// per block plus the K−1 rows of overlap at the run's start; consecutive
// threads read consecutive columns (coalesced) and write consecutive float2.
// The first K−1 rows of the stream come straight from `carry`, so carry ‖ x
// is never concatenated (nor padded to DMA windows, as the TPU kernel must)
// in device memory; the ragged last run of frames and columns past M are
// masked. The output is interleaved complex64, ready for torch.fft. Products
// and sums are rounded separately (no fused multiply-add), in the plain
// version's order, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // columns a block
constexpr int kFrames = 128;    // frames a block
constexpr int kKMax = 8;        // taps a branch held in registers

template <int K>
__global__ void __launch_bounds__(kThreads)
pfb_fold_kernel(const float* __restrict__ G, const float* __restrict__ c_re,
                const float* __restrict__ c_im,
                const float* __restrict__ x_re,
                const float* __restrict__ x_im, float2* __restrict__ out,
                int nf, int M) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= M) return;
  const int t0 = blockIdx.y * kFrames;
  const int t1 = min(t0 + kFrames, nf);
  float g[K], wr[K], wi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) g[k] = G[(long)k * M + r];
  // row j of carry ‖ x: the carry's K−1 rows first
  auto load = [&](int j, float& vr, float& vi) {
    if (j < K - 1) {
      vr = c_re[(long)j * M + r];
      vi = c_im[(long)j * M + r];
    } else {
      const long idx = (long)(j - (K - 1)) * M + r;
      vr = x_re[idx];
      vi = x_im[idx];
    }
  };
#pragma unroll
  for (int k = 0; k < K - 1; ++k) load(t0 + k, wr[k], wi[k]);
  for (int t = t0; t < t1; ++t) {
    load(t + K - 1, wr[K - 1], wi[K - 1]);
    float ar = __fmul_rn(g[0], wr[0]);
    float ai = __fmul_rn(g[0], wi[0]);
#pragma unroll
    for (int k = 1; k < K; ++k) {
      ar = __fadd_rn(ar, __fmul_rn(g[k], wr[k]));
      ai = __fadd_rn(ai, __fmul_rn(g[k], wi[k]));
    }
    out[(long)t * M + r] = make_float2(ar, ai);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
      wr[k] = wr[k + 1];
      wi[k] = wi[k + 1];
    }
  }
}

template <int K>
cudaError_t launch(const float* G, const float* c_re, const float* c_im,
                   const float* x_re, const float* x_im, float2* out, int nf,
                   int M, cudaStream_t s) {
  const dim3 grid((M + kThreads - 1) / kThreads,
                  (nf + kFrames - 1) / kFrames);
  pfb_fold_kernel<K><<<grid, kThreads, 0, s>>>(G, c_re, c_im, x_re, x_im,
                                               out, nf, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest taps_per the kernel folds (the wrapper checks K against it).
int pfb_fold_max_taps() { return kKMax; }

// G: [K, M] fold taps (G[k, r] = reversed prototype[k·M + r]); c_*: the
// carried (K−1)·M history planes; x_*: nf·M input planes; out: [nf, M]
// complex64 (interleaved re, im).
int pfb_fold(const float* G, const float* c_re, const float* c_im,
             const float* x_re, const float* x_im, void* out, int nf, int M,
             int K, void* stream) {
  if (nf < 1 || M < 1 || nf > kFrames * 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* o = static_cast<float2*>(out);
  switch (K) {
    case 1: return (int)launch<1>(G, c_re, c_im, x_re, x_im, o, nf, M, s);
    case 2: return (int)launch<2>(G, c_re, c_im, x_re, x_im, o, nf, M, s);
    case 3: return (int)launch<3>(G, c_re, c_im, x_re, x_im, o, nf, M, s);
    case 4: return (int)launch<4>(G, c_re, c_im, x_re, x_im, o, nf, M, s);
    case 5: return (int)launch<5>(G, c_re, c_im, x_re, x_im, o, nf, M, s);
    case 6: return (int)launch<6>(G, c_re, c_im, x_re, x_im, o, nf, M, s);
    case 7: return (int)launch<7>(G, c_re, c_im, x_re, x_im, o, nf, M, s);
    case 8: return (int)launch<8>(G, c_re, c_im, x_re, x_im, o, nf, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
