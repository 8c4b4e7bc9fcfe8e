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
// masked. A leading shard axis (blockIdx.z: D time shards, each with its own
// carry, the mesh form of the wideband fallback tier) moves the base
// pointers once a block. The output is interleaved complex64, ready for
// torch.fft. Products
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
  const long sh = blockIdx.z;  // this block's shard
  c_re += sh * (K - 1) * M;
  c_im += sh * (K - 1) * M;
  x_re += sh * nf * M;
  x_im += sh * nf * M;
  out += sh * nf * M;
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
                   int M, int n_shards, cudaStream_t s) {
  const dim3 grid((M + kThreads - 1) / kThreads,
                  (nf + kFrames - 1) / kFrames, n_shards);
  pfb_fold_kernel<K><<<grid, kThreads, 0, s>>>(G, c_re, c_im, x_re, x_im,
                                               out, nf, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest taps_per the kernel folds (the wrapper checks K against it).
int pfb_fold_max_taps() { return kKMax; }

// G: [K, M] fold taps (G[k, r] = reversed prototype[k·M + r]); c_*: the
// carried history planes [D, (K−1)·M]; x_*: input planes [D, nf·M]; out:
// [D, nf, M] complex64 (interleaved re, im); D = n_shards time shards.
int pfb_fold(const float* G, const float* c_re, const float* c_im,
             const float* x_re, const float* x_im, void* out, int nf, int M,
             int K, int n_shards, void* stream) {
  if (nf < 1 || M < 1 || nf > kFrames * 65535 || n_shards < 1 ||
      n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* o = static_cast<float2*>(out);
#define SSDR_FOLD(KK) \
  case KK:            \
    return (int)launch<KK>(G, c_re, c_im, x_re, x_im, o, nf, M, n_shards, s)
  switch (K) {
    SSDR_FOLD(1);
    SSDR_FOLD(2);
    SSDR_FOLD(3);
    SSDR_FOLD(4);
    SSDR_FOLD(5);
    SSDR_FOLD(6);
    SSDR_FOLD(7);
    SSDR_FOLD(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSDR_FOLD
}

}  // extern "C"
