// Squelch gate for Hopper (sm_90a) on time-major audio, in place.
//
// Replaces no TPU kernel: the reference's gate
// (supersdr_tpu/ops/squelch.py::apply_squelch) is jnp code that XLA fuses
// into the tail's program. In the port the same function ran as ~29 PyTorch
// operations on the planar / time-major tail (runtime/chain.py
// process_tail_tmajor): the state gathered by `order`, a float32 [C, n] gain
// built through temporaries of the audio's size, the product, two
// transposes, the state scattered back by `inv` (2.96 ms a HEADLINE chunk
// of 2560 channels × 64512 audio samples). This kernel is that gate in one
// launch. The chain-major tails (runtime/chain.py `_gate`) keep the plain
// gate.
//
// What it computes, for audio [n, C] (C contiguous) and channel c, with
// open and g0 read at bin b = order[c] (b = c without order):
//   open'  = enabled > 0 ? clamp(open + [rssi ≥ thresh]
//                                     − [rssi < thresh − hyst], 0, 1) : 1
//   sgn    = sign(open' − g0),  lo = min(g0, open'),  hi = max(g0, open')
//   g(t)   = clamp(g0 + (sgn·ramp)·t, lo, hi)             t = 1 … n
//   audio[t − 1][c] ← audio[t − 1][c] · g(t)
//   open'[b], g_last[b] = clamp(g0 + sgn·(ramp·n), lo, hi)   (new tensors)
// Every product and sum rounds as PyTorch's separate elementwise operations
// do (__fmul_rn, __fadd_rn: nvcc may not contract them into an FMA), in
// float32, and rounds once to the audio's type (float32, float16 or
// bfloat16), so the output equals the plain version
// (ops/cuda/squelch_gate.py) bit for bit, but for the sign of zero: a shut
// channel's negative sample is stored as +0.0 where the product gives −0.0.
//
// What bounds it on this card: bytes. g(t) is monotone in t and bounded by
// open', so once it equals open' it stays there. A tile of rows whose first
// g(t) already equals open' for a channel is settled for it: open' = 1
// leaves its audio as it is (no load, no store), open' = 0 stores zeros (no
// load). Only a ramp still running in the tile (at most 1 / ramp samples:
// 960 at the port's 240 IQ samples and ×4), a target strictly between 0
// and 1, or a settled-open channel beside a shut one in 32 bytes is
// loaded, scaled and stored. Under the squelch cell's keyed traffic
// at HEADLINE (~159 channels settled open, ~2,351 settled shut, ~50 moving a
// chunk) the least traffic is ~645 MB, mostly zero stores: 0.189 ms at
// 3.35 TB/s (sdrbench/roofline/squelch.py counts it from the gate counter).
//
// Design: one launch a chunk, nothing allocated, no transpose. A thread owns
// 16 bytes of adjacent channels (4 float32 or 8 float16 / bfloat16 lanes; one
// lane where C or the base does not allow 16-byte rows) and walks tiles of
// kTileRows rows; a warp covers 512 contiguous bytes of a row. Each tile it
// classes its vector once: every lane settled open → nothing; every lane
// settled shut → zeros, no load; otherwise (a lane ramps, settled lanes of
// both kinds, or a fractional target) it loads, scales every lane by its
// g(t) (a settled lane's g(t) is its target, so x·1 = x and x·0 = ±0) and
// stores, kGroup rows loaded before any is stored. What decides the time is
// that no 32-byte sector is ever left partly written: a vector is left alone
// only if the other vector of its sector is too, and the zero and the
// scaled vectors of a row are stored by the same instruction, after the
// loads, so a sector with an open channel is read clean and written whole.
// At HEADLINE on the squelch cell's mix (float32) that takes 0.42 ms; zero
// stores issued apart from the scaled vectors' loads and stores (the
// sectors written by halves, the halves read back) took 0.96 ms, per-lane
// zero stores around the open lanes 0.72 ms, and the scaled rows spread
// over the whole warp 1.5 ms (PERF.md §6). What is left over the least
// time is the sectors that hold an open channel: read and written whole,
// where the count (sdrbench/roofline/squelch.py) charges nothing. The
// blocks of the first tile row decide open' and g_last and write the new
// state in bin order, which takes the place of the state's gathers by order
// and inv. The parameters and the state are read from device memory: no
// host synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 64;
constexpr int kGroup = 8;          // rows loaded before any is stored
constexpr unsigned kMaxTileBlocks = 65535;

// The audio's element types as their bits, with float32 conversions.
struct F32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ float decode(uint32_t b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ uint32_t encode(float x) {
    return __float_as_uint(x);
  }
};
struct F16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float decode(uint32_t b) {
    return __half2float(__ushort_as_half((unsigned short)b));
  }
  static __device__ __forceinline__ uint32_t encode(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
struct BF16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float decode(uint32_t b) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)b));
  }
  static __device__ __forceinline__ uint32_t encode(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// 16 bytes of adjacent lanes, moved as one 128-bit load or store.
template <typename Fmt>
struct Wide {
  static constexpr int kLanes = 16 / (int)sizeof(typename Fmt::Bits);
  static constexpr int kPerWord = 4 / (int)sizeof(typename Fmt::Bits);
  uint4 w;
  static __device__ __forceinline__ Wide load(const void* p) {
    return Wide{*static_cast<const uint4*>(p)};
  }
  static __device__ __forceinline__ Wide zero() {
    return Wide{make_uint4(0u, 0u, 0u, 0u)};
  }
  __device__ __forceinline__ void store(void* p) const {
    *static_cast<uint4*>(p) = w;
  }
  __device__ __forceinline__ uint32_t word(int k) const {
    return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
  }
  __device__ __forceinline__ void set_word(int k, uint32_t v) {
    if (k == 0) w.x = v; else if (k == 1) w.y = v;
    else if (k == 2) w.z = v; else w.w = v;
  }
  __device__ __forceinline__ float get(int i) const {
    const uint32_t v = word(i / kPerWord);
    return Fmt::decode(kPerWord == 1 ? v : (v >> (16 * (i % kPerWord)))
                                               & 0xffffu);
  }
  __device__ __forceinline__ void set(int i, float x) {
    const uint32_t b = Fmt::encode(x);
    if (kPerWord == 1) {
      set_word(i, b);
    } else {
      const int s = 16 * (i % kPerWord);
      set_word(i / kPerWord,
               (word(i / kPerWord) & ~(0xffffu << s)) | (b << s));
    }
  }
};

// One lane, for rows that cannot be read in 16-byte pieces.
template <typename Fmt>
struct Narrow {
  using Bits = typename Fmt::Bits;
  static constexpr int kLanes = 1;
  Bits b;
  static __device__ __forceinline__ Narrow load(const void* p) {
    return Narrow{*static_cast<const Bits*>(p)};
  }
  static __device__ __forceinline__ Narrow zero() { return Narrow{0}; }
  __device__ __forceinline__ void store(void* p) const {
    *static_cast<Bits*>(p) = b;
  }
  __device__ __forceinline__ float get(int) const { return Fmt::decode(b); }
  __device__ __forceinline__ void set(int, float x) {
    b = (Bits)Fmt::encode(x);
  }
};

template <typename Fmt>
using Bits_t = typename Fmt::Bits;

struct GateArgs {
  const float* rssi;        // [C], audio row order
  const float* open_in;     // [C], bin order
  const float* gain_in;
  const int64_t* order;     // [C] or null: row c's bin
  float* open_out;          // [C], bin order
  float* gain_out;
  const float* enabled;     // scalars
  const float* thresh;
  const float* hyst;
  const float* ramp;
};

// One channel's gate for the chunk: g(t) = clamp(g0 + sr·t, lo, hi).
struct Lane {
  float g0, sr, lo, hi, target;
};

// p = (g0, sr, lo, hi)
__device__ __forceinline__ float gain_at(float4 p, float t) {
  return fminf(fmaxf(__fadd_rn(p.x, __fmul_rn(p.y, t)), p.z), p.w);
}

// The gate's decision for row c (ops/squelch.py `_open_now` and
// `apply_squelch`, operation for operation); writes the new state when
// `write`.
__device__ __forceinline__ Lane decide(const GateArgs& a, int c, long n,
                                       bool write) {
  const int64_t b = a.order != nullptr ? a.order[c] : c;
  const float thresh = *a.thresh;
  const float rssi = a.rssi[c];
  const float opens = rssi >= thresh ? 1.0f : 0.0f;
  const float closes = rssi < __fsub_rn(thresh, *a.hyst) ? 1.0f : 0.0f;
  float open_now = __fsub_rn(__fadd_rn(a.open_in[b], opens), closes);
  open_now = fminf(fmaxf(open_now, 0.0f), 1.0f);
  if (!(*a.enabled > 0.0f)) open_now = 1.0f;
  Lane l;
  l.g0 = a.gain_in[b];
  l.target = open_now;
  const float d = __fsub_rn(open_now, l.g0);
  const float sgn = (float)((0.0f < d) - (d < 0.0f));
  const float ramp = *a.ramp;
  l.sr = __fmul_rn(sgn, ramp);
  l.lo = fminf(l.g0, open_now);
  l.hi = fmaxf(l.g0, open_now);
  if (write) {
    a.open_out[b] = open_now;
    a.gain_out[b] = fminf(
        fmaxf(__fadd_rn(l.g0, __fmul_rn(sgn, __fmul_rn(ramp, (float)n))),
              l.lo),
        l.hi);
  }
  return l;
}

template <typename Fmt, typename Pack>
__global__ void __launch_bounds__(kThreads)
squelch_gate_kernel(typename Fmt::Bits* audio, long n, int C, GateArgs a) {
  constexpr int N = Pack::kLanes;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool live = v < C / N;
  float4 ramp[N];           // (g0, sr, lo, hi) of each lane
  float target[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ramp[i] = make_float4(1.0f, 0.0f, 1.0f, 1.0f);
    target[i] = 1.0f;
    if (live) {
      const Lane l = decide(a, v * N + i, n, blockIdx.y == 0);
      ramp[i] = make_float4(l.g0, l.sr, l.lo, l.hi);
      target[i] = l.target;
    }
  }
  Bits_t<Fmt>* col = audio + (long)v * N;
  const long n_tiles = (n + kTileRows - 1) / kTileRows;
  for (long tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const long r0 = tile * kTileRows;
    const long r1 = min(r0 + (long)kTileRows, n);
    const float t0 = (float)(r0 + 1);
    bool skip = true, zero = live;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool settled = gain_at(ramp[i], t0) == target[i];
      skip = skip && settled && target[i] == 1.0f;
      zero = zero && settled && target[i] == 0.0f;
    }
    // the two 16-byte vectors of a 32-byte sector are written together or
    // not at all: one left alone beside one that is written would leave the
    // sector partly written
    skip = !live || (skip && __shfl_xor_sync(0xffffffffu, skip, 1));
    if (skip) continue;
#pragma unroll 1
    for (long r = r0; r < r1; r += kGroup) {
      Pack x[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        x[k] = Pack::zero();
        if (!zero && r + k < r1) x[k] = Pack::load(col + (r + k) * C);
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (r + k < r1) {
          const float t = (float)(r + k + 1);
#pragma unroll
          for (int i = 0; i < N; ++i)
            x[k].set(i, __fmul_rn(x[k].get(i), gain_at(ramp[i], t)));
          if (zero) x[k] = Pack::zero();
          x[k].store(col + (r + k) * C);
        }
      }
    }
  }
}

template <typename Fmt>
cudaError_t launch(void* audio, long n, int C, const GateArgs& a,
                   cudaStream_t stream) {
  using Bits = typename Fmt::Bits;
  const bool wide = reinterpret_cast<uintptr_t>(audio) % 16 == 0 &&
                    C % Wide<Fmt>::kLanes == 0;
  const int lanes = wide ? Wide<Fmt>::kLanes : 1;
  // a block a tile of rows (a block walks several past the grid's limit)
  const long n_tiles = (n + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)((C / lanes + kThreads - 1) / kThreads),
                  (unsigned)(n_tiles < (long)kMaxTileBlocks ? n_tiles
                                                            : kMaxTileBlocks));
  Bits* p = static_cast<Bits*>(audio);
  if (wide)
    squelch_gate_kernel<Fmt, Wide<Fmt>><<<grid, kThreads, 0, stream>>>(
        p, n, C, a);
  else
    squelch_gate_kernel<Fmt, Narrow<Fmt>><<<grid, kThreads, 0, stream>>>(
        p, n, C, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// audio: [n, C] with C contiguous, element type `dtype` (0 float32,
// 1 float16, 2 bfloat16), gated in place. rssi: float32 [C] in the audio's
// row order. open_in, gain_in: the gate's state, float32 [C] in bin order,
// read at order[c] (int64 [C], a permutation; null: the identity).
// open_out, gain_out: float32 [C], the new state written at order[c].
// enabled, thresh, hyst, ramp: float32 scalars on the device (the ramp per
// audio sample).
int squelch_gate(void* audio, int dtype, long n, int C, const void* rssi,
                 const void* open_in, const void* gain_in, const void* order,
                 void* open_out, void* gain_out, const void* enabled,
                 const void* thresh, const void* hyst, const void* ramp,
                 void* stream) {
  if (n < 1 || C < 1 || audio == nullptr || rssi == nullptr ||
      open_in == nullptr || gain_in == nullptr || open_out == nullptr ||
      gain_out == nullptr || enabled == nullptr || thresh == nullptr ||
      hyst == nullptr || ramp == nullptr)
    return (int)cudaErrorInvalidValue;
  const GateArgs a{static_cast<const float*>(rssi),
                   static_cast<const float*>(open_in),
                   static_cast<const float*>(gain_in),
                   static_cast<const int64_t*>(order),
                   static_cast<float*>(open_out),
                   static_cast<float*>(gain_out),
                   static_cast<const float*>(enabled),
                   static_cast<const float*>(thresh),
                   static_cast<const float*>(hyst),
                   static_cast<const float*>(ramp)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<F32>(audio, n, C, a, st);
    case 1: return (int)launch<F16>(audio, n, C, a, st);
    case 2: return (int)launch<BF16>(audio, n, C, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
