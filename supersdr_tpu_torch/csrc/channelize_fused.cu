// Fused polyphase channelizer for Hopper (sm_90a): K-tap fold, DIF stage A
// and the stage-B DFT in one launch.
//
// Replaces: supersdr_tpu/ops/pallas/channelize_fused.py::_kernel, as called
// by channelize_fused_c(out_layout="raw3") on the planar wideband path.
//
// What it computes (M = n1·n2 channels, K taps a branch, nf frames):
//   seg   = [K−1 carry rows (head) | x rows]                    [K−1+nf, M]
//   fold[t, r]     = Σ_k g2[k, r]·seg[t+k, r]
//   Y[k1, t, j2]   = Σ_j1 At[j1·n1+k1, j2]·fold[t, j1·n2+j2]  (twiddle folded)
//   out[k1, t, k2] = Σ_j2 Y[k1, t, j2]·C2[j2, k2]               (complex)
// The output is the reference's raw planar layout [n1, nf, n2] (planar
// channel k1·n2 + k2 is PFB bin k2·n1 + k1), or its out_layout="time",
// [nf, M] with bin k2·n1 + k1 in column order (the wideband time-major tier
// off the planar coupling).
//
// The mesh form (the reference's n1_pad, for the time-sharded wideband
// pipeline): D time shards of nf frames each, x [D, nf, M] and heads
// [D, K−1, M] (each shard's own history), out [D, n1_out, nf, n2] (or
// [D, nf, M] for the time store), one launch for every shard. Planes
// k1 ∈ [n1, n1_out) are exact zeros, so the all_to_all's split axis divides
// by the shard count. D = 1 with n1_out = n1 is the plain form, bit for bit.
//
// The layout is a template parameter: output strides passed as kernel
// arguments slowed the kernel ~5 % at the headline shape on an H100. int16
// input is dequantized ×in_scale as it is read.
//
// What bounds it on this card: bytes (330 MB read, 165 MB of bf16 written a
// 2560-channel × 16128-frame chunk: 0.15 ms at 3.35 TB/s). Stage B is an
// [n1, n2]×[n2, n2] complex product a frame, about 85 GFLOP a chunk: 0.09 ms
// at the bf16 tensor-core peak, 1.3 ms on the CUDA cores, where it ran
// before and took 4.6 ms. On the tensor cores the fold and stage A (4.6
// GFLOP in float32, and 1 MB a block of rows and tables out of L2) are the
// larger part.
//
// Design: one block owns T consecutive frames of one shard (blockIdx.y; T = 8
// at 2560 channels; a tile never straddles two shards) and
// keeps the stage-A output as the bf16 matrix Y[n1·T rows, Yr | Yi] in
// shared memory; 256 threads, one block an SM. Blocks read their own K − 1
// history rows, so they run in any order; frames past nf are masked.
//  * Phase 1 walks stages of one column group j1 and 4 frames: thread j2
//    folds column j1·n2 + j2 and accumulates the n1 stage-A outputs in
//    registers over j1, so Y is written once. The 4 + K − 1 input rows of a
//    stage arrive through a two-tile shared ring filled by 16-byte cp.async
//    copies one stage ahead (int16 rows as they are: no 2-byte loads), and
//    the stage's fold taps and stage-A factors are loaded into registers
//    one stage ahead: when these table loads sat inside the stage, in a
//    predicated loop the compiler did not hoist them out of, they serialized
//    on L2 latency and the phase took 1.5 ms instead of 0.6.
//  * Phase 2 is stage B as the real product [Yr | Yi]·[[Cr, Ci], [−Ci, Cr]]
//    on mma.sync m16n8k16 (bf16 → f32): a warp owns 16 output columns and
//    all row tiles, A fragments come by ldmatrix (row stride ≡ 4 words mod
//    32: conflict-free), B fragments are 32-bit loads of the transposed bf16
//    DFT table from L2, one k-step ahead (a warp is the only reader of its
//    columns, so staging them in shared memory would buy no reuse), −Ci by
//    flipping sign bits.
//  * bf16_b (the fast profile) rounds Y and the table to bf16: one pass.
//    Otherwise (the quality profile) both stay float32, each split into a
//    high and a low bf16 piece (x ≈ hi + lo, 16 significant bits), and the
//    product is hi·hi + hi·lo + lo·hi in three passes into the same float32
//    accumulators: 108 dB against the float32 plain version where one bf16
//    pass gives 50 and one TF32 pass about 70, at 1.3 ms where the CUDA-core
//    product took 4.8.
//  * The raw planes are stored from the accumulators (a warp writes whole
//    32-byte sectors of a row). The time-major store stages each warp's
//    [T, 16·n1] run of consecutive bins in shared memory (the ring's space,
//    free by then), a plane at a time, and writes 16 bytes a lane.
//  * Phantom planes: in the epilogue each block writes zeros over its T rows
//    of every plane past n1, 16 bytes a thread (a block's rows of a plane
//    are contiguous), so no second pass clears them. The shard count, n1_out
//    and the shard strides are run-time values (no template instances);
//    a block adds its shard's offsets where it addresses memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kN2Step = 128;      // n2 is a multiple of this
constexpr int kKMax = 8;          // most fold taps a branch (registers)
constexpr int kK1G = 10;          // stage-A outputs a thread accumulates
constexpr int kMG = 5;            // 16-row tiles a warp accumulates at once
constexpr int kWN = 16;           // output columns a warp owns in a pass
constexpr int kSmemMax = 227 * 1024;   // a block's most

template <bool kI16, typename In>
__device__ __forceinline__ float to_float(In v, float s) {
  return kI16 ? float(v) * s : float(v);
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// fills the 16 with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ int y_rows(int n1, int T) {
  return (n1 * T + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int y_stride(int n2) {
  return 2 * n2 + 8;  // bf16 elements: n2 + 4 words, ≡ 4 (mod 32)
}
__host__ __device__ __forceinline__ int stage_stride(int n1) {
  return kWN * n1 + 4;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D (16×8, f32) += A (16×16, bf16, row) · B (16×8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (cr, ci) += (a_r + i·a_i)·(b_r + i·b_i) on one 16×8 tile
__device__ __forceinline__ void cmma(float (&cr)[4], float (&ci)[4],
                                     const uint32_t (&a_r)[4],
                                     const uint32_t (&a_i)[4],
                                     const uint32_t (&b_r)[2],
                                     const uint32_t (&b_i)[2]) {
  const uint32_t kNeg = 0x80008000u;
  mma_bf16(cr, a_r, b_r[0], b_r[1]);
  mma_bf16(cr, a_i, b_i[0] ^ kNeg, b_i[1] ^ kNeg);
  mma_bf16(ci, a_r, b_i[0], b_i[1]);
  mma_bf16(ci, a_i, b_r[0], b_r[1]);
}

// v as bf16 at p; kSplit: and what bf16 left of it, `lo` elements on
template <bool kSplit>
__device__ __forceinline__ void put_y(__nv_bfloat16* p, size_t lo, float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *p = h;
  if (kSplit) p[lo] = __float2bfloat16_rn(v - __bfloat162float(h));
}

// ct: the stage-B DFT transposed, bf16 planes [2 (re, im)][n2 (k2)][n2 (j2)];
// kSplit: two more planes, the low pieces of re and im.
template <int T, bool kI16, bool kOutBf16, bool kTime, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
channelize_mma_kernel(const void* __restrict__ x_re,
                      const void* __restrict__ x_im, float in_scale,
                      const float* __restrict__ head_re,
                      const float* __restrict__ head_im,
                      const float* __restrict__ g2,
                      const float* __restrict__ at_r,
                      const float* __restrict__ at_i,
                      const __nv_bfloat16* __restrict__ ct, void* out_r,
                      void* out_i, int nf, int M, int K, int n1, int n2,
                      int n1_out) {
  extern __shared__ float4 smem_f4[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_f4);
  using In = typename std::conditional<kI16, int16_t, float>::type;
  using Out = typename std::conditional<kOutBf16, __nv_bfloat16, float>::type;
  // this block's shard (x [D, nf, M], heads [D, K−1, M], out per shard),
  // as element offsets added where the pointers are used
  const long s_x = (long)blockIdx.y * nf * M;
  const long s_h = (long)blockIdx.y * (K - 1) * M;
  const long s_o =
      (long)blockIdx.y * (kTime ? (long)nf * M : (long)n1_out * nf * n2);
  const int t0 = blockIdx.x * T;
  const int R = n1 * T;
  const int Rpad = y_rows(n1, T);
  const int Sy = y_stride(n2);
  const int tid = threadIdx.x;
  constexpr int NP = kSplit ? 2 : 1;      // operand pieces: high (and low)
  const size_t ylo = (size_t)Rpad * Sy;   // from a high piece to its low one

  for (int i = tid; i < (Rpad - R) * Sy; i += kThreads) {
    ys[R * Sy + i] = __float2bfloat16_rn(0.f);
    if (kSplit) ys[ylo + R * Sy + i] = __float2bfloat16_rn(0.f);
  }

  // ---- phase 1: fold + stage A into ys[k1·T + t][j2 | n2 + j2]
  const int hk = K - 1;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int TH = T < 4 ? T : 4;  // frames a pass
  const int nkg = (n1 + kK1G - 1) / kK1G;
  const int n_stages = (n2 + kThreads - 1) / kThreads * (T / TH) * nkg * n1;
  // a stage: column block jb, frames th …, stage-A outputs kg …, column
  // group j1 (j1 fastest: the outputs accumulate over it in registers)
  struct Stage {
    int jb, th, kg, j1;
  };
  auto next = [&](Stage c) {
    if (++c.j1 < n1) return c;
    c.j1 = 0;
    if ((c.kg += kK1G) < n1) return c;
    c.kg = 0;
    if ((c.th += TH) < T) return c;
    c.th = 0;
    c.jb += kThreads;
    return c;
  };
  // The rows a stage folds, TH + K − 1 of one column group, come through a
  // ring of two tiles [2 (re, im)][rows][kThreads] in the input's type,
  // filled by 16-byte asynchronous copies one stage ahead (a warp a row;
  // rows past the chunk are zero-filled). The first blocks, whose rows
  // reach into the carry head (float32 whatever the input is), read global
  // memory instead.
  constexpr int kPiece = 16 / (int)sizeof(In);  // elements a 16-byte copy
  In* ring = reinterpret_cast<In*>(ys + NP * ylo);
  const int rows_st = TH + hk;
  const size_t tile_elems = 2 * (size_t)(TH + kKMax - 1) * kThreads;
  const bool staged = t0 >= hk;
  auto fill = [&](const Stage& st, int buf) {
    const int cols = min(kThreads, n2 - st.jb);
    const long col0 = (long)st.j1 * n2 + st.jb;
    for (int rw = warp; rw < 2 * rows_st; rw += kWarps) {
      const int pl = rw >= rows_st, row = rw - pl * rows_st;
      const int f = t0 + st.th + row - hk;  // the input frame of this row
      const In* src = static_cast<const In*>(pl ? x_im : x_re) + s_x +
                      (f < nf ? (long)f * M + col0 : 0);
      In* dst = ring + buf * tile_elems + (size_t)rw * kThreads;
      for (int c = lane * kPiece; c < cols; c += 32 * kPiece)
        cp_async16(dst + c, src + c, f < nf ? 16 : 0);
    }
  };
  // a stage's fold taps and stage-A twiddles, loaded a stage ahead (the
  // loads' latency passes under the stage before; indices clamped, what
  // lies past K or n1 is not used)
  auto tables = [&](const Stage& st, float(&g)[kKMax], float(&ar)[kK1G],
                    float(&ai)[kK1G]) {
    const int j2 = min(st.jb + tid, n2 - 1);
#pragma unroll
    for (int k = 0; k < kKMax; ++k)
      g[k] = __ldg(g2 + (long)min(k, K - 1) * M + st.j1 * n2 + j2);
#pragma unroll
    for (int k1 = 0; k1 < kK1G; ++k1) {
      const long a = (long)(st.j1 * n1 + min(st.kg + k1, n1 - 1)) * n2 + j2;
      ar[k1] = __ldg(at_r + a);
      ai[k1] = __ldg(at_i + a);
    }
  };
  Stage cur{0, 0, 0, 0};
  if (staged) {
    fill(cur, 0);
    cp_async_commit();
  }
  float yr[kK1G][TH], yi[kK1G][TH];
  float gk[kKMax], ark[kK1G], aik[kK1G];
  tables(cur, gk, ark, aik);
  for (int s = 0; s < n_stages; ++s) {
    const int th = cur.th, kg = cur.kg, j1 = cur.j1;
    const int j2 = cur.jb + tid;
    const bool on = j2 < n2;
    const bool more = s + 1 < n_stages;
    const Stage nxt = more ? next(cur) : cur;
    float gn[kKMax], arn[kK1G], ain[kK1G];
    tables(nxt, gn, arn, ain);
    if (j1 == 0) {
#pragma unroll
      for (int k1 = 0; k1 < kK1G; ++k1)
#pragma unroll
        for (int t = 0; t < TH; ++t) yr[k1][t] = yi[k1][t] = 0.f;
    }
    if (staged) {
      if (more) fill(nxt, (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // all but the newest group: this stage's tile
      __syncthreads();
    }
    if (on) {
      const int r = j1 * n2 + j2;
      float sr[TH + kKMax - 1], si[TH + kKMax - 1];
      const In* xs = ring + (s & 1) * tile_elems + tid;
#pragma unroll
      for (int v = 0; v < TH + kKMax - 1; ++v) {
        sr[v] = si[v] = 0.f;
        if (v >= rows_st) continue;
        if (staged) {
          sr[v] = to_float<kI16>(xs[v * kThreads], in_scale);
          si[v] = to_float<kI16>(xs[(rows_st + v) * kThreads], in_scale);
        } else if (t0 + th + v < hk) {
          sr[v] = head_re[s_h + (long)(t0 + th + v) * M + r];
          si[v] = head_im[s_h + (long)(t0 + th + v) * M + r];
        } else if (t0 + th + v - hk < nf) {
          const long idx = s_x + (long)(t0 + th + v - hk) * M + r;
          sr[v] = to_float<kI16>(static_cast<const In*>(x_re)[idx], in_scale);
          si[v] = to_float<kI16>(static_cast<const In*>(x_im)[idx], in_scale);
        }
      }
      float fr[TH], fi[TH];
#pragma unroll
      for (int t = 0; t < TH; ++t) fr[t] = fi[t] = 0.f;
#pragma unroll
      for (int k = 0; k < kKMax; ++k) {
        if (k < K) {
#pragma unroll
          for (int t = 0; t < TH; ++t) {
            fr[t] += gk[k] * sr[t + k];
            fi[t] += gk[k] * si[t + k];
          }
        }
      }
#pragma unroll
      for (int k1 = 0; k1 < kK1G; ++k1) {
        if (kg + k1 < n1) {
#pragma unroll
          for (int t = 0; t < TH; ++t) {
            yr[k1][t] += ark[k1] * fr[t] - aik[k1] * fi[t];
            yi[k1][t] += ark[k1] * fi[t] + aik[k1] * fr[t];
          }
        }
      }
      if (j1 == n1 - 1) {
#pragma unroll
        for (int k1 = 0; k1 < kK1G; ++k1) {
          if (kg + k1 < n1) {
#pragma unroll
            for (int t = 0; t < TH; ++t) {
              __nv_bfloat16* yp = ys + ((kg + k1) * T + th + t) * Sy + j2;
              put_y<kSplit>(yp, ylo, yr[k1][t]);
              put_y<kSplit>(yp + n2, ylo, yi[k1][t]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kKMax; ++k) gk[k] = gn[k];
#pragma unroll
    for (int k1 = 0; k1 < kK1G; ++k1) {
      ark[k1] = arn[k1];
      aik[k1] = ain[k1];
    }
    cur = nxt;
    // the tile is free for the fill after next; Y is whole after the last
    __syncthreads();
  }
  if (staged) cp_async_wait<0>();

  // ---- phase 2: [Yr | Yi]·[[Cr, Ci], [−Ci, Cr]] on the tensor cores
  const int g = lane >> 2, tig = lane & 3;
  const int mtiles = Rpad / 16;
  // ldmatrix: lane l addresses row l % 16 of the tile, columns (l / 16)·8
  const uint32_t ya0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(ys)) +
      2u * ((lane & 15) * Sy + (lane >> 4) * 8);
  const uint32_t* ctw = reinterpret_cast<const uint32_t*>(ct);
  const int cw = n2 / 2;                   // words a table row
  const long plane_w = (long)n2 * cw;      // words a table plane
  const int ss = stage_stride(n1);
  float* stg = reinterpret_cast<float*>(ys + NP * ylo) + (size_t)warp * T * ss;
  for (int nb = warp * kWN; nb < n2; nb += kWarps * kWN) {
    // B fragments of this lane: table rows nb + g and nb + 8 + g, as
    // [piece][re | im][8-column half][word]
    const uint32_t* b_r0 = ctw + (long)(nb + g) * cw + tig;
    const uint32_t* b_r1 = b_r0 + 8 * cw;
    auto load_b = [&](uint32_t (&b)[NP][2][2][2], int kw) {
#pragma unroll
      for (int pc = 0; pc < NP; ++pc)
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const long off = (long)(2 * pc + ri) * plane_w + kw;
          b[pc][ri][0][0] = __ldg(b_r0 + off);
          b[pc][ri][0][1] = __ldg(b_r0 + off + 4);
          b[pc][ri][1][0] = __ldg(b_r1 + off);
          b[pc][ri][1][1] = __ldg(b_r1 + off + 4);
        }
    };
    for (int mg = 0; mg < mtiles; mg += kMG) {
      float cr[kMG][2][4], ci[kMG][2][4];
#pragma unroll
      for (int m = 0; m < kMG; ++m)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) cr[m][q][i] = ci[m][q][i] = 0.f;
      uint32_t b[NP][2][2][2];
      load_b(b, 0);
      for (int k0 = 0; k0 < n2; k0 += 16) {
        // the next k-step's table words, in flight during this step's mma
        uint32_t bn[NP][2][2][2];
        load_b(bn, (k0 + 16 < n2 ? k0 + 16 : k0) / 2);
#pragma unroll
        for (int m = 0; m < kMG; ++m) {
          if (mg + m < mtiles) {
            uint32_t a[NP][2][4];
            const uint32_t row = ya0 + 2u * ((mg + m) * 16 * Sy + k0);
#pragma unroll
            for (int pc = 0; pc < NP; ++pc) {
              ldmatrix_x4(a[pc][0], row + 2u * (uint32_t)(pc * ylo));
              ldmatrix_x4(a[pc][1], row + 2u * (uint32_t)(pc * ylo + n2));
            }
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              cmma(cr[m][q], ci[m][q], a[0][0], a[0][1], b[0][0][q],
                   b[0][1][q]);
              if (kSplit) {  // hi·lo + lo·hi: float32 operands in three passes
                cmma(cr[m][q], ci[m][q], a[0][0], a[0][1], b[NP - 1][0][q],
                     b[NP - 1][1][q]);
                cmma(cr[m][q], ci[m][q], a[NP - 1][0], a[NP - 1][1],
                     b[0][0][q], b[0][1][q]);
              }
            }
          }
        }
#pragma unroll
        for (int pc = 0; pc < NP; ++pc)
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              b[pc][ri][q][0] = bn[pc][ri][q][0];
              b[pc][ri][q][1] = bn[pc][ri][q][1];
            }
      }
      // accumulators: rows (tile·16 + g | + 8), columns nb + q·8 + 2·tig | +1
      if (kTime) {
        // one pass holds every row (the host picks T so): stage the warp's
        // [T, 16·n1] run of consecutive bins, a plane at a time, and write
        // it 16 bytes a lane, a frame's run after the other
        auto store_plane = [&](const float(&acc)[kMG][2][4], float* dst) {
#pragma unroll
          for (int m = 0; m < kMG; ++m) {
            if (m >= mtiles) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m * 16 + g + h * 8;
              if (row >= R) continue;
              const int k1 = row / T, t = row % T;
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                float* sp = stg + t * ss + (q * 8 + 2 * tig) * n1 + k1;
                sp[0] = acc[m][q][2 * h];
                sp[n1] = acc[m][q][2 * h + 1];
              }
            }
          }
          __syncwarp();
          const int run = kWN * n1 / 4;  // 16-byte pieces a frame
          for (int i = lane; i < T * run; i += 32) {
            const int t = i / run, c = i % run * 4;
            if (t0 + t < nf)
              *reinterpret_cast<float4*>(dst + (long)(t0 + t) * M +
                                         (long)nb * n1 + c) =
                  *reinterpret_cast<const float4*>(stg + t * ss + c);
          }
          __syncwarp();
        };
        store_plane(cr, static_cast<float*>(out_r) + s_o);
        store_plane(ci, static_cast<float*>(out_i) + s_o);
        continue;
      }
#pragma unroll
      for (int m = 0; m < kMG; ++m) {
        if (mg + m >= mtiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (mg + m) * 16 + g + h * 8;
          if (row >= R) continue;
          const int k1 = row / T, t = row % T;
          const int tg = t0 + t;
          if (tg >= nf) continue;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const long o =
                s_o + ((long)k1 * nf + tg) * n2 + nb + q * 8 + 2 * tig;
            const float vr0 = cr[m][q][2 * h], vr1 = cr[m][q][2 * h + 1];
            const float vi0 = ci[m][q][2 * h], vi1 = ci[m][q][2 * h + 1];
            if (kOutBf16) {
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<__nv_bfloat16*>(out_r) + o) =
                  __floats2bfloat162_rn(vr0, vr1);
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<__nv_bfloat16*>(out_i) + o) =
                  __floats2bfloat162_rn(vi0, vi1);
            } else {
              *reinterpret_cast<float2*>(static_cast<float*>(out_r) + o) =
                  make_float2(vr0, vr1);
              *reinterpret_cast<float2*>(static_cast<float*>(out_i) + o) =
                  make_float2(vi0, vi1);
            }
          }
        }
      }
    }
  }
  // ---- phantom planes k1 ∈ [n1, n1_out): this block's rows, zeros
  if (!kTime && n1_out > n1) {
    const int rows = min(T, nf - t0);
    const long pieces = (long)rows * n2 * (long)sizeof(Out) / 16;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k1 = n1; k1 < n1_out; ++k1) {
      const long e = s_o + ((long)k1 * nf + t0) * n2;
      float4* pr = reinterpret_cast<float4*>(static_cast<Out*>(out_r) + e);
      float4* pi = reinterpret_cast<float4*>(static_cast<Out*>(out_i) + e);
      for (long i = tid; i < pieces; i += kThreads) {
        pr[i] = z;
        pi[i] = z;
      }
    }
  }
}

// Y, then the input ring, which the time store's staging reuses
__host__ size_t mma_smem(int n1, int n2, int T, bool split, bool time) {
  const size_t y = (size_t)(split ? 2 : 1) * y_rows(n1, T) * y_stride(n2) * 2;
  const int TH = T < 4 ? T : 4;
  size_t ring = 2 * 2 * (size_t)(TH + kKMax - 1) * kThreads * sizeof(float);
  const size_t stage = (size_t)kWarps * T * stage_stride(n1) * sizeof(float);
  return y + (time && stage > ring ? stage : ring);
}

// Frames a block owns: the largest T that fits (0: none does). The time
// store wants every row tile in one pass of accumulators.
__host__ int mma_tile(int n1, int n2, bool split, bool time) {
  for (int T = 8; T >= 2; T /= 2) {
    if (time && y_rows(n1, T) / 16 > kMG) continue;
    if (mma_smem(n1, n2, T, split, time) <= kSmemMax) return T;
  }
  return 0;
}

template <int T, bool kI16, bool kOutBf16, bool kTime, bool kSplit>
cudaError_t launch_mma(const void* x_re, const void* x_im, float in_scale,
                       const float* head_re, const float* head_im,
                       const float* g2, const float* at_r, const float* at_i,
                       const __nv_bfloat16* ct, void* out_r, void* out_i,
                       int nf, int M, int K, int n1, int n2, int n_shards,
                       int n1_out, cudaStream_t stream) {
  const size_t smem = mma_smem(n1, n2, T, kSplit, kTime);
  auto kern = channelize_mma_kernel<T, kI16, kOutBf16, kTime, kSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks((nf + T - 1) / T, n_shards);
  kern<<<blocks, kThreads, smem, stream>>>(x_re, x_im, in_scale, head_re,
                                           head_im, g2, at_r, at_i, ct, out_r,
                                           out_i, nf, M, K, n1, n2, n1_out);
  return cudaGetLastError();
}

// kSplit: float32 stage B in three bf16 passes (ct has four planes).
template <int T, bool kSplit>
cudaError_t dispatch_io(int in_i16, int out_bf16, int out_time,
                        const void* x_re, const void* x_im, float in_scale,
                        const float* head_re, const float* head_im,
                        const float* g2, const float* at_r, const float* at_i,
                        const __nv_bfloat16* ct, void* out_r, void* out_i,
                        int nf, int M, int K, int n1, int n2, int n_shards,
                        int n1_out, cudaStream_t s) {
#define SSDR_LAUNCH(I16, BF16, TIME)                                        \
  return launch_mma<T, I16, BF16, TIME, kSplit>(                            \
      x_re, x_im, in_scale, head_re, head_im, g2, at_r, at_i, ct, out_r,    \
      out_i, nf, M, K, n1, n2, n_shards, n1_out, s)
  if (out_time) {  // the time-major store writes float32
    if (in_i16) SSDR_LAUNCH(true, false, true);
    SSDR_LAUNCH(false, false, true);
  }
  if (out_bf16) {
    if (kSplit) return cudaErrorInvalidValue;  // three passes for bf16 out
    if (in_i16) SSDR_LAUNCH(true, !kSplit, false);
    SSDR_LAUNCH(false, !kSplit, false);
  }
  if (in_i16) SSDR_LAUNCH(true, false, false);
  SSDR_LAUNCH(false, false, false);
#undef SSDR_LAUNCH
}

template <bool kSplit>
cudaError_t dispatch_tile(int T, int in_i16, int out_bf16, int out_time,
                          const void* x_re, const void* x_im, float in_scale,
                          const float* head_re, const float* head_im,
                          const float* g2, const float* at_r,
                          const float* at_i, const __nv_bfloat16* ct,
                          void* out_r, void* out_i, int nf, int M, int K,
                          int n1, int n2, int n_shards, int n1_out,
                          cudaStream_t s) {
#define SSDR_TILE(TT)                                                       \
  return dispatch_io<TT, kSplit>(in_i16, out_bf16, out_time, x_re, x_im,    \
                                 in_scale, head_re, head_im, g2, at_r,      \
                                 at_i, ct, out_r, out_i, nf, M, K, n1, n2,  \
                                 n_shards, n1_out, s)
  switch (T) {
    case 8:
      SSDR_TILE(8);
    case 4:
      SSDR_TILE(4);
    case 2:
      SSDR_TILE(2);
    default:
      return cudaErrorInvalidValue;
  }
#undef SSDR_TILE
}

}  // namespace

extern "C" {

// Frames per block for a config and a variant (0: the stage-A output does
// not fit in shared memory). The wrapper reads it to refuse such shapes up
// front.
int channelize_fused_tile(int n1, int n2, int bf16_b, int out_time) {
  return mma_tile(n1, n2, !bf16_b, out_time != 0);
}

// x_re/x_im: [D, nf, M] float32 (in_i16 = 0) or int16 (in_i16 = 1,
// ×in_scale), D = n_shards time shards of nf frames; head_*: [D, K−1, M] f32
// history rows, each shard's own; g2: [K, M]; at_*: [n1·n1, n2];
// ct: the stage-B DFT transposed, bf16 planes [n2 (k2), n2 (j2)] — bf16_b =
// 1 (stage B on bf16 operands): re, im; bf16_b = 0 (float32 operands, each
// split in a high and a low bf16 piece, three passes): re, im high, then
// re, im low; out_*: the raw planes [D, n1_out, nf, n2], f32 or (bf16_b only)
// bf16, planes n1 … n1_out − 1 zero (out_time = 0), or the time-major
// bin-ordered planes [D, nf, M], f32 (out_time = 1, n1_out = n1: element
// (k1, t, k2) at t·M + k2·n1 + k1).
int channelize_fused_raw3(const void* x_re, const void* x_im, int in_i16,
                          float in_scale, const float* head_re,
                          const float* head_im, const float* g2,
                          const float* at_r, const float* at_i,
                          const void* ct, void* out_r, void* out_i,
                          int out_bf16, int nf, int M, int K, int n1, int n2,
                          int bf16_b, int out_time, int n_shards, int n1_out,
                          void* stream) {
  if (n1 * n2 != M || n2 % kN2Step || K < 1 || K > kKMax || nf < 1 ||
      (out_time && out_bf16) || n_shards < 1 || n_shards > 65535 ||
      n1_out < n1 || (out_time && n1_out != n1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(ct);
  const int T = mma_tile(n1, n2, !bf16_b, out_time != 0);
  if (bf16_b)
    return (int)dispatch_tile<false>(T, in_i16, out_bf16, out_time, x_re,
                                     x_im, in_scale, head_re, head_im, g2,
                                     at_r, at_i, t, out_r, out_i, nf, M, K,
                                     n1, n2, n_shards, n1_out, s);
  return (int)dispatch_tile<true>(T, in_i16, out_bf16, out_time, x_re, x_im,
                                  in_scale, head_re, head_im, g2, at_r, at_i,
                                  t, out_r, out_i, nf, M, K, n1, n2,
                                  n_shards, n1_out, s);
}

}  // extern "C"
