// Halo exchange along a time-sharded axis for Hopper (sm_90a): every shard's
// last m samples of each row land in the receive buffer of the shard `hop`
// places to its right; the first `hop` shards, which have no such neighbour,
// receive `fill` (or, on one hop, a caller-given head: the carried stream
// state that the sharded chain would otherwise select in afterwards).
//
// Replaces: supersdr_tpu/ops/pallas/halo.py::_halo_kernel (left_halo_rdma),
// the remote-DMA push that parallel/sharded_chain.py uses for the
// overlap-save history with halo_impl="rdma"; with a hop count it also
// serves ops/scans.left_context (contexts longer than one shard).
//
//   dst[p][s][r·dst_rs + j·dst_es] =
//       s ≥ hop ? src[p][s − hop][r·src_rs + (src_off + j)·src_es]
//               : head ? head[p][r·head_rs + j·head_es] : fill[p]
//   for planes p < n_planes (re and im go in one launch), shards s < D,
//   rows r < R, samples j < m.
//
// Sources and destinations are tables of per-shard base pointers, passed by
// value in the kernel's parameters (D ≤ 64), never one base plus a stride.
// In one process all D pointers point into one allocation. Across processes
// (parallel/collectives.ProcessTransport on CUDA tensors) the wrapper lengthens
// the table: virtual shards past this process's last one are the receive
// buffers of the processes to its right, mapped into this process with CUDA
// IPC (ops/cuda/peer.py), so one launch writes this process's own halos and
// pushes its tails to its neighbours. The body is the same either way. That
// transport runs with every process on one card; across cards the same
// tables would hold peer pointers over NVLink, which is not built or measured.
//
// Ordering: the TPU kernel signals a barrier to both neighbours before it
// pushes, so that a push never lands in a receive buffer that is not ready.
// In one process every source and destination lives on one card and the
// launch is ordered on the caller's stream after whatever produced the
// sources and before whatever reads the destinations: stream order is the
// barrier. Across processes CUDA IPC events and a host handshake stand in
// its place (ops/cuda/peer.py): before the push the stream waits on the
// receiver's event "done reading this buffer", the push records "pushed",
// the processes meet on the host, and each receiver's stream waits on its
// senders' "pushed" before it reads. The receive buffers alternate by call
// parity, so call k+1's push never lands on what call k has not yet read.

// What bounds it on this card: the launch. At the sharded chain's shape
// (8 rows × 8 shards × 256 samples × 2 planes of f32) it moves 0.26 MB in
// and out, ~0.1 µs at 3.35 TB/s, far under the few µs an empty launch takes.
// So the design is one launch for everything a call needs: both planes, all
// shards, the fill and the head in the same grid, by element strides on both
// sides so no .contiguous() pass and no where() pass runs around it. Threads
// walk j fastest, so a contiguous source row is read coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;
constexpr int kMaxPlanes = 2;

struct HaloTables {
  const void* src[kMaxPlanes][kMaxShards];
  void* dst[kMaxPlanes][kMaxShards];
  const void* head[kMaxPlanes];  // null: the first shards receive fill
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_kernel(HaloTables tab, int R, int m, int hop, long src_rs, long src_es,
            long src_off, long dst_rs, long dst_es, long head_rs,
            long head_es, T fill0, T fill1) {
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long)R * m) return;
  const int r = (int)(idx / m);
  const int j = (int)(idx % m);
  const int s = blockIdx.y;
  const int p = blockIdx.z;
  T v;
  if (s >= hop) {
    const T* src = static_cast<const T*>(tab.src[p][s - hop]);
    v = src[r * src_rs + (src_off + j) * src_es];
  } else if (tab.head[p] != nullptr) {
    v = static_cast<const T*>(tab.head[p])[r * head_rs + j * head_es];
  } else {
    v = p == 0 ? fill0 : fill1;
  }
  static_cast<T*>(tab.dst[p][s])[r * dst_rs + j * dst_es] = v;
}

// Nothing but the launch: chip_smoke.py times it for the kernel's bound.
__global__ void halo_empty_kernel() {}

template <typename T>
cudaError_t launch(const HaloTables& tab, int n_planes, int D, int R, int m,
                   int hop, long src_rs, long src_es, long src_off,
                   long dst_rs, long dst_es, long head_rs, long head_es,
                   T fill0, T fill1, cudaStream_t stream) {
  const dim3 grid((unsigned)(((long)R * m + kThreads - 1) / kThreads), D,
                  n_planes);
  halo_kernel<T><<<grid, kThreads, 0, stream>>>(tab, R, m, hop, src_rs,
                                                src_es, src_off, dst_rs,
                                                dst_es, head_rs, head_es,
                                                fill0, fill1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Most shards a pointer table holds (the wrapper checks D against it).
int halo_max_shards() { return kMaxShards; }

// An empty kernel on the stream: the floor under any launch on this card.
int halo_empty_launch(void* stream) {
  halo_empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// src_tab, dst_tab: host arrays of n_planes·D device pointers, plane-major
// (the base of shard s's rows in plane p at [p·D + s]); head_tab: host array
// of n_planes device pointers, or null. is_i16: elements are int16, else
// 4-byte (float32 moved as it is). Strides and src_off count elements.
// fill0 / fill1: what shards s < hop receive in plane 0 / 1 without a head
// (rounded to int16 when is_i16).
int halo_push(const void* const* src_tab, void* const* dst_tab,
              const void* const* head_tab, int n_planes, int D, int is_i16,
              int R, int m, int hop, long src_rs, long src_es, long src_off,
              long dst_rs, long dst_es, long head_rs, long head_es,
              float fill0, float fill1, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || D < 1 || D > kMaxShards ||
      R < 1 || m < 1 || hop < 1 || src_off < 0)
    return (int)cudaErrorInvalidValue;
  HaloTables tab;
  for (int p = 0; p < kMaxPlanes; ++p) {
    for (int s = 0; s < kMaxShards; ++s) {
      const bool on = p < n_planes && s < D;
      tab.src[p][s] = on ? src_tab[p * D + s] : nullptr;
      tab.dst[p][s] = on ? dst_tab[p * D + s] : nullptr;
    }
    tab.head[p] = (head_tab != nullptr && p < n_planes) ? head_tab[p] : nullptr;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_i16)
    return (int)launch<int16_t>(tab, n_planes, D, R, m, hop, src_rs, src_es,
                                src_off, dst_rs, dst_es, head_rs, head_es,
                                (int16_t)fill0, (int16_t)fill1, st);
  return (int)launch<float>(tab, n_planes, D, R, m, hop, src_rs, src_es,
                            src_off, dst_rs, dst_es, head_rs, head_es, fill0,
                            fill1, st);
}

// The receive buffers of the transport across processes (ops/cuda/peer.py):
// device memory of this library's own, so that an IPC handle names exactly
// the buffer (a pointer into the caching allocator's pool would name the
// whole pool block, at an offset the opener would have to add), and so that
// PyTorch's allocator settings (expandable segments) do not apply to it.
int peer_alloc(int device, long bytes, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, (size_t)bytes);
  return (int)err;
}

int peer_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return (int)err;
}

// Bytes of an IPC memory handle (the caller's buffer for peer_ipc_handle).
int peer_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

int peer_ipc_handle(int device, void* ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr);
  return (int)err;
}

// Opens another process's buffer (a process cannot open its own handle).
int peer_ipc_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcOpenMemHandle(
        ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
        cudaIpcMemLazyEnablePeerAccess);
  return (int)err;
}

int peer_ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return (int)err;
}

}  // extern "C"
