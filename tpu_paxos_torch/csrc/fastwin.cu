// Hand-written Hopper (sm_90a) kernel for the fast path's steady-state
// accept+learn window.  It replaces the Pallas TPU kernel
// tpu_paxos/core/fastwin.py:57-229 (steady_state_windows_fused, bodies
// _window_body / _window_kernel / _window_kernel_iota).
//
// One launch computes one window k of one prepared proposer's batched
// accept + commit over I fresh instances:
//
//   vid[i]           = prepared ? vids0[i] + k*span : NONE
//                      (iota variant: i + k*span, vids0 never read)
//   acc_ballot[a, i] = ok[a] & vid != NONE ? ballot : NONE
//   acc_vid[a, i]    = ok[a] & vid != NONE ? vid    : NONE
//   learned[a, i]    = chosen & vid != NONE ? vid   : NONE
//   counts[k]       += #{i : chosen & vid != NONE}
//
// where ballot/span/prepared/chosen/ok[A] are the phase-1/phase-2
// decisions, read from one small int32 array (scal) that the wrapper
// fills on the device.  vids0 + k*span is computed in uint32 and cast
// back: it wraps as JAX's int32 add does (signed overflow is undefined
// in C++).
//
// What bounds it: it is a store-only pass, 3*A*4 bytes written per
// instance and window (60 B at A=5; plus 4 B read for explicit vids)
// against a handful of integer operations, so on the card it is bound
// by device-memory bytes.  The design follows from that: consecutive
// threads on consecutive instances, 16-byte vector stores where every
// row is 16-byte aligned (a scalar path otherwise), streaming stores
// (st.global.cs) since nothing reads the state back in the window, and
// the chosen count reduced in registers (warp shuffles), then once per
// block in shared memory, with a single atomicAdd per block into
// counts[k].  wgmma and TMA have no role in a pass with no loads to
// stage and no products.
//
// Windows are ordered by the stream: the wrapper launches one kernel
// per window, so window k+1's stores reach a cell after window k's, and
// every window's stores are real (no compiler can fold stores across
// launches, and 3*A*I*4 bytes per window is far past the 50 MB L2 at
// the bench size, so each window's writes go to device memory).
//
// Plain C interface (built with nvcc -shared, loaded with ctypes): the
// launcher enqueues on the caller's stream, never synchronizes, and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNone = -1;  // NONE for both ballots and vids
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 8192;  // grid-stride cap: bounds the atomics

// scal = [ballot, span, prepared, chosen, ok[0..A-1]] (int32, 0/1 flags).
template <bool kIota, bool kVec>
__global__ void window_kernel(int32_t* __restrict__ acc_ballot,
                              int32_t* __restrict__ acc_vid,
                              int32_t* __restrict__ learned,
                              const int32_t* __restrict__ vids0,
                              const int32_t* __restrict__ scal,
                              int32_t* __restrict__ count, int A,
                              long long I, unsigned k) {
  const int32_t ballot = scal[0];
  const uint32_t offset = k * (uint32_t)scal[1];
  const bool prepared = scal[2] != 0;
  const bool chosen = scal[3] != 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int n = 0;
  if (kVec) {
    const long long n4 = I >> 2;
    for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         q < n4; q += stride) {
      int v[4];
      if (kIota) {
        const uint32_t i0 = (uint32_t)(q << 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = (int32_t)(i0 + j + offset);
      } else {
        const int4 b = __ldcs(reinterpret_cast<const int4*>(vids0) + q);
        v[0] = (int32_t)((uint32_t)b.x + offset);
        v[1] = (int32_t)((uint32_t)b.y + offset);
        v[2] = (int32_t)((uint32_t)b.z + offset);
        v[3] = (int32_t)((uint32_t)b.w + offset);
      }
      int4 ab, av, lr;
      int* pab = &ab.x;
      int* pav = &av.x;
      int* plr = &lr.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t vid = prepared ? v[j] : kNone;
        const bool has = vid != kNone;
        pab[j] = has ? ballot : kNone;
        pav[j] = vid;
        plr[j] = chosen ? vid : kNone;
        n += (chosen && has) ? 1 : 0;
      }
      const int4 none = make_int4(kNone, kNone, kNone, kNone);
      for (int a = 0; a < A; ++a) {
        const bool ok = scal[4 + a] != 0;
        const long long row = (long long)a * (I >> 2) + q;
        __stcs(reinterpret_cast<int4*>(acc_ballot) + row, ok ? ab : none);
        __stcs(reinterpret_cast<int4*>(acc_vid) + row, ok ? av : none);
        __stcs(reinterpret_cast<int4*>(learned) + row, lr);
      }
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < I; i += stride) {
      uint32_t base = kIota ? (uint32_t)i : (uint32_t)__ldcs(vids0 + i);
      const int32_t vid = prepared ? (int32_t)(base + offset) : kNone;
      const bool has = vid != kNone;
      const int32_t lr = chosen ? vid : kNone;
      n += (chosen && has) ? 1 : 0;
      for (int a = 0; a < A; ++a) {
        const bool ok = scal[4 + a] != 0;
        const long long c = (long long)a * I + i;
        __stcs(acc_ballot + c, (ok && has) ? ballot : kNone);
        __stcs(acc_vid + c, ok ? vid : kNone);
        __stcs(learned + c, lr);
      }
    }
  }
  // Block reduction of the chosen count: warp shuffles, then one slot
  // per warp in shared memory, then one atomicAdd per block.
  __shared__ int warp_sums[kWarps];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) n += __shfl_down_sync(0xffffffffu, n, s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    if (total) atomicAdd(count, total);
  }
}

template <bool kIota, bool kVec>
void launch(void* acc_ballot, void* acc_vid, void* learned, const void* vids0,
            const void* scal, void* count, int A, long long I, unsigned k,
            cudaStream_t stream) {
  const long long items = kVec ? (I >> 2) : I;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  window_kernel<kIota, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (int32_t*)acc_ballot, (int32_t*)acc_vid, (int32_t*)learned,
      (const int32_t*)vids0, (const int32_t*)scal, (int32_t*)count, A, I, k);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// One window k.  vids0 == nullptr selects the iota variant; count
// points at counts[k], zeroed by the caller.
int fastwin_window(void* acc_ballot, void* acc_vid, void* learned,
                   const void* vids0, const void* scal, void* count, int A,
                   long long I, int k, void* stream) {
  if (I > 0 && A > 0) {
    const bool iota = vids0 == nullptr;
    const bool vec = (I & 3) == 0 && aligned16(acc_ballot) &&
                     aligned16(acc_vid) && aligned16(learned) &&
                     (iota || aligned16(vids0));
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned kk = (unsigned)k;
    if (iota && vec)
      launch<true, true>(acc_ballot, acc_vid, learned, vids0, scal, count, A, I, kk, s);
    else if (iota)
      launch<true, false>(acc_ballot, acc_vid, learned, vids0, scal, count, A, I, kk, s);
    else if (vec)
      launch<false, true>(acc_ballot, acc_vid, learned, vids0, scal, count, A, I, kk, s);
    else
      launch<false, false>(acc_ballot, acc_vid, learned, vids0, scal, count, A, I, kk, s);
  }
  return (int)cudaGetLastError();
}

const char* fastwin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
