// Hand-written Hopper (sm_90a) kernels for the general engine's two
// hottest event blocks.  They replace the Pallas TPU kernels in
// tpu_paxos/core/simkern.py:
//
//   store_accepts  <- simkern.store_accepts (_store_kernel)
//   accum_acks     <- simkern.accum_acks    (_ack_kernel)
//
// Both are elementwise passes over the instance axis with a tiny loop
// over the proposers P and nodes A, so on the card they are bound by
// device-memory bytes (88 B/instance for the store and 96
// B/instance for the ack fold at A=5, P=2), never by operations.  The
// design follows from that: one thread per instance column (store) or
// per (proposer, instance) pair (acks), consecutive threads on
// consecutive instances so every row access is coalesced, each operand
// element read once by its thread, outputs updated in place, and the
// [P] / [P, A] scalars read from one small device array that stays in
// L1.  There is no tiling and no shape requirement: any I works, the
// ragged tail is bounds-checked.
//
// Plain C interface (built with nvcc -shared, loaded with ctypes): each
// launcher enqueues on the caller's stream, never synchronizes, and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNone = -1;  // NONE for both ballots and vids
constexpr int kThreads = 256;

// scal = [abal[P], elig[P * A]] (int32 0/1, [P, A] row-major).
// acc_ballot/acc_vid/learned [A, I], abat [P, I], all int32.
__global__ void store_accepts_kernel(int32_t* __restrict__ acc_ballot,
                                     int32_t* __restrict__ acc_vid,
                                     const int32_t* __restrict__ learned,
                                     const int32_t* __restrict__ abat,
                                     const int32_t* __restrict__ scal,
                                     int A, int P, long long I) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I) return;
  for (int a = 0; a < A; ++a) {
    long long k = (long long)a * I + i;
    int32_t ab = acc_ballot[k];
    int32_t lr = learned[k];
    bool is_comm = lr != kNone;
    int32_t best_b = kNone;
    int32_t best_v = kNone;
    for (int p = 0; p < P; ++p) {
      int32_t batp = abat[(long long)p * I + i];
      int32_t abal_p = scal[p];
      bool elig = scal[P + p * A + a] != 0;
      bool store_ok = is_comm ? (batp == lr) : (abal_p >= ab);
      bool ack = elig && batp != kNone && store_ok;
      int32_t cand = (ack && !is_comm) ? abal_p : kNone;
      if (cand > best_b) {
        best_b = cand;
        best_v = batp;
      }
    }
    if (best_b != kNone) {
      acc_ballot[k] = best_b;
      acc_vid[k] = best_v;
    }
  }
}

// scal = [ballot[P], amatch[P * A]] (int32 0/1, [P, A] row-major).
// acks [P, A, I] int8 0/1 (in place), n_ack [P, I] int32 (written),
// cur_batch [P, I], acc_ballot/acc_vid/learned [A, I], all int32.
__global__ void accum_acks_kernel(int8_t* __restrict__ acks,
                                  int32_t* __restrict__ n_ack,
                                  const int32_t* __restrict__ cur_batch,
                                  const int32_t* __restrict__ acc_ballot,
                                  const int32_t* __restrict__ acc_vid,
                                  const int32_t* __restrict__ learned,
                                  const int32_t* __restrict__ scal,
                                  int A, int P, long long I) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int p = blockIdx.y;
  if (i >= I) return;
  int32_t cb = cur_batch[(long long)p * I + i];
  int32_t ballot_p = scal[p];
  int32_t n = 0;
  for (int a = 0; a < A; ++a) {
    long long k = (long long)a * I + i;
    long long c = ((long long)p * A + a) * I + i;
    int8_t ak = acks[c];
    if (scal[P + p * A + a] != 0 && cb != kNone) {
      int32_t lr = learned[k];
      bool hold = acc_vid[k] == cb && acc_ballot[k] == ballot_p;
      bool comm = lr == cb && lr != kNone;
      if (hold || comm) {
        ak = (int8_t)(ak | 1);
        acks[c] = ak;
      }
    }
    n += ak;
  }
  n_ack[(long long)p * I + i] = n;
}

}  // namespace

extern "C" {

int simkern_store_accepts(void* acc_ballot, void* acc_vid, const void* learned,
                          const void* abat, const void* scal, int A, int P,
                          long long I, void* stream) {
  if (I > 0 && A > 0) {
    dim3 grid((unsigned)((I + kThreads - 1) / kThreads));
    store_accepts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (int32_t*)acc_ballot, (int32_t*)acc_vid, (const int32_t*)learned,
        (const int32_t*)abat, (const int32_t*)scal, A, P, I);
  }
  return (int)cudaGetLastError();
}

int simkern_accum_acks(void* acks, void* n_ack, const void* cur_batch,
                       const void* acc_ballot, const void* acc_vid,
                       const void* learned, const void* scal, int A, int P,
                       long long I, void* stream) {
  if (I > 0 && P > 0) {
    dim3 grid((unsigned)((I + kThreads - 1) / kThreads), (unsigned)P);
    accum_acks_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (int8_t*)acks, (int32_t*)n_ack, (const int32_t*)cur_batch,
        (const int32_t*)acc_ballot, (const int32_t*)acc_vid,
        (const int32_t*)learned, (const int32_t*)scal, A, P, I);
  }
  return (int)cudaGetLastError();
}

const char* simkern_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
