// Hand-written Hopper (sm_90a) kernels for the general engine's two
// hottest event blocks.  They replace the Pallas TPU kernels in
// tpu_paxos/core/simkern.py:
//
//   store_accepts  <- simkern.store_accepts (_store_kernel)
//   accum_acks     <- simkern.accum_acks    (_ack_kernel)
//
// Both are elementwise passes over the instance axis with a tiny loop
// over the proposers P and nodes A, so on the card they are bound by
// device-memory bytes, never by operations: dense operands need 88
// B/instance for the store and 96 B/instance for the ack fold at A=5,
// P=2 (simkern.bytes_per_launch), against a handful of integer compares.
//
// store_accepts, per (a, i): the highest abal[p] over the proposers p
// with elig[p, a], abat[p, i] != NONE, learned[a, i] == NONE and
// abal[p] >= acc_ballot[a, i] is stored in acc_ballot, that proposer's
// batch in acc_vid (ties to the first p; a NONE ballot never stores).
// A real round's batches live on one assignment window per proposer, a
// quarter of the instances or less, so the bytes it needs are the batch
// rows and a few acceptor sectors (simkern.bytes_needed), and the
// design reads only those:
// - One thread per group of 4 consecutive instances over all proposers:
//   each batch row is read once as a 16-byte vector, not once per
//   acceptor.
// - Batch row p is read only if elig[p, :] has a true (the same test in
//   every thread, so it costs no divergence); acceptor row a of a group
//   (learned, acc_ballot) only if some p with elig[p, a] has a batch in
//   the group.  Batches sit in contiguous windows, so whole warps skip.
// - Batch rows are streamed (__ldcs, evict first): read once, they
//   should not push out of L2 what other launches reuse.
// - A and P are template parameters for the bench shape (5, 2).  A
//   group's acceptor rows are taken one at a time, so few registers
//   are live and many threads are in flight, each with one or two row
//   streams open.  acc_ballot is loaded after learned, and only where a
//   lane with an eligible batch has not learned (the bytes_needed
//   rule): timed in turns, that ties with loading both together on the
//   main path's operands and is 1% faster on dense ones.  Loading all
//   needed rows first (78 registers) or 2 or 4 groups a thread were
//   slower (scripts/torch_simkern_ab.py; PERF.md).  Other shapes take
//   the run-time-loop instantiation (A = P = 0).
// - Only the lanes that store are written: one 16-byte store per row
//   where all 4 do, per-lane stores elsewhere.  acc_vid is never read.
// - abal [P] int32 and elig [P, A] bool (one byte each) are read
//   straight from the caller's tensors: one launch per call.
// - A scalar path (groups of one instance) takes I % 4 != 0 and rows
//   that are not 16-byte aligned; any I works, the tail is
//   bounds-checked.
//
// accum_acks, per (p, a, i):
//   acks[p, a, i] |= amatch[p, a] & cb[p, i] != NONE & (hold | comm)
//   n_ack[p, i]    = sum_a acks[p, a, i]
// Its bytes are the three [A, I] acceptor arrays (60 of the 96 B), so
// the design reads each acceptor word once and only where it is needed:
// - One thread per group of 4 consecutive instances over all P
//   proposers: each acceptor word of the group is read once (not once
//   per proposer) as a 16-byte vector, each proposer's cur_batch as a
//   16-byte vector, each (p, a) row of the int8 ack cube as one 4-byte
//   word that is written back only where a bit changed, and n_ack as
//   16-byte vectors.
// - A and P are template parameters for the bench shape (5, 2): the
//   loops unroll and every load of a group is issued before the first
//   compare, so each thread has about twenty loads in flight (1.31x
//   faster than the run-time loop on dense operands, 1.03x on the main
//   path's, scripts/torch_simkern_ab.py).  Other shapes run the same
//   kernel with A = P = 0, which loops at run time over proposers, then
//   acceptors.
// - Acceptor row a of a group is loaded only if some proposer p with
//   amatch[p, a] has a batch in the group, so a round whose instances
//   mostly carry no batch reads cur_batch and the ack cube and writes
//   n_ack, and little else.  Skipping also the rows whose acks are all
//   in the cube already would save more bytes (simkern.bytes_needed
//   counts them), but it makes the acceptor loads wait for the cube
//   words: measured, that is slower on both operand sets.
// - A scalar path (groups of one instance, byte-wide acks) takes
//   I % 4 != 0 and rows that are not 16-byte aligned; any I works, the
//   tail is bounds-checked.
// - ballot [P] int32 and amatch [P, A] bool are read straight from the
//   caller's tensors, as in the store: one launch per call.
// No shared memory, no TMA, no tensor cores in either kernel: nothing is
// reused across threads, the loads are already 16 bytes wide and all in
// flight together, and the work is a few integer compares per word.
//
// Lanes.  A fleet runs nL independent simulations in one round, every
// operand stacked on a leading lane axis ([nL, A, I], [nL, P], ...), and
// each kernel covers all of them in one launch.  Where a lane has fewer
// groups than a block has threads, thread t of the whole grid takes group
// t % groups of lane t / groups, so (lane, group) pairs spread over every
// block: a fleet lane of 56 instances is 14 groups, and one block per
// lane would leave most of its threads idle.  Lanes of more groups each
// take a row of the y-grid (blockIdx.y is the lane).  A single lane (the
// single run) is offset by nothing: timed in turns, the lane offsets
// alone (held in registers, 12 more in the store) cost the main path's
// short store launches 2-4 us each (PERF.md).  Offsets are
// 64-bit; a lane's rows start A * I or P * I elements after the previous
// lane's, so with I % 4 == 0 and aligned bases every lane takes the
// vector path, and otherwise every lane takes the scalar one.  A lane
// that must not change (a finished one) comes with elig or amatch all
// false: the store then writes nothing there and the fold changes no
// ack (it still writes the lane's n_ack).  At one lane the launch is
// the single run's.
//
// Plain C interface (built with nvcc -shared, loaded with ctypes): each
// launcher enqueues on the caller's stream, never synchronizes, and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNone = -1;  // NONE for both ballots and vids
constexpr int kThreads = 256;

// A group of instances: 4 on the vector path, 1 on the scalar path.
template <bool kVec>
struct Group {
  static constexpr int L = kVec ? 4 : 1;

  // the group's int32 lanes of a row that is read-only in the kernel
  __device__ static void load(const int32_t* row, long long i, int32_t (&v)[L]) {
    if constexpr (kVec) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(row + i));
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      v[0] = __ldg(row + i);
    }
  }

  // the same, streamed (evict first): a row read once in the launch
  __device__ static void load_stream(const int32_t* row, long long i, int32_t (&v)[L]) {
    if constexpr (kVec) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(row + i));
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      v[0] = __ldcs(row + i);
    }
  }

  // the same for a row the kernel also writes (no read-only cache)
  __device__ static void load_rw(const int32_t* row, long long i, int32_t (&v)[L]) {
    if constexpr (kVec) {
      const int4 x = *reinterpret_cast<const int4*>(row + i);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      v[0] = row[i];
    }
  }

  __device__ static void store(int32_t* row, long long i, const int32_t (&v)[L]) {
    if constexpr (kVec) {
      *reinterpret_cast<int4*>(row + i) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      row[i] = v[0];
    }
  }

  // the lanes j with bit j of m set: one vector store if all are
  __device__ static void store_lanes(int32_t* row, long long i, const int32_t (&v)[L],
                                     unsigned m) {
    if (m == (1u << L) - 1) {
      store(row, i, v);
      return;
    }
#pragma unroll
    for (int j = 0; j < L; ++j)
      if ((m >> j) & 1u) row[i + j] = v[j];
  }

  // the group's int8 acks of one (p, a) row, byte j in bits 8j..8j+7
  __device__ static uint32_t load_acks(const int8_t* row, long long i) {
    if constexpr (kVec) {
      return *reinterpret_cast<const uint32_t*>(row + i);
    } else {
      return (uint8_t)row[i];
    }
  }

  __device__ static void store_acks(int8_t* row, long long i, uint32_t w) {
    if constexpr (kVec) {
      *reinterpret_cast<uint32_t*>(row + i) = w;
    } else {
      row[i] = (int8_t)(uint8_t)w;
    }
  }
};

// How a launch maps threads to lanes.  kOne: a single lane, the grid
// covers its groups and nothing is offset (the single run's launch, with
// the one-run kernel's registers).  kRows: blockIdx.y is the lane and the x-grid covers
// its groups.  kFlat: thread t of the whole grid takes group t % groups
// of lane t / groups, so lanes of a few groups share blocks.
enum LaneMode { kOne = 0, kRows = 1, kFlat = 2 };

// This thread's lane and the first instance of its group, or false if
// it has none.  Groups never straddle a lane: no partial group.
template <int kMode>
__device__ __forceinline__ bool lane_group(unsigned groups, unsigned threads, unsigned& lane,
                                           long long& i, int width) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kMode == kFlat) {
    if (t >= threads) return false;
    lane = t / groups;
    i = (long long)(t - lane * groups) * width;
  } else {
    if (t >= groups) return false;
    lane = kMode == kRows ? blockIdx.y : 0;
    i = (long long)t * width;
  }
  return true;
}

// One acceptor row's store for a group: folds proposer p's candidate
// (ballot bal, batches bt, eligible el) into the best ballot and batch
// per lane.  learned != NONE never stores, so the plain version's
// batch == learned test cannot change the result and is left out.
template <int L>
__device__ __forceinline__ void fold_store(int32_t (&bb)[L], int32_t (&bv)[L], bool el,
                                           int32_t bal, const int32_t (&bt)[L],
                                           const int32_t (&ab)[L], const int32_t (&lr)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (el && bt[j] != kNone && lr[j] == kNone && bal >= ab[j] && bal > bb[j]) {
      bb[j] = bal;
      bv[j] = bt[j];
    }
  }
}

template <int L>
__device__ __forceinline__ unsigned storing_lanes(const int32_t (&bb)[L]) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) m |= (unsigned)(bb[j] != kNone) << j;
  return m;
}

// acc_ballot/acc_vid [nL, A, I] (in place), learned [nL, A, I], abat
// [nL, P, I], all int32; abal [nL, P] int32, elig [nL, P, A] bool bytes,
// row-major, nL lanes.  Thread t takes group t % groups of lane
// t / groups.  kA = kP = 0 takes A and P at run time.
template <int kA, int kP, bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads)
    store_accepts_kernel(int32_t* __restrict__ acc_ballot, int32_t* __restrict__ acc_vid,
                         const int32_t* __restrict__ learned,
                         const int32_t* __restrict__ abat,
                         const int32_t* __restrict__ abal,
                         const uint8_t* __restrict__ elig, int A_rt, int P_rt,
                         long long I, unsigned groups, unsigned threads) {
  using G = Group<kVec>;
  constexpr int L = G::L;
  unsigned lane;
  long long i;
  if (!lane_group<kMode>(groups, threads, lane, i, L)) return;
  if constexpr (kMode != kOne) {
    const int A = kA > 0 ? kA : A_rt;
    const int P = kP > 0 ? kP : P_rt;
    acc_ballot += (long long)lane * A * I;
    acc_vid += (long long)lane * A * I;
    learned += (long long)lane * A * I;
    abat += (long long)lane * P * I;
    abal += (long long)lane * P;
    elig += (long long)lane * P * A;
  }

  if constexpr (kA > 0) {
    constexpr int A = kA;
    constexpr int P = kP;
    // 1. The scalars, and the batches of every proposer some acceptor
    //    takes (the same rows in every thread), streamed: read once.
    int32_t ballot[P];
    bool el[P][A];
    int32_t bt[P][L];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ballot[p] = __ldg(abal + p);
      bool row = false;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        el[p][a] = __ldg(elig + p * A + a) != 0;
        row |= el[p][a];
      }
      if (row) {
        G::load_stream(abat + p * I, i, bt[p]);
      } else {
#pragma unroll
        for (int j = 0; j < L; ++j) bt[p][j] = kNone;
      }
    }

    // 2. The acceptor rows some eligible proposer has a batch for.
    unsigned need = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      bool live = false;
#pragma unroll
      for (int j = 0; j < L; ++j) live |= bt[p][j] != kNone;
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (live && el[p][a]) need |= 1u << a;
    }
    if (need == 0) return;

    // 3. Each such row in turn: load learned, then acc_ballot if a lane
    //    with an eligible batch has not learned, fold over the
    //    proposers, store the lanes that take a batch.
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (!((need >> a) & 1u)) continue;
      int32_t lr[L], ab[L];
      G::load(learned + a * I, i, lr);
      bool open = false;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        bool batch = false;
#pragma unroll
        for (int p = 0; p < P; ++p) batch |= el[p][a] && bt[p][j] != kNone;
        open |= batch && lr[j] == kNone;
      }
      if (!open) continue;  // no lane can store
      G::load_rw(acc_ballot + a * I, i, ab);
      int32_t bb[L], bv[L];
#pragma unroll
      for (int j = 0; j < L; ++j) bb[j] = bv[j] = kNone;
#pragma unroll
      for (int p = 0; p < P; ++p) fold_store<L>(bb, bv, el[p][a], ballot[p], bt[p], ab, lr);
      const unsigned m = storing_lanes<L>(bb);
      if (m) {
        G::store_lanes(acc_ballot + a * I, i, bb, m);
        G::store_lanes(acc_vid + a * I, i, bv, m);
      }
    }
  } else {
    // Any A and P: acceptors, then proposers, at run time (a batch row
    // is read again per acceptor, from the cache).
    const int A = A_rt;
    const int P = P_rt;
    for (int a = 0; a < A; ++a) {
      bool live = false;
      for (int p = 0; p < P && !live; ++p) {
        if (__ldg(elig + p * A + a) == 0) continue;
        int32_t bt[L];
        G::load(abat + (long long)p * I, i, bt);
#pragma unroll
        for (int j = 0; j < L; ++j) live |= bt[j] != kNone;
      }
      if (!live) continue;
      int32_t lr[L], ab[L];
      G::load(learned + (long long)a * I, i, lr);
      G::load_rw(acc_ballot + (long long)a * I, i, ab);
      int32_t bb[L], bv[L];
#pragma unroll
      for (int j = 0; j < L; ++j) bb[j] = bv[j] = kNone;
      for (int p = 0; p < P; ++p) {
        const bool el = __ldg(elig + p * A + a) != 0;
        if (!el) continue;
        int32_t bt[L];
        G::load(abat + (long long)p * I, i, bt);
        fold_store<L>(bb, bv, el, __ldg(abal + p), bt, ab, lr);
      }
      const unsigned m = storing_lanes<L>(bb);
      if (m) {
        G::store_lanes(acc_ballot + (long long)a * I, i, bb, m);
        G::store_lanes(acc_vid + (long long)a * I, i, bv, m);
      }
    }
  }
}

// The ack bits one acceptor's state certifies for one proposer's
// batches (amatch applied by the caller): 1 in byte j where lane j
// holds or has learned the batch.
template <int L>
__device__ __forceinline__ uint32_t new_acks(const int32_t (&cb)[L], int32_t ballot,
                                             const int32_t (&ab)[L],
                                             const int32_t (&av)[L],
                                             const int32_t (&lr)[L]) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const bool hold = av[j] == cb[j] && ab[j] == ballot;
    const bool comm = lr[j] == cb[j] && lr[j] != kNone;
    if (cb[j] != kNone && (hold || comm)) bits |= 1u << (8 * j);
  }
  return bits;
}

template <int L>
__device__ __forceinline__ void add_acks(int32_t (&n)[L], uint32_t w) {
#pragma unroll
  for (int j = 0; j < L; ++j) n[j] += (int8_t)(uint8_t)(w >> (8 * j));
}

// acks [nL, P, A, I] int8 0/1 (in place), n_ack [nL, P, I] int32
// (written), cur_batch [nL, P, I], acc_ballot/acc_vid/learned [nL, A, I],
// all int32; ballot [nL, P] int32, amatch [nL, P, A] bool bytes,
// row-major, nL lanes.  Thread t takes group t % groups of lane
// t / groups.  kA = kP = 0 takes A and P at run time.
template <int kA, int kP, bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads)
    accum_acks_kernel(int8_t* __restrict__ acks, int32_t* __restrict__ n_ack,
                      const int32_t* __restrict__ cur_batch,
                      const int32_t* __restrict__ acc_ballot,
                      const int32_t* __restrict__ acc_vid,
                      const int32_t* __restrict__ learned,
                      const int32_t* __restrict__ ballots,
                      const uint8_t* __restrict__ amatch, int A_rt, int P_rt,
                      long long I, unsigned groups, unsigned threads) {
  using G = Group<kVec>;
  constexpr int L = G::L;
  unsigned lane;
  long long i;
  if (!lane_group<kMode>(groups, threads, lane, i, L)) return;
  if constexpr (kMode != kOne) {
    const int A = kA > 0 ? kA : A_rt;
    const int P = kP > 0 ? kP : P_rt;
    acks += (long long)lane * P * A * I;
    n_ack += (long long)lane * P * I;
    cur_batch += (long long)lane * P * I;
    acc_ballot += (long long)lane * A * I;
    acc_vid += (long long)lane * A * I;
    learned += (long long)lane * A * I;
    ballots += (long long)lane * P;
    amatch += (long long)lane * P * A;
  }

  if constexpr (kA > 0) {
    constexpr int A = kA;
    constexpr int P = kP;
    // 1. The loads every group needs: the batches and the ack words.
    int32_t cb[P][L];
    uint32_t ak[P][A];
#pragma unroll
    for (int p = 0; p < P; ++p) G::load(cur_batch + p * I, i, cb[p]);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int a = 0; a < A; ++a) ak[p][a] = G::load_acks(acks + (p * A + a) * I, i);

    // 2. The scalars, and the acceptor rows some live proposer needs.
    int32_t ballot[P];
    bool am[P][A];
    unsigned need = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ballot[p] = __ldg(ballots + p);
      bool live = false;
#pragma unroll
      for (int j = 0; j < L; ++j) live |= cb[p][j] != kNone;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        am[p][a] = __ldg(amatch + p * A + a) != 0;
        if (live && am[p][a]) need |= 1u << a;
      }
    }

    // 3. Those rows, all issued before the first compare.
    int32_t ab[A][L], av[A][L], lr[A][L];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if ((need >> a) & 1u) {
        G::load(acc_ballot + a * I, i, ab[a]);
        G::load(acc_vid + a * I, i, av[a]);
        G::load(learned + a * I, i, lr[a]);
      } else {  // no live proposer reads them: any value will do
#pragma unroll
        for (int j = 0; j < L; ++j) ab[a][j] = av[a][j] = lr[a][j] = kNone;
      }
    }

    // 4. Fold, count, and write back the words that changed.
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int32_t n[L] = {};
#pragma unroll
      for (int a = 0; a < A; ++a) {
        uint32_t w = ak[p][a];
        if (am[p][a]) w |= new_acks<L>(cb[p], ballot[p], ab[a], av[a], lr[a]);
        if (w != ak[p][a]) G::store_acks(acks + (p * A + a) * I, i, w);
        add_acks<L>(n, w);
      }
      G::store(n_ack + p * I, i, n);
    }
  } else {
    // Any A and P: proposers, then acceptors, at run time.
    const int A = A_rt;
    const int P = P_rt;
    for (int p = 0; p < P; ++p) {
      int32_t cb[L];
      G::load(cur_batch + p * I, i, cb);
      bool live = false;
#pragma unroll
      for (int j = 0; j < L; ++j) live |= cb[j] != kNone;
      const int32_t ballot = __ldg(ballots + p);
      int32_t n[L] = {};
      for (int a = 0; a < A; ++a) {
        const long long c = ((long long)p * A + a) * I;
        uint32_t w = G::load_acks(acks + c, i);
        if (live && __ldg(amatch + p * A + a) != 0) {
          int32_t ab[L], av[L], lr[L];
          G::load(acc_ballot + a * I, i, ab);
          G::load(acc_vid + a * I, i, av);
          G::load(learned + a * I, i, lr);
          const uint32_t nw = w | new_acks<L>(cb, ballot, ab, av, lr);
          if (nw != w) {
            G::store_acks(acks + c, i, nw);
            w = nw;
          }
        }
        add_acks<L>(n, w);
      }
      G::store(n_ack + p * I, i, n);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// The launch shape for nL lanes of `groups` groups (LaneMode), or a zero
// grid where the lanes do not fit one.
struct LaneGrid {
  int mode;
  dim3 grid;
  unsigned threads;  // the flat grid's (lane, group) count
};

LaneGrid lane_grid(int nL, unsigned groups) {
  if (nL == 1) return {kOne, dim3((groups + kThreads - 1) / kThreads), groups};
  if (groups < (unsigned)kThreads) {
    const long long threads = (long long)groups * nL;
    if (threads > 0x7fffffffLL) return {kFlat, dim3(0), 0};
    return {kFlat, dim3((unsigned)((threads + kThreads - 1) / kThreads)), (unsigned)threads};
  }
  if (nL > 65535) return {kRows, dim3(0), 0};
  return {kRows, dim3((groups + kThreads - 1) / kThreads, (unsigned)nL), 0};
}

template <int kA, int kP, bool kVec>
void launch_store(void* acc_ballot, void* acc_vid, const void* learned, const void* abat,
                  const void* abal, const void* elig, int A, int P, long long I,
                  unsigned groups, const LaneGrid& g, cudaStream_t s) {
  auto kernel = g.mode == kOne    ? store_accepts_kernel<kA, kP, kVec, kOne>
                : g.mode == kRows ? store_accepts_kernel<kA, kP, kVec, kRows>
                                  : store_accepts_kernel<kA, kP, kVec, kFlat>;
  kernel<<<g.grid, kThreads, 0, s>>>(
      (int32_t*)acc_ballot, (int32_t*)acc_vid, (const int32_t*)learned,
      (const int32_t*)abat, (const int32_t*)abal, (const uint8_t*)elig, A, P, I, groups,
      g.threads);
}

template <int kA, int kP, bool kVec>
void launch_acks(void* acks, void* n_ack, const void* cur_batch, const void* acc_ballot,
                 const void* acc_vid, const void* learned, const void* ballot,
                 const void* amatch, int A, int P, long long I, unsigned groups,
                 const LaneGrid& g, cudaStream_t s) {
  auto kernel = g.mode == kOne    ? accum_acks_kernel<kA, kP, kVec, kOne>
                : g.mode == kRows ? accum_acks_kernel<kA, kP, kVec, kRows>
                                  : accum_acks_kernel<kA, kP, kVec, kFlat>;
  kernel<<<g.grid, kThreads, 0, s>>>(
      (int8_t*)acks, (int32_t*)n_ack, (const int32_t*)cur_batch,
      (const int32_t*)acc_ballot, (const int32_t*)acc_vid, (const int32_t*)learned,
      (const int32_t*)ballot, (const uint8_t*)amatch, A, P, I, groups, g.threads);
}

}  // namespace

extern "C" {

// Every lane's rows are 16-byte aligned when the bases are and I % 4 == 0
// (a lane starts A * I or P * I elements after the previous one).
int simkern_store_accepts(void* acc_ballot, void* acc_vid, const void* learned,
                          const void* abat, const void* abal, const void* elig,
                          int nL, int A, int P, long long I, void* stream) {
  if (nL > 0 && I > 0 && A > 0 && P > 0) {
    const bool vec = (I & 3) == 0 && aligned(acc_ballot, 16) && aligned(acc_vid, 16) &&
                     aligned(learned, 16) && aligned(abat, 16);
    const long long groups = vec ? I / 4 : I;
    if (groups > 0xffffffffLL) return (int)cudaErrorInvalidValue;
    const LaneGrid g = lane_grid(nL, (unsigned)groups);
    if (g.grid.x == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    auto launch = A == 5 && P == 2 ? (vec ? launch_store<5, 2, true> : launch_store<5, 2, false>)
                                   : (vec ? launch_store<0, 0, true> : launch_store<0, 0, false>);
    launch(acc_ballot, acc_vid, learned, abat, abal, elig, A, P, I, (unsigned)groups, g, s);
  }
  return (int)cudaGetLastError();
}

int simkern_accum_acks(void* acks, void* n_ack, const void* cur_batch,
                       const void* acc_ballot, const void* acc_vid,
                       const void* learned, const void* ballot, const void* amatch,
                       int nL, int A, int P, long long I, void* stream) {
  if (nL > 0 && I > 0 && P > 0) {
    // every row 16-byte aligned (4 for the int8 cube) when I % 4 == 0
    const bool vec = (I & 3) == 0 && aligned(acks, 4) && aligned(n_ack, 16) &&
                     aligned(cur_batch, 16) && aligned(acc_ballot, 16) &&
                     aligned(acc_vid, 16) && aligned(learned, 16);
    const long long groups = vec ? I / 4 : I;
    if (groups > 0xffffffffLL) return (int)cudaErrorInvalidValue;
    const LaneGrid g = lane_grid(nL, (unsigned)groups);
    if (g.grid.x == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    auto launch = A == 5 && P == 2 ? (vec ? launch_acks<5, 2, true> : launch_acks<5, 2, false>)
                                   : (vec ? launch_acks<0, 0, true> : launch_acks<0, 0, false>);
    launch(acks, n_ack, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch, A, P, I,
           (unsigned)groups, g, s);
  }
  return (int)cudaGetLastError();
}

const char* simkern_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
