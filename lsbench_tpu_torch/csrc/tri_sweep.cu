// Sparse triangular sweeps for NVIDIA Hopper (sm_90a), bound to Python with
// ctypes (lsbench_tpu_torch/ops/_cuda.py builds this file with nvcc; the
// wrapper, the launch plan and the plain PyTorch version are in
// lsbench_tpu_torch/ops/tri_sweep.py).
//
//   The kernels compute one sweep of
//   lsbench_tpu/solvers/sparse_cholesky.py::_sweep (an XLA lax.scan over
//   dependency levels, no Pallas kernel):
//       x_i = (b_i - sum_j L_ij * x_j) * dinv_i
//   for every row i, j over the row's strictly-lower entries (forward) or
//   over the transposed rows (backward), dinv = 1 / diag(L), for up to
//   kMaxCols columns of b at once. The IC(0) preconditioner and
//   sparse_cholesky's `level` schedule apply one forward and one backward
//   sweep.
//
// Layout (TriSweep, ops/tri_sweep.py), in position space: rows in
// dependency-level order.
//   perm     (n,) int32       row at position p
//   offs     (n + 1,) int64   entries of position p at offs[p] .. offs[p+1]
//   ioffs    (n,) int64       the first entry a run sums of position p (past
//                             those its pre-pass summed; offs[p] elsewhere)
//   cols     (nnz,) int32     the POSITION of the row each entry depends on,
//                             always in an earlier level; ascending in a row
//   vals     (nnz,) T         L_ij
//   dinv     (n,) T           1 / L_ii, by position
//   pslot, pvals (n, 2)       a pair run's rows: their two entries by
//                             position, columns as ring slots (pair kernel)
//   lvl_offs (nlev + 1,) int64  positions of level l: lvl_offs[l] .. [l+1]
//   lvl_lg   (nlev,) int8     log2 of the lanes G that sum one row of level l
//   b, x     (n, ld) T        by row, row-major; a launch takes kc <= 8
//                             columns starting at the pointers it is given
//   xpos     (n, ld) T        x by position: what later levels read
//   pre      (n, ld) T        the pre-passes' sums by position
// One call of lsb_tri_sweep_* launches the sweep's plan (host arrays) in
// order for up to kMaxCols columns, each segment once:
//   tri_sweep_run_kernel   a run of consecutive levels that one block can
//                          hold (<= the capacity's rows and a bounded
//                          number of entries each), on ONE block whose
//                          threads (a power of two) hold its widest level;
//   tri_sweep_pair_kernel  the same for a run whose rows hold <= 2 entries
//                          (IC(0) of a 2-D Poisson matrix), leaner;
//   tri_sweep_wide_kernel  any other level, row-parallel over as many
//                          blocks as it needs; and (PRE) the pre-pass of a
//                          run whose rows hold many entries on positions
//                          before it: those summed over the card into pre,
//                          from which the run starts each row's sum.
//
// What bounds a sweep on an H100 is not bytes (a sweep of poisson_2d(512)'s
// IC(0) factor reads ~7.3 MB, 2.2 us at 3.35 TB/s) but the level chain:
// 1023 levels, each of which can start only when the one before has been
// written. The earlier design ran the chain across the card, so every level
// paid a device-wide publish and observe through L2 (a fence, a flag, a
// poll, a claim atomic): ~2.1 us per level. Here a run of levels never
// leaves its block, and a level costs its barrier, the dependent read of
// x_j and the instructions its rows issue:
//   - one block walks the run's levels with one __syncthreads() between
//     them; there are no flags, no atomics and no waits on another block;
//   - x_j of recent levels comes from shared memory: every x a run computes
//     goes into a ring of W slots (slot = position mod W, 128 KB) besides
//     xpos in global memory. A level [s, e) reads the ring for positions
//     >= e - W (never a slot this level writes) and xpos below that, or
//     below the run's first position (written by an earlier launch);
//   - the entries on positions before the run leave it where there are
//     many (the separator tail of a sparse factor: ~2400 entries per
//     level, a third of them on positions the wide levels computed): one
//     SM gathering those x_j from L2 took ~2.4 us a level, so a pre-pass
//     over the card sums them first (rows' entries ascend by position, so
//     they are a prefix of each row, up to ioffs[p]), and the run reads
//     only its own positions' x_j, from the ring;
//   - the loads that do not depend on x leave the chain: a row's perm (pair
//     kernel) or offs, perm and dinv (run kernel) two levels ahead, its
//     entries (the pair, or the first kAhead per lane) and b one level
//     ahead, into registers while the level before computes; entries past
//     those are loaded kBatch at a time;
//   - each level's rows are summed by groups of G lanes chosen at pack
//     time from its row count and longest row (ops/tri_sweep.py): one lane
//     per row for short rows, a few lanes for longer rows, up to the whole
//     block for a lone long separator row of a sparse factor; warps that
//     hold no row of a level skip it, and the block is no wider than the
//     run needs, so idle warps issue little. Each lane sums its entries
//     (ioffs[p] + lane + m*G, m ascending; lane 0 from pre[p] after a
//     pre-pass) with FMA, then a fixed
//     xor-shuffle tree (and, for G > 32, a tree over the group's warps in
//     shared memory) adds the lanes: one order, so x is bitwise
//     repeatable.
// A level with more rows or entries than a block should take needs no order
// inside it: the wide kernel gives each row a group of G <= 256 lanes over
// 256-thread blocks, with the same sum order, and reads x_j from xpos. The
// bytes of a sweep bound it at ~0.002 ms; the chain's floor is what one
// level costs in the pair kernel (chip_smoke.py measures it on a
// bidiagonal L, one row per level).
//
// The plan loop is C++ so that a plan of ~1000 wide levels (the backward
// sweep of a sparse factor) costs the host a launch each, not a Python
// call each, and every launch uses Hopper's programmatic dependent launch:
// a kernel may be scheduled while the one before it drains, reads what it
// can of the constant layout (a wide level's row bounds and first entries)
// and then waits for it (griddepcontrol.wait), which hides most of the gap
// between two dependent launches. No kernel waits on a block of its own
// grid. The
// entry point returns the first launch's error (cudaGetLastError() after
// each launch, 0 = OK); the Python wrapper raises on anything else.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxCols = 8;           // columns one launch sums
constexpr int kMaxRunLevels = 4096;   // the run's level tables in shared memory
constexpr int kAhead = 6;             // entries per lane loaded a level ahead
constexpr int kBatch = 4;             // entries per lane loaded at once after
constexpr int kRingBytes = 128 * 1024;  // the x ring, all columns
constexpr int kMaxRing = 32768;         // ring slots
constexpr int kPairRing = 2048;       // the pair kernel's ring slots
constexpr int kWideThreads = 256;
// Segment kinds of a plan (ops/tri_sweep.py).
constexpr int kRun = 0, kWide = 1, kPair = 2, kPre = 3;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Adds row entries q, q + G, ... < q1 of this lane to acc, kBatch entries
// at a time: their cols and vals are fetched together (ent(q, j, v)), then
// x_j, then the FMAs in entry order.
template <typename T, int KC, typename Ent, typename XVal>
__device__ __forceinline__ void add_entries(Ent ent, int64_t q, int64_t q1,
                                            int G, int kc, XVal xval,
                                            T (&acc)[KC]) {
  for (; q < q1; q += static_cast<int64_t>(kBatch) * G) {
    int j[kBatch];
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t qq = q + static_cast<int64_t>(u) * G;
      j[u] = -1;
      v[u] = T(0);
      if (qq < q1) ent(qq, j[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j[u] >= 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (KC == 1 || c < kc) acc[c] = fma_t(v[u], xval(j[u], c), acc[c]);
        }
      }
    }
  }
}

// Programmatic dependent launch: wait for the grid before this one (its
// writes then visible), then let the next grid launch. A kernel reads only
// the constant layout before this; b, pre, x and xpos after.
__device__ __forceinline__ void after_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
}

// Stores x of position p (row `row`) in the ring, xpos and x.
template <typename T, int KC>
__device__ __forceinline__ void put_x(T* ring, int ring_mask, T* xpos, T* x,
                                      int p, int row, int kc, int ld,
                                      const T (&bb)[KC], const T (&acc)[KC],
                                      T d) {
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c < kc) {
      const T xv = (bb[c] - acc[c]) * d;
      ring[(p & ring_mask) * KC + c] = xv;
      xpos[static_cast<int64_t>(p) * ld + c] = xv;
      x[static_cast<int64_t>(row) * ld + c] = xv;
    }
  }
}

// A run whose rows hold at most two entries, each naming a position within
// kPairRing of its level's end (IC(0) of a 2-D Poisson matrix): one thread
// per row, the row's entries as a pair by position whose columns are
// already ring slots (pslot; slot kPairRing holds 0 for an absent entry),
// so x_j always comes from shared memory, with no branch and no offsets to
// chase. The ring starts with x of the kPairRing positions before the run.
// A thread's perm of level l + 2 and its pair, dinv and b of level l + 1
// are loaded while level l computes.
template <typename T, int KC, int NT>
__global__ void __launch_bounds__(NT, 1)
tri_sweep_pair_kernel(const int* __restrict__ perm,
                      const int2* __restrict__ pslot,
                      const T* __restrict__ pvals, const T* __restrict__ dinv,
                      const int64_t* __restrict__ lvl_offs,
                      const T* __restrict__ b, T* __restrict__ x, T* xpos,
                      int l0, int nl, int kc, int ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // (kPairRing + 1) * KC
  int* lv = reinterpret_cast<int*>(ring + (kPairRing + 1) * KC);  // nl + 1
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i <= nl; i += nt) {
    lv[i] = static_cast<int>(lvl_offs[l0 + i]);
  }
  const int run0 = static_cast<int>(lvl_offs[l0]);
  after_prior_grid();
  for (int j = max(run0 - kPairRing, 0) + tid; j < run0; j += nt) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (KC == 1 || c < kc) {
        ring[(j & (kPairRing - 1)) * KC + c] =
            xpos[static_cast<int64_t>(j) * ld + c];
      }
    }
  }
  if (tid < KC) ring[kPairRing * KC + tid] = T(0);
  __syncthreads();
  using T2 = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
  const T2* pv = reinterpret_cast<const T2*>(pvals);
  struct Row {
    int p, row;  // p = -1 where this thread has no row in the level
    int2 c;
    T2 v;
    T d;
    T bb[KC];
  };
  auto load_perm = [&](int L) -> int {
    if (L >= nl) return -1;
    const int p = lv[L] + tid;
    return p < lv[L + 1] ? perm[p] : -1;
  };
  // Row `row` at position p (nothing where row < 0).
  auto load_row = [&](int p, int row, Row& r) {
    r.p = row >= 0 ? p : -1;
    r.row = row;
    if (row >= 0) {
      r.c = pslot[p];
      r.v = pv[p];
      r.d = dinv[p];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        r.bb[c] = (KC == 1 || c < kc)
                      ? b[static_cast<int64_t>(row) * ld + c] : T(0);
      }
    }
  };
  auto solve = [&](const Row& r) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (KC == 1 || c < kc) {
        T acc = fma_t(r.v.x, ring[r.c.x * KC + c], T(0));
        acc = fma_t(r.v.y, ring[r.c.y * KC + c], acc);
        const T xv = (r.bb[c] - acc) * r.d;
        ring[(r.p & (kPairRing - 1)) * KC + c] = xv;
        xpos[static_cast<int64_t>(r.p) * ld + c] = xv;
        x[static_cast<int64_t>(r.row) * ld + c] = xv;
      }
    }
  };

  Row cur, next;
  load_row(lv[0] + tid, load_perm(0), cur);
  int row_next = load_perm(1);
  for (int li = 0; li < nl; ++li) {
    const int row_after = load_perm(li + 2);
    next.p = -1;
    if (li + 1 < nl) load_row(lv[li + 1] + tid, row_next, next);
    if (cur.p >= 0) solve(cur);
    for (int p = lv[li] + tid + nt; p < lv[li + 1]; p += nt) {  // > nt rows
      Row r;
      load_row(p, perm[p], r);
      solve(r);
    }
    __syncthreads();
    cur = next;
    row_next = row_after;
  }
}

// A group's first row of one level: loaded two levels ahead.
template <typename T>
struct Head {
  int64_t e0, e1;  // its entries
  int p;           // its position; -1 where the group has no row there
  int row;
  T d;
};

// That row's first kAhead entries of this lane, and b and its pre-pass sum
// (lane 0): loaded one level ahead.
template <typename T, int KC>
struct Body {
  int c[kAhead];  // -1 past the row's end
  T v[kAhead];
  T bb[KC];
  T pre[KC];
};

// A run of levels on one block, each group's row entries (the first kAhead
// per lane) loaded into registers a level ahead. A row's entries start at
// ioffs[p] (offs[p], or past the entries on positions before the run where
// a pre-pass summed those into pre[p]); with `pre`, lane 0 of the row's
// group starts its sum from pre[p].
template <typename T, int KC, int NT>
__global__ void __launch_bounds__(NT, 1)
tri_sweep_run_kernel(const int* __restrict__ perm,
                     const int64_t* __restrict__ ioffs,
                     const int64_t* __restrict__ offs,
                     const int* __restrict__ cols, const T* __restrict__ vals,
                     const T* __restrict__ dinv,
                     const int64_t* __restrict__ lvl_offs,
                     const signed char* __restrict__ lvl_lg,
                     const T* __restrict__ b, const T* __restrict__ pre,
                     T* __restrict__ x, T* xpos, int l0, int nl, int kc,
                     int ld, int ring_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);                       // W * KC
  T* part = ring + static_cast<size_t>(ring_mask + 1) * KC;   // warps * KC
  int* lv = reinterpret_cast<int*>(part + (NT / 32) * KC);    // nl + 1
  unsigned char* lgs = reinterpret_cast<unsigned char*>(lv + nl + 1);
  const int tid = threadIdx.x, nt = blockDim.x;  // nt: a power of two
  const int lg_nt = 31 - __clz(nt);
  for (int i = tid; i <= nl; i += nt) {
    lv[i] = static_cast<int>(lvl_offs[l0 + i]);
    // A level's lanes per row are at most the block.
    if (i < nl) lgs[i] = static_cast<unsigned char>(min(
                    static_cast<int>(lvl_lg[l0 + i]), lg_nt));
  }
  __syncthreads();
  const int run0 = lv[0];
  const int W = ring_mask + 1;
  const int warp = tid >> 5, lane32 = tid & 31;

  auto load_head = [&](int li, Head<T>& h) {
    h.p = -1;
    h.e0 = h.e1 = 0;
    h.row = 0;
    h.d = T(0);
    if (li < nl) {
      const int p = lv[li] + (tid >> lgs[li]);
      if (p < lv[li + 1]) {
        h.p = p;
        h.e0 = ioffs[p];
        h.e1 = offs[p + 1];
        h.row = perm[p];
        h.d = dinv[p];
      }
    }
  };
  auto load_body = [&](int li, const Head<T>& h, Body<T, KC>& bd) {
    const int G = li < nl ? 1 << lgs[li] : 1;
    const int lane = tid & (G - 1);
#pragma unroll
    for (int m = 0; m < kAhead; ++m) {
      const int64_t e = h.e0 + lane + static_cast<int64_t>(m) * G;
      const bool in = e < h.e1;
      bd.c[m] = in ? cols[e] : -1;
      bd.v[m] = in ? vals[e] : T(0);
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const bool first = h.p >= 0 && lane == 0 && c < kc;
      bd.bb[c] = first ? b[static_cast<int64_t>(h.row) * ld + c] : T(0);
      bd.pre[c] = first && pre != nullptr
                      ? pre[static_cast<int64_t>(h.p) * ld + c] : T(0);
    }
  };
  auto ent = [&](int64_t q, int& j, T& v) {
    j = cols[q];
    v = vals[q];
  };

  Head<T> h0, h1, h2;
  Body<T, KC> b0, b1;
  load_head(0, h0);
  load_head(1, h1);
  after_prior_grid();  // the bodies read b and pre
  load_body(0, h0, b0);
  for (int li = 0; li < nl; ++li) {
    load_head(li + 2, h2);
    load_body(li + 1, h1, b1);
    const int s = lv[li], e = lv[li + 1], lg = lgs[li];
    const int G = 1 << lg, g = tid >> lg, lane = tid & (G - 1);
    const int NG = nt >> lg;
    const int iters = (e - s + NG - 1) >> (lg_nt - lg);
    // x_j of column c: from the ring where it holds j, else from xpos.
    const int lo = max(run0, e - W);
    auto xval = [&](int j, int c) -> T {
      return j >= lo ? ring[(j & ring_mask) * KC + c]
                     : xpos[static_cast<int64_t>(j) * ld + c];
    };
    // The first group of this warp (its own group where G > 32).
    const int wfirst = (tid & ~31) >> lg;
    for (int it = 0; it < iters; ++it) {
      const int base = s + it * NG;
      const int p = base + g;
      T acc[KC], bb[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = bb[c] = T(0);
      int row = 0;
      T d = T(0);
      if (base + wfirst < e) {  // the warp has a row: warp-uniform
        int64_t q = 0, q1 = 0;
        if (it == 0) {
          row = h0.row;
          d = h0.d;
          q = h0.e0 + lane + static_cast<int64_t>(kAhead) * G;
          q1 = h0.e1;
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            bb[c] = b0.bb[c];
            acc[c] = b0.pre[c];
          }
#pragma unroll
          for (int m = 0; m < kAhead; ++m) {
            if (b0.c[m] >= 0) {
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                if (KC == 1 || c < kc) {
                  acc[c] = fma_t(b0.v[m], xval(b0.c[m], c), acc[c]);
                }
              }
            }
          }
        } else if (p < e) {
          q = ioffs[p] + lane;
          q1 = offs[p + 1];
          row = perm[p];
          d = dinv[p];
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            if (lane == 0 && c < kc) {
              bb[c] = b[static_cast<int64_t>(row) * ld + c];
              if (pre != nullptr) {
                acc[c] = pre[static_cast<int64_t>(p) * ld + c];
              }
            }
          }
        }
        add_entries<T, KC>(ent, q, q1, G, kc, xval, acc);
        for (int o = min(G, 32) >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            acc[c] += __shfl_xor_sync(kFull, acc[c], o);
          }
        }
      }
      if (G > 32) {  // the group's warps meet in shared memory
        if (lane32 == 0) {
#pragma unroll
          for (int c = 0; c < KC; ++c) part[warp * KC + c] = acc[c];
        }
        __syncthreads();
        if (lane < 32) {  // the group's first warp
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            acc[c] = lane32 < (G >> 5) ? part[(warp + lane32) * KC + c]
                                       : T(0);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
            for (int c = 0; c < KC; ++c) {
              acc[c] += __shfl_xor_sync(kFull, acc[c], o);
            }
          }
        }
      }
      if (lane == 0 && p < e) {
        put_x<T, KC>(ring, ring_mask, xpos, x, p, row, kc, ld, bb, acc, d);
      }
      if (G > 32 && it + 1 < iters) __syncthreads();  // part written again
    }
    __syncthreads();
    h0 = h1;
    h1 = h2;
    b0 = b1;
  }
}

// Positions s .. e-1, row-parallel: G lanes per row over 256-thread blocks,
// x_j from xpos. Without PRE, one wide level: each row's entries, then x.
// With PRE, a run's pre-pass: each row's entries before ioffs[p] (those on
// positions before the run), their sum into pre[p].
template <typename T, int KC, bool PRE>
__global__ void __launch_bounds__(kWideThreads)
tri_sweep_wide_kernel(const int* __restrict__ perm,
                      const int64_t* __restrict__ ioffs,
                      const int64_t* __restrict__ offs,
                      const int* __restrict__ cols,
                      const T* __restrict__ vals, const T* __restrict__ dinv,
                      const T* __restrict__ b, T* __restrict__ pre,
                      T* __restrict__ x, T* xpos, int s, int e, int G,
                      int kc, int ld) {
  __shared__ T part[kWideThreads / 32][KC];
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kWideThreads + threadIdx.x;
  const int64_t gi = t / G;
  const int lane = static_cast<int>(t - gi * G);
  const int64_t p = s + gi;
  const bool on = p < e;
  T acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = T(0);
  auto xval = [&](int j, int c) -> T {
    return xpos[static_cast<int64_t>(j) * ld + c];
  };
  auto ent = [&](int64_t q, int& j, T& v) {
    j = cols[q];
    v = vals[q];
  };
  // The row's bounds and first kBatch entries of this lane come from the
  // layout: loaded before the wait for the grid before this one.
  const int64_t q0 = on ? offs[p] + lane : 0;
  const int64_t q1 = on ? (PRE ? ioffs[p] : offs[p + 1]) : 0;
  int j0[kBatch];
  T v0[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int64_t q = q0 + static_cast<int64_t>(u) * G;
    j0[u] = -1;
    v0[u] = T(0);
    if (q < q1) ent(q, j0[u], v0[u]);
  }
  after_prior_grid();
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (j0[u] >= 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (KC == 1 || c < kc) acc[c] = fma_t(v0[u], xval(j0[u], c), acc[c]);
      }
    }
  }
  add_entries<T, KC>(ent, q0 + static_cast<int64_t>(kBatch) * G, q1, G, kc,
                     xval, acc);
  for (int o = min(G, 32) >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], o);
  }
  if (G > 32) {  // the group's warps meet in shared memory
    const int warp = threadIdx.x >> 5, lane32 = threadIdx.x & 31;
    if (lane32 == 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) part[warp][c] = acc[c];
    }
    __syncthreads();
    if (lane < 32) {  // the group's first warp
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        acc[c] = lane32 < (G >> 5) ? part[warp + lane32][c] : T(0);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          acc[c] += __shfl_xor_sync(kFull, acc[c], o);
        }
      }
    }
  }
  if (on && lane == 0 && PRE) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c < kc) pre[p * ld + c] = acc[c];
    }
  } else if (on && lane == 0) {
    const int row = perm[p];
    const T d = dinv[p];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c < kc) {
        const T xv = (b[static_cast<int64_t>(row) * ld + c] - acc[c]) * d;
        xpos[p * ld + c] = xv;
        x[static_cast<int64_t>(row) * ld + c] = xv;
      }
    }
  }
}


// Launches `kernel` with programmatic stream serialization: it may start
// while the kernel before it drains, and waits for it in
// after_prior_grid().
template <typename... P, typename... A>
void launch_pdl(void (*kernel)(P...), int blocks, int threads, size_t smem,
                cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
}

bool pow2_within(int v, int lo, int hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

// Ring slots: the largest power of two whose KC columns fit kRingBytes.
template <typename T, int KC>
constexpr int ring_slots() {
  int w = kMaxRing;
  while (w * KC * static_cast<int>(sizeof(T)) > kRingBytes) w >>= 1;
  return w;
}

// Opts a kernel into `bytes` of dynamic shared memory, once.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = rc == cudaSuccess;
  return static_cast<int>(rc);
}

// One sweep's arrays (TriSweep, ops/tri_sweep.py) and the kc columns of b,
// pre, x and xpos one call takes.
struct Sweep {
  const void *perm, *ioffs, *offs, *cols, *vals, *dinv, *pslot, *pvals,
      *lvl_offs, *lvl_lg, *b;
  void *pre, *x, *xpos;
  int kc, ld;
  cudaStream_t stream;
};

// A run; with_pre: its pre-pass ran just before it.
template <typename T, int KC>
int run_kc(const Sweep& a, int l0, int nl, int threads, bool with_pre) {
  // At most 512 threads: a wider block's barrier costs more than the rows
  // it adds (the host plans runs of at most 512, ops/tri_sweep.py).
  constexpr int NT = 512;
  constexpr int W = ring_slots<T, KC>();
  constexpr size_t fixed = (static_cast<size_t>(W) + NT / 32) * KC * sizeof(T);
  // Level tables: lv ints, lgs bytes.
  constexpr size_t per_level = sizeof(int) + 1;
  static bool opted = false;
  const int rc = allow_smem(tri_sweep_run_kernel<T, KC, NT>,
                            fixed + (kMaxRunLevels + 1) * per_level, opted);
  if (rc != 0) return rc;
  const size_t smem = fixed + static_cast<size_t>(nl + 1) * per_level;
  launch_pdl(tri_sweep_run_kernel<T, KC, NT>, 1, min(threads, NT), smem, a.stream,
      static_cast<const int*>(a.perm), static_cast<const int64_t*>(a.ioffs),
      static_cast<const int64_t*>(a.offs), static_cast<const int*>(a.cols),
      static_cast<const T*>(a.vals), static_cast<const T*>(a.dinv),
      static_cast<const int64_t*>(a.lvl_offs),
      static_cast<const signed char*>(a.lvl_lg), static_cast<const T*>(a.b),
      with_pre ? static_cast<const T*>(a.pre) : nullptr,
      static_cast<T*>(a.x), static_cast<T*>(a.xpos), l0, nl, a.kc, a.ld,
      W - 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KC>
int pair_kc(const Sweep& a, int l0, int nl, int threads) {
  constexpr int NT = KC == 1 ? 1024 : 512;
  constexpr size_t fixed = static_cast<size_t>(kPairRing + 1) * KC * sizeof(T);
  static bool opted = false;
  const int rc = allow_smem(tri_sweep_pair_kernel<T, KC, NT>,
                            fixed + (kMaxRunLevels + 1) * sizeof(int), opted);
  if (rc != 0) return rc;
  const size_t smem = fixed + static_cast<size_t>(nl + 1) * sizeof(int);
  launch_pdl(tri_sweep_pair_kernel<T, KC, NT>, 1, min(threads, NT), smem, a.stream,
      static_cast<const int*>(a.perm), static_cast<const int2*>(a.pslot),
      static_cast<const T*>(a.pvals), static_cast<const T*>(a.dinv),
      static_cast<const int64_t*>(a.lvl_offs), static_cast<const T*>(a.b),
      static_cast<T*>(a.x), static_cast<T*>(a.xpos), l0, nl, a.kc, a.ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KC, bool PRE>
int wide_kc(const Sweep& a, int s, int e, int group) {
  const int64_t threads = static_cast<int64_t>(e - s) * group;
  const int blocks = static_cast<int>((threads + kWideThreads - 1) /
                                      kWideThreads);
  launch_pdl(tri_sweep_wide_kernel<T, KC, PRE>, blocks, kWideThreads, 0, a.stream,
      static_cast<const int*>(a.perm), static_cast<const int64_t*>(a.ioffs),
      static_cast<const int64_t*>(a.offs), static_cast<const int*>(a.cols),
      static_cast<const T*>(a.vals), static_cast<const T*>(a.dinv),
      static_cast<const T*>(a.b), static_cast<T*>(a.pre),
      static_cast<T*>(a.x), static_cast<T*>(a.xpos), s, e, group, a.kc,
      a.ld);
  return static_cast<int>(cudaGetLastError());
}

// One segment of a plan: (kind, l0, l1, width) with lvl the level offsets
// on the host; a run directly after its pre-pass (the same levels) starts
// its rows' sums from the pre-pass. Returns a cudaError_t
// (cudaErrorInvalidValue for a segment the kernels cannot take).
template <typename T, int KC>
int segment(const Sweep& a, const int64_t* seg, const int64_t* prev,
            const int64_t* lvl) {
  const int64_t kind = seg[0], l0 = seg[1], l1 = seg[2], width = seg[3];
  const int64_t nl = l1 - l0;
  if (l0 < 0 || nl < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>(width);
  if (kind == kWide || kind == kPre) {
    if (!pow2_within(w, 1, kWideThreads) || (kind == kWide && nl != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int s = static_cast<int>(lvl[l0]), e = static_cast<int>(lvl[l1]);
    return kind == kWide ? wide_kc<T, KC, false>(a, s, e, w)
                         : wide_kc<T, KC, true>(a, s, e, w);
  }
  if (nl > kMaxRunLevels || !pow2_within(w, 32, 1024)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int il0 = static_cast<int>(l0), inl = static_cast<int>(nl);
  if (kind == kRun) {
    const bool with_pre = prev != nullptr && prev[0] == kPre &&
                          prev[1] == l0 && prev[2] == l1;
    return run_kc<T, KC>(a, il0, inl, w, with_pre);
  }
  if (kind == kPair) return pair_kc<T, KC>(a, il0, inl, w);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches every segment of the plan in order; stops at the first error.
template <typename T, int KC>
int sweep_kc(const Sweep& a, const int64_t* plan, int nseg,
             const int64_t* lvl) {
  for (int i = 0; i < nseg; ++i) {
    const int64_t* seg = plan + 4 * static_cast<int64_t>(i);
    const int rc = segment<T, KC>(a, seg, i > 0 ? seg - 4 : nullptr, lvl);
    if (rc != 0) return rc;
  }
  return 0;
}

template <typename T>
int sweep(const void* plan, const void* lvl_host, const void* perm,
          const void* ioffs, const void* offs, const void* cols,
          const void* vals, const void* dinv, const void* pslot,
          const void* pvals, const void* lvl_offs, const void* lvl_lg,
          const void* b, void* pre, void* x, void* xpos, int nseg, int kc,
          int ld, void* stream) {
  if (nseg < 0 || kc < 1 || kc > kMaxCols || ld < kc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Sweep a{perm,  ioffs, offs, cols, vals, dinv,
                pslot, pvals, lvl_offs, lvl_lg, b, pre,
                x,     xpos,  kc,   ld,   static_cast<cudaStream_t>(stream)};
  const auto* p = static_cast<const int64_t*>(plan);
  const auto* lvl = static_cast<const int64_t*>(lvl_host);
  if (kc == 1) return sweep_kc<T, 1>(a, p, nseg, lvl);
  if (kc == 2) return sweep_kc<T, 2>(a, p, nseg, lvl);
  if (kc <= 4) return sweep_kc<T, 4>(a, p, nseg, lvl);
  return sweep_kc<T, 8>(a, p, nseg, lvl);
}

}  // namespace

extern "C" {

// One sweep of up to 8 columns: every segment of the plan, in order, on
// `stream`. plan (nseg, 4) int64 and lvl_host (nlev+1,) int64 are HOST
// arrays: each segment's kind (0 run, 1 wide level, 2 pair run, 3 the
// pre-pass of the run after it), first level, end level and width (a run's
// threads, a power of two in 32..1024, at most 512 launched; a wide level's
// or a pre-pass's lanes per row, 1..256), and the levels' position offsets.
// The rest are device arrays: perm (n,) int32, ioffs (n,) int64 the first
// entry a run sums of each position (after those its pre-pass summed),
// offs (n+1,) int64, cols (nnz,) int32 positions, vals (nnz,) f32, dinv
// (n,) f32, pslot (n, 2) int32 and pvals (n, 2) f32 (a pair run's entries
// as ring slots: position mod 2048, 2048 for an absent entry whose value is
// 0), lvl_offs (nlev+1,) int64, lvl_lg (nlev,) int8 log2 of each level's
// lanes per row; b, pre, x and xpos point at the first of kc columns of
// (n, ld) f32 arrays (pre: the pre-passes' sums by position). Returns the
// first launch's error, 0 if none.
int lsb_tri_sweep_f32(const void* plan, const void* lvl_host,
                      const void* perm, const void* ioffs, const void* offs,
                      const void* cols, const void* vals, const void* dinv,
                      const void* pslot, const void* pvals,
                      const void* lvl_offs, const void* lvl_lg, const void* b,
                      void* pre, void* x, void* xpos, int nseg, int kc,
                      int ld, void* stream) {
  return sweep<float>(plan, lvl_host, perm, ioffs, offs, cols, vals, dinv,
                      pslot, pvals, lvl_offs, lvl_lg, b, pre, x, xpos, nseg,
                      kc, ld, stream);
}

// The same with vals, dinv, pvals, b, pre, x and xpos in f64.
int lsb_tri_sweep_f64(const void* plan, const void* lvl_host,
                      const void* perm, const void* ioffs, const void* offs,
                      const void* cols, const void* vals, const void* dinv,
                      const void* pslot, const void* pvals,
                      const void* lvl_offs, const void* lvl_lg, const void* b,
                      void* pre, void* x, void* xpos, int nseg, int kc,
                      int ld, void* stream) {
  return sweep<double>(plan, lvl_host, perm, ioffs, offs, cols, vals, dinv,
                       pslot, pvals, lvl_offs, lvl_lg, b, pre, x, xpos, nseg,
                       kc, ld, stream);
}

}  // extern "C"
