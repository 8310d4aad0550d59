// Gather and launch probes for Hopper: the counterparts of the Pallas
// kernels in tools/microbench_pallas_gather.py and
// tools/microbench_mosaic_seed.py. They measure what the seeding state
// machine is made of: a row gather, a dependent chain of row gathers
// inside one kernel, and the cost of one launch.
//
// gather_rows   replaces microbench_pallas_gather.py gather_kernel (:48).
//   out[b, :] = tab[idx[b], :] on a dense int32 (N, C) table, C % 4 == 0.
//   The TPU kernel padded each 16-word row to 128 lanes (a VMEM layout
//   artifact); here the table is dense. Bound: bytes (each row read once,
//   written once). Design: one 16-byte load and store per thread, so a
//   row is C/4 int4 loads by neighbouring threads.
//
// gather_chain  replaces microbench_mosaic_seed.py make_a (:91), make_b
//   (:111), make_c (:139), make_a2 (:180), make_d (:156) and make_e (:167):
//   per lane, T dependent steps j <- (j * 48271 + r + 11) & mask, where
//   r = tab[j, 0] (ROWS = 1), r = tab[j, 0] + tab[j2, 0] with
//   j2 = (j * 40503 + 7) & mask (ROWS = 2, the FM fetch shape: occ at k
//   and k + s), or, with no load, make_d's floor (FLOOR = 1: r = 7 in
//   every lane) or make_e's (FLOOR = 2: r = 0 in lane 0, and every other
//   lane returns its start index, as make_e passes lanes 1.. through).
//   FRESH adds s * salt at step s: the tool's step is one fixed random
//   mapping, so a lane falls into a short cycle after about sqrt(N) steps
//   and lanes merge, and its table shrinks to a few cached rows; with a
//   salt each step is a new mapping and reads a new random row, as the FM
//   walk does, so the table's tier (L2 or device memory) shows. The TPU's
//   three layouts of the same chain (tile + masked max, roll, sublane
//   slice) collapse into one: a thread is a lane, and its load is a
//   scalar load. Bound: the latency of one dependent load per step (bytes
//   and instructions are both far below it). Design: one thread per lane,
//   all T steps in the kernel; the table sits in L2 or device memory
//   according to its size, or, with SMEM, its reachable column 0 is
//   copied into shared memory first (the Hopper meaning of the TPU's
//   VMEM-resident table). mask and T are runtime arguments, so the
//   compiler cannot fold steps together (it cannot know which bits the
//   mask keeps) nor unroll the chain away: every step stays a dependent
//   multiply-add and AND.
//
// add_one       replaces microbench_pallas_gather.py nop_kernel (:110).
//   o = x + 1 on int32. Its time is the cost of one launch.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kChainThreads = 128;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block can use

__global__ void gather_rows_kernel(const int4* __restrict__ tab,
                                   const int* __restrict__ idx,
                                   int4* __restrict__ out, long long n_items,
                                   int vec_per_row, int n_rows) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_items) return;
  const long long b = t / vec_per_row;
  const int q = (int)(t - b * vec_per_row);
  // out-of-range indices are clamped, as XLA's gathers clamp them
  const int j = min(max(idx[b], 0), n_rows - 1);
  out[t] = __ldg(tab + (size_t)j * vec_per_row + q);
}

// FLOOR: 0 reads the table, 1 is make_d's floor, 2 is make_e's
template <int ROWS, int FLOOR, bool SMEM, bool FRESH>
__global__ void __launch_bounds__(kChainThreads)
gather_chain_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                    int* __restrict__ out, int lanes, int pitch,
                    unsigned mask, int steps, unsigned salt) {
  extern __shared__ int col0[];
  if (SMEM) {
    for (unsigned r = threadIdx.x; r <= mask; r += blockDim.x)
      col0[r] = __ldg(tab + (size_t)r * pitch);
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  if (FLOOR == 2 && lane != 0) {
    out[lane] = idx[lane];
    return;
  }
  unsigned j = (unsigned)idx[lane] & mask;
  unsigned bump = 11u;  // 11 + s * salt at step s
  for (int s = 0; s < steps; ++s) {
    unsigned r = FLOOR == 1 ? 7u : 0u;
    if (FLOOR == 0) {
      r = SMEM ? (unsigned)col0[j] : (unsigned)__ldg(tab + (size_t)j * pitch);
      if (ROWS == 2) {
        const unsigned j2 = (j * 40503u + 7u) & mask;
        r += SMEM ? (unsigned)col0[j2]
                  : (unsigned)__ldg(tab + (size_t)j2 * pitch);
      }
    }
    j = (j * 48271u + r + bump) & mask;
    if (FRESH) bump += salt;
  }
  out[lane] = (int)j;
}

__global__ void add_one_kernel(const int* __restrict__ x, int* __restrict__ o,
                               int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) o[t] = x[t] + 1;
}

template <int ROWS, int FLOOR, bool SMEM, bool FRESH>
int chain(const int* tab, const int* idx, int* out, int lanes, int pitch,
          unsigned mask, int steps, unsigned salt, cudaStream_t stream) {
  auto kern = gather_chain_kernel<ROWS, FLOOR, SMEM, FRESH>;
  const size_t smem = SMEM ? ((size_t)mask + 1) * sizeof(int) : 0;
  static bool smem_max_set = false;
  if (SMEM && !smem_max_set) {
    // above 48 KB a block's dynamic shared memory must be asked for; ask
    // once for the most a block can have
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    smem_max_set = true;
  }
  const int blocks = (lanes + kChainThreads - 1) / kChainThreads;
  kern<<<blocks, kChainThreads, smem, stream>>>(tab, idx, out, lanes, pitch,
                                                 mask, steps, salt);
  return (int)cudaGetLastError();
}

}  // namespace

// tab int32[n_rows, cols] (16-byte aligned, cols % 4 == 0), idx int32[B],
// out int32[B, cols].
extern "C" int gather_rows_launch(const void* tab, const void* idx, void* out,
                                  int B, int n_rows, int cols, void* stream) {
  const int vec = cols / 4;
  const long long n_items = (long long)B * vec;
  const long long blocks = (n_items + kThreads - 1) / kThreads;
  gather_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(tab), static_cast<const int*>(idx),
      static_cast<int4*>(out), n_items, vec, n_rows);
  return (int)cudaGetLastError();
}

// tab int32[n_rows, pitch] (column 0 is read), idx int32[lanes], out
// int32[lanes]; mask = 2^k - 1 < n_rows. rows 1 or 2; floor 1 or 2 runs
// make_d's or make_e's floor (no load: rows 1, no smem, no salt); smem 1
// needs (mask + 1) * 4 bytes of shared memory and no salt; a salt (not 0)
// runs the FRESH chain from device memory or L2.
extern "C" int gather_chain_launch(const void* tab, const void* idx, void* out,
                                   int lanes, int pitch, int mask, int steps,
                                   int rows, int floor, int smem, int salt,
                                   void* stream) {
  auto* t = static_cast<const int*>(tab);
  auto* i = static_cast<const int*>(idx);
  auto* o = static_cast<int*>(out);
  const unsigned m = (unsigned)mask, sa = (unsigned)salt;
  auto s = static_cast<cudaStream_t>(stream);
#define CHAIN(R, L, S, F) chain<R, L, S, F>(t, i, o, lanes, pitch, m, steps, sa, s)
  if (floor == 1) return CHAIN(1, 1, false, false);
  if (floor == 2) return CHAIN(1, 2, false, false);
  if (salt) return rows == 1 ? CHAIN(1, 0, false, true)
                             : CHAIN(2, 0, false, true);
  if (rows == 1) return smem ? CHAIN(1, 0, true, false)
                             : CHAIN(1, 0, false, false);
  return smem ? CHAIN(2, 0, true, false) : CHAIN(2, 0, false, false);
#undef CHAIN
}

// x, out int32[n].
extern "C" int add_one_launch(const void* x, void* out, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  add_one_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), n);
  return (int)cudaGetLastError();
}
