// The forward field on the H100's tensor cores: one trunk loop, shared by the
// fused field kernel K1 (field_fused.cu, which runs the heads after it) and
// the trunk-only kernel K3 (trunk_fwd.cu), so that one trunk exists:
//   h_0 = sin(w0 * (x @ W0 + b0)),  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
//
// A block of two warpgroups owns a 64-row tile of points. Up to 512 wide its
// activations stay in shared memory for the whole field: the (64, F) tile H
// in the compute dtype, written in place by every layer, beside the x tile
// (as wide as the padded input, 16 to 128) and, in K1 once the trunk is done
// with x, the aux tile (16 to 128 wide). Wider trunks (640 to 1,024) keep H
// in global memory instead (kGlobalH below). Every product runs on wgmma, in passes of
// 256 output columns: warpgroup g computes columns [256 p + 128 g, 256 p + 128 (g + 1)) of pass
// p for all 64 rows (m64n128), so a 512-wide layer takes two passes; a width
// that is an odd multiple of 128 (128, 384, 640, 896) ends with a pass of
// 128 columns, 64 per warpgroup (m64n64). Widths are run-time values (one
// kernel per dtype serves every width in {128, 256, 384, 512}, a second one
// every width in {640, 768, 896, 1024}); only the pass's column
// count per warpgroup is a template (the accumulator's size). A comes
// from registers: each thread loads its fragment of H (or x, aux) from
// shared memory and, in f32, splits it into tf32 hi + lo (tc::split_tf32,
// the rounding of ops/_bwd.py:matmul_3xtf32). B, the weight W^T (N, K)
// K-major, streams from L2 through a ring of two shared-memory slots: the
// wrapper lays every weight out as the kernel's 32-byte swizzled tiles
// (ops/trunk.py:tc_operand; one gather per call, reused while the weights
// are unchanged), so a chunk (two k-steps of a pass's 256 rows, four of a
// 128-column pass's, or the 32 k-steps of a 16-row projection: 16 KB) is one
// cp.async.bulk by one thread,
// counted on the slot's mbarrier. In f32 the threads split each chunk, once
// it lands, into the slot's hi and lo parts, so the weights cross L2 once;
// the head projections' K is permuted (ops/field_fused.py:tc_weights).
//
// Accuracy: the tensor cores add into the accumulator with truncation toward
// zero, and one accumulator over K = 512 (192 adds in 3xTF32) left h_{L-1}
// 6.7e-5 off the plain version after 8 layers, above the 5e-5 bar. So each
// chunk's products (f32: 2 k-steps; bf16: each k-step) start a fresh
// accumulator and join an f32 total in registers (rounded to nearest), as
// the backward's reduction does; 64 + 64 registers per pass is why a pass
// is 128 columns per warpgroup. In f32 the chunk's cross terms go first
// (mma_unit), so that only its hi*hi adds truncate at the chunk's own size.
// An error that follows a partial sum's sign survives a sum over the points
// of a batch where the points cancel (the loss's gradient of a head bias at
// trained weights): the running output of every head's projection (K 512 +
// 6 x 256 in K1) left those gradients 40x farther from f64 than the plain
// version's, so a projection sums each k-step afresh (project). A two-pass
// layer (384, 512) written in place holds its first pass's values until the
// second pass has read all of H (Held); a one-pass layer (128, 256) writes
// H after its pass's last barrier, when every warp has read H.
//
// Wider trunks (640 to 1,024, the JAX kernels' feat % 128 == 0 up to where
// their VMEM holds the weights): in f32 the (64, F) tile alone takes 164,864
// to 263,168 bytes beside the ring's 65,536, past the 232,448 a block may
// have, and a 1,024-wide layer written in place would hold three passes'
// values until its fourth had read H. So at these widths (kGlobalH) H lives
// in global memory, two (64, F) buffers per block (FieldArgs / TrunkArgs
// h_ws, h_slots slots of 2 x 64 x F elements): layer i reads one and writes
// the other (ping-pong), each pass's epilogue storing straight to it, so no
// pass's values wait. The A fragments come through L1/L2 instead of shared
// memory; every sum keeps the order of the shared-memory loop. The grid is
// at most h_slots persistent blocks, each walking the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... with its own buffers, so the workspace is
// h_slots x 2 x 64 x F elements whatever the points; the ring's stream of
// chunks starts again with each tile. Shared memory holds the x (aux) tile
// and the ring alone.
//
// The slots carry one stream of chunks through the whole tile, in the order
// of a plan the host builds from the argument struct (Plan): each job is a
// pass's or a projection's B operand. Per chunk: its wgmmas (three per
// k-step in f32: lo*hi, hi*lo, hi*hi; one in bf16), meanwhile the next chunk
// is waited for and split, then the wait for the wgmmas, the sum into the
// total, one barrier, and the copy of the chunk after next into the freed
// slot, so a layer's epilogue (bias, w0 scale, sine, stores) overlaps the
// next weights' copies.
//
// A projection (sigma from h_{L-1}, and each head's hidden layer) never
// stores its input: each warpgroup feeds its pass's values, after the
// epilogue, straight back as the register A operand of m64n16 wgmmas, one
// job per 16 output columns, into that group's f32 accumulator (kept in
// global memory between projections, each thread's own 8 floats; group 0,
// columns 0-15, is shared by every head). In bf16 the accumulator's layout
// is the A fragment's (as in FlashAttention-3); in tf32 the accumulator holds columns
// (2t, 2t + 1) of each group of 8 where the A fragment takes (t, t + 4), so
// the wrapper permutes the projection's K within each group of 8 to match.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sine.cuh"
#include "tile_gemm.cuh"
#include "wgmma.cuh"

namespace satnerf {
namespace fwd {

constexpr int kRows = 64;       // point rows per block
constexpr int kThreads = 256;   // two warpgroups
constexpr int kPart = 16384;    // bytes of one part (hi or lo) of a ring slot
constexpr int kMaxJobs = 96;    // satnerf_torch.ops.trunk.TC_MAX_JOBS
constexpr int kPassCols = 256;  // output columns of one pass, 128 per warpgroup
constexpr int kNW = kPassCols / 2;
constexpr int kTailCols = 128;  // the last pass of an odd multiple of 128: 64 per warpgroup
// widest x tile: K after padding to 16; the JAX kernels take any c_in <= 128
// (satnerf_tpu/ops/pallas/trunk.py:83)
constexpr int kMaxX = 128;

enum Act { kLinear = 0, kSine = 1, kRelu = 2 };

// K per wgmma k-step (32 bytes), tensor-core passes per product, row
// padding of the activation tiles, and k-steps per sum into the f32 total
// (bf16 every step: its activations round to 8 bits, so a different f32
// sum flips roundings that the next layers carry; f32 every chunk, its
// cross terms first: mma_unit)
template <typename T> struct Tc;
template <> struct Tc<float> {
  static constexpr int kKs = 8, kParts = 2, kPad = 4, kSum = 2;
};
template <> struct Tc<__nv_bfloat16> {
  static constexpr int kKs = 16, kParts = 1, kPad = 8, kSum = 1;
};

__host__ __device__ constexpr int round16(int k) { return (k + 15) / 16 * 16; }

// the passes of an F-wide layer (F a multiple of 128, at most 1,024): F / 256
// of 256 columns, then one of 128 when F is an odd multiple of 128
__host__ __device__ constexpr int full_passes(int F) { return F / kPassCols; }
__host__ __device__ constexpr int tail_passes(int F) { return (F % kPassCols) / kTailCols; }
__host__ __device__ constexpr int passes(int F) { return full_passes(F) + tail_passes(F); }
// host: F is a width the loop takes; keep in sync with
// satnerf_torch.ops.trunk.FEAT_WIDTHS
// (one line: tests/test_torch_field_fused.py reads the list from it)
inline bool width_ok(int F) { return F == 128 || F == 256 || F == 384 || F == 512 || F == 640 || F == 768 || F == 896 || F == 1024; }
// the widest trunk whose H stays in shared memory; wider ones take kGlobalH
constexpr int kSmemMaxF = 512;
__host__ __device__ constexpr bool global_h(int F) { return F > kSmemMaxF; }

// The B operand of one job (a pass or a projection): one or two products,
// each the weight W^T (rows, K) in the layout of ops/trunk.py:tc_operand,
// where k-step s is the (rows, 32-byte) swizzled tile at src + s * rows * 32:
// the shared-memory tile itself, so a chunk of steps is one contiguous copy.
struct BJob {
  const char* src[2];
  int steps[2];  // k-steps of each product
  short nprod;
  short rows_log2;  // rows of W^T: 256 or 128 (a pass), 16 (a projection)
  short group;      // a projection's 16-column output group
  short fresh;      // a projection that starts its group's sum at 0
};

struct Plan {
  BJob jobs[kMaxJobs];
  int njobs;
};

// host: append a job of `rows` rows with the products (w, K); K is a
// multiple of 16, esz the compute dtype's size
inline void add_job(Plan& pl, int rows, size_t esz, const void* w0, int k0,
                    const void* w1 = nullptr, int k1 = 0) {
  BJob& j = pl.jobs[pl.njobs++];
  j.src[0] = static_cast<const char*>(w0);
  j.steps[0] = static_cast<int>(k0 * esz / 32);
  j.nprod = w1 != nullptr ? 2 : 1;
  j.src[1] = static_cast<const char*>(w1);
  j.steps[1] = static_cast<int>(k1 * esz / 32);
  j.rows_log2 = rows == 256 ? 8 : rows == 128 ? 7 : 4;
  j.group = 0;
  j.fresh = 0;
}

// host: pass p of an N-wide layer: rows 256 p .. of W^T (N, k0) [and (N, k1)],
// 256 of them or the 128 of a last pass (ops/trunk.py:tc_operand lays the
// passes out one after the other, so pass p starts at row 256 p)
inline void add_pass_job(Plan& pl, size_t esz, int n, int p, const void* w0, int k0,
                         const void* w1, int k1) {
  const size_t r0 = static_cast<size_t>(p) * kPassCols;
  add_job(pl, p < full_passes(n) ? kPassCols : kTailCols, esz,
          static_cast<const char*>(w0) + r0 * k0 * esz, k0,
          w1 != nullptr ? static_cast<const char*>(w1) + r0 * k1 * esz : nullptr, k1);
}

// host: the passes of an N-wide layer
inline void add_layer_jobs(Plan& pl, size_t esz, int n, const void* w0, int k0,
                           const void* w1 = nullptr, int k1 = 0) {
  for (int p = 0; p < passes(n); ++p) add_pass_job(pl, esz, n, p, w0, k0, w1, k1);
}

// host: the projection of pass p of an n-wide activation: its columns
// (256 p .. 256 p + 255, or the last pass's 128) of W2^T (16, n), onto
// output group `group` (W2^T is that group's 16 rows of a wider projection);
// `fresh` starts the group's sum
inline void add_proj_job(Plan& pl, size_t esz, int n, const void* w2, int p, int group = 0,
                         bool fresh = false) {
  add_job(pl, 16, esz, static_cast<const char*>(w2) + static_cast<size_t>(p) * kPassCols * 16 * esz,
          p < full_passes(n) ? kPassCols : kTailCols);
  pl.jobs[pl.njobs - 1].group = static_cast<short>(group);
  pl.jobs[pl.njobs - 1].fresh = fresh ? 1 : 0;
}

// host: the projections of every pass of an n-wide activation
inline void add_proj_jobs(Plan& pl, size_t esz, int n, const void* w2) {
  for (int p = 0; p < passes(n); ++p) add_proj_job(pl, esz, n, w2, p);
}

// host: an N-wide layer whose passes are each projected right away by the
// first `groups` 16-row groups of W2^T (16 groups, n), group g at 16 g n
// elements (ops/field_fused.py:tc_projection): pass 0, its projection onto
// each group (groups 1 .. starting afresh), pass 1, ...
inline void add_projected_jobs(Plan& pl, size_t esz, int n, const void* w2, const void* w0,
                               int k0, const void* w1 = nullptr, int k1 = 0, int groups = 1) {
  for (int p = 0; p < passes(n); ++p) {
    add_pass_job(pl, esz, n, p, w0, k0, w1, k1);
    for (int g = 0; g < groups; ++g) {
      const char* w2g = static_cast<const char*>(w2) + static_cast<size_t>(g) * 16 * n * esz;
      add_proj_job(pl, esz, n, w2g, p, g, g > 0 && p == 0);
    }
  }
}

// host: 0 when no chunk of the plan spans two products
inline int check_plan(const Plan& pl) {
  for (int q = 0; q < pl.njobs; ++q) {
    const BJob& j = pl.jobs[q];
    if (j.nprod > 1 && j.steps[0] % (512 >> j.rows_log2) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// shared memory of an F-wide trunk with a kx-wide x tile: H (64, F); the x
// tile (64, kx), whose room K1 takes over once the trunk is done with x for
// the aux tile (64, ka; ka 0 for K3); the ring of two slots, aligned to the
// 32-byte swizzle's period of 256 bytes (desc_sw32: every B tile starts at a
// multiple of it); their mbarriers. The tiles' row strides (ldx) are padded
// against bank conflicts. In f32 at F 512 a 128-wide x or aux tile leaves
// 752 bytes of the 232,448 a block may have: no 1,024-byte alignment, and
// no output accumulators beside the aux tile (K1 keeps them in global
// memory, field_fused.cu), would fit.
template <typename T>
struct Smem {
  static constexpr int kSlot = Tc<T>::kParts * kPart;
  static constexpr int kAlign = 256;
  __host__ __device__ static constexpr int ldh(int F) { return F + Tc<T>::kPad; }
  __host__ __device__ static constexpr int ldx(int kx) { return kx + Tc<T>::kPad; }
  __host__ __device__ static constexpr int tile(int k) {
    return k > 0 ? kRows * ldx(k) * static_cast<int>(sizeof(T)) : 0;
  }
  __host__ __device__ static constexpr int x_room(int kx, int ka) {
    return tile(kx) > tile(ka) ? tile(kx) : tile(ka);
  }
  // F 0: H in global memory (kGlobalH), the x tile at the base
  __host__ __device__ static constexpr int h_tile(int F) {
    return F > 0 ? kRows * ldh(F) * static_cast<int>(sizeof(T)) : 0;
  }
  __host__ __device__ static constexpr int ring(int F, int kx, int ka) {
    return (h_tile(F) + x_room(kx, ka) + kAlign - 1) / kAlign * kAlign;
  }
  __host__ __device__ static constexpr int bars(int F, int kx, int ka) {
    return ring(F, kx, ka) + 2 * kSlot;
  }
  // + the base's alignment
  __host__ __device__ static constexpr int bytes(int F, int kx, int ka) {
    return bars(F, kx, ka) + 16 + kAlign;
  }
};

// p (dynamic shared memory) rounded up to a multiple of `align` bytes (a
// power of two) of shared address, by pointer arithmetic: every pointer
// derived from it stays a shared-memory pointer to the compiler (32-bit
// addresses, LDS/STS)
__device__ __forceinline__ unsigned char* align_up(unsigned char* p, uint32_t align) {
  return p + ((align - (tc::smem_u32(p) & (align - 1))) & (align - 1));
}

template <typename T>
struct ATile {
  const T* p;  // shared memory, row-major
  int ld;      // row stride in elements
};

struct Ring {
  unsigned char* ptr;  // slot 0
  uint32_t base;       // its shared address
  uint32_t bar;        // shared address of slot 0's mbarrier (slot 1's at + 8)
  int prod, cons;      // chunks issued / consumed so far
  int pq, pc;          // the next chunk to issue: chunk pc of job pq
};

template <typename T>
__device__ __forceinline__ uint32_t slot(const Ring& r, int i) {
  return r.base + (i & 1) * (Tc<T>::kParts * kPart);
}
template <typename T>
__device__ __forceinline__ unsigned char* slot_ptr(const Ring& r, int i) {
  return r.ptr + (i & 1) * (Tc<T>::kParts * kPart);
}

// the ring at `smem` + Smem<T>::ring(F, kx, ka), its mbarriers initialised
template <typename T>
__device__ __forceinline__ Ring make_ring(unsigned char* smem, int F, int kx, int ka) {
  using S = Smem<T>;
  const int at = S::ring(F, kx, ka);
  Ring r{smem + at, tc::smem_u32(smem + at), tc::smem_u32(smem + S::bars(F, kx, ka)),
         0, 0, 0, 0};
  if (threadIdx.x == 0) {
    tc::mbar_init(r.bar, 1);
    tc::mbar_init(r.bar + 8, 1);
    tc::fence_mbar_init();
  }
  __syncthreads();
  return r;
}

__device__ __forceinline__ int job_steps(const BJob& j) {
  return j.steps[0] + (j.nprod > 1 ? j.steps[1] : 0);
}

// bytes of chunk c of job j (one part): up to 16 KB of whole k-steps
__device__ __forceinline__ int chunk_bytes(const BJob& j, int c) {
  const int spc = 512 >> j.rows_log2;
  return min(spc, job_steps(j) - c * spc) << (j.rows_log2 + 5);
}

// issue the next chunk of the plan's stream (nothing past its end) into the
// next slot (its hi part in f32): one bulk copy by thread 0, counted on the
// slot's mbarrier. The stream runs through every job's chunks in order, so a
// slot freed by one job's last chunk already takes the next job's.
template <typename T>
__device__ __forceinline__ void produce(const Plan& pl, Ring& r) {
  if (r.pq >= pl.njobs) return;
  const BJob& j = pl.jobs[r.pq];
  const int spc = 512 >> j.rows_log2;
  if (threadIdx.x == 0) {
    const int s0 = r.pc * spc;
    const int p = s0 >= j.steps[0] ? 1 : 0;  // a chunk lies in one product
    const int bytes = chunk_bytes(j, r.pc);
    const uint32_t bar = r.bar + 8 * (r.prod & 1);
    tc::mbar_expect_tx(bar, bytes);
    tc::bulk_g2s(slot<T>(r, r.prod), j.src[p] + ((s0 - (p ? j.steps[0] : 0)) << (j.rows_log2 + 5)),
                 bytes, bar);
  }
  ++r.prod;
  if ((r.pc + 1) * spc < job_steps(j)) {
    ++r.pc;
  } else {
    ++r.pq;
    r.pc = 0;
  }
}

// wait for chunk c of job j, the ring's chunk `idx`, and, in f32, split it
// in place into tf32 hi (hi part) and lo (lo part), the rounding of
// ops/_bwd.py:split_tf32: the weights cross L2 once; then make the split
// visible to the tensor cores (a barrier of the caller's follows)
template <typename T>
__device__ __forceinline__ void receive(const BJob& j, int c, const Ring& r, int idx) {
  tc::mbar_wait(r.bar + 8 * (idx & 1), (idx >> 1) & 1);
  if constexpr (Tc<T>::kParts == 2) {
    unsigned char* sl = slot_ptr<T>(r, idx);
    const int n16 = chunk_bytes(j, c) >> 4;
    for (int i = threadIdx.x; i < n16; i += kThreads) {
      float4* hp = reinterpret_cast<float4*>(sl) + i;
      const float4 v = *hp;
      float4 h, l;
      tc::split_tf32(v.x, h.x, l.x);
      tc::split_tf32(v.y, h.y, l.y);
      tc::split_tf32(v.z, h.z, l.z);
      tc::split_tf32(v.w, h.w, l.w);
      *hp = h;
      *reinterpret_cast<float4*>(sl + kPart + 16 * i) = l;
    }
    tc::fence_async_smem();
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one k-step of this warpgroup's 2 R columns (128 or 64): A's fragment at
// column k0 of the tile (rows of this warp), B's tile at shared address b;
// scale_d 0 starts the accumulator afresh
template <typename T, int R>
__device__ __forceinline__ void mma_step(float (&acc)[R], const T* A, int ld, int k0,
                                         uint32_t b, int scale_d) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r = warp * 16 + (lane >> 2);
  if constexpr (Tc<T>::kParts == 2) {
    const int c = k0 + (lane & 3);
    const float v[4] = {A[r * ld + c], A[(r + 8) * ld + c], A[r * ld + c + 4],
                        A[(r + 8) * ld + c + 4]};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h, l;
      tc::split_tf32(v[i], h, l);
      hi[i] = __float_as_uint(h);
      lo[i] = __float_as_uint(l);
    }
    const uint64_t bh = tc::desc_sw32(b), bl = tc::desc_sw32(b + kPart);
    tc::wg_fence();
    tc::mma_rs<T, 2 * R>(acc, lo, bh, scale_d);
    tc::mma_rs<T, 2 * R>(acc, hi, bl, 1);
    tc::mma_rs<T, 2 * R>(acc, hi, bh, 1);
  } else {
    const int c = k0 + 2 * (lane & 3);
    const uint32_t* A32 = reinterpret_cast<const uint32_t*>(A);
    const uint32_t a[4] = {A32[(r * ld + c) / 2], A32[((r + 8) * ld + c) / 2],
                           A32[(r * ld + c + 8) / 2], A32[((r + 8) * ld + c + 8) / 2]};
    tc::wg_fence();
    tc::mma_rs<T, 2 * R>(acc, a, tc::desc_sw32(b), scale_d);
  }
}

// one unit (Tc<T>::kSum k-steps from column k0 of A) of this warpgroup's 2 R
// columns into acc, afresh: f32 the cross terms lo*hi and hi*lo of every
// step first, then hi*hi of every step; bf16 one product. b: B's tile of the
// unit's first step, the next step's b + b_step. The caller commits.
template <typename T, int R>
__device__ __forceinline__ void mma_unit(float (&acc)[R], const T* A, int ld, int k0,
                                         uint32_t b, uint32_t b_step) {
  if constexpr (Tc<T>::kParts == 2) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r = warp * 16 + (lane >> 2);
    uint32_t hi[Tc<T>::kSum][4], lo[Tc<T>::kSum][4];
#pragma unroll
    for (int s = 0; s < Tc<T>::kSum; ++s) {
      const int c = k0 + s * Tc<T>::kKs + (lane & 3);
      const float v[4] = {A[r * ld + c], A[(r + 8) * ld + c], A[r * ld + c + 4],
                          A[(r + 8) * ld + c + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float h, l;
        tc::split_tf32(v[i], h, l);
        hi[s][i] = __float_as_uint(h);
        lo[s][i] = __float_as_uint(l);
      }
    }
    tc::wg_fence();
#pragma unroll
    for (int s = 0; s < Tc<T>::kSum; ++s) {
      const uint32_t bs = b + s * b_step;
      tc::mma_rs<T, 2 * R>(acc, lo[s], tc::desc_sw32(bs), s == 0 ? 0 : 1);
      tc::mma_rs<T, 2 * R>(acc, hi[s], tc::desc_sw32(bs + kPart), 1);
    }
#pragma unroll
    for (int s = 0; s < Tc<T>::kSum; ++s)
      tc::mma_rs<T, 2 * R>(acc, hi[s], tc::desc_sw32(b + s * b_step), 1);
  } else {
#pragma unroll
    for (int s = 0; s < Tc<T>::kSum; ++s)
      mma_step<T>(acc, A, ld, k0 + s * Tc<T>::kKs, b + s * b_step, s == 0 ? 0 : 1);
  }
}

// total = A0 W0 [+ A1 W1] for this warpgroup's 2 R columns of pass job q
// (R = 64: a 256-column pass; R = 32: a 128-column one),
// each chunk's (bf16: each k-step's) products summed afresh on the tensor
// cores and added to the f32 total. Chunk c + 1 is received (waited for and split) while chunk c's
// wgmmas run; one barrier per chunk then frees chunk c's slot for the next
// copy. Returns after that barrier for the last chunk: every wgmma of the
// block is done, H may be written.
template <typename T, int R>
__device__ __forceinline__ void pass(const Plan& pl, Ring& r, int q, ATile<T> a0, ATile<T> a1,
                                     float (&total)[R]) {
  constexpr int kKs = Tc<T>::kKs;
  const BJob& j = pl.jobs[q];
  const int spc = 512 >> j.rows_log2;
  const int steps = job_steps(j), steps0 = j.steps[0];
  const int nch = (steps + spc - 1) / spc;
  const uint32_t wg_off = (threadIdx.x >> 7) * (2 * R) * 32;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = total[i] = 0.0f;
  receive<T>(j, 0, r, r.cons);
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    const uint32_t cur = slot<T>(r, r.cons);
    const int ns = min(spc, steps - c * spc);
    bool received = c + 1 >= nch;
    tc::fence_regs(acc);
    for (int s = 0; s < ns; s += Tc<T>::kSum) {  // K is a multiple of 16: whole units
      const int gs = c * spc + s;
      const bool second = gs >= steps0;
      const ATile<T> a = second ? a1 : a0;
      mma_unit<T>(acc, a.p, a.ld, (second ? gs - steps0 : gs) * kKs,
                  cur + ((s << j.rows_log2) * 32) + wg_off, (1 << j.rows_log2) * 32);
      tc::wg_commit();
      if (!received) {
        receive<T>(j, c + 1, r, r.cons + 1);
        received = true;
      }
      tc::wg_wait<0>();
      tc::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < R; ++i) total[i] += acc[i];
    }
    ++r.cons;
    __syncthreads();  // chunk c's wgmmas done by all, chunk c + 1 split by all
    produce<T>(pl, r);
  }
}

// The epilogue of this thread's values of a pass (bias, D, G and pre
// offset by the caller to the pass's first column): v = acc + bias, then
// act(scale * v) rounded to T, kept in acc (a projection's input). With
// pre: v rounded to T to global row row0 + row (stride ld_pre) for rows < n;
// with D: the activation to shared memory (row stride ldd); with G: to
// global (stride ld_g), rows < n. Value 4i + 2h + e of the accumulator sits
// at row 16 warp + lane / 4 + 8h, column 2 R wg + 8i + 2 (lane % 4) + e.
template <typename T, int R>
__device__ __forceinline__ void epilogue(float (&acc)[R], const float* __restrict__ bias,
                                         int act, float scale, int sin_mode, T* pre,
                                         int ld_pre, T* D, int ldd, T* G, int ld_g, int row0,
                                         int n) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r = warp * 16 + (lane >> 2);
  const int cb = (threadIdx.x >> 7) * (2 * R) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    // keeps the compiler from hoisting every column's bias load (registers)
    asm volatile("" ::: "memory");
    const int col = cb + 8 * i;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      const bool valid = row0 + row < n;
      float v0 = acc[4 * i + 2 * h] + b0, v1 = acc[4 * i + 2 * h + 1] + b1;
      if (pre != nullptr && valid)
        tile::st2(pre + static_cast<size_t>(row0 + row) * ld_pre + col, v0, v1);
      if (act == kSine) {
        v0 = satnerf::sin_mode(scale * v0, sin_mode);
        v1 = satnerf::sin_mode(scale * v1, sin_mode);
      } else if (act == kRelu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      if constexpr (Tc<T>::kParts == 1) {  // the stored value, as every reader sees it
        v0 = __bfloat162float(__float2bfloat16(v0));
        v1 = __bfloat162float(__float2bfloat16(v1));
      }
      acc[4 * i + 2 * h] = v0;
      acc[4 * i + 2 * h + 1] = v1;
      if (D != nullptr) tile::st2(D + row * ldd + col, v0, v1);
      if (G != nullptr && valid)
        tile::st2(G + static_cast<size_t>(row0 + row) * ld_g + col, v0, v1);
    }
  }
}

// 16 output columns of this warpgroup's rows (an m64n16 accumulator, kept
// between projections in this thread's 8 floats at `keep` + 8 threadIdx.x in
// global memory, so that no pass holds it in registers; only this thread
// reads or writes them until the kernel's last barrier) += v (this
// warpgroup's 2 R columns of a pass, after the epilogue) @ the projection of
// job q (16 rows, K = 4 R; in f32 K permuted within groups of 8); `fresh`
// starts the sum at 0. Its one chunk is in flight; call after a barrier that
// follows the last wgmma on the other slot (pass's).
template <typename T, int R>
__device__ __forceinline__ void project(const Plan& pl, Ring& r, int q, float (&v)[R],
                                       float* keep, bool fresh) {
  constexpr int kKs = Tc<T>::kKs;
  constexpr int kMine = 2 * R / kKs;  // this warpgroup's k-steps
  // the wgmmas read their A registers asynchronously, so a fragment stays
  // live until its group completes: bf16 waits every kBatch k-steps
  constexpr int kBatch = 2;
  float out[8];
  float4* kp = reinterpret_cast<float4*>(keep + 8 * threadIdx.x);
  const float4 k0 = fresh ? make_float4(0.f, 0.f, 0.f, 0.f) : kp[0];
  const float4 k1 = fresh ? make_float4(0.f, 0.f, 0.f, 0.f) : kp[1];
  out[0] = k0.x; out[1] = k0.y; out[2] = k0.z; out[3] = k0.w;
  out[4] = k1.x; out[5] = k1.y; out[6] = k1.z; out[7] = k1.w;
  receive<T>(pl.jobs[q], 0, r, r.cons);
  __syncthreads();
  const uint32_t base = slot<T>(r, r.cons) + (threadIdx.x >> 7) * kMine * 16 * 32;
  tc::fence_regs(out);
  if constexpr (Tc<T>::kParts == 2) {
    // f32: each k-step's products start afresh (the cross terms, then hi*hi)
    // and join the running output in an f32 add; the wait also releases
    // the step's fragments
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const uint32_t b = base + i * 16 * 32;
      // fragment (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) <- columns
      // 2t, 2t (row + 8), 2t + 1, 2t + 1 (row + 8) of group i
      const float a[4] = {v[4 * i], v[4 * i + 2], v[4 * i + 1], v[4 * i + 3]};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float h, l;
        tc::split_tf32(a[e], h, l);
        hi[e] = __float_as_uint(h);
        lo[e] = __float_as_uint(l);
      }
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const uint64_t bh = tc::desc_sw32(b), bl = tc::desc_sw32(b + kPart);
      tc::fence_regs(acc);
      tc::wg_fence();
      tc::mma_rs<T, 16>(acc, lo, bh, 0);
      tc::mma_rs<T, 16>(acc, hi, bl, 1);
      tc::mma_rs<T, 16>(acc, hi, bh, 1);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(acc);
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] += acc[e];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const uint32_t a[4] = {pack_bf16(v[8 * i], v[8 * i + 1]),
                             pack_bf16(v[8 * i + 2], v[8 * i + 3]),
                             pack_bf16(v[8 * i + 4], v[8 * i + 5]),
                             pack_bf16(v[8 * i + 6], v[8 * i + 7])};
      tc::wg_fence();
      tc::mma_rs<T, 16>(out, a, tc::desc_sw32(base + i * 16 * 32), 1);
      if (i % kBatch == kBatch - 1) {  // release the fragments of kBatch k-steps
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_regs(out);
      }
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_regs(out);
  }
  kp[0] = make_float4(out[0], out[1], out[2], out[3]);
  kp[1] = make_float4(out[4], out[5], out[6], out[7]);
  ++r.cons;
  __syncthreads();  // its slot free
  produce<T>(pl, r);
}

// The first pass's values of a two-pass layer written in place, held while
// the second pass reads H. bf16: registers. f32: a per-thread local-memory
// array (volatile, so never promoted to registers; 256 bytes a thread,
// through L1/L2): beside the m64n128 accumulator and its f32 total they do
// not fit the 255 registers, ptxas spilled otherwise. It costs 64 KB out and
// 64 KB back per 512-wide layer and tile, an eighth of the layer's weight
// bytes (1 MB in f32); a 384-wide layer's second pass is the 128-column one,
// with half the registers of a full pass.
template <typename T>
using Held = std::conditional_t<Tc<T>::kParts == 2, volatile float, float>;

// this thread's values of a pass (after the epilogue) into the shared tile D
// (offset by the caller to the pass's first column), as epilogue places them
template <typename T, typename V, int R>
__device__ __forceinline__ void store_pass(const V (&v)[R], T* D, int ldd) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r = warp * 16 + (lane >> 2);
  const int cb = (threadIdx.x >> 7) * (2 * R) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < R / 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tile::st2(D + (r + 8 * h) * ldd + cb + 8 * i, v[4 * i + 2 * h], v[4 * i + 2 * h + 1]);
}

__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

// the inverse of store_pass: this thread's values of a pass from D
template <typename T, int R>
__device__ __forceinline__ void load_pass(float (&v)[R], const T* D, int ldd) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r = warp * 16 + (lane >> 2);
  const int cb = (threadIdx.x >> 7) * (2 * R) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < R / 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ld2(D + (r + 8 * h) * ldd + cb + 8 * i, v[4 * i + 2 * h], v[4 * i + 2 * h + 1]);
}

// rows row0 .. row0 + 63 of a (n, cols) row-major global array into a
// (64, k) shared tile (row stride ld), zero past n rows and past cols
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, int k, const T* src, int cols,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < kRows * k; i += kThreads) {
    const int r = i / k, c = i - r * k;
    dst[r * ld + c] = (row0 + r < n && c < cols)
                          ? src[static_cast<size_t>(row0 + r) * cols + c]
                          : tile::zero<T>();
  }
}

// host: the trunk's jobs (the passes of layer 0, then of 1 .. L-1 with their
// skips) of the prepared weights w0 (F, kx), w_mid (L-1, F, F), w_skip
// (S, F, kx)
inline void add_trunk_jobs(Plan& pl, size_t esz, int layers, int F, int kx, int skip_mask,
                           const void* w0, const void* w_mid, const void* w_skip) {
  const size_t ff = static_cast<size_t>(F) * F, fx = static_cast<size_t>(F) * kx;
  add_layer_jobs(pl, esz, F, w0, kx);
  int s = 0;
  for (int i = 1; i < layers; ++i) {
    const void* wi = static_cast<const char*>(w_mid) + (i - 1) * ff * esz;
    if ((skip_mask >> i) & 1) {
      add_layer_jobs(pl, esz, F, wi, F, static_cast<const char*>(w_skip) + s * fx * esz, kx);
      ++s;
    } else {
      add_layer_jobs(pl, esz, F, wi, F);
    }
  }
}

// An F-wide layer from [A0, A1] into H (row stride ldh): its passes
// (full_passes(F) of 256 columns, then tail_passes(F) of 128). In shared
// memory (kGlobalH false) H is A0 itself, written in place: in a two-pass
// layer the first pass's values wait (Held) until the second pass has read
// H. With kGlobalH, H is the other global buffer and each pass's epilogue
// stores to it at once. pre, G: the pre-activations and activations to
// global (row stride F, rows < n); then, with project_q >= 0, every pass
// projected by jobs project_q, ... into keep. Jobs q .. q + passes(F) - 1.
template <typename T, bool kGlobalH, typename Args>
__device__ __forceinline__ void wide_layer(const Args& a, const Plan& pl, Ring& r, int q, int F,
                                           ATile<T> a0, ATile<T> a1, const float* bias,
                                           int act, float scale, T* pre, T* H, int ldh, T* G,
                                           int row0, int project_q, float* keep) {
  const int full = full_passes(F), tail = tail_passes(F);
  float total[kNW / 2];
  if constexpr (kGlobalH) {
#pragma unroll 1
    for (int p = 0; p < full; ++p) {
      const int c0 = p * kPassCols;
      pass<T>(pl, r, q + p, a0, a1, total);
      epilogue<T>(total, bias + c0, act, scale, a.sin_mode, pre != nullptr ? pre + c0 : nullptr,
                  F, H + c0, ldh, G != nullptr ? G + c0 : nullptr, F, row0, a.n);
    }
    if (tail != 0) {
      const int c0 = full * kPassCols;
      float part[kNW / 4];
      pass<T>(pl, r, q + full, a0, a1, part);
      epilogue<T>(part, bias + c0, act, scale, a.sin_mode, pre != nullptr ? pre + c0 : nullptr,
                  F, H + c0, ldh, G != nullptr ? G + c0 : nullptr, F, row0, a.n);
    }
  } else {
    Held<T> held[kNW / 2];
#pragma unroll 1
    for (int p = 0; p < full; ++p) {
      const int c0 = p * kPassCols;
      pass<T>(pl, r, q + p, a0, a1, total);
      // the second pass's last barrier: nothing reads H any more, so the
      // first pass's values go first and are not live in its epilogue
      if (p == 1) store_pass<T>(held, H, ldh);
      epilogue<T>(total, bias + c0, act, scale, a.sin_mode, pre != nullptr ? pre + c0 : nullptr,
                  F, nullptr, 0, G != nullptr ? G + c0 : nullptr, F, row0, a.n);
      if (p == 0 && full + tail == 2) {
#pragma unroll
        for (int i = 0; i < kNW / 2; ++i) held[i] = total[i];
      }
    }
    if (tail == 0) {
      store_pass<T>(total, H + (full - 1) * kPassCols, ldh);
    } else {  // the 128-column pass, after the full one if any
      const int c0 = full * kPassCols;
      float part[kNW / 4];
      pass<T>(pl, r, q + full, a0, a1, part);
      if (full == 1) store_pass<T>(held, H, ldh);
      epilogue<T>(part, bias + c0, act, scale, a.sin_mode, pre != nullptr ? pre + c0 : nullptr,
                  F, nullptr, 0, G != nullptr ? G + c0 : nullptr, F, row0, a.n);
      store_pass<T>(part, H + c0, ldh);
    }
  }
  if (project_q >= 0) {  // from H (this thread's own values), so that neither pass's values stay live
#pragma unroll 1
    for (int p = 0; p < full; ++p) {
      load_pass<T>(total, H + p * kPassCols, ldh);
      project<T>(pl, r, project_q + p, total, keep, p == 0);
    }
    if (tail != 0) {
      float part[kNW / 4];
      load_pass<T>(part, H + full * kPassCols, ldh);
      project<T>(pl, r, project_q + full, part, keep, full == 0);
    }
  }
}

// The trunk over the tile: L layers of width a.feat from the x tile X, the
// residuals as the TPU kernel writes them (pre: layer i's pre-activations at
// acts + i * n * F, before the w0 scale of layer 0); with G, h_{L-1} also
// goes to global rows < n (stride F). H: the shared tile, written in place
// by every layer; with kGlobalH, the first of the block's two global
// buffers (the second at H + 64 F), layer i writing buffer i % 2. With
// P = passes(F): jobs 0 .. P L - 1 of the plan. kField (K1): then the sigma
// projection of h_{L-1} into `keep` (jobs P L ..) and the linear feats layer
// with bias b_feats (P (L + 1) ..), in place in H or into buffer L % 2. One
// loop (not unrolled) runs every layer, so the kernel holds one copy of it.
template <typename T, bool kField, bool kGlobalH, typename Args>
__device__ __forceinline__ void run_trunk(const Args& a, const Plan& pl, Ring& r, ATile<T> X,
                                          T* H, T* acts, T* G, int row0, float* keep,
                                          const float* b_feats) {
  const int F = a.feat, P = passes(F);
  const int ldh = kGlobalH ? F : Smem<T>::ldh(F);
  const float* b = static_cast<const float*>(a.b);
  const ATile<T> none{nullptr, 0};
#pragma unroll 1
  for (int i = 0; i < a.layers + (kField ? 1 : 0); ++i) {
    const bool feats = kField && i == a.layers;
    const bool skip = i > 0 && !feats && ((a.skip_mask >> i) & 1);
    const bool last = i == a.layers - 1;
    T* pre = acts != nullptr && !feats ? acts + static_cast<size_t>(i) * a.n * F : nullptr;
    // the layer's input (shared: H itself) and output
    T* in = kGlobalH ? H + ((i + 1) & 1) * kRows * F : H;
    T* out = kGlobalH ? H + (i & 1) * kRows * F : H;
    wide_layer<T, kGlobalH>(a, pl, r, feats ? P * (i + 1) : P * i, F,
                            i == 0 ? X : ATile<T>{in, ldh}, skip ? X : none,
                            feats ? b_feats : b + i * F, feats ? kLinear : kSine,
                            i == 0 ? a.w0_scale : 1.0f, pre, out, ldh, last ? G : nullptr, row0,
                            kField && last ? P * a.layers : -1, keep);
  }
}

// The tiles of this block: tile blockIdx.x alone (H in shared memory, one
// block per tile), or, with kGlobalH, blockIdx.x, blockIdx.x + gridDim.x, ...
// (h_slots persistent blocks). body(row0) runs one tile; the ring's stream of
// chunks starts again with each (its counters run on, so the mbarriers'
// phases stay in step).
template <bool kGlobalH, typename Body>
__device__ __forceinline__ void for_tiles(int n, Ring& r, Body&& body) {
  if constexpr (kGlobalH) {
    const int tiles = (n + kRows - 1) / kRows;
#pragma unroll 1
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      r.pq = r.pc = 0;
      body(t * kRows);
      __syncthreads();  // the tile's last reads of the block's tiles and accumulators
    }
  } else {
    body(static_cast<int>(blockIdx.x) * kRows);
  }
}

// host: the grid of a launch over n points: a block per 64-row tile, or with
// H in global memory at most h_slots persistent blocks
inline int grid_blocks(int n, int F, int h_slots) {
  const int tiles = (n + kRows - 1) / kRows;
  return global_h(F) && h_slots < tiles ? h_slots : tiles;
}

}  // namespace fwd
}  // namespace satnerf
