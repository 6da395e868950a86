// K6's loop: the tensor-core trunk of trunk_tc.cuh (K1, K3) rebuilt as a
// warp-specialised ping-pong, for the interleaved variant K6 (trunk_fwd.cu):
//   h_0 = sin(w0 * (x @ W0 + b0)),  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
//
// The idea it carries over is the prototype's (tools/interleave_trunk_proto.py
// _fwd_kernel_il): the products of one half of the work run while the sine of
// the other half is evaluated. In K3 both warpgroups of a block reach their
// epilogue (bias, w0 scale, sine, stores) at once, after a block-wide barrier
// that ends every two-k-step chunk, so the tensor cores wait while the sines
// run. Here the block has three warpgroups:
//
// - A producer warpgroup gives up its registers (setmaxnreg.dec); one thread
//   of it streams the weights into a ring of 64 KB (four 16 KB slots in f32,
//   eight 8 KB slots in bf16), a slot per two k-steps, each slot with a
//   "full" mbarrier (the bulk copies' bytes) and an "empty" one (the four
//   warps of the warpgroup that read it). The chunks come in the order the
//   tensor cores take them, so each slot is read by one warpgroup only.
// - Two consumer warpgroups (setmaxnreg.inc) own K3's columns: for every
//   256-column pass p of a 512-wide layer, warpgroup g computes columns
//   [256 p + 128 g, 256 p + 128 g + 128) of the block's 64 rows, with m64n128
//   wgmmas whose A fragment each thread loads from the activation tile H (and
//   in f32 splits into tf32 hi + lo), as K3 does. A consumer waits on "full",
//   issues the slot's wgmmas, waits for them and arrives on "empty"; no
//   block-wide barrier runs per chunk.
// - Ping-pong: two named barriers hand the tensor cores from one consumer to
//   the other, so the passes' products run in the order (layer i) g0 p0,
//   g1 p0, g0 p1, g1 p1, and each warpgroup's epilogue of a pass runs under
//   the other's products of the next. Layer i + 1 reads all of H, so after
//   the last pass of a layer both write H (the first pass's values were held,
//   as K3's Held, since the other warpgroup still read H) and meet at a third
//   barrier: one epilogue per layer is not hidden. The turns also keep each
//   consumer inside the producer's window: a warpgroup starts a pass only
//   once every earlier chunk of the stream has been read, so it never waits
//   on a slot two phases ahead of the producer (a parity wait cannot tell
//   those apart from the phase before).
//
// Why columns, not one 64-row tile per warpgroup (the prototype's split of
// rows): a warpgroup that owns all 512 columns of its rows must, to write H in
// place, hold three of its four passes' values beside the pass's f32 total and
// its fresh accumulator (over 230 registers), or keep a second H (two more
// 64 KB tiles in bf16, beyond the 227 KB of shared memory); and the two
// warpgroups, a pass apart, would need the same weights a pass apart (128 KB
// of ring in bf16). With columns, both dtypes fit (f32: H 132 KB, x 17 KB,
// ring 64 KB) and each weight byte crosses L2 into shared memory once per
// tile, as in K3.
//
// In f32 the weights are split into tf32 hi and lo once, by the wrapper
// (ops/trunk.py:tc_split_weights, the rounding of split_tf32): 2 x 8 MB for
// the flagship's 8x512, which stays in the 50 MB L2. The producer copies
// both parts, so the consumers' only shared-memory work is their A fragments
// (K3 splits each chunk in the consumer threads, behind the barrier).
//
// The order of sums is K3's: a fresh accumulator per Tc<T>::kSum k-steps
// (f32 2, cross terms first; bf16 1: fwd::mma_unit), added into an f32
// total in registers, then K3's epilogue (fwd::epilogue); so K6 equals K3
// bit for bit. One accumulator is in flight
// at a time: the unit's wgmmas, then its sum. A second one, to keep the next
// unit's wgmmas running under the sum (wg_wait<1>), spilled in bf16 (192
// registers of sums beside the A fragments) and was no faster, so the
// tensor cores of a warpgroup wait for each unit's 64 adds while the other
// warpgroup's epilogue runs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_tc.cuh"

namespace satnerf {
namespace ws {

using fwd::ATile;
using fwd::Tc;

constexpr int kConsumers = fwd::kThreads;   // threads 0 .. 255: two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kNW = fwd::kNW;               // columns of a warpgroup's pass
constexpr int kStep = kNW * 32;             // bytes of one k-step of its W^T rows
constexpr int kChunk = 2;                   // k-steps per ring slot
constexpr int kRingBytes = 65536;
constexpr int kTurn0 = 1, kTurn1 = 2, kLayer = 3;       // named barriers (0: __syncthreads)

template <typename T>
struct Ring {
  static constexpr int kSlotBytes = kChunk * kStep * Tc<T>::kParts;
  static constexpr int kSlots = kRingBytes / kSlotBytes;  // f32 4, bf16 8
  // registers after setmaxnreg: the block's 384 x 168 shared out as
  // 128 x producer + 256 x consumer (the f32 producer streams two parts)
  static constexpr int kProducerRegs = Tc<T>::kParts == 2 ? 56 : 40;
  static constexpr int kConsumerRegs = (168 * kThreads - 128 * kProducerRegs) / kConsumers;
  static_assert(kConsumerRegs % 8 == 0, "setmaxnreg takes multiples of 8");
};

// shared address of slot j: in f32 its hi part, with the lo part
// fwd::kPart bytes past it (where fwd::mma_step reads it), two slots per
// 32 KB; in bf16 8 KB slots back to back
template <typename T>
__device__ __forceinline__ uint32_t slot_addr(uint32_t ring, int j) {
  if constexpr (Tc<T>::kParts == 2)
    return ring + (j >> 1) * (2 * fwd::kPart) + (j & 1) * (kChunk * kStep);
  else
    return ring + j * (kChunk * kStep);
}

// K6's widest x tile: K after padding to 16 (K3 takes up to fwd::kMaxX)
constexpr int kMaxX = 64;

// H (64, F), the x tile (64, kMaxX), the 1,024-byte aligned ring, the
// full and empty mbarriers
template <typename T, int F>
struct Smem {
  static constexpr int kLdh = F + Tc<T>::kPad;
  static constexpr int kLdx = kMaxX + Tc<T>::kPad;
  static constexpr int kTiles = fwd::kRows * (kLdh + kLdx) * static_cast<int>(sizeof(T));
  static constexpr int kRing = (kTiles + 1023) / 1024 * 1024;
  static constexpr int kBars = kRing + kRingBytes;
  static constexpr int kBytes = kBars + 2 * 8 * Ring<T>::kSlots + 1024;  // + alignment
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// named barriers over the two consumer warpgroups
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

// One product of layer i in the prepared layout (ops/trunk.py:tc_operand):
// the hi (or bf16) and lo weights, its k-steps, and the bytes of one
// 256-row pass block; j = 0: W0 (i = 0) or W_i, j = 1: the skip's Ws_i
struct Prod {
  const char* hi;
  const char* lo;
  int steps;
  size_t pass_bytes;
};

template <typename Args>
__device__ __forceinline__ int products(const Args& a, int i) {
  return i > 0 && ((a.skip_mask >> i) & 1) ? 2 : 1;
}

template <typename T, int F, typename Args>
__device__ __forceinline__ Prod product(const Args& a, int i, int j, int kx) {
  constexpr size_t esz = sizeof(T);
  const int k = (i == 0 || j == 1) ? kx : F;
  size_t off = 0;
  const void *hi = a.w0, *lo = a.w0_lo;
  if (j == 1) {
    off = static_cast<size_t>(__popc(a.skip_mask & ((1 << i) - 1))) * F * kx * esz;
    hi = a.w_skip;
    lo = a.w_skip_lo;
  } else if (i > 0) {
    off = static_cast<size_t>(i - 1) * F * F * esz;
    hi = a.w_mid;
    lo = a.w_mid_lo;
  }
  return {static_cast<const char*>(hi) + off,
          lo != nullptr ? static_cast<const char*>(lo) + off : nullptr,
          static_cast<int>(k * esz / 32), static_cast<size_t>(fwd::kPassCols) * k * esz};
}

// The producer thread: every chunk of the tile's stream, in the consumers'
// order (layer i: pass 0 of warpgroup 0, of warpgroup 1, then pass 1), each
// into the next slot once its readers have freed it. A chunk is up to two
// k-steps of one warpgroup's 128 rows of W^T: one 4 KB bulk copy per k-step
// (and per part in f32), counted on the slot's full barrier.
template <typename T, int F, typename Args>
__device__ __forceinline__ void produce(const Args& a, uint32_t ring, uint32_t full,
                                        uint32_t empty) {
  constexpr int S = Ring<T>::kSlots;
  const int kx = fwd::round16(a.cx);
  int q = 0;
#pragma unroll 1
  for (int i = 0; i < a.layers; ++i) {
#pragma unroll 1
    for (int pg = 0; pg < 4; ++pg) {
#pragma unroll 1
      for (int j = 0; j < products(a, i); ++j) {
        const Prod pr = product<T, F>(a, i, j, kx);
        const size_t base = (pg >> 1) * pr.pass_bytes + (pg & 1) * kStep;
#pragma unroll 1
        for (int c = 0; kChunk * c < pr.steps; ++c, ++q) {
          const int slot = q % S;
          const uint32_t fb = full + 8 * slot;
          tc::mbar_wait(empty + 8 * slot, ((q / S) & 1) ^ 1);
          const int ns = min(kChunk, pr.steps - kChunk * c);
          tc::mbar_expect_tx(fb, ns * kStep * Tc<T>::kParts);
          for (int s = 0; s < ns; ++s) {
            // k-step tiles are 256 rows x 32 bytes apart; this warpgroup's
            // rows start kStep into each
            const size_t src = base + static_cast<size_t>(kChunk * c + s) * (2 * kStep);
            const uint32_t dst = slot_addr<T>(ring, slot) + s * kStep;
            tc::bulk_g2s(dst, pr.hi + src, kStep, fb);
            if constexpr (Tc<T>::kParts == 2) tc::bulk_g2s(dst + fwd::kPart, pr.lo + src, kStep, fb);
          }
        }
      }
    }
  }
}

// One unit of a pass's products, Tc<T>::kSum k-steps summed afresh: in f32
// a chunk (two k-steps: every product's K is a multiple of 16), in bf16 one
// k-step; the chunk q of the stream it reads, its first k-step in the chunk,
// its first K column, its product, and whether it is the chunk's last unit
// (which frees the slot)
struct Unit {
  int q, s0, k0, prod;
  bool last;
};

template <typename T>
__device__ __forceinline__ Unit unit_at(int u, int q0, int steps0, int steps1) {
  const int ch0 = (steps0 + kChunk - 1) / kChunk;
  Unit v;
  if constexpr (Tc<T>::kSum == kChunk) {
    v.prod = u >= ch0;
    const int c = v.prod ? u - ch0 : u;
    v.q = q0 + u;
    v.s0 = 0;
    v.k0 = kChunk * c * Tc<T>::kKs;
    v.last = true;
  } else {
    v.prod = u >= steps0;
    const int t = v.prod ? u - steps0 : u;
    v.q = q0 + (v.prod ? ch0 : 0) + t / kChunk;
    v.s0 = t % kChunk;
    v.k0 = t * Tc<T>::kKs;
    v.last = v.s0 == kChunk - 1 || t == (v.prod ? steps1 : steps0) - 1;
  }
  return v;
}

// issue a unit's wgmmas into acc (a fresh sum), waiting for its chunk first
template <typename T>
__device__ __forceinline__ void issue(const Unit& v, ATile<T> a0, ATile<T> a1, uint32_t ring,
                                      uint32_t full, float (&acc)[kNW / 2]) {
  constexpr int S = Ring<T>::kSlots;
  const int slot = v.q % S;
  if (v.s0 == 0) tc::mbar_wait(full + 8 * slot, (v.q / S) & 1);
  const ATile<T> A = v.prod ? a1 : a0;
  const uint32_t b = slot_addr<T>(ring, slot) + v.s0 * kStep;
  tc::fence_regs(acc);
  fwd::mma_unit<T>(acc, A.p, A.ld, v.k0, b, kStep);
  tc::wg_commit();
}

// after the unit's wgmmas retired: free its slot (the chunk's last unit)
// and add its sum into the f32 total
template <typename T>
__device__ __forceinline__ void retire(const Unit& v, uint32_t empty, float (&acc)[kNW / 2],
                                       float (&total)[kNW / 2]) {
  if (v.last && (threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * (v.q % Ring<T>::kSlots));
  tc::fence_regs(acc);
#pragma unroll
  for (int i = 0; i < kNW / 2; ++i) total[i] += acc[i];
}

// total = A0 W0 [+ A1 W1] for this warpgroup's 128 columns of one pass: the
// chunks q0 .. of the stream, steps0 (steps1) k-steps of each product; each
// unit's wgmmas, their wait, the slot freed, the sum added
template <typename T>
__device__ __forceinline__ void mma_phase(int q0, ATile<T> a0, int steps0, ATile<T> a1,
                                          int steps1, uint32_t ring, uint32_t full,
                                          uint32_t empty, float (&total)[kNW / 2]) {
  const int units = Tc<T>::kSum == kChunk
                        ? (steps0 + kChunk - 1) / kChunk + (steps1 + kChunk - 1) / kChunk
                        : steps0 + steps1;
#pragma unroll
  for (int i = 0; i < kNW / 2; ++i) total[i] = 0.0f;
  float acc[kNW / 2];
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    const Unit v = unit_at<T>(u, q0, steps0, steps1);
    issue<T>(v, a0, a1, ring, full, acc);
    tc::wg_wait<0>();
    retire<T>(v, empty, acc, total);
  }
}

// A consumer warpgroup g (threadIdx.x / 128, read warp-uniformly by the
// caller, so that ptxas sees its wgmmas on a converged path) over the
// block's 64 rows from row0: the x tile, then every layer's two passes in
// ping-pong with the other warpgroup, h_{L-1} to a.out (rows < n) from the
// last layer's epilogues.
template <typename T, int F, typename Args>
__device__ __forceinline__ void consume(const Args& a, int g, T* H, T* X, uint32_t ring,
                                        uint32_t full, uint32_t empty, int row0) {
  static_assert(F == 2 * fwd::kPassCols, "two passes per layer");
  constexpr int kLdh = Smem<T, F>::kLdh, kLdx = Smem<T, F>::kLdx;
  const int mine = g == 0 ? kTurn0 : kTurn1, theirs = g == 0 ? kTurn1 : kTurn0;
  const int kx = fwd::round16(a.cx);
  const int steps_x = kx * static_cast<int>(sizeof(T)) / 32;
  const int steps_h = F * static_cast<int>(sizeof(T)) / 32;
  const float* b = static_cast<const float*>(a.b);
  T* out = static_cast<T*>(a.out);
  const ATile<T> Xt{X, kLdx}, Ht{H, kLdh}, none{nullptr, 0};
  fwd::load_tile(X, kLdx, kx, static_cast<const T*>(a.x), a.cx, row0, a.n);
  bar_sync(kLayer);
  if (g == 1) bar_arrive(kTurn0);  // warpgroup 0 takes the tensor cores first
  int q = 0;
#pragma unroll 1
  for (int i = 0; i < a.layers; ++i) {
    const bool skip = i > 0 && ((a.skip_mask >> i) & 1);
    const bool last = i == a.layers - 1;
    const ATile<T> a0 = i == 0 ? Xt : Ht;
    const int s0 = i == 0 ? steps_x : steps_h, s1 = skip ? steps_x : 0;
    const int nch = (s0 + kChunk - 1) / kChunk + (s1 + kChunk - 1) / kChunk;
    const float scale = i == 0 ? a.w0_scale : 1.0f;
    float total[kNW / 2];
    volatile float held[kNW / 2];  // local memory, as K3's f32 Held
    // pass 0: warpgroup 0 holds the turn from the last layer's end
    if (g == 1 || i == 0) bar_sync(mine);
    mma_phase<T>(q + g * nch, a0, s0, skip ? Xt : none, s1, ring, full, empty, total);
    bar_arrive(theirs);
    fwd::epilogue<T>(total, b + i * F, fwd::kSine, scale, a.sin_mode, nullptr, 0, nullptr, 0,
                     last ? out : nullptr, F, row0, a.n);
#pragma unroll
    for (int k = 0; k < kNW / 2; ++k) held[k] = total[k];
    // pass 1
    bar_sync(mine);
    mma_phase<T>(q + (2 + g) * nch, a0, s0, skip ? Xt : none, s1, ring, full, empty,
                         total);
    if (g == 0 || !last) bar_arrive(theirs);
    fwd::epilogue<T>(total, b + i * F + fwd::kPassCols, fwd::kSine, scale, a.sin_mode,
                     nullptr, 0, nullptr, 0, last ? out + fwd::kPassCols : nullptr, F, row0,
                     a.n);
    if (!last) {
      // warpgroup 1 has read H (and warpgroup 0 holds the next turn)
      if (g == 0) bar_sync(mine);
      fwd::store_pass<T>(held, H, kLdh);
      fwd::store_pass<T>(total, H + fwd::kPassCols, kLdh);
      bar_sync(kLayer);  // H holds h_i for both warpgroups
    }
    q += 4 * nch;
  }
}

}  // namespace ws
}  // namespace satnerf
