// Helpers shared by the fused conv's forward (fused_conv3x3.cu) and backward
// (fused_conv3x3_dgrad.cu, fused_conv3x3_wgrad.cu) kernels for Hopper
// (sm_90a): tile constants, the tensor-core instructions (mma.sync tf32 and
// bf16, ldmatrix, cp.async), the 3xTF32 split, the reflect and edge index
// maps, and the phase fold of the weights at up2_reflect.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TW = 16;            // tile columns: the M of one mma fragment
constexpr int HC = TW + 2;        // halo tile columns
constexpr int COT = 32;           // N channels per block (4 n8 fragments)
constexpr int NT = COT / 8;       // n8 fragments per warp
constexpr int KW = 8;             // 32-bit words of channels per chunk: 8 f32 or 16 bf16
constexpr int PS = KW + 4;        // smem words per pixel (and per weight row): bank-conflict-free
constexpr int WARPS = 4;          // warps per block
constexpr int THREADS = 32 * WARPS;
enum PadMode { kReflect = 0, kUp2Reflect = 1 };
enum Act { kNone = 0, kElu = 1 };

// Weight taps staged per (co, ci) pair: 9 at reflect, 16 phase taps at up2_reflect.
template <int MODE>
__host__ __device__ constexpr int taps_of() { return MODE == kReflect ? 9 : 16; }

template <typename T>
__host__ __device__ constexpr int elems_per_word() { return 4 / static_cast<int>(sizeof(T)); }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte async copy global -> shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
// Four 8x8 b16 matrices (rows of 16 bytes) from shared memory: lane L gives
// the address of row L % 8 of matrix L / 8 and receives, in register q, the
// 32-bit word L % 4 of row L / 4 of matrix q.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 consecutive channels: load and store, vectorised (aligned) or masked.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Source row (or column) of halo coordinate v (M-space tile origin - 1 + halo
// index).  reflect: v is an output coordinate of the padded grid, -1 -> 1 and
// n -> n - 2.  up2_reflect: v is a low-res coordinate of the edge-padded input,
// -1 -> 0 and n -> n - 1.  The clamp also covers coordinates past a ragged
// edge, which feed only masked outputs.
template <int MODE>
__device__ __forceinline__ int source_index(int v, int n) {
  if (MODE == kReflect) {
    v = v < 0 ? -v : v;
    v = v >= n ? 2 * n - 2 - v : v;
  }
  return min(max(v, 0), n - 1);
}

// The weight taps of one (co, ci) pair, OIHW raw[dy * 3 + dx], as staged: the
// 9 taps for reflect; for up2_reflect the 16 phase-summed 2x2 taps, index
// ((a * 2 + b) * 2 + ty) * 2 + tx, summed over dy first and then dx as
// footprints_tpu/ops/upconv.py:_phase_kernels does.
template <int MODE>
__device__ __forceinline__ void fold_taps(const float (&raw)[9], float (&out)[taps_of<MODE>()]) {
  if constexpr (MODE == kReflect) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = raw[k];
  } else {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float rs[2][3];  // row-summed taps [ty][dx]
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        rs[0][dx] = a == 0 ? raw[dx] : raw[dx] + raw[3 + dx];
        rs[1][dx] = a == 0 ? raw[3 + dx] + raw[6 + dx] : raw[6 + dx];
      }
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int ty = 0; ty < 2; ++ty) {
          const int base = ((a * 2 + b) * 2 + ty) * 2;
          out[base + 0] = b == 0 ? rs[ty][0] : rs[ty][0] + rs[ty][1];
          out[base + 1] = b == 0 ? rs[ty][1] + rs[ty][2] : rs[ty][2];
        }
    }
  }
}

// Raise `kernel`'s dynamic shared-memory limit to `smem` once per device
// (`done` holds one bit per device), not on every launch.
template <typename Kernel>
int smem_limit_once(Kernel kernel, size_t smem, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    done.fetch_or(bit);
  }
  return 0;
}

}  // namespace
