// Helpers shared by the fused conv's forward (fused_conv3x3.cu) and backward
// (fused_conv3x3_dgrad.cu, fused_conv3x3_wgrad.cu) kernels for Hopper
// (sm_90a): tile constants, the tensor-core instructions (wgmma with its
// shared-memory descriptors; mma.sync tf32 and bf16 and cp.async, which
// wgrad keeps; ldmatrix), the 3xTF32 split, the reflect and edge index maps,
// the phase fold of the weights at up2_reflect, mbarriers, bulk async
// copies, TMA tensor maps with the swizzled image their loads write, and the
// clock64() probe's stamps (compiled in only under FOOTPRINTS_PROBE).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TW = 16;            // tile columns: the M of one mma fragment
constexpr int HC = TW + 2;        // halo tile columns
constexpr int COT = 32;           // wgrad: output channels per block
constexpr int WARPS = 4;          // warps per block
constexpr int THREADS = 32 * WARPS;
enum PadMode { kReflect = 0, kUp2Reflect = 1 };
enum Act { kNone = 0, kElu = 1 };

// Weight taps staged per (co, ci) pair: 9 at reflect, 16 phase taps at up2_reflect.
template <int MODE>
__host__ __device__ constexpr int taps_of() { return MODE == kReflect ? 9 : 16; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
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

// 4 consecutive channels, stored vectorised (aligned).
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

// ---- Hopper's instructions: wgmma, mbarriers, bulk copies ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The TF32 split as the backward stores it: hi = tf32(v), lo = tf32(v - hi),
// each with its 13 low bits cleared, so the stored bits are exactly the TF32
// values (ops/fused_conv.py:tf32_split_plain emulates it bit for bit).
__device__ __forceinline__ void split_tf32_bits(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v) & 0xffffe000u;
  lo = tf32(v - __uint_as_float(hi)) & 0xffffe000u;
}

// The split the kernels apply to operands as they land: hi as above, lo =
// v - hi left in f32 (exact; the tensor cores read only its TF32 bits, so
// hi + lo stays within 2^-21 |v|): one conversion per element.
__device__ __forceinline__ void split_tf32_landed(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// ldmatrix, transposed: lane L gives the address of row L % 8 of matrix L / 8
// and receives, in register q, elements (2 (L % 4), L / 4) and
// (2 (L % 4) + 1, L / 4) of matrix q: a row of the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// mbarrier in shared memory: init (one thread), arrive with an expected
// transaction byte count, and the parity wait.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One bulk async copy global -> shared (16-byte aligned, a multiple of 16
// bytes) that completes `bytes` transactions on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* smem, const void* gmem, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- TMA: tensor maps, tiled loads and the swizzled image they write ----

// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (a TMA load into a buffer the thread wrote or read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA tiled load of a 4-d box (innermost coordinate first; out-of-range
// elements are written as zeros) into shared memory, completing the box's
// bytes as transactions on `bar`.
__device__ __forceinline__ void tma_load_4d(void* smem, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// Byte offset, inside a 1024-byte aligned buffer, of byte `off` of the image
// a TMA load writes with the swizzle of rows of RB bytes (32, 64 or 128:
// CU_TENSOR_MAP_SWIZZLE_32B/64B/128B): the 16-byte chunk index within each
// 128-byte line is XORed with the line's index mod RB / 16.  Eight rows of
// 16 bytes at one column of 8 consecutive pixels then fall in 8 distinct
// bank groups: ldmatrix reads them without conflicts and without padding.
template <int RB>
__host__ __device__ constexpr uint32_t swizzled(uint32_t off) {
  static_assert(RB == 32 || RB == 64 || RB == 128, "TMA swizzles rows of 32, 64 or 128 bytes");
  return off ^ (((off >> 7) & (RB / 16 - 1)) << 4);
}
template <int RB>
constexpr CUtensorMapSwizzle swizzle_mode() {
  return RB == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                  : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}

constexpr size_t align1024(size_t v) { return (v + 1023) & ~size_t{1023}; }

// cuTensorMapEncodeTiled (libcuda), found through the runtime (no link
// against libcuda).
inline decltype(&cuTensorMapEncodeTiled) tensor_map_encoder() {
  static decltype(&cuTensorMapEncodeTiled) fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of an NHWC tensor [N, H, W, C] of T for TMA boxes of
// `box` (channels, columns, rows, 1), each dimension but the channels' read
// every `step`-th element (1, or 2 to read one output phase of an up2
// tensor), with the swizzle of RB-byte rows.  C * sizeof(T) and the base
// address must be multiples of 16 bytes.  Returns 0 or a CUDA error.
template <typename T, int RB>
int nhwc_tensor_map(CUtensorMap* map, const void* base, int N, int H, int W, int C,
                    const uint32_t (&box)[4], uint32_t step) {
  const auto encode = tensor_map_encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)W * C * sizeof(T),
                                 (cuuint64_t)H * W * C * sizeof(T)};
  const cuuint32_t boxes[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t steps[4] = {1, step, step, 1};
  const CUresult r = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(base), dims, strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle_mode<RB>(), CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// wgmma's shared-memory matrix descriptor, no swizzle: the operand is made
// of 8-row x 16-byte core matrices, each one contiguous 128-byte line;
// `lbo` is the byte stride between core matrices along K, `sbo` along M/N.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo & 0x3ffff) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3ffff) >> 4) << 32;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin the accumulators' order against the asynchronous wgmma (after a wait).
template <int R>
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x K] B[K x N], A from registers (each warp its 16 rows,
// the mma.sync m16n8kK fragment), B from shared memory (K-major descriptor),
// f32 accumulators in the mma.sync C layout per n8 block.  tf32: K = 8;
// bf16: K = 16.
#define FP_D16(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define FP_D32(d)                                                                               \
  FP_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),     \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),             \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FP_R16                                                                            \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1"
#define FP_R32                                                                              \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
  "%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1"

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " FP_R16 ";\n}\n"
      : FP_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FP_R32 ";\n}\n"
      : FP_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FP_R16 ", 0;\n}\n"
      : FP_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FP_R32 ", 0;\n}\n"
      : FP_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef FP_D16
#undef FP_D32
#undef FP_R16
#undef FP_R32

// The clock64() probe (FOOTPRINTS_PROBE builds only): per block, thread 0's
// cycles waiting (on copies, mbarriers and barriers), staging (issuing
// copies, the f32 split), in the MMAs and in the epilogue, its SM and its
// start and end on the global nanosecond timer: PROBE_FIELDS 64-bit words at
// probe_buf[block * PROBE_FIELDS], for the first probe_cap blocks.
constexpr int PROBE_FIELDS = 7;  // wait, stage, mma, epilogue cycles; smid; start, end ns
#ifdef FOOTPRINTS_PROBE
__device__ unsigned long long* probe_buf;
__device__ long long probe_cap;
struct Probe {
  unsigned long long wait = 0, stage = 0, mma = 0, epi = 0, t = 0, start_ns = 0;
  __device__ static unsigned long long ns() {
    unsigned long long v;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
    return v;
  }
  __device__ void begin() {
    if (threadIdx.x == 0) { start_ns = ns(); t = clock64(); }
  }
  // charge the cycles since the last mark to `field`
  __device__ void mark(unsigned long long& field) {
    if (threadIdx.x == 0) {
      const unsigned long long now = clock64();
      field += now - t;
      t = now;
    }
  }
  __device__ void end(long long block) {
    if (threadIdx.x == 0 && probe_buf && block < probe_cap) {
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      unsigned long long* p = probe_buf + block * PROBE_FIELDS;
      p[0] = wait; p[1] = stage; p[2] = mma; p[3] = epi; p[4] = smid; p[5] = start_ns;
      p[6] = ns();
    }
  }
};
#define PROBE_BEGIN(pr) (pr).begin()
#define PROBE_MARK(pr, field) (pr).mark((pr).field)
#define PROBE_END(pr, block) (pr).end(block)

// Where the blocks write their stamps: `buf`, room for `blocks` blocks
// (null: none).  Returns a CUDA error code.
inline int probe_set(void* buf, long long blocks) {
  cudaError_t err = cudaMemcpyToSymbol(probe_buf, &buf, sizeof(buf));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(probe_cap, &blocks, sizeof(blocks));
  return static_cast<int>(err);
}
#else
struct Probe {};
#define PROBE_BEGIN(pr) ((void)(pr))
#define PROBE_MARK(pr, field) ((void)0)
#define PROBE_END(pr, block) ((void)0)
#endif

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
