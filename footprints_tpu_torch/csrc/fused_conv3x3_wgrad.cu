// Gradient on w of the fused 3x3 conv (wgrad), for Hopper (sm_90a).
//
// Replaces the w half of the XLA backward that the JAX package's custom_vjp
// wrappers of the Pallas kernel footprints_tpu/ops/pallas_conv.py:fused_conv3x3
// run (_up_bwd :221, _s2d_bwd :243, _s2d_res_bwd :265; for small outputs
// the single contraction of ops/wgrad.py:conv3x3_valid_small_co :42, _bwd :62).
// It computes
//     gw[co, ci, dy, dx] = sum over n, h, w of gz[n, h, w, co] * xpad[n, h + dy, w + dx, ci]
// from the pre-activation cotangent gz [N,Ho,Wo,Co] and x [N,H,W,Ci], both
// NHWC, with xpad read through the reflect (or, at up2_reflect, the nearest-up
// and edge) index map, never materialised; gw is OIHW [Co,Ci,3,3] in x's dtype.
//
// What bounds it: the forward's MACs on the tensor cores (3 TF32 products per
// MAC in f32, 3xTF32; bf16 operands are exact in TF32, so the bf16 route takes
// one TF32 product per MAC) over a reduction of N x H x W terms (1,474,560 for
// the decoder's last conv at batch 12): bound by operations.
//
// What the design does about it:
//   * implicit GEMM with M = 32 output channels per block (2 m16 fragments),
//     N = 32 input channels per block (one n8 fragment per warp), K = pixels.
//     A block sums a run of tiles of 4 x 32 pixels.  Each tile's cotangent
//     and x's halo of 6 x 34 pixels (through the index map) are staged in x's
//     dtype as [pixel][channel] by 16-byte cp.async into two buffers, the
//     next tile's while this one is summed, so the loads' latency overlaps
//     the MMAs of the tile before (2 blocks per SM alone do not hide it).
//     A and B are read with scalar
//     loads (B for tap (dy, dx) is the halo shifted by the tap, which breaks
//     ldmatrix's 16-byte rows), bank-conflict-free with 40 elements a pixel;
//   * up2_reflect in the phase form: each block takes one output phase (pa, pb)
//     of a low-res tile, 4 taps of its 2x2 conv on the edge-padded low-res x,
//     16 (phase, tap) sums where the full-resolution form has 9 taps at 4
//     times the pixels; the second pass folds them back to 3x3 through the
//     adjoint of the phase sums (footprints_tpu/ops/upconv.py:_phase_kernels);
//   * the reduction is split over blocks, each a fixed run of tiles (about 3-6
//     thousand pixels at the decoder's batch-12 shapes).  The tensor cores'
//     f32 accumulation truncates, so each tile's sums (128 pixels) start from
//     zero in the MMA accumulators and are then added, rounded to nearest, into
//     the block's f32 sums; each block writes its [taps][Ci][Co] partial into
//     scratch the wrapper allocates.  The second kernel sums the partials in
//     block order and writes gw.  No atomics: the same bits every run;
//   * ragged H, W, Ci, Co are masked: no divisibility rule.
//
// Plain C interface (no PyTorch headers) for ctypes; see ops/build.py.

#include "fused_conv3x3_common.cuh"

namespace {

constexpr int WTR = 4;                  // tile rows (M space: x rows, low-res rows at up2)
constexpr int WTC = 32;                 // tile columns
constexpr int WTP = WTR * WTC;          // tile pixels: the K of one tile
constexpr int WHC = WTC + 2;            // x halo columns
constexpr int WHPIX = (WTR + 2) * WHC;  // x halo pixels
constexpr int WCO = 32;                 // output channels per block: 2 m16 fragments
constexpr int WCI = 8 * WARPS;          // input channels per block: one n8 fragment a warp
// smem elements per pixel of the x halo and of the cotangent tile: 8 past
// the 32 channels, so each fragment's scalar loads hit 32 distinct banks
// (f32 words t * 40 + g; bf16 words t * 20 + g / 2) and rows stay 16-byte
// aligned for cp.async
constexpr int SX = WCI + 8;
constexpr int SG = WCO + 8;
constexpr int BUF = WHPIX * SX + WTP * SG;  // elements per tile buffer
// Blocks the reduction is split into, over all (co, ci, phase) tiles: about
// four waves of blocks on the H100's 132 SMs.  A constant, so that the order
// of the sums, and the result's bits, depend on the shapes only.
constexpr int TARGET_BLOCKS = 4 * 132;

template <int MODE>
struct WgradGeometry {
  static constexpr int PHASES = MODE == kReflect ? 1 : 4;  // blocks per tile: up2's phases
  static constexpr int BT = MODE == kReflect ? 9 : 4;      // taps a block sums
  static constexpr int TAPS = taps_of<MODE>();             // taps in a partial
};

struct Tiling {
  int tiles;      // pixel tiles of the whole batch
  int per_block;  // tiles a block sums
  int blocks;     // partial sums per (co, ci, phase) tile
};

template <int MODE>
Tiling wgrad_tiling(int N, int H, int W, int Ci, int Co) {
  const int tiles = N * ((H + WTR - 1) / WTR) * ((W + WTC - 1) / WTC);
  const int others = ((Co + WCO - 1) / WCO) * ((Ci + WCI - 1) / WCI) * WgradGeometry<MODE>::PHASES;
  int blocks = (TARGET_BLOCKS + others - 1) / others;
  blocks = blocks < tiles ? blocks : tiles;
  const int per_block = blocks > 0 ? (tiles + blocks - 1) / blocks : 1;
  blocks = (tiles + per_block - 1) / per_block;
  return {tiles, per_block, blocks > 0 ? blocks : 1};
}

// two tile buffers (the next tile loads while this one is summed)
template <typename T>
constexpr size_t wgrad_smem_bytes() { return sizeof(T) * 2 * BUF; }

// An operand element from shared memory as the bits of an f32 (bf16 values
// are exact in f32 and in TF32).
__device__ __forceinline__ uint32_t operand(const float* p) { return __float_as_uint(*p); }
__device__ __forceinline__ uint32_t operand(const __nv_bfloat16* p) {
  return __float_as_uint(__bfloat162float(*p));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
fused_conv3x3_wgrad_partial_kernel(const T* __restrict__ gz, const T* __restrict__ x,
                                   float* __restrict__ partial, int H, int W, int Ci, int Co,
                                   int tiles, int per_block, bool vec_x, bool vec_g) {
  using G = WgradGeometry<MODE>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int GE = 16 / sizeof(T);  // channels per 16-byte group

  extern __shared__ __align__(16) uint32_t smem[];
  // [2][x halo [WHPIX][SX], cotangent [WTP][SG]], in x's dtype
  T* s_buf = reinterpret_cast<T*>(smem);

  const int Ho = MODE == kReflect ? H : 2 * H;
  const int Wo = MODE == kReflect ? W : 2 * W;
  const int phase = blockIdx.z % G::PHASES;
  const int pa = phase >> 1, pb = phase & 1;
  const int ci_tile = (blockIdx.z / G::PHASES) * WCI;
  const int co_tile = blockIdx.y * WCO;
  const int tiles_x = (W + WTC - 1) / WTC;
  const int tiles_img = tiles_x * ((H + WTR - 1) / WTR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // One tile into buffer `buf`: x's halo through the index map, and the
  // cotangent (of phase (pa, pb) at up2_reflect; zero past a ragged edge, so
  // those pixels add nothing), by 16-byte cp.async groups where the channel
  // counts and addresses allow, else by plain loads.  One commit group.
  auto stage = [&](int tile, int buf) {
    const int n = tile / tiles_img, rem = tile - n * tiles_img;
    const int y0 = (rem / tiles_x) * WTR, x0 = (rem % tiles_x) * WTC;
    T* s_x = s_buf + buf * BUF;
    T* s_g = s_x + WHPIX * SX;
    const T* xn = x + (size_t)n * H * W * Ci;
    const T* gn = gz + (size_t)n * Ho * Wo * Co;
    if (vec_x) {  // Ci % GE == 0 and x 16-byte aligned: whole groups in or out
      for (int i = tid; i < WHPIX * (WCI / GE); i += THREADS) {
        const int p = i / (WCI / GE), c = (i % (WCI / GE)) * GE;
        const int sy = source_index<MODE>(y0 - 1 + p / WHC, H);
        const int sx = source_index<MODE>(x0 - 1 + p % WHC, W);
        const bool in = ci_tile + c < Ci;
        cp_async16(s_x + p * SX + c, in ? xn + ((size_t)sy * W + sx) * Ci + ci_tile + c : xn,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < WHPIX * WCI; i += THREADS) {
        const int p = i / WCI, c = i % WCI;
        const int sy = source_index<MODE>(y0 - 1 + p / WHC, H);
        const int sx = source_index<MODE>(x0 - 1 + p % WHC, W);
        s_x[p * SX + c] = ci_tile + c < Ci ? xn[((size_t)sy * W + sx) * Ci + ci_tile + c]
                                           : from_float<T>(0.f);
      }
    }
    if (vec_g) {  // Co % GE == 0 and gz 16-byte aligned
      for (int i = tid; i < WTP * (WCO / GE); i += THREADS) {
        const int p = i / (WCO / GE), c = (i % (WCO / GE)) * GE;
        const int yy = y0 + p / WTC, xx = x0 + p % WTC;
        const int oy = MODE == kReflect ? yy : 2 * yy + pa;
        const int ox = MODE == kReflect ? xx : 2 * xx + pb;
        const bool in = yy < H && xx < W && co_tile + c < Co;
        cp_async16(s_g + p * SG + c, in ? gn + ((size_t)oy * Wo + ox) * Co + co_tile + c : gn,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < WTP * WCO; i += THREADS) {
        const int p = i / WCO, c = i % WCO;
        const int yy = y0 + p / WTC, xx = x0 + p % WTC;
        const int oy = MODE == kReflect ? yy : 2 * yy + pa;
        const int ox = MODE == kReflect ? xx : 2 * xx + pb;
        s_g[p * SG + c] = yy < H && xx < W && co_tile + c < Co
                              ? gn[((size_t)oy * Wo + ox) * Co + co_tile + c]
                              : from_float<T>(0.f);
      }
    }
    cp_async_commit();
  };

  float sum[G::BT][2][4];
#pragma unroll
  for (int k = 0; k < G::BT; ++k)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[k][f][q] = 0.f;

  const int first = blockIdx.x * per_block;
  const int count = max(0, min(first + per_block, tiles) - first);
  if (count > 0) stage(first, 0);
  for (int it = 0; it < count; ++it) {
    if (it + 1 < count) {
      stage(first + it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's buffer is complete for every thread
    const T* s_x = s_buf + (it & 1) * BUF;
    const T* s_g = s_x + WHPIX * SX;

    float acc[G::BT][2][4];
#pragma unroll
    for (int k = 0; k < G::BT; ++k)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][f][q] = 0.f;

    for (int kc = 0; kc < WTP / 8; ++kc) {  // 8 pixels of one tile row
      const int r = kc / (WTC / 8), c8 = (kc % (WTC / 8)) * 8;
      // A[m = co][k = pixel] = the cotangent at pixel kc * 8 + k
      uint32_t a[2][4], ah[2][4], al[2][4];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const T* ap = s_g + (kc * 8 + t) * SG + f * 16 + g;
        a[f][0] = operand(ap);
        a[f][1] = operand(ap + 8);
        a[f][2] = operand(ap + 4 * SG);
        a[f][3] = operand(ap + 4 * SG + 8);
        if constexpr (kF32) {
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(a[f][q]), ah[f][q], al[f][q]);
        }
      }
#pragma unroll
      for (int k = 0; k < G::BT; ++k) {
        // the tap's shift into the halo (reflect: dy, dx; up2: pa + ty, pb + tx)
        const int oy = MODE == kReflect ? k / 3 : pa + (k >> 1);
        const int ox = MODE == kReflect ? k % 3 : pb + (k & 1);
        const T* bp = s_x + ((r + oy) * WHC + c8 + ox + t) * SX + warp * 8 + g;
        // B[k = pixel t, t + 4][n = channel g]
        const uint32_t b0 = operand(bp), b1 = operand(bp + 4 * SX);
        if constexpr (kF32) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(__uint_as_float(b0), bh0, bl0);
          split_tf32(__uint_as_float(b1), bh1, bl1);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            mma_tf32(acc[k][f], al[f], bh0, bh1);
            mma_tf32(acc[k][f], ah[f], bl0, bl1);
            mma_tf32(acc[k][f], ah[f], bh0, bh1);
          }
        } else {
          // bf16 values are exact in TF32: one product, no split
#pragma unroll
          for (int f = 0; f < 2; ++f) mma_tf32(acc[k][f], a[f], b0, b1);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < G::BT; ++k)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[k][f][q] += acc[k][f][q];
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

  // this block's partial [tap][ci][co]: D[m = co][n = ci] of each fragment
#pragma unroll
  for (int k = 0; k < G::BT; ++k) {
    const int tap = MODE == kReflect ? k : phase * 4 + k;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = co_tile + f * 16 + g + (q >= 2 ? 8 : 0);
        const int ci = ci_tile + warp * 8 + 2 * t + (q & 1);
        if (co < Co && ci < Ci)
          partial[(((size_t)blockIdx.x * G::TAPS + tap) * Ci + ci) * Co + co] = sum[k][f][q];
      }
  }
}

// Whether 3x3 row (column) d was summed into phase-tap row t of phase a
// (up2_phase_weights: phase 0 = (w0, w1 + w2), phase 1 = (w0 + w1, w2)).
__device__ __forceinline__ bool covers(int a, int t, int d) {
  return a == 0 ? (t == 0 ? d == 0 : d >= 1) : (t == 0 ? d <= 1 : d == 2);
}

// The second pass: gw[co][ci][dy][dx] = the partials summed in block order
// (at up2_reflect per phase tap, then those of the tap's phase taps added).
template <typename T, int MODE>
__global__ void fused_conv3x3_wgrad_reduce_kernel(const float* __restrict__ partial,
                                                  T* __restrict__ gw, int blocks, int Ci,
                                                  int Co) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // (k * Ci + ci) * Co + co
  if (idx >= 9 * Ci * Co) return;
  const int co = idx % Co, ci = (idx / Co) % Ci, k = idx / (Co * Ci);
  const size_t slice = (size_t)Ci * Co;
  const size_t stride = taps_of<MODE>() * slice;  // between blocks' partials
  const float* p = partial + (size_t)ci * Co + co;
  auto sum_blocks = [&](int tap) {
    float s = 0.f;
#pragma unroll 8
    for (int b = 0; b < blocks; ++b) s += p[b * stride + tap * slice];
    return s;
  };
  float s = 0.f;
  if constexpr (MODE == kReflect) {
    s = sum_blocks(k);
  } else {
    const int dy = k / 3, dx = k % 3;
    for (int a = 0; a < 2; ++a)
      for (int ty = 0; ty < 2; ++ty) {
        if (!covers(a, ty, dy)) continue;
        for (int b = 0; b < 2; ++b)
          for (int tx = 0; tx < 2; ++tx)
            if (covers(b, tx, dx)) s += sum_blocks(((a * 2 + b) * 2 + ty) * 2 + tx);
      }
  }
  gw[((size_t)co * Ci + ci) * 9 + k] = from_float<T>(s);
}

template <typename T, int MODE>
int launch_wgrad(const void* gz, const void* x, float* partial, long long capacity, void* gw,
                 int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
  using G = WgradGeometry<MODE>;
  const Tiling tl = wgrad_tiling<MODE>(N, H, W, Ci, Co);
  if ((long long)tl.blocks * G::TAPS * Ci * Co > capacity)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = wgrad_smem_bytes<T>();
  auto kernel = fused_conv3x3_wgrad_partial_kernel<T, MODE>;
  static std::atomic<uint64_t> smem_set{0};
  if (const int err = smem_limit_once(kernel, smem, smem_set)) return err;
  constexpr int GE = 16 / sizeof(T);  // channels per 16-byte cp.async group
  const bool vec_x = Ci % GE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_g = Co % GE == 0 && reinterpret_cast<uintptr_t>(gz) % 16 == 0;
  const dim3 grid(tl.blocks, (Co + WCO - 1) / WCO, ((Ci + WCI - 1) / WCI) * G::PHASES);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(gz), static_cast<const T*>(x),
                                          partial, H, W, Ci, Co, tl.tiles, tl.per_block, vec_x,
                                          vec_g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = 9 * Ci * Co;
  fused_conv3x3_wgrad_reduce_kernel<T, MODE><<<(outputs + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<T*>(gw), tl.blocks, Ci, Co);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgrad_mode(int pad_mode, const void* gz, const void* x, float* partial,
                      long long capacity, void* gw, int N, int H, int W, int Ci, int Co,
                      cudaStream_t s) {
  return pad_mode == kReflect
             ? launch_wgrad<T, kReflect>(gz, x, partial, capacity, gw, N, H, W, Ci, Co, s)
             : launch_wgrad<T, kUp2Reflect>(gz, x, partial, capacity, gw, N, H, W, Ci, Co, s);
}

}  // namespace

// The f32 scratch (elements) fused_conv3x3_wgrad_launch needs for these
// shapes: one [taps][Ci][Co] partial per block of the split reduction.
extern "C" long long fused_conv3x3_wgrad_scratch(int N, int H, int W, int Ci, int Co,
                                                 int pad_mode) {
  if (pad_mode == kReflect)
    return (long long)wgrad_tiling<kReflect>(N, H, W, Ci, Co).blocks * 9 * Ci * Co;
  return (long long)wgrad_tiling<kUp2Reflect>(N, H, W, Ci, Co).blocks * 16 * Ci * Co;
}

// dtype: 0 = float32, 1 = bfloat16.  pad_mode: 0 = reflect, 1 = up2_reflect.
// gz is NHWC [N,Ho,Wo,Co] (Ho x Wo = H x W at reflect, 2H x 2W at
// up2_reflect), x NHWC [N,H,W,Ci], both contiguous; partial is f32 scratch
// of `capacity` elements (at least fused_conv3x3_wgrad_scratch's); gw is a
// contiguous OIHW [Co,Ci,3,3], every element written.  Two launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fused_conv3x3_wgrad_launch(int dtype, const void* gz, const void* x,
                                          void* partial, long long capacity, void* gw, int N,
                                          int H, int W, int Ci, int Ho, int Wo, int Co,
                                          int pad_mode, void* stream) {
  if (pad_mode != kReflect && pad_mode != kUp2Reflect) return static_cast<int>(cudaErrorInvalidValue);
  const int f = pad_mode == kReflect ? 1 : 2;
  if (Ho != f * H || Wo != f * W || (pad_mode == kReflect && (H < 2 || W < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)Ci * Co == 0) return 0;
  float* p = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_wgrad_mode<float>(pad_mode, gz, x, p, capacity, gw, N, H, W, Ci, Co, s);
  if (dtype == 1)
    return launch_wgrad_mode<__nv_bfloat16>(pad_mode, gz, x, p, capacity, gw, N, H, W, Ci, Co,
                                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}
