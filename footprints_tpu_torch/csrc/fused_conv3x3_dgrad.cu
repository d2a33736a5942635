// Gradient on x of the fused 3x3 conv (dgrad), for Hopper (sm_90a).
//
// Replaces the x half of the XLA backward that the JAX package's custom_vjp
// wrappers of the Pallas kernel footprints_tpu/ops/pallas_conv.py:fused_conv3x3
// run (_up_bwd :221, _s2d_bwd :243, _s2d_res_bwd :265): at reflect the VALID
// conv plus edge strips of ops/s2d.py:_s2d_reflect_conv_bwd :320 /
// _dxp_presliced :283, at the up sites the phase form of
// ops/s2d.py:_edge_conv_phase_bwd :354.  It computes
//     gx = (pad o [nearest_up2])^T ( conv3x3^T(gz, w) )
// straight into x's NHWC layout [N,H,W,Ci] from the pre-activation cotangent
// gz [N,Ho,Wo,Co]; no padded or upsampled gradient is materialised.
//
// What bounds it: the forward's MACs (9 taps x Co per x pixel at reflect, 16
// phase taps x Co per low-res pixel at up2_reflect) on the tensor cores, 3 TF32
// products per MAC in f32 (3xTF32, as the forward) and 1 bf16 product in bf16:
// bound by operations in f32, by bytes in bf16 at the decoder's shapes.
//
// What the design does about it: the forward's implicit GEMM with the roles of
// the channels swapped: M = x pixels (16 columns of a tile row per m16
// fragment; low-res pixels at up2_reflect), N = 32 input channels per block
// (4 n8 fragments), K = taps x Co.  The cotangent's halo tile is staged by
// cp.async (zero-filled outside the map: the transposed conv's zero padding)
// through a ring of 2 buffers, chunk by chunk of Co, the weights transposed
// (B[k = co][n = ci]) and, at up2_reflect, phase-folded in f32 as the forward
// folds them.  ldmatrix takes one row address per lane, so each lane's pixel
// may read any halo pixel, or a zero row:
//   * reflect: pixel a reads cotangent row a + 1 - dy for weight row dy (the
//     zero-padded transposed conv).  The reflect pad copied x row 1 to padded
//     row -1 and row H-2 to padded row H, so x row 1 also reads cotangent row 0
//     through weight row 0, and row H-2 reads row H-1 through weight row 2
//     (rows 1 and H-2 take two contributions at those taps); the same for the
//     columns, and both at the 4 corners.  These folds run as extra MMAs on the
//     tile rows (warp-uniform) and, masked per lane to a zero row, on the
//     border columns of the blocks at the left and right edges;
//   * up2_reflect, the phase form: output phase (pa, pb) is a 2x2 conv of the
//     edge-padded low-res input with phase-summed weights, so low-res pixel s
//     gathers phase (pa, pb)'s cotangent at low-res row s + 1 - pa - ty, column
//     s + 1 - pb - tx, through its 2x2 weights: 16 (phase, tap) pairs per
//     low-res pixel where the full-resolution adjoint runs 9 taps at 4 pixels.
//     The 4 phase planes of the cotangent are staged as 4 halo tiles.  The edge
//     pad's adjoint folds low-res row -1 onto row 0 (phase 0, tap 0) and row
//     Hi onto row Hi-1 (phase 1, tap 1), as extra MMAs like reflect's;
//   * each block owns its outputs and sums them in a fixed order: no atomics,
//     the same bits every run.  Ragged H, W, Ci, Co are masked: no
//     divisibility rule; w may be an input-channel slice view (read through
//     its output-channel stride).
//
// Plain C interface (no PyTorch headers) for ctypes; see ops/build.py.

#include "fused_conv3x3_common.cuh"

namespace {

// Tile geometry per mode.  reflect: 16 x rows, 4 per warp (9 taps each);
// up2_reflect: 4 low-res rows, one per warp (16 phase taps each, over 4
// cotangent planes).
template <int MODE>
struct DgradGeometry {
  static constexpr int WR = MODE == kReflect ? 4 : 1;      // M rows (m16 fragments) per warp
  static constexpr int R = WARPS * WR;                      // tile rows (M space)
  static constexpr int PLANES = MODE == kReflect ? 1 : 4;   // cotangent planes staged
  static constexpr int TAPS = taps_of<MODE>();              // weight taps staged
  static constexpr int PLANE_PIX = (R + 2) * HC;            // halo pixels per plane
  static constexpr int HPIX = PLANES * PLANE_PIX;
  // blocks per SM the register and shared-memory budgets allow
  static constexpr int MIN_BLOCKS_F32 = MODE == kReflect ? 3 : 2;
  static constexpr int MIN_BLOCKS_BF16 = MODE == kReflect ? 4 : 3;
};

template <typename T, int MODE>
constexpr size_t dgrad_smem_bytes() {
  using G = DgradGeometry<MODE>;
  constexpr int planes = sizeof(T) == 4 ? 2 : 1;  // f32: hi and lo weight planes
  return sizeof(uint32_t) * (2 * G::HPIX * PS + planes * G::TAPS * COT * PS + PS) +
         sizeof(int) * G::HPIX;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? DgradGeometry<MODE>::MIN_BLOCKS_F32
                                                          : DgradGeometry<MODE>::MIN_BLOCKS_BF16)
fused_conv3x3_dgrad_kernel(const T* __restrict__ gz, const T* __restrict__ w, int w_stride,
                           T* __restrict__ gx, int H, int W, int Ci, int Co, bool vec_in,
                           bool vec_out) {
  using G = DgradGeometry<MODE>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int WPLANES = kF32 ? 2 : 1;
  constexpr int CKE = KW * elems_per_word<T>();  // cotangent channels per chunk
  constexpr int GE = 16 / sizeof(T);             // channels per 16-byte group
  constexpr int XBUF = G::HPIX * PS;             // words per halo buffer
  constexpr int WPLANE = G::TAPS * COT * PS;     // words per weight plane

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_g = smem;                    // [2][HPIX][PS] cotangent halo ring
  uint32_t* s_w = s_g + 2 * XBUF;          // [WPLANES][TAPS][COT ci][PS co words]
  uint32_t* s_zero = s_w + WPLANES * WPLANE;  // one zero pixel: masked lanes read it
  int* s_src = reinterpret_cast<int*>(s_zero + PS);

  const int Ho = MODE == kReflect ? H : 2 * H;
  const int Wo = MODE == kReflect ? W : 2 * W;
  const int n_ci_tiles = (Ci + COT - 1) / COT;
  const int n = blockIdx.z / n_ci_tiles;
  const int ci_tile = (blockIdx.z - n * n_ci_tiles) * COT;
  const int my0 = blockIdx.y * G::R;
  const int mx0 = blockIdx.x * TW;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rbase = warp * G::WR;

  // halo pixel -> cotangent offset, -1 outside the map (the zero padding).
  // Plane (pa, pb) at up2_reflect holds output pixels (2i + pa, 2j + pb).
  for (int p = tid; p < G::HPIX; p += THREADS) {
    const int plane = p / G::PLANE_PIX, q = p - plane * G::PLANE_PIX;
    const int i = my0 - 1 + q / HC, j = mx0 - 1 + q % HC;
    int src = -1;
    if (i >= 0 && i < H && j >= 0 && j < W) {
      const int oy = MODE == kReflect ? i : 2 * i + (plane >> 1);
      const int ox = MODE == kReflect ? j : 2 * j + (plane & 1);
      src = (oy * Wo + ox) * Co;
    }
    s_src[p] = src;
  }
  if (tid < PS) s_zero[tid] = 0u;
  __syncthreads();

  const T* gn = gz + (size_t)n * Ho * Wo * Co;
  auto stage_halo = [&](int c0, int buf) {
    uint32_t* dst = s_g + buf * XBUF;
    if (vec_in) {  // Co % GE == 0 and gz 16-byte aligned: whole groups in or out
      for (int i = tid; i < G::HPIX * 2; i += THREADS) {
        const int p = i >> 1, grp = i & 1;
        const int c = c0 + grp * GE;
        const int src = s_src[p];
        const bool in = src >= 0 && c < Co;
        cp_async16(dst + p * PS + grp * 4, in ? gn + src + c : gn, in ? 16 : 0);
      }
      cp_async_commit();
    } else {
      T* dt = reinterpret_cast<T*>(dst);
      for (int i = tid; i < G::HPIX * CKE; i += THREADS) {
        const int p = i / CKE, cl = i - p * CKE;
        const int src = s_src[p];
        dt[p * PS * elems_per_word<T>() + cl] =
            src >= 0 && c0 + cl < Co ? gn[src + c0 + cl] : from_float<T>(0.f);
      }
    }
  };
  // One chunk's weights, transposed: OIHW -> s_w[plane][tap][ci][co], folded
  // (up2) and split into hi and lo planes (f32) on the way.
  auto stage_weights = [&](int c0) {
    for (int u = tid; u < COT * CKE; u += THREADS) {
      const int kl = u / COT, ci = u - kl * COT;
      float raw[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ci_tile + ci < Ci && c0 + kl < Co) {
        const T* src = w + (size_t)(c0 + kl) * w_stride + (size_t)(ci_tile + ci) * 9;
#pragma unroll
        for (int k = 0; k < 9; ++k) raw[k] = to_float(src[k]);
      }
      float folded[G::TAPS];
      fold_taps<MODE>(raw, folded);
#pragma unroll
      for (int k = 0; k < G::TAPS; ++k) {
        const int row = (k * COT + ci) * PS;
        if constexpr (kF32) {
          uint32_t hi, lo;
          split_tf32(folded[k], hi, lo);
          s_w[row + kl] = hi;
          s_w[WPLANE + row + kl] = lo;
        } else {
          reinterpret_cast<__nv_bfloat16*>(s_w + row)[kl] = __float2bfloat16(folded[k]);
        }
      }
    }
  };

  float acc[G::WR][NT][4];
#pragma unroll
  for (int m = 0; m < G::WR; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;

  // ldmatrix row addresses of this lane, as the forward's
  const int a_px = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_word = (lane >> 4) * 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_word = ((lane >> 3) & 1) * 4;
  const uint32_t s_g_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_g));
  const uint32_t s_w_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_w));
  const uint32_t zero_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(s_zero)) + 4 * a_word;

  // The pad's border folds.  Row (column) lo and hi of x read a second
  // cotangent row through weight row 0 and 2 (reflect: rows 1 and H-2;
  // up2_reflect: low-res rows 0 and H-1, through phase-tap rows pa + ty = 0
  // and 2).  The column folds run only in the blocks that hold a border
  // column, masked to its lanes.
  const int lo_row = MODE == kReflect ? 1 : 0, hi_row = MODE == kReflect ? H - 2 : H - 1;
  const int lo_col = MODE == kReflect ? 1 : 0, hi_col = MODE == kReflect ? W - 2 : W - 1;
  const int mx = mx0 + a_px;  // this lane's A pixel column
  const bool fold_cols = (lo_col >= mx0 && lo_col < mx0 + TW) || (hi_col >= mx0 && hi_col < mx0 + TW);

  const int n_chunks = (Co + CKE - 1) / CKE;
  stage_halo(0, 0);
  for (int k = 0; k < n_chunks; ++k) {
    stage_weights(k * CKE);
    cp_async_wait_all();
    // chunk k's halo and weights are staged, and every warp is done with
    // chunk k - 1's halo buffer, which the next staging overwrites
    __syncthreads();
    if (k + 1 < n_chunks) stage_halo((k + 1) * CKE, (k + 1) & 1);
    const uint32_t hx = s_g_addr + 4 * ((k & 1) * XBUF + a_word);
    const uint32_t hw = s_w_addr + 4 * b_word;

#pragma unroll
    for (int tap = 0; tap < G::TAPS; ++tap) {
      // weight row u and column v of the tap (reflect: dy, dx; up2_reflect:
      // pa + ty, pb + tx), and its cotangent plane
      const int u = MODE == kReflect ? tap / 3 : (tap >> 3) + ((tap >> 1) & 1);
      const int v = MODE == kReflect ? tap % 3 : ((tap >> 2) & 1) + (tap & 1);
      const int plane = MODE == kReflect ? 0 : tap >> 2;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const uint32_t row = 4 * (tap * COT + j * 8 + b_row) * PS;
        uint32_t r[4];
        ldmatrix_x4(hw + row, r);
        bh[j][0] = r[0]; bh[j][1] = r[1]; bh[j + 1][0] = r[2]; bh[j + 1][1] = r[3];
        if constexpr (kF32) {
          ldmatrix_x4(hw + 4 * WPLANE + row, r);
          bl[j][0] = r[0]; bl[j][1] = r[1]; bl[j + 1][0] = r[2]; bl[j + 1][1] = r[3];
        }
      }
      // one A fragment (16 pixels' cotangent, one per lane's row address)
      // times this tap's weights into acc[m]
      auto term = [&](uint32_t addr, float (&c)[NT][4]) {
        uint32_t a[4];
        ldmatrix_x4(addr, a);
        if constexpr (kF32) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(a[q]), ah[q], al[q]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_tf32(c[j], al, bh[j][0], bh[j][1]);
            mma_tf32(c[j], ah, bl[j][0], bl[j][1]);
            mma_tf32(c[j], ah, bh[j][0], bh[j][1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(c[j], a, bh[j][0], bh[j][1]);
        }
      };
      const uint32_t base = hx + 4 * plane * G::PLANE_PIX * PS;
      const int pc = a_px + 2 - v;                           // primary column
      const int fc = MODE == kReflect ? a_px + v : a_px + 1;  // folded column
      const bool lane_fold = v == 0 ? mx == lo_col : mx == hi_col;
#pragma unroll
      for (int m = 0; m < G::WR; ++m) {
        const int row = my0 + rbase + m;
        const int pr = rbase + m + 2 - u;                               // primary halo row
        const int fr = MODE == kReflect ? rbase + m + u : rbase + m + 1;  // folded halo row
        const bool row_fold = (u == 0 && row == lo_row) || (u == 2 && row == hi_row);
        term(base + 4 * (pr * HC + pc) * PS, acc[m]);
        if (row_fold) term(base + 4 * (fr * HC + pc) * PS, acc[m]);
        if (v != 1 && fold_cols) {
          term(lane_fold ? base + 4 * (pr * HC + fc) * PS : zero_addr, acc[m]);
          if (row_fold) term(lane_fold ? base + 4 * (fr * HC + fc) * PS : zero_addr, acc[m]);
        }
      }
    }
    __syncthreads();  // before the next chunk's weights overwrite s_w
  }

  // epilogue: lanes t and t^1 swap halves so each owns 4 consecutive input
  // channels of one pixel, as the forward's
  const bool odd = t & 1;
  const int col = g + (odd ? 8 : 0);
  const int ox = mx0 + col;
#pragma unroll
  for (int m = 0; m < G::WR; ++m) {
    const int oy = my0 + rbase + m;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* c = acc[m][j];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const float v[4] = {odd ? s0 : c[0], odd ? s1 : c[1], odd ? c[2] : s0, odd ? c[3] : s1};
      const int ci0 = ci_tile + j * 8 + (t >> 1) * 4;
      if (oy >= H || ox >= W || ci0 >= Ci) continue;
      const size_t base = (((size_t)n * H + oy) * W + ox) * Ci + ci0;
      if (vec_out) {  // Ci % 4 == 0 and aligned: all 4 channels valid
        store4(gx + base, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ci0 + q < Ci) gx[base + q] = from_float<T>(v[q]);
      }
    }
  }
}

template <typename T, int MODE>
int launch_dgrad(const void* gz, const void* w, int w_stride, void* gx, int N, int H, int W,
                 int Ci, int Co, cudaStream_t stream) {
  using G = DgradGeometry<MODE>;
  constexpr size_t smem = dgrad_smem_bytes<T, MODE>();
  auto kernel = fused_conv3x3_dgrad_kernel<T, MODE>;
  static std::atomic<uint64_t> smem_set{0};
  if (const int err = smem_limit_once(kernel, smem, smem_set)) return err;
  const bool vec_in = Co % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(gz) % 16 == 0;
  const bool vec_out = Ci % 4 == 0 && reinterpret_cast<uintptr_t>(gx) % (4 * sizeof(T)) == 0;
  const dim3 grid((W + TW - 1) / TW, (H + G::R - 1) / G::R, N * ((Ci + COT - 1) / COT));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(gz), static_cast<const T*>(w),
                                          w_stride, static_cast<T*>(gx), H, W, Ci, Co, vec_in,
                                          vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dgrad_mode(int pad_mode, const void* gz, const void* w, int w_stride, void* gx,
                      int N, int H, int W, int Ci, int Co, cudaStream_t s) {
  return pad_mode == kReflect
             ? launch_dgrad<T, kReflect>(gz, w, w_stride, gx, N, H, W, Ci, Co, s)
             : launch_dgrad<T, kUp2Reflect>(gz, w, w_stride, gx, N, H, W, Ci, Co, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  pad_mode: 0 = reflect, 1 = up2_reflect.
// gz is NHWC [N,Ho,Wo,Co] (Ho x Wo = H x W at reflect, 2H x 2W at
// up2_reflect); w is OIHW [Co,Ci,3,3] with its last three dims contiguous
// and w_stride elements between output channels (>= Ci * 9); gx is NHWC
// [N,H,W,Ci], every element written.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_conv3x3_dgrad_launch(int dtype, const void* gz, const void* w,
                                          int w_stride, void* gx, int N, int H, int W, int Ci,
                                          int Ho, int Wo, int Co, int pad_mode, void* stream) {
  if (pad_mode != kReflect && pad_mode != kUp2Reflect) return static_cast<int>(cudaErrorInvalidValue);
  const int f = pad_mode == kReflect ? 1 : 2;
  if (Ho != f * H || Wo != f * W || w_stride < Ci * 9 ||
      (pad_mode == kReflect && (H < 2 || W < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)N * H * W * Ci == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dgrad_mode<float>(pad_mode, gz, w, w_stride, gx, N, H, W, Ci, Co, s);
  if (dtype == 1)
    return launch_dgrad_mode<__nv_bfloat16>(pad_mode, gz, w, w_stride, gx, N, H, W, Ci, Co, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
