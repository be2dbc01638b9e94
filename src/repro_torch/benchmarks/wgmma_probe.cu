// The wgmma-vs-mma.sync probe of rmmec_ablation, built by it beside its
// copies of csrc/rmmec_matmul.cu and not part of the shipped library: the
// committed source with one more kernel that runs the same bf16 chunk chains
// through the wgmma route's m64n64k16 steps (its shared-memory layouts:
// wg_x_offset below, wg_b_offset) and through split_k_kernel's mma.sync
// m16n8k16 steps, so that the two can be compared bit for bit.
//
//   nvcc <the library's flags> -I src/repro_torch/csrc -o probe.so wgmma_probe.cu

#include "rmmec_matmul.cu"

namespace {

// Byte offset of x element (r, k) of a stage's tile as TMA writes it with
// the 128-byte swizzle: box k / 64, row r at 128 r, 16-byte chunk
// (k / 8 % 8) ^ (r % 8).
__host__ __device__ constexpr int wg_x_offset(int r, int k, int x_box) {
  return (k / 64) * x_box + r * 128 + (((k / 8) % 8) ^ (r % 8)) * 16 + (k % 8) * 2;
}

// `chunks` independent 64 x KC by KC x 128 chunk chains, a (chunks, 64,
// KC) and b (chunks, KC, 128) row-major bf16, through wgmma m64n64k16 (operands in shared memory in the route's
// layouts, columns 64 .. 127 `lbo` bytes after the first 64, the B
// descriptor's stride byte offset `sbo`) into out_w (the first k16 step
// with scale-d 0, as wgmma_kernel) and out_z (zeroed accumulators, scale-d
// 1 throughout), and through mma.sync m16n8k16 chains from +0
// (split_k_kernel's arithmetic, fragments read from global memory) into
// out_m; each (chunks, 64, 128) f32.  A warpgroup a chunk.
constexpr int PROBE_SMEM = 2 * 64 * 64 * 2 + KC * 128 * 2 + 1024;

__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, float* out_w,
                   float* out_z, float* out_m, int lbo, int sbo) {
  constexpr int X_BOX = 64 * 64 * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* bs = xs + 2 * X_BOX;
  const bf16* ac = a + (size_t)blockIdx.x * 64 * KC;
  const bf16* bc = b + (size_t)blockIdx.x * KC * 128;
  for (int i = threadIdx.x; i < 64 * KC; i += 128)
    *reinterpret_cast<bf16*>(xs + wg_x_offset(i / KC, i % KC, X_BOX)) = ac[i];
  for (int i = threadIdx.x; i < KC * 128; i += 128)
    *reinterpret_cast<bf16*>(bs + wg_b_offset(i / 128, i % 128)) = bc[i];
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float d[32];
  for (int v = 0; v < 4; ++v) {  // scale-d 0 / zero init, columns 0 .. 63 / 64 .. 127
    const int half = v % 2;
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(d[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wgmma_m64n64k16(d,
                      gmma_desc_sw128(smem_addr(xs) + (ks / 4) * X_BOX + (ks % 4) * 32, 16, 1024),
                      gmma_desc_sw128(smem_addr(bs) + half * lbo + ks * 16 * 128, lbo, sbo),
                      v >= 2 || ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(d[i]);
    float* o = (v < 2 ? out_w : out_z) + (size_t)blockIdx.x * 64 * 128 + 64 * half;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      o[(16 * warp + g + 8 * ((i % 4) / 2)) * 128 + 8 * (i / 4) + 2 * t + (i % 2)] = d[i];
  }
  // mma.sync: rows 16 warp .., each n8 tile, k16 steps in order from +0
  auto ld2 = [](const bf16* p0, const bf16* p1) { return pack2(*p0, *p1); };
  for (int nt = 0; nt < 16; ++nt) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ks = 0; ks < KC / 16; ++ks) {
      const bf16* ar = ac + (16 * warp + g) * KC + ks * 16 + 2 * t;
      const uint32_t af[4] = {ld2(ar, ar + 1), ld2(ar + 8 * KC, ar + 8 * KC + 1),
                              ld2(ar + 8, ar + 9), ld2(ar + 8 * KC + 8, ar + 8 * KC + 9)};
      const bf16* br = bc + (ks * 16 + 2 * t) * 128 + nt * 8 + g;
      mma_bf16(c, af, ld2(br, br + 128), ld2(br + 8 * 128, br + 9 * 128));
    }
    float* o = out_m + (size_t)blockIdx.x * 64 * 128;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[(16 * warp + g + 8 * (e / 2)) * 128 + nt * 8 + 2 * t + (e % 2)] = c[e];
  }
}

}  // namespace

// The wgmma-vs-mma.sync probe (wgmma_probe_kernel): `chunks` chunk chains
// of a (chunks, 64, KC) and b (chunks, KC, 128) bf16 into out_w, out_z and
// out_m (chunks, 64, 128) f32; lbo / sbo: the B descriptor's byte offsets.
extern "C" int rmmec_wgmma_probe(const void* a, const void* b, void* out_w, void* out_z,
                                 void* out_m, int chunks, int lbo, int sbo, void* stream) {
  static bool allowed = false;
  const cudaError_t err = allow_smem(wgmma_probe_kernel, PROBE_SMEM, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe_kernel<<<chunks, 128, PROBE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(out_w),
      static_cast<float*>(out_z), static_cast<float*>(out_m), lbo, sbo);
  return static_cast<int>(cudaGetLastError());
}
