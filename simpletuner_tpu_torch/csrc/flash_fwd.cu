// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces simpletuner_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _flash_forward through pl.pallas_call).  It computes the same function: an
// online softmax over key/value tiles that emits `out` and the per-row
// logsumexp `lse = m + log l`, with the segment-id mask
//     attend(i, j) = q_seg[i] == kv_seg[j] && kv_seg[j] != SEGMENT_PAD_ID
// where masked logits take the finite value -1e30 and their probabilities are
// zeroed by selection, so a row that sees no key emits exactly 0 and
// lse = -1e30.  P is rounded to bf16 only as the A operand of P.V, while l
// sums the f32 probabilities, as the TPU kernel does.
//
// What bounds it: at the Flux shape (S = 4608, D = 128) the two S x S x D
// products are 2.6e11 flop against 114 MB of q/k/v/out (0.26 ms at 989
// TFLOP/s against 0.03 ms at 3.35 TB/s): tensor-core bound.  The design keeps
// the S x S scores out of device memory and feeds the tensor cores through
// Hopper's asynchronous paths:
//   * one CTA per (batch * head, 128 query rows): one producer warpgroup and
//     two consumer warpgroups of 64 rows each; setmaxnreg moves registers
//     from the producer (24) to the consumers (240);
//   * one producer warp loads Q once and streams 128-row K and V tiles
//     through a 2-stage ring with TMA (128-byte swizzle, rows past S
//     zero-filled), completion on mbarriers; the consumers release a K stage
//     and a V stage apart, on "empty" mbarriers, once their products have
//     read it;
//   * S = Q K^T is a wgmma with both operands in shared memory; O += P V a
//     wgmma with P in registers (the S accumulator re-packed as bf16) and V
//     read MN-major through the descriptor;
//   * softmax in base 2 in registers, row statistics reduced across the quad
//     of lanes that shares a row; it runs while S of the next tile and P V
//     of the current one are in flight, and the two consumer warpgroups
//     issue their products in turns (ping-pong on named barriers);
//   * the segment mask is scheduled per tile pair (hopper::tile_class, the
//     rule of ops/flash_attention.py::tile_schedule): before the roles split,
//     the CTA reduces its query ids and every key tile's ids to ranges and
//     classes each key tile as skip (no load, no product), full (no mask) or
//     mixed (per-element mask; the producer warp stages that tile's key ids
//     in shared memory).  A query tile whose rows are all pad skips every key
//     tile and writes 0 and -1e30 without reading K or V.
// (B, S, H, D) views are read through their strides by the tensor maps; a
// ragged S is masked with pad semantics and rows past S are never stored.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int BLOCK_M = 128;  // query rows per CTA, 64 per consumer warpgroup
constexpr int BLOCK_N = 128;  // keys per streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_THREADS = 256;

struct Params {
  const int32_t* q_seg;   // (batch, sq) or null (all zeros)
  const int32_t* kv_seg;  // (batch, sk) or null (all zeros)
  bf16* out;              // contiguous (batch, heads, sq, D)
  float* lse;             // contiguous (batch, heads, sq)
  int heads, sq, sk;
  float scale_log2;  // sm_scale * log2(e): softmax runs in base 2
};

// byte offsets from the 1024-aligned start of dynamic shared memory
template <int D>
struct Smem {
  static constexpr int TILE = BLOCK_N * D * 2;  // one K or V stage
  static constexpr int Q = 0;
  static constexpr int K = Q + BLOCK_M * D * 2;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int KV_IDS = V + STAGES * TILE;  // int [STAGES][BLOCK_N]: key ids of a mixed tile
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  static constexpr int BARS = KV_IDS + STAGES * BLOCK_N * 4;
  static constexpr int BOUNDS = BARS + 8 * (1 + 4 * STAGES);  // query id range of each row warp
  static constexpr int CLASSES = BOUNDS + 8 * (BLOCK_M / 32);  // one byte per key tile
  static int bytes(int key_tiles) { return 1024 + CLASSES + ((key_tiles + 15) & ~15); }
};

template <int D>
__device__ __forceinline__ void product_pv(float (&o)[D / 2], const uint32_t* p, uint64_t desc) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, p, desc);
  } else {
    wgmma_rs_n64(o, p, desc);
  }
}

// scores of one tile -> f32 probabilities (in place) against the new row
// maxima m_new (base 2), with their row sums; element 4 i + e is the
// thread's row e / 2, key 8 i + 2 t + e % 2 of the tile.  A mixed tile sets
// masked logits to -1e30 and zeroes their probabilities by selection.
template <bool MIXED>
__device__ __forceinline__ void softmax_tile(float (&s)[BLOCK_N / 2], float scale_log2, const float (&m_run)[2],
                                             const int (&q_ids)[2], const int* kv_ids, int t, float (&m_new)[2],
                                             float (&row_sum)[2]) {
  uint64_t keep = ~0ull;
  if (MIXED) {
#pragma unroll
    for (int i = 0; i < BLOCK_N / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * i + e] * scale_log2;
        if (!attends(q_ids[e >> 1], kv_ids[8 * i + 2 * t + (e & 1)])) {
          x = MASK_VALUE;
          keep &= ~(1ull << (4 * i + e));
        }
        s[4 * i + e] = x;
      }
    }
  }
  float mx[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
#pragma unroll
  for (int i = 0; i < BLOCK_N / 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  // a full tile's scores are still unscaled: scale > 0, so the max commutes
  const float to_log2 = MIXED ? 1.f : scale_log2;
#pragma unroll
  for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m_run[r], quad_max(mx[r]) * to_log2);
  row_sum[0] = row_sum[1] = 0.f;
#pragma unroll
  for (int i = 0; i < BLOCK_N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = fast_exp2(fmaf(s[4 * i + e], to_log2, -m_new[e >> 1]));
      if (MIXED && !((keep >> (4 * i + e)) & 1ull)) pr = 0.f;
      s[4 * i + e] = pr;
      row_sum[e >> 1] += pr;
    }
  }
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using S = Smem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int* kv_id_s = reinterpret_cast<int*>(smem + S::KV_IDS);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  int* bounds = reinterpret_cast<int*>(smem + S::BOUNDS);
  uint8_t* classes = smem + S::CLASSES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int m0 = blockIdx.x * BLOCK_M;
  const int n_tiles = (p.sk + BLOCK_N - 1) / BLOCK_N;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMER_THREADS);
      mbar_init(&v_empty[s], CONSUMER_THREADS);
    }
    mbar_init_fence();
  }
  // the tile schedule: query id range, then one class per key tile
  if (MASKED) schedule_key_tiles<BLOCK_M, BLOCK_N, THREADS>(p.q_seg, p.kv_seg, b, p.sq, p.sk, m0, bounds, classes);
  __syncthreads();
  // the next tile at or after j that is not skipped (n_tiles when none)
  auto next_tile = [&](int j) {
    if (MASKED) {
      while (j < n_tiles && classes[j] == TILE_SKIP) ++j;
    }
    return j;
  };

  if (warp < 4) {
    // ------------------------------------------------------------ producer
    regs_dealloc<24>();
    if (warp == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int j = next_tile(0); j < n_tiles; j = next_tile(j + 1)) {
        if (lane == 0 && stage == 0 && phase == 0) {
          mbar_expect_tx(q_full, BLOCK_M * D * 2);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(smem + S::Q + c * BLOCK_M * 128, &tm_q, q_full, c * 64, m0, h, b);
          }
        }
        mbar_wait(&k_empty[stage], phase ^ 1);
        if (MASKED && classes[j] == TILE_MIXED) {
#pragma unroll
          for (int r = 0; r < BLOCK_N / 32; ++r) {
            kv_id_s[stage * BLOCK_N + r * 32 + lane] = segment_id(p.kv_seg, b, p.sk, j * BLOCK_N + r * 32 + lane);
          }
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&k_full[stage], S::TILE);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(smem + S::K + stage * S::TILE + c * BLOCK_N * 128, &tm_k, &k_full[stage], c * 64,
                        j * BLOCK_N, h, b);
          }
          mbar_wait(&v_empty[stage], phase ^ 1);
          mbar_expect_tx(&v_full[stage], S::TILE);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(smem + S::V + stage * S::TILE + c * BLOCK_N * 128, &tm_v, &v_full[stage], c * 64,
                        j * BLOCK_N, h, b);
          }
        }
        __syncwarp();
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    // Per tile pair: S(next) = Q K(next)^T and O += P(cur) V(cur) are in
    // flight together while the softmax of S(next) runs; O is rescaled once
    // the P V product has completed.  The two warpgroups issue their
    // products in turns (ping-pong, below).
    regs_alloc<240>();
    const int c = warp / 4 - 1;  // query rows [64 c, 64 c + 64) of the CTA's tile
    const int w = warp % 4;
    const int t = lane & 3;
    const int rows[2] = {m0 + 64 * c + 16 * w + (lane >> 2), m0 + 64 * c + 16 * w + (lane >> 2) + 8};
    int q_ids[2] = {0, 0};
    if (MASKED) {
      q_ids[0] = segment_id(p.q_seg, b, p.sq, rows[0]);
      q_ids[1] = segment_id(p.q_seg, b, p.sq, rows[1]);
    }
    float m_run[2] = {MASK_VALUE, MASK_VALUE};
    float l_run[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[BLOCK_N / 2];
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) s[i] = 0.f;
    uint32_t pa[BLOCK_N / 4];

    const uint32_t q_tile = smem_u32(smem + S::Q);
    int k_stage = 0, v_stage = 0;
    uint32_t k_phase = 0, v_phase = 0;

    // S(j) = Q K(j)^T into s, issued and committed; the K stage advances
    auto issue_scores = [&](int j) {
      const uint32_t k_tile = smem_u32(smem + S::K + k_stage * S::TILE);
      mbar_wait(&k_full[k_stage], k_phase);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n128(s, desc_k_major<BLOCK_M>(q_tile, c * 64 * 128, kk), desc_k_major<BLOCK_N>(k_tile, 0, kk),
                      kk > 0);
      }
      wgmma_commit();
    };
    // probabilities of the completed S(j) in s, new maxima and row sums;
    // releases the K stage
    auto softmax = [&](int j, float (&m_new)[2], float (&row_sum)[2]) {
      fence_regs(s);
      if (MASKED && classes[j] == TILE_MIXED) {
        softmax_tile<true>(s, p.scale_log2, m_run, q_ids, kv_id_s + k_stage * BLOCK_N, t, m_new, row_sum);
      } else {
        softmax_tile<false>(s, p.scale_log2, m_run, q_ids, kv_id_s, t, m_new, row_sum);
      }
      mbar_arrive(&k_empty[k_stage]);
      if (++k_stage == STAGES) {
        k_stage = 0;
        k_phase ^= 1;
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        pa[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    // rescale o and l to the new maxima and add the row sums
    auto rescale = [&](const float (&m_new)[2], const float (&row_sum)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = fast_exp2(m_run[r] - m_new[r]);
        l_run[r] = alpha * l_run[r] + quad_sum(row_sum[r]);
        m_run[r] = m_new[r];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[4 * i + 2 * r] *= alpha;
          o[4 * i + 2 * r + 1] *= alpha;
        }
      }
    };

    // O += bf16(P) V for the tile of the current V stage, issued and committed
    auto issue_pv = [&]() {
      const uint32_t v_tile = smem_u32(smem + S::V + v_stage * S::TILE);
      fence_regs(pa);
      fence_regs(o);
      mbar_wait(&v_full[v_stage], v_phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        product_pv<D>(o, &pa[4 * kk], desc_mn_major<BLOCK_N>(v_tile, kk));
      }
      wgmma_commit();
    };
    // waits for every product in flight and releases the V stage
    auto retire_pv = [&]() {
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&v_empty[v_stage]);
      if (++v_stage == STAGES) {
        v_stage = 0;
        v_phase ^= 1;
      }
    };

    // ping-pong: the two warpgroups take turns to issue their products, so
    // one's softmax runs while the other's products occupy the tensor cores.
    // Warpgroup c waits on barrier 1 + c before it issues and then lets the
    // other go; warpgroup 1 lets warpgroup 0 go first and skips its last pass.
    auto my_turn = [&]() { named_bar_sync(1 + c, CONSUMER_THREADS); };
    auto pass_turn = [&]() { named_bar_arrive(2 - c, CONSUMER_THREADS); };

    int j = next_tile(0);
    if (j < n_tiles) {
      mbar_wait(q_full, 0);
      if (c == 1) named_bar_arrive(1, CONSUMER_THREADS);
      float m_new[2], row_sum[2];
      my_turn();
      issue_scores(j);
      pass_turn();
      wgmma_wait<0>();
      softmax(j, m_new, row_sum);
      rescale(m_new, row_sum);
      pack_p();
      for (int next = next_tile(j + 1); next < n_tiles; next = next_tile(j + 1)) {
        my_turn();
        issue_scores(next);
        issue_pv();
        pass_turn();
        wgmma_wait<1>();  // S(next) has completed, P(j) V(j) may still run
        softmax(next, m_new, row_sum);
        retire_pv();
        rescale(m_new, row_sum);
        pack_p();
        j = next;
      }
      my_turn();
      issue_pv();
      if (c == 0) pass_turn();
      retire_pv();
    }

    // epilogue: out = o / l (0 where l == 0), lse = m + log l
    bf16* og = p.out + (int64_t)bh * p.sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.sq) continue;
      const float inv = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
      bf16* orow = og + (int64_t)rows[r] * D + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(orow + 8 * i) = pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      }
      if (t == 0) {
        p.lse[(int64_t)bh * p.sq + rows[r]] = l_run[r] == 0.f ? MASK_VALUE : m_run[r] * LN2 + logf(l_run[r]);
      }
    }
  }
}

template <int D, bool MASKED>
cudaError_t launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v, const Params& p,
                   int batch_heads, cudaStream_t stream) {
  const int smem = Smem<D>::bytes((p.sk + BLOCK_N - 1) / BLOCK_N);
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel<D, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BLOCK_M - 1) / BLOCK_M, batch_heads);
  flash_fwd_kernel<D, MASKED><<<grid, THREADS, smem, stream>>>(tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v, const Params& p,
                       int batch_heads, int masked, cudaStream_t stream) {
  return masked ? launch<D, true>(tm_q, tm_k, tm_v, p, batch_heads, stream)
                : launch<D, false>(tm_q, tm_k, tm_v, p, batch_heads, stream);
}

}  // namespace

extern "C" int st_flash_fwd_abi_version() { return 2; }

// q/k/v: bf16 (batch, heads, seq, head_dim) views with unit stride on the
// head dim and the given element strides elsewhere (multiples of 8, base
// 16-byte aligned); out: contiguous (batch, heads, sq, head_dim) bf16; lse:
// contiguous (batch, heads, sq) f32; q_seg/kv_seg: contiguous int32 or null.
// head_dim 64 or 128.  `masked` = 0 is only valid when there are no segment
// ids and sk is a multiple of 128.  Returns a cudaError_t (0 on a successful
// launch).
extern "C" int st_flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                                 const void* q_seg, const void* kv_seg, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                 int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                 int64_t v_ss, int batch, int heads, int sq, int sk, int head_dim, float sm_scale,
                                 int masked, void* stream) {
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_tensor_map(&tm_q, q, batch, heads, sq, head_dim, q_sb, q_sh, q_ss, BLOCK_M);
  if (err == cudaSuccess) err = make_tensor_map(&tm_k, k, batch, heads, sk, head_dim, k_sb, k_sh, k_ss, BLOCK_N);
  if (err == cudaSuccess) err = make_tensor_map(&tm_v, v, batch, heads, sk, head_dim, v_sb, v_sh, v_ss, BLOCK_N);
  if (err != cudaSuccess) return err;
  Params p;
  p.q_seg = static_cast<const int32_t*>(q_seg);
  p.kv_seg = static_cast<const int32_t*>(kv_seg);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.scale_log2 = sm_scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 128 ? launch_dim<128>(tm_q, tm_k, tm_v, p, batch * heads, masked, s)
                         : launch_dim<64>(tm_q, tm_k, tm_v, p, batch * heads, masked, s);
}
