// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces simpletuner_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _flash_forward through pl.pallas_call).  It computes the same function: an
// online softmax over key/value tiles that emits `out` and the per-row
// logsumexp `lse = m + log l`, with the segment-id mask
//     attend(i, j) = q_seg[i] == kv_seg[j] && kv_seg[j] != SEGMENT_PAD_ID
// where masked logits take the finite value -1e30 and their probabilities are
// zeroed, so a row that sees no key emits exactly 0 and lse = -1e30.
//
// What bounds it: at the Flux shape (S = 4608, D = 128) each CTA does
// 4 * 64 * S * D flops for 2 * S * D * 2 bytes of K/V it streams through shared
// memory (about 64 flops per byte of L2 traffic, and K/V of one head stay
// resident in L2 across the 72 CTAs that read them), so the kernel is bound by
// tensor-core operations, not device memory.  The design keeps the S x S score
// matrix out of device memory entirely: scores live in registers one 64 x 64
// tile at a time, and only out (S x D) and lse (S) are written.
//
// Layout of the work:
//   * one CTA of 4 warps per (batch*head, 64-row query tile); each warp owns
//     16 query rows, so the row statistics (m, l) stay inside one quad of
//     lanes and need no shared memory;
//   * K/V tiles of 64 rows are double-buffered in shared memory with cp.async
//     (rows padded by 8 elements so every fragment load is bank-conflict free);
//   * Q.K^T and P.V run on mma.sync m16n8k16 (bf16 operands, f32 accumulate);
//     the score accumulator is re-packed in registers as the A operand of P.V,
//     and V is read with ldmatrix.trans;
//   * P is rounded to bf16 before P.V while l sums the f32 probabilities,
//     as the TPU kernel does;
//   * the ragged tail (S not a multiple of 64) is masked in the kernel with
//     the semantics of padding by SEGMENT_PAD_ID; rows past S are never stored.
// wgmma/TMA and warp specialisation are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;
  const int32_t* q_seg;   // (batch, sq) or null (all zeros)
  const int32_t* kv_seg;  // (batch, sk) or null (all zeros)
  int64_t q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int heads, sq, sk;
  float scale_log2;  // sm_scale * log2(e): softmax runs in base 2
};

template <int D>
struct Tile {
  static constexpr int STRIDE = Row<D>::STRIDE;
  static constexpr int ELEMS = BLOCK_M * STRIDE;
  // Q + double-buffered K and V
  static constexpr int SMEM_BYTES = 5 * ELEMS * (int)sizeof(bf16);
};

template <int D, bool MASKED>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + Tile<D>::ELEMS;
  bf16* v_s = k_s + 2 * Tile<D>::ELEMS;
  constexpr int STRIDE = Tile<D>::STRIDE;
  constexpr int DT = D / 8;        // 8-wide output column tiles
  constexpr int NT = BLOCK_N / 8;  // 8-wide score column tiles

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int m0 = blockIdx.x * BLOCK_M;

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.sk + BLOCK_N - 1) / BLOCK_N;

  load_tile<BLOCK_M, D>(q_s, qg, p.q_ss, m0, p.sq, tid);
  load_tile<BLOCK_M, D>(k_s, kg, p.k_ss, 0, p.sk, tid);
  load_tile<BLOCK_M, D>(v_s, vg, p.v_ss, 0, p.sk, tid);
  cp_async_commit();

  // this thread holds query rows r[0] = row and r[1] = row + 8 of the tile
  const int rows[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  int q_ids[2] = {0, 0};
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      q_ids[i] = rows[i] >= p.sq ? SEGMENT_PAD_ID
                                 : (p.q_seg ? p.q_seg[(int64_t)b * p.sq + rows[i]] : 0);
    }
  }

  float m_run[2] = {MASK_VALUE, MASK_VALUE};
  float l_run[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  uint32_t q_frag[D / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int next = (buf ^ 1) * Tile<D>::ELEMS;
      load_tile<BLOCK_M, D>(k_s + next, kg, p.k_ss, (j + 1) * BLOCK_N, p.sk, tid);
      load_tile<BLOCK_M, D>(v_s + next, vg, p.v_ss, (j + 1) * BLOCK_N, p.sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
      const bf16* qw = q_s + warp * 16 * STRIDE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        q_frag[kk][0] = load_u32(qw + g * STRIDE + kk * 16 + t * 2);
        q_frag[kk][1] = load_u32(qw + (g + 8) * STRIDE + kk * 16 + t * 2);
        q_frag[kk][2] = load_u32(qw + g * STRIDE + kk * 16 + 8 + t * 2);
        q_frag[kk][3] = load_u32(qw + (g + 8) * STRIDE + kk * 16 + 8 + t * 2);
      }
    }
    const bf16* ks = k_s + buf * Tile<D>::ELEMS;
    const bf16* vs = v_s + buf * Tile<D>::ELEMS;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b_frag[2];
        const bf16* krow = ks + (nt * 8 + g) * STRIDE + kk * 16 + t * 2;
        b_frag[0] = load_u32(krow);
        b_frag[1] = load_u32(krow + 8);
        mma_16816(s[nt], q_frag[kk], b_frag);
      }
    }

    // scale (base 2) and mask; element e of tile nt is row rows[e >> 1],
    // key column j*64 + nt*8 + 2t + (e & 1)
    uint32_t keep = 0xffffffffu;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (MASKED) {
          const int col = j * BLOCK_N + nt * 8 + 2 * t + (e & 1);
          const int kv_id = col >= p.sk ? SEGMENT_PAD_ID
                                        : (p.kv_seg ? p.kv_seg[(int64_t)b * p.sk + col] : 0);
          const bool valid = kv_id == q_ids[e >> 1] && kv_id != SEGMENT_PAD_ID;
          if (!valid) {
            x = MASK_VALUE;
            keep &= ~(1u << (nt * 4 + e));
          }
        }
        s[nt][e] = x;
      }
    }

    // online softmax update
    float m_next[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      m_next[0] = fmaxf(m_next[0], fmaxf(s[nt][0], s[nt][1]));
      m_next[1] = fmaxf(m_next[1], fmaxf(s[nt][2], s[nt][3]));
    }
    m_next[0] = quad_max(m_next[0]);
    m_next[1] = quad_max(m_next[1]);
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(s[nt][e] - m_next[e >> 1]);
        if (MASKED && !(keep & (1u << (nt * 4 + e)))) pr = 0.f;
        s[nt][e] = pr;
        row_sum[e >> 1] += pr;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float alpha = exp2f(m_run[i] - m_next[i]);
      l_run[i] = alpha * l_run[i] + quad_sum(row_sum[i]);
      m_run[i] = m_next[i];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * i] *= alpha;
        acc[dt][2 * i + 1] *= alpha;
      }
    }

    // acc += P V, P re-packed from the score accumulator as bf16 A fragments
    const int mat = lane >> 3;
    const int mat_row = lane & 7;
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a_frag[4];
      a_frag[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a_frag[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a_frag[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a_frag[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b_frag[4];
        const bf16* vptr =
            vs + (kk * 16 + (mat & 1) * 8 + mat_row) * STRIDE + dp * 16 + (mat >> 1) * 8;
        ldmatrix_x4_trans(b_frag, vptr);
        mma_16816(acc[2 * dp], a_frag, b_frag);
        mma_16816(acc[2 * dp + 1], a_frag, b_frag + 2);
      }
    }
    __syncthreads();  // everyone is done with `buf` before it is refilled
  }

  // epilogue: out = acc / l (0 where l == 0), lse = m + log l
  bf16* og = p.out + (int64_t)bh * p.sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.sq) continue;
    const float inv = l_run[i] == 0.f ? 1.f : 1.f / l_run[i];
    bf16* orow = og + (int64_t)rows[i] * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
    }
    if (t == 0) {
      p.lse[(int64_t)bh * p.sq + rows[i]] =
          l_run[i] == 0.f ? MASK_VALUE : m_run[i] * LN2 + logf(l_run[i]);
    }
  }
}

template <int D, bool MASKED>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  constexpr int smem = Tile<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, MASKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BLOCK_M - 1) / BLOCK_M, batch_heads);
  flash_fwd_kernel<D, MASKED><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(const Params& p, int batch_heads, int masked, cudaStream_t stream) {
  return masked ? launch<D, true>(p, batch_heads, stream) : launch<D, false>(p, batch_heads, stream);
}

}  // namespace

extern "C" int st_flash_fwd_abi_version() { return 1; }

// q/k/v: bf16 with unit stride on the last (head) dim and the given element
// strides elsewhere; out: contiguous (batch, heads, sq, head_dim) bf16;
// lse: contiguous (batch, heads, sq) f32; q_seg/kv_seg: contiguous int32 or
// null.  `masked` = 0 is only valid when there are no segment ids and sk is a
// multiple of 64.  Returns a cudaError_t (0 on a successful launch).
extern "C" int st_flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                 void* lse, const void* q_seg, const void* kv_seg, int64_t q_sb,
                                 int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                                 int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                 int batch, int heads, int sq, int sk, int head_dim,
                                 float sm_scale, int masked, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_seg = static_cast<const int32_t*>(q_seg);
  p.kv_seg = static_cast<const int32_t*>(kv_seg);
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.scale_log2 = sm_scale * LOG2E;
  const int batch_heads = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dim<32>(p, batch_heads, masked, s);
    case 64:
      return launch_dim<64>(p, batch_heads, masked, s);
    case 128:
      return launch_dim<128>(p, batch_heads, masked, s);
    default:
      return cudaErrorInvalidValue;
  }
}
