"""Flux rectified-flow DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/flux/transformer.py``: 19 double-stream
MMDiT blocks with joint text+image attention, 38 single-stream blocks over the
fused stream, axial RoPE over (t, h, w) ids, AdaLN-Zero modulation and the
guidance embedding of the distilled flavours.  Submodules keep the JAX names
(``double_{i}.img_attn_q``, ``single_{i}.linear1``, ``time_in.in_layer``, ...).

Remat (``gradient_checkpointing``) runs blocks under
``torch.utils.checkpoint`` (non-reentrant) with the JAX policies
(transformer.py:340-431):

* ``full``: every double and single block keeps only its inputs and is
  recomputed in the backward;
* ``attn``: as ``full``, except that the single-stream blocks keep their
  attention outputs across the boundary (JAX ``save_only_these_names("attn_out")``).
  Selective checkpointing saves the outputs of the flash op (``out`` and
  ``lse``), so the recompute skips the forward kernel;
* ``attn_all``: as ``attn`` in the double-stream blocks too (``attn_out_double``);
* ``single``: only the single-stream blocks are checkpointed (``full`` inside);
* ``dots``: JAX ``dots_with_no_batch_dims_saveable``.  Selective
  checkpointing saves the outputs of the 2-D products (``aten.mm``,
  ``aten.addmm``, ``aten._int_mm``: every linear) and recomputes the rest,
  batched products (``bmm``, the plain attention path) and the flash op
  included.

``remat_skip_last`` leaves the last N single-stream blocks unchecked, and
``remat_interval`` checkpoints only every k-th block of both stacks.  Remat
changes no gradient.

Timesteps may be tokenwise, (B, S_img) (LongCat-Image's edit flavour gives
its reference tokens t = 0): each image token then modulates on its own
conditioning, the text stream on the per-sample mean of it, and the single
blocks on ``[text mean repeated, per token]`` over the fused stream, as the
JAX module does.  TREAD routing, ControlNet residuals, FlowMap conditioning
and QK-clip are not ported; the forward takes none of them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ...ops import apply_rope, axial_rope, dot_product_attention
from ..layers import (
    AdaLayerNormZero,
    FeedForward,
    LoRADense,
    MLPEmbedder,
    RMSNorm,
    gate_mod,
    layer_norm,
    modulate,
    timestep_embedding,
)

Rope = Tuple[torch.Tensor, torch.Tensor]
REMAT_POLICIES = ("full", "attn", "attn_all", "single", "dots")


def _saving(ops) -> Callable:
    """A checkpoint ``context_fn`` that saves the outputs of ``ops`` and recomputes the rest."""

    def policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


_SAVE_ATTENTION = _saving({torch.ops.simpletuner_tpu_torch.flash_attention.default})
_SAVE_DOTS = _saving({torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten._int_mm.default})
# (policy, single-stream block) -> checkpoint context_fn; None: plain checkpoint
_CONTEXTS = {
    ("attn", True): _SAVE_ATTENTION,
    ("attn_all", False): _SAVE_ATTENTION,
    ("attn_all", True): _SAVE_ATTENTION,
    ("dots", False): _SAVE_DOTS,
    ("dots", True): _SAVE_DOTS,
}


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64  # packed 2x2 patches of 16-channel latents
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    mlp_ratio: float = 4.0
    depth_double: int = 19
    depth_single: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    txt_in_features: int = 4096  # T5-XXL hidden
    vec_in_features: int = 768  # pooled CLIP-L
    vector_embed: bool = True
    guidance_embed: bool = True
    qkv_bias: bool = True

    @classmethod
    def tiny(cls) -> "FluxConfig":
        """Small config for tests."""
        return cls(
            in_channels=16,
            hidden_size=64,
            num_heads=2,
            head_dim=32,
            depth_double=2,
            depth_single=2,
            axes_dim=(8, 12, 12),
            txt_in_features=32,
            vec_in_features=32,
        )


class DoubleStreamBlock(nn.Module):
    """MMDiT block: separate img/txt params, joint attention over the fused stream."""

    def __init__(self, config: FluxConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 lora_mod_layers: bool = False) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        mod_lora = lora if lora_mod_layers else dict(dtype=dtype)
        for prefix in ("img", "txt"):
            self.add_module(f"{prefix}_mod", AdaLayerNormZero(dim, 6, **mod_lora))
            for proj in ("q", "k", "v"):
                self.add_module(
                    f"{prefix}_attn_{proj}", LoRADense(dim, dim, use_bias=config.qkv_bias, **lora)
                )
            self.add_module(f"{prefix}_attn_norm_q", RMSNorm(config.head_dim, dtype=dtype))
            self.add_module(f"{prefix}_attn_norm_k", RMSNorm(config.head_dim, dtype=dtype))
            self.add_module(f"{prefix}_attn_proj", LoRADense(dim, dim, **lora))
            self.add_module(f"{prefix}_mlp", FeedForward(dim, config.mlp_ratio, **lora))

    def _qkv(self, prefix: str, x: torch.Tensor):
        cfg = self.config
        shape = (x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim)
        q = getattr(self, f"{prefix}_attn_q")(x).reshape(shape)
        k = getattr(self, f"{prefix}_attn_k")(x).reshape(shape)
        v = getattr(self, f"{prefix}_attn_v")(x).reshape(shape)
        q = getattr(self, f"{prefix}_attn_norm_q")(q)
        k = getattr(self, f"{prefix}_attn_norm_k")(k)
        return q, k, v

    def forward(self, img, txt, vec, rope: Rope, segment_ids=None, vec_txt=None):
        dim = self.config.hidden_size
        # vec may be tokenwise (B, S_img, dim); the text stream then takes vec_txt (B, dim)
        img_mods = self.img_mod(vec)
        txt_mods = self.txt_mod(vec if vec_txt is None else vec_txt)

        img_n = modulate(layer_norm(img, self.dtype), img_mods[0], img_mods[1])
        txt_n = modulate(layer_norm(txt, self.dtype), txt_mods[0], txt_mods[1])
        img_q, img_k, img_v = self._qkv("img", img_n)
        txt_q, txt_k, txt_v = self._qkv("txt", txt_n)

        # fused stream: text tokens first (Flux ordering), then image tokens
        q = torch.cat([txt_q, img_q], dim=1)
        k = torch.cat([txt_k, img_k], dim=1)
        v = torch.cat([txt_v, img_v], dim=1)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = dot_product_attention(q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
        attn = attn.reshape(img.shape[0], -1, dim)
        txt_attn, img_attn = attn[:, : txt.shape[1]], attn[:, txt.shape[1]:]

        img = img + gate_mod(img_mods[2]) * self.img_attn_proj(img_attn)
        txt = txt + gate_mod(txt_mods[2]) * self.txt_attn_proj(txt_attn)

        img_m = modulate(layer_norm(img, self.dtype), img_mods[3], img_mods[4])
        img = img + gate_mod(img_mods[5]) * self.img_mlp(img_m)
        txt_m = modulate(layer_norm(txt, self.dtype), txt_mods[3], txt_mods[4])
        txt = txt + gate_mod(txt_mods[5]) * self.txt_mlp(txt_m)
        return img, txt


class SingleStreamBlock(nn.Module):
    """DiT block over the fused (txt+img) stream with a fused qkv+mlp projection."""

    def __init__(self, config: FluxConfig, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 lora_mod_layers: bool = False) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        dim = config.hidden_size
        self.mlp_dim = int(dim * config.mlp_ratio)
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.modulation = AdaLayerNormZero(dim, 3, **(lora if lora_mod_layers else dict(dtype=dtype)))
        self.linear1 = LoRADense(dim, dim * 3 + self.mlp_dim, **lora)
        self.norm_q = RMSNorm(config.head_dim, dtype=dtype)
        self.norm_k = RMSNorm(config.head_dim, dtype=dtype)
        self.linear2 = LoRADense(dim + self.mlp_dim, dim, **lora)

    def forward(self, x, vec, rope: Rope, segment_ids=None):
        cfg = self.config
        dim = cfg.hidden_size
        shift, scale, gate = self.modulation(vec)
        x_n = modulate(layer_norm(x, self.dtype), shift, scale)

        fused = self.linear1(x_n)
        batch, seq = x.shape[:2]
        shape = (batch, seq, cfg.num_heads, cfg.head_dim)
        q, k, v = (t.reshape(shape) for t in fused[..., : dim * 3].split(dim, dim=-1))
        mlp = fused[..., dim * 3:]
        q = self.norm_q(q)
        k = self.norm_k(k)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = dot_product_attention(q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
        attn = attn.reshape(batch, seq, dim)
        out = self.linear2(torch.cat([attn, F.gelu(mlp, approximate="tanh")], dim=-1))
        return x + gate_mod(gate) * out


class FluxTransformer(nn.Module):
    """Full Flux DiT.  Inputs are pre-packed token sequences:

    img: (B, S_img, in_channels) packed latent patches
    img_ids / txt_ids: (B, S, 3) axial position ids
    txt: (B, S_txt, txt_in_features) T5 features
    vec: (B, vec_in_features) pooled CLIP features
    timesteps: (B,) in [0, 1], or (B, S_img) tokenwise
    guidance: (B,) guidance scale (distilled flavours)
    segment_ids: (B, S_txt + S_img) int32, -1 on tokens nothing may attend to
    Returns (B, S_img, in_channels) f32.

    ``lora_mod_layers`` adapts the blocks' AdaLN modulation linears too
    (``flux_lora_target=ai-toolkit``); ``remat``, ``remat_policy``,
    ``remat_skip_last`` and ``remat_interval`` as in the module docstring.
    """

    def __init__(self, config: FluxConfig = FluxConfig(), dtype: torch.dtype = torch.bfloat16,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None, lora_algo: str = "lora",
                 lora_mod_layers: bool = False, remat: bool = False, remat_policy: str = "full",
                 remat_skip_last: int = 0, remat_interval: int = 1) -> None:
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown gradient_checkpointing_policy {remat_policy!r}; known: {REMAT_POLICIES}")
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.remat_policy = remat_policy
        self.remat_skip_last = remat_skip_last
        self.remat_interval = max(1, remat_interval)
        dim = config.hidden_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.img_in = LoRADense(config.in_channels, dim, **lora)
        self.txt_in = LoRADense(config.txt_in_features, dim, **lora)
        self.time_in = MLPEmbedder(256, dim, dtype=dtype)
        if config.vector_embed:
            self.vector_in = MLPEmbedder(config.vec_in_features, dim, dtype=dtype)
        if config.guidance_embed:
            self.guidance_in = MLPEmbedder(256, dim, dtype=dtype)
        for i in range(config.depth_double):
            self.add_module(f"double_{i}", DoubleStreamBlock(config, lora_mod_layers=lora_mod_layers, **lora))
        for i in range(config.depth_single):
            self.add_module(f"single_{i}", SingleStreamBlock(config, lora_mod_layers=lora_mod_layers, **lora))
        self.final_mod = AdaLayerNormZero(dim, 2, dtype=dtype)
        self.final_proj = LoRADense(dim, config.in_channels, dtype=dtype)

    def forward(
        self,
        img: torch.Tensor,
        img_ids: torch.Tensor,
        txt: torch.Tensor,
        txt_ids: torch.Tensor,
        timesteps: torch.Tensor,
        vec: torch.Tensor,
        guidance: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        img_tok = self.img_in(img)
        txt_tok = self.txt_in(txt)

        tokenwise = timesteps.dim() == 2
        if tokenwise:
            t_emb = timestep_embedding(timesteps.reshape(-1), 256).reshape(*timesteps.shape, 256)
        else:
            t_emb = timestep_embedding(timesteps, 256)
        cond = self.time_in(t_emb.to(self.dtype))
        if cfg.vector_embed:
            vec_cond = self.vector_in(vec.to(self.dtype))
            cond = cond + (vec_cond[:, None] if tokenwise else vec_cond)
        if cfg.guidance_embed:
            if guidance is None:
                guidance = torch.ones((img.shape[0],), dtype=torch.float32, device=img.device)
            g_cond = self.guidance_in(timestep_embedding(guidance, 256).to(self.dtype))
            cond = cond + (g_cond[:, None] if tokenwise else g_cond)
        # tokenwise: the text stream modulates on the per-sample mean
        cond_txt = cond.mean(dim=1) if tokenwise else None

        rope = axial_rope(cfg.axes_dim, torch.cat([txt_ids, img_ids], dim=1), cfg.theta)
        for i in range(cfg.depth_double):
            img_tok, txt_tok = self._block(False, i, img_tok, txt_tok, cond, rope, segment_ids, cond_txt)

        stream = torch.cat([txt_tok, img_tok], dim=1)
        cond_single = cond
        if tokenwise:
            cond_single = torch.cat([cond_txt[:, None].expand(-1, txt_tok.shape[1], -1), cond], dim=1)
        for i in range(cfg.depth_single):
            stream = self._block(True, i, stream, cond_single, rope, segment_ids)
        img_tok = stream[:, txt_tok.shape[1]:]

        shift, scale = self.final_mod(cond)
        img_tok = modulate(layer_norm(img_tok, self.dtype), shift, scale)
        return self.final_proj(img_tok).to(torch.float32)

    def checkpointed(self, single: bool, layer: int) -> bool:
        """Whether remat checkpoints block ``layer`` of the single (or double)
        stack: every ``remat_interval``-th block, no double block under
        ``single``, none of the last ``remat_skip_last`` single blocks."""
        if not self.remat or layer % self.remat_interval:
            return False
        if single:
            return layer < self.config.depth_single - self.remat_skip_last
        return self.remat_policy != "single"

    def _block(self, single: bool, layer: int, *args):
        block = getattr(self, f"{'single' if single else 'double'}_{layer}")
        if not (torch.is_grad_enabled() and self.checkpointed(single, layer)):
            return block(*args)
        # a block draws no random numbers, so the recompute needs no saved RNG
        # state (reading it is refused while a CUDA graph captures the step)
        context = _CONTEXTS.get((self.remat_policy, single))
        if context is None:
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False, context_fn=context)


def pack_latents(latents: torch.Tensor, patch: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, C*p*p) tokens, channels last in (ph, pw, c) order."""
    batch, height, width, channels = latents.shape
    x = latents.reshape(batch, height // patch, patch, width // patch, patch, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(batch, (height // patch) * (width // patch), channels * patch * patch)


def unpack_latents(tokens: torch.Tensor, height: int, width: int, patch: int = 2) -> torch.Tensor:
    """Inverse of :func:`pack_latents`; height/width are the latent dims."""
    batch = tokens.shape[0]
    channels = tokens.shape[-1] // (patch * patch)
    x = tokens.reshape(batch, height // patch, width // patch, patch, patch, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(batch, height, width, channels)


def make_img_ids(batch: int, height: int, width: int, patch: int = 2, device=None) -> torch.Tensor:
    """Axial (t, h, w) position ids for packed latent tokens."""
    h, w = height // patch, width // patch
    grid = torch.stack(
        [
            torch.zeros((h, w), dtype=torch.int32, device=device),
            torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w),
            torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w),
        ],
        dim=-1,
    ).reshape(1, -1, 3)
    return grid.expand(batch, grid.shape[1], 3)


def make_txt_ids(batch: int, seq: int, device=None) -> torch.Tensor:
    return torch.zeros((batch, seq, 3), dtype=torch.int32, device=device)
