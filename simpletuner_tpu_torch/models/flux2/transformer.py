"""FLUX.2 DiT in PyTorch.

Counterpart of ``simpletuner_tpu/models/flux2/transformer.py`` (the
``Flux2Transformer2DModel``): bias-free linears throughout; global
modulation, one (shift, scale, gate) pair per stream shared by every double
block (``mod_double_img`` / ``mod_double_txt``) and one set shared by every
single block (``mod_single``), all three from ``silu(temb)`` in f32; double
blocks with per-stream q / k / v, per-head RMS q / k norms (eps 1e-6), one
joint attention with the text tokens first and SwiGLU feed-forwards (fused
gate and up in ``ff_in``); single blocks are ViT-22B parallel blocks, one
fused ``qkv_mlp`` split [q, k, v, gate, up] and one fused ``proj_out`` over
[attention, silu(gate) * up].  The rope is 4-axis (t, h, w, l) at theta
2000 on interleaved pairs: image ids (0, h, w, 0) after text ids (0, 0, 0,
l).  The timestep and guidance sinusoids are scaled by 1000 inside
``timestep_embedding``; the head is the scale-first AdaLayerNormContinuous
(``final_mod``) and ``final_proj``.  Submodules keep the JAX names
(``double_{i}.attn_q``, ``single_{i}.qkv_mlp``), so the bridge maps a Flax
tree by name.

The module patchifies 2x2 inside, as the JAX module does.  Its ``patch_in``
takes ``in_channels * patch ** 2`` features from the config, where the Flax
module infers them from its first input: at the published and tiny configs
the two give the same parameter shapes.  Remat (``gradient_checkpointing``)
checkpoints every block whole, as ``nn.remat`` wraps both block classes.
The JAX module's per-block ``intermediates`` (the CREPA tap) are not ported
(ROADMAP Queue 1 item 4h).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import apply_rope, axial_rope, dot_product_attention
from ..layers import LoRADense, RMSNorm, layer_norm, timestep_embedding


@dataclasses.dataclass(frozen=True)
class Flux2Config:
    in_channels: int = 32
    patch_size: int = 2
    num_heads: int = 48
    head_dim: int = 128
    depth_double: int = 8
    depth_single: int = 48
    txt_in_features: int = 15360  # three tapped Mistral-3 layers
    mlp_ratio: float = 3.0
    axes_dim: Tuple[int, int, int, int] = (32, 32, 32, 32)
    rope_theta: float = 2000.0
    guidance_embed: bool = True

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @classmethod
    def tiny(cls) -> "Flux2Config":
        return cls(in_channels=4, num_heads=2, head_dim=16, depth_double=1, depth_single=2, txt_in_features=32,
                   axes_dim=(4, 4, 4, 4))

    @classmethod
    def klein(cls) -> "Flux2Config":
        # the guidance-free distilled variant
        return cls(num_heads=24, depth_double=5, depth_single=20, guidance_embed=False)


def _heads(x: torch.Tensor, cfg: Flux2Config) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim)


class Flux2DoubleBlock(nn.Module):
    """Joint [text, image] attention block.  ``mod_img`` / ``mod_txt`` are the
    shared (B, 1, 6 x dim) modulations: (shift, scale, gate) of the attention,
    then of the feed-forward."""

    def __init__(self, config: Flux2Config, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, inner, mlp = config.hidden_size, config.num_heads * config.head_dim, config.mlp_hidden
        lora = dict(use_bias=False, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        for prefix in ("attn", "attn_add"):
            for name in ("q", "k", "v"):
                self.add_module(f"{prefix}_{name}", LoRADense(dim, inner, **lora))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            self.add_module(name, RMSNorm(config.head_dim, dtype=dtype))
        self.attn_proj = LoRADense(inner, dim, **lora)
        self.attn_add_proj = LoRADense(inner, dim, **lora)
        for prefix in ("ff", "ff_context"):
            self.add_module(f"{prefix}_in", LoRADense(dim, 2 * mlp, **lora))
            self.add_module(f"{prefix}_out", LoRADense(mlp, dim, **lora))

    def _ffn(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        gate, up = getattr(self, f"{prefix}_in")(x).chunk(2, dim=-1)
        return getattr(self, f"{prefix}_out")(F.silu(gate) * up)

    def forward(self, img: torch.Tensor, txt: torch.Tensor, mod_img: torch.Tensor, mod_txt: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor):
        cfg, dtype = self.config, self.dtype
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = mod_img.chunk(6, dim=-1)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = mod_txt.chunk(6, dim=-1)
        img_n = (1 + i_sc1) * layer_norm(img, dtype) + i_sh1
        txt_n = (1 + t_sc1) * layer_norm(txt, dtype) + t_sh1
        q_i = self.norm_q(_heads(self.attn_q(img_n), cfg))
        k_i = self.norm_k(_heads(self.attn_k(img_n), cfg))
        q_t = self.norm_added_q(_heads(self.attn_add_q(txt_n), cfg))
        k_t = self.norm_added_k(_heads(self.attn_add_k(txt_n), cfg))
        # text first
        q = apply_rope(torch.cat([q_t, q_i], dim=1), cos, sin)
        k = apply_rope(torch.cat([k_t, k_i], dim=1), cos, sin)
        v = torch.cat([_heads(self.attn_add_v(txt_n), cfg), _heads(self.attn_v(img_n), cfg)], dim=1)
        attn = dot_product_attention(q, k, v).reshape(img.shape[0], -1, cfg.num_heads * cfg.head_dim)
        txt_len = txt.shape[1]
        img = img + i_g1 * self.attn_proj(attn[:, txt_len:])
        txt = txt + t_g1 * self.attn_add_proj(attn[:, :txt_len])
        img = img + i_g2 * self._ffn("ff", layer_norm(img, dtype) * (1 + i_sc2) + i_sh2)
        txt = txt + t_g2 * self._ffn("ff_context", layer_norm(txt, dtype) * (1 + t_sc2) + t_sh2)
        return img, txt


class Flux2SingleBlock(nn.Module):
    """ViT-22B parallel block over the joint stream; ``mod`` is the shared
    (B, 1, 3 x dim) (shift, scale, gate)."""

    def __init__(self, config: Flux2Config, dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora") -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, inner, mlp = config.hidden_size, config.num_heads * config.head_dim, config.mlp_hidden
        lora = dict(use_bias=False, dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        self.qkv_mlp = LoRADense(dim, 3 * inner + 2 * mlp, **lora)
        self.norm_q = RMSNorm(config.head_dim, dtype=dtype)
        self.norm_k = RMSNorm(config.head_dim, dtype=dtype)
        self.proj_out = LoRADense(inner + mlp, dim, **lora)

    def forward(self, x: torch.Tensor, mod: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        inner, mlp = cfg.num_heads * cfg.head_dim, cfg.mlp_hidden
        shift, scale, gate = mod.chunk(3, dim=-1)
        x_n = (1 + scale) * layer_norm(x, self.dtype) + shift
        q, k, v, mlp_gate, mlp_up = self.qkv_mlp(x_n).split([inner, inner, inner, mlp, mlp], dim=-1)
        q = apply_rope(self.norm_q(_heads(q, cfg)), cos, sin)
        k = apply_rope(self.norm_k(_heads(k, cfg)), cos, sin)
        attn = dot_product_attention(q, k, _heads(v, cfg)).reshape(x.shape[0], x.shape[1], inner)
        return x + gate * self.proj_out(torch.cat([attn, F.silu(mlp_gate) * mlp_up], dim=-1))


def flux2_rope_ids(hh: int, ww: int, txt_len: int, device=None) -> torch.Tensor:
    """(1, txt_len + hh * ww, 4) f32 position ids: text (0, 0, 0, l), then image (0, h, w, 0)."""
    rows = torch.arange(hh, dtype=torch.float32, device=device).repeat_interleave(ww)
    cols = torch.arange(ww, dtype=torch.float32, device=device).repeat(hh)
    ell = torch.arange(txt_len, dtype=torch.float32, device=device)
    zi, zt = torch.zeros_like(rows), torch.zeros_like(ell)
    ids = torch.cat([torch.stack([zt, zt, zt, ell], dim=-1), torch.stack([zi, rows, cols, zi], dim=-1)], dim=0)
    return ids[None]


class Flux2Transformer(nn.Module):
    """The FLUX.2 DiT.  ``latents`` (B, H, W, in_channels) VAE latents,
    ``timesteps`` (B,) sigma in (0, 1), ``context`` (B, L, txt_in_features),
    ``guidance`` (B,) raw guidance values (ones when None and the config embeds
    guidance); returns (B, H, W, in_channels) in f32."""

    def __init__(self, config: Flux2Config = Flux2Config(), dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, lora_algo: str = "lora", remat: bool = False) -> None:
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, remat
        dim, p = config.hidden_size, config.patch_size
        lora = dict(dtype=dtype, lora_rank=lora_rank, lora_alpha=lora_alpha, lora_algo=lora_algo)
        plain = dict(use_bias=False, dtype=dtype)
        self.time_in_1, self.time_in_2 = LoRADense(256, dim, **plain), LoRADense(dim, dim, **plain)
        if config.guidance_embed:
            self.guidance_in_1, self.guidance_in_2 = LoRADense(256, dim, **plain), LoRADense(dim, dim, **plain)
        self.mod_double_img = LoRADense(dim, 6 * dim, **plain)
        self.mod_double_txt = LoRADense(dim, 6 * dim, **plain)
        self.mod_single = LoRADense(dim, 3 * dim, **plain)
        self.patch_in = LoRADense(p * p * config.in_channels, dim, use_bias=False, **lora)
        self.txt_in = LoRADense(config.txt_in_features, dim, use_bias=False, **lora)
        for layer in range(config.depth_double):
            self.add_module(f"double_{layer}", Flux2DoubleBlock(config, **lora))
        for layer in range(config.depth_single):
            self.add_module(f"single_{layer}", Flux2SingleBlock(config, **lora))
        self.final_mod = LoRADense(dim, 2 * dim, **plain)
        self.final_proj = LoRADense(dim, p * p * config.in_channels, use_bias=False, **lora)

    def _embed(self, values: torch.Tensor, prefix: str) -> torch.Tensor:
        h = getattr(self, f"{prefix}_1")(timestep_embedding(values, 256).to(self.dtype))
        return getattr(self, f"{prefix}_2")(F.silu(h))

    def _run(self, block: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            # a block draws no random numbers: the recompute needs no RNG state
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dtype, p = self.config, self.dtype, self.config.patch_size
        batch, height, width, channels = latents.shape
        hh, ww = height // p, width // p
        txt_len = context.shape[1]

        temb = self._embed(timesteps, "time_in")
        if cfg.guidance_embed:
            temb = temb + self._embed(torch.ones_like(timesteps) if guidance is None else guidance, "guidance_in")
        silu_t = F.silu(temb.to(torch.float32)).to(dtype)
        mod_img = self.mod_double_img(silu_t)[:, None]
        mod_txt = self.mod_double_txt(silu_t)[:, None]
        mod_single = self.mod_single(silu_t)[:, None]

        x = latents.to(dtype).reshape(batch, hh, p, ww, p, channels).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_in(x.reshape(batch, hh * ww, p * p * channels))
        txt = self.txt_in(context.to(dtype))
        cos, sin = axial_rope(cfg.axes_dim, flux2_rope_ids(hh, ww, txt_len, latents.device), cfg.rope_theta)

        for layer in range(cfg.depth_double):
            x, txt = self._run(getattr(self, f"double_{layer}"), x, txt, mod_img, mod_txt, cos, sin)
        stream = torch.cat([txt, x], dim=1)
        for layer in range(cfg.depth_single):
            stream = self._run(getattr(self, f"single_{layer}"), stream, mod_single, cos, sin)

        # AdaLayerNormContinuous: (scale, shift), scale first
        scale, shift = self.final_mod(silu_t).chunk(2, dim=-1)
        x = layer_norm(stream[:, txt_len:], dtype) * (1 + scale[:, None]) + shift[:, None]
        x = self.final_proj(x).reshape(batch, hh, ww, p, p, channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(batch, height, width, channels).to(torch.float32)
