"""Pretrained-weight import: safetensors checkpoints -> the port's modules.

Counterpart of the Flux, SD3 and VAE paths of
``simpletuner_tpu/models/weight_import.py``.  The importers build the same
Flax-layout tree as the JAX functions, leaf for leaf (dense ``kernel`` (in,
out), conv ``kernel`` (kh, kw, in, out), norm ``scale``), and
``weight_bridge.load_flax_params`` puts that tree on the module.  Both Flux
checkpoint layouts are read:

* **original/BFL** single file (``double_blocks.*``, fused ``img_attn.qkv``);
* **diffusers** model dirs (``transformer/*.safetensors``,
  ``transformer_blocks.*``, split ``attn.to_q``).

SD3 / SD3.5 read the diffusers ``SD3Transformer2DModel`` layout; SDXL, SD 1.x
and SD 2.x the diffusers ``UNet2DConditionModel`` layout (``unet/``), level
for level as the JAX presets build it: attention wherever
``cross_attention_blocks`` marks a level, so SDXL's
``down_blocks.0.attentions.*`` too (ROADMAP Queue 3), and SD 1.x's 1x1-conv
``proj_in`` / ``proj_out`` read as dense kernels; PixArt-Sigma the diffusers
``PixArtTransformer2DModel`` layout (``transformer/``); AuraFlow the
diffusers ``AuraFlowTransformer2DModel`` layout (``transformer/``); Wan the
diffusers ``WanTransformer3DModel`` layout (``transformer/``); LTX-Video the
diffusers ``LTXVideoTransformer3DModel`` layout (``transformer/``); Chroma the
diffusers ``ChromaTransformer2DModel`` layout (``transformer/``; read without
Flux's packing permutation, as the JAX importer reads it: ROADMAP Queue 3);
Lumina2 the diffusers ``Lumina2Transformer2DModel`` layout (``transformer/``);
Kandinsky 5.0 (image and video) the ai-forever ``Kandinsky5Transformer3DModel``
layout (``transformer/``); HunyuanVideo 1.5 the diffusers
``HunyuanVideo15Transformer3DModel`` layout (``transformer/``); FLUX.2 the diffusers
``Flux2Transformer2DModel`` layout (``transformer/``); Kolors the diffusers UNet
layout (``unet/``); Krea-2 the ``Krea2Transformer2DModel`` layout, Cosmos-Predict2
the diffusers ``CosmosTransformer3DModel`` layout and Anima its adapter with a
``core.``-prefixed Cosmos core (``transformer/``); OmniGen the diffusers
``OmniGenTransformer2DModel`` layout, ERNIE-Image the ``ErnieImageTransformer2DModel``
layout and Ideogram the ``Ideogram4Transformer`` layout (``transformer/``);
LongCat-Video the ``LongCatVideoTransformer3DModel`` layout, Sana the diffusers
``SanaTransformer2DModel`` layout and Sana-Video the ``SanaVideoTransformer3DModel``
layout (``transformer/``); Cosmos3 the flat ``Cosmos3OmniTransformer`` layout;
LTX-2 the diffusers ``LTX2VideoTransformer3DModel`` layout (``transformer/``);
ACE-Step the ``ACEStepTransformer2DModel`` layout (its conformer lyric encoder
included); Wan-S2V Wan's.

Where the JAX side upcasts every leaf to f32 (its ``_to_f32``), the port
keeps f32, bf16 and fp8 (e4m3) leaves in the file's dtype (``_float``; the
bridge takes e4m3 values to the module's dtype on its device, exactly) and
every other dtype through f32, so the module the bridge fills is bitwise the
one the JAX import followed by the bridge gives, without an f32 copy of the
checkpoint in host memory.  (The JAX reader, through ``safetensors.numpy``, cannot read an
fp8 file at all; the port reads the dtype the published fp8 checkpoints use.)  Kernels are transposed views of the file's
tensors; the bridge transposes them back.

The safetensors reader and writer are the port's own (stdlib, numpy and
torch): an 8-byte little-endian header length, a JSON header, raw
little-endian bytes.  Files are memory-mapped copy-on-write, so a tensor is
read from disk when it is first used.  Only the ``flux``, ``sd3``, ``sdxl``,
``sd1x``, ``sd2x``, ``pixart_sigma``, ``auraflow``, ``wan``, ``ltxvideo``, ``chroma``,
``lumina2``, ``kandinsky5_video``, ``kandinsky5_image``, ``hunyuanvideo``, ``qwen_image``,
``mageflow``, ``z_image``, ``hidream``, ``flux2``, ``kolors``, ``longcat_image``,
``z_image_omni``, ``zlab_i1``, ``boogu_image``, ``krea2``, ``cosmos``, ``anima``, ``omnigen``,
``ernie``, ``ideogram``, ``longcat_video``, ``sana``, ``sanavideo``, ``cosmos3``, ``ltxvideo2``,
``ace_step`` and ``wan_s2v`` families import; every other family raises.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import sys
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from .weight_bridge import load_flax_params

logger = logging.getLogger(__name__)

# safetensors dtype names <-> torch dtypes (the ones a diffusion checkpoint holds)
_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


# ---------------------------------------------------------------------------------
# safetensors reading and writing
# ---------------------------------------------------------------------------------


def load_safetensors_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over a
    copy-on-write memory map of the file (writable; the file is never
    changed).  ``__metadata__`` is dropped."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors stores little-endian bytes; this reader runs on little-endian hosts only")
    size = os.path.getsize(path)
    with open(path, "rb") as handle:
        (length,) = struct.unpack("<Q", handle.read(8))
        if length > size - 8:
            raise ValueError(f"{path}: header length {length} exceeds the file ({size} bytes)")
        header = json.loads(handle.read(length))
    header.pop("__metadata__", None)
    start_of_data = 8 + length
    data_bytes = size - start_of_data
    buffer = (torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c", offset=start_of_data))
              if data_bytes else torch.empty(0, dtype=torch.uint8, device="cpu"))
    tensors: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise NotImplementedError(f"{path}: {name} has dtype {info['dtype']}, which the reader does not take")
        dtype, shape = _DTYPES[info["dtype"]], [int(d) for d in info["shape"]]
        begin, end = (int(x) for x in info["data_offsets"])
        itemsize = dtype.itemsize
        if not 0 <= begin <= end <= data_bytes or end - begin != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} has offsets {info['data_offsets']} for {info['dtype']} {shape}")
        raw = buffer[begin:end]
        if begin % itemsize:  # a view needs an aligned start: copy the bytes once
            raw = raw.clone()
        tensors[name] = raw.view(dtype).reshape(shape)
    return tensors


def save_safetensors(
    tensors: Mapping[str, Union[torch.Tensor, np.ndarray]], path: str, metadata: Optional[Dict[str, str]] = None
) -> None:
    """Write ``tensors`` as one ``.safetensors`` file (written to a temporary
    name, then renamed).  Tensors are ordered by element size, then name, and
    the header is padded with spaces to 8 bytes, as the safetensors package
    lays a file out; tensors on a device are copied to the host one at a time."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors stores little-endian bytes; this writer runs on little-endian hosts only")
    items = []
    for name, value in tensors.items():
        tensor = torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value
        if tensor.dtype not in _NAMES:
            raise NotImplementedError(f"{name}: dtype {tensor.dtype} has no safetensors name here")
        items.append((name, tensor.detach()))
    items.sort(key=lambda item: (-item[1].element_size(), item[0]))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, tensor in items:
        nbytes = tensor.numel() * tensor.element_size()
        header[name] = {"dtype": _NAMES[tensor.dtype], "shape": list(tensor.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as handle:
        handle.write(struct.pack("<Q", len(blob)))
        handle.write(blob)
        for _, tensor in items:
            host = tensor.to("cpu").contiguous().reshape(-1)
            handle.write(host.view(torch.uint8).numpy().data)
    os.replace(tmp, path)


def safetensors_metadata(path: str) -> Dict[str, str]:
    """The ``__metadata__`` of one ``.safetensors`` file ({} without one)."""
    with open(path, "rb") as handle:
        (length,) = struct.unpack("<Q", handle.read(8))
        return dict(json.loads(handle.read(length)).get("__metadata__") or {})


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read one file or every ``*.safetensors`` shard in a directory (a
    ``transformer/`` or ``unet/`` subfolder is preferred when present)."""
    files: List[str]
    if os.path.isdir(path):
        for sub in ("transformer", "unet"):
            cand = os.path.join(path, sub)
            if os.path.isdir(cand):
                path = cand
                break
        files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors"))
    else:
        files = [path]
    if not files:
        raise FileNotFoundError(f"no safetensors found under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for file in files:
        tensors.update(load_safetensors_file(file))
    return tensors


# ---------------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------------


def _float(value: torch.Tensor) -> torch.Tensor:
    """A leaf in a float dtype: f32, bf16 and fp8 (e4m3) as stored, every
    other dtype through f32 (the JAX ``_to_f32``; the bridge then rounds once
    to the module's dtype, as it does from the JAX tree).  An e4m3 leaf is a
    float8 checkpoint's values, which the bridge takes to the module's dtype
    on the module's device (exact: bf16 holds every e4m3 value), so the file's
    bytes cross to the card as they are and the host converts nothing."""
    if value.dtype in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
        return value
    return value.to(torch.float32)


def _linear(weights: Mapping[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    out = {"kernel": _float(weights[f"{key}.weight"]).t()}
    if f"{key}.bias" in weights:
        out["bias"] = _float(weights[f"{key}.bias"])
    return out


def _scale(weights: Mapping[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    return {"scale": _float(weights[key])}


# ---------------------------------------------------------------------------------
# Flux
# ---------------------------------------------------------------------------------


def _flux_detect_layout(weights: Mapping[str, torch.Tensor]) -> str:
    if any(k.startswith("double_blocks.") for k in weights):
        return "bfl"
    if any(k.startswith("transformer_blocks.") for k in weights):
        return "diffusers"
    # single-file checkpoints sometimes prefix with model.diffusion_model.
    if any("double_blocks." in k for k in weights):
        return "bfl-prefixed"
    raise ValueError("unrecognized flux checkpoint layout")


def _strip_prefix(weights: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in weights.items():
        for prefix in ("model.diffusion_model.", "module.", "transformer."):
            if key.startswith(prefix):
                key = key[len(prefix):]
        out[key] = value
    return out


def _flux_pack_permutation(packed_features: int, patch: int = 2) -> torch.Tensor:
    """The reference packs latent patches in (c, ph, pw) feature order; the
    port's ``pack_latents`` flattens (ph, pw, c).  Returns ``perm`` with
    ``perm[ours] = theirs``."""
    channels = packed_features // (patch * patch)
    perm = [c * patch * patch + ph * patch + pw for ph in range(patch) for pw in range(patch) for c in range(channels)]
    return torch.tensor(perm, dtype=torch.int64, device="cpu")


def _flux_permute_io(params: Dict[str, Any]) -> Dict[str, Any]:
    """Reorder img_in input rows and final_proj output columns/bias from the
    reference (c, ph, pw) packing to the port's (ph, pw, c)."""
    img_in = dict(params["img_in"])
    img_in["kernel"] = img_in["kernel"][_flux_pack_permutation(img_in["kernel"].shape[0])]
    params["img_in"] = img_in
    final = dict(params["final_proj"])
    out_perm = _flux_pack_permutation(final["kernel"].shape[1])
    final["kernel"] = final["kernel"][:, out_perm]
    if "bias" in final:
        final["bias"] = final["bias"][out_perm]
    params["final_proj"] = final
    return params


def flux_params_from_bfl(weights: Mapping[str, torch.Tensor], depth_double: int, depth_single: int) -> Dict[str, Any]:
    w = weights
    params: Dict[str, Any] = {
        "img_in": _linear(w, "img_in"),
        "txt_in": _linear(w, "txt_in"),
        "time_in": {"in_layer": _linear(w, "time_in.in_layer"), "out_layer": _linear(w, "time_in.out_layer")},
        "vector_in": {"in_layer": _linear(w, "vector_in.in_layer"), "out_layer": _linear(w, "vector_in.out_layer")},
        "final_proj": _linear(w, "final_layer.linear"),
        "final_mod": {"lin": _linear(w, "final_layer.adaLN_modulation.1")},
    }
    if "guidance_in.in_layer.weight" in w:
        params["guidance_in"] = {
            "in_layer": _linear(w, "guidance_in.in_layer"),
            "out_layer": _linear(w, "guidance_in.out_layer"),
        }
    for i in range(depth_double):
        p = f"double_blocks.{i}"
        block: Dict[str, Any] = {}
        for stream in ("img", "txt"):
            qkv_w = _float(w[f"{p}.{stream}_attn.qkv.weight"])  # (3d, d)
            qkv_b = _float(w[f"{p}.{stream}_attn.qkv.bias"])
            dim = qkv_w.shape[1]
            for j, name in enumerate(("q", "k", "v")):
                block[f"{stream}_attn_{name}"] = {
                    "kernel": qkv_w[j * dim:(j + 1) * dim].t(),
                    "bias": qkv_b[j * dim:(j + 1) * dim],
                }
            block[f"{stream}_attn_norm_q"] = _scale(w, f"{p}.{stream}_attn.norm.query_norm.scale")
            block[f"{stream}_attn_norm_k"] = _scale(w, f"{p}.{stream}_attn.norm.key_norm.scale")
            block[f"{stream}_attn_proj"] = _linear(w, f"{p}.{stream}_attn.proj")
            block[f"{stream}_mlp"] = {"proj_in": _linear(w, f"{p}.{stream}_mlp.0"),
                                      "proj_out": _linear(w, f"{p}.{stream}_mlp.2")}
            block[f"{stream}_mod"] = {"lin": _linear(w, f"{p}.{stream}_mod.lin")}
        params[f"double_{i}"] = block
    for i in range(depth_single):
        p = f"single_blocks.{i}"
        params[f"single_{i}"] = {
            "linear1": _linear(w, f"{p}.linear1"),
            "linear2": _linear(w, f"{p}.linear2"),
            "modulation": {"lin": _linear(w, f"{p}.modulation.lin")},
            "norm_q": _scale(w, f"{p}.norm.query_norm.scale"),
            "norm_k": _scale(w, f"{p}.norm.key_norm.scale"),
        }
    return _flux_permute_io(params)


def flux_params_from_diffusers(
    weights: Mapping[str, torch.Tensor], depth_double: int, depth_single: int
) -> Dict[str, Any]:
    w = weights
    params: Dict[str, Any] = {
        "img_in": _linear(w, "x_embedder"),
        "txt_in": _linear(w, "context_embedder"),
        "time_in": {
            "in_layer": _linear(w, "time_text_embed.timestep_embedder.linear_1"),
            "out_layer": _linear(w, "time_text_embed.timestep_embedder.linear_2"),
        },
        "final_proj": _linear(w, "proj_out"),
    }
    # LongCat-Image (timestep-only modulation) has no pooled-text embedder
    if "time_text_embed.text_embedder.linear_1.weight" in w:
        params["vector_in"] = {
            "in_layer": _linear(w, "time_text_embed.text_embedder.linear_1"),
            "out_layer": _linear(w, "time_text_embed.text_embedder.linear_2"),
        }
    if "time_text_embed.guidance_embedder.linear_1.weight" in w:
        params["guidance_in"] = {
            "in_layer": _linear(w, "time_text_embed.guidance_embedder.linear_1"),
            "out_layer": _linear(w, "time_text_embed.guidance_embedder.linear_2"),
        }
    # diffusers AdaLayerNormContinuous emits (scale, shift); BFL and the port
    # (shift, scale): swap the two output halves (rows of the torch weight)
    weight, bias = _float(w["norm_out.linear.weight"]), _float(w["norm_out.linear.bias"])
    half = weight.shape[0] // 2
    params["final_mod"] = {"lin": {"kernel": torch.cat([weight[half:], weight[:half]]).t(),
                                   "bias": torch.cat([bias[half:], bias[:half]])}}
    for i in range(depth_double):
        p = f"transformer_blocks.{i}"
        params[f"double_{i}"] = {
            "img_mod": {"lin": _linear(w, f"{p}.norm1.linear")},
            "txt_mod": {"lin": _linear(w, f"{p}.norm1_context.linear")},
            "img_attn_q": _linear(w, f"{p}.attn.to_q"),
            "img_attn_k": _linear(w, f"{p}.attn.to_k"),
            "img_attn_v": _linear(w, f"{p}.attn.to_v"),
            "txt_attn_q": _linear(w, f"{p}.attn.add_q_proj"),
            "txt_attn_k": _linear(w, f"{p}.attn.add_k_proj"),
            "txt_attn_v": _linear(w, f"{p}.attn.add_v_proj"),
            "img_attn_norm_q": _scale(w, f"{p}.attn.norm_q.weight"),
            "img_attn_norm_k": _scale(w, f"{p}.attn.norm_k.weight"),
            "txt_attn_norm_q": _scale(w, f"{p}.attn.norm_added_q.weight"),
            "txt_attn_norm_k": _scale(w, f"{p}.attn.norm_added_k.weight"),
            "img_attn_proj": _linear(w, f"{p}.attn.to_out.0"),
            "txt_attn_proj": _linear(w, f"{p}.attn.to_add_out"),
            "img_mlp": {"proj_in": _linear(w, f"{p}.ff.net.0.proj"), "proj_out": _linear(w, f"{p}.ff.net.2")},
            "txt_mlp": {"proj_in": _linear(w, f"{p}.ff_context.net.0.proj"),
                        "proj_out": _linear(w, f"{p}.ff_context.net.2")},
        }
    for i in range(depth_single):
        p = f"single_transformer_blocks.{i}"
        parts = [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v", f"{p}.proj_mlp"]
        params[f"single_{i}"] = {
            "linear1": {"kernel": torch.cat([_float(w[f"{part}.weight"]) for part in parts]).t(),
                        "bias": torch.cat([_float(w[f"{part}.bias"]) for part in parts])},
            "linear2": _linear(w, f"{p}.proj_out"),
            "modulation": {"lin": _linear(w, f"{p}.norm.linear")},
            "norm_q": _scale(w, f"{p}.attn.norm_q.weight"),
            "norm_k": _scale(w, f"{p}.attn.norm_k.weight"),
        }
    return _flux_permute_io(params)


def load_flux_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a BFL or diffusers Flux checkpoint."""
    weights = _strip_prefix(read_safetensors(path))
    layout = _flux_detect_layout(weights)
    arch = model.arch
    if layout.startswith("bfl"):
        params = flux_params_from_bfl(weights, arch.depth_double, arch.depth_single)
    else:
        params = flux_params_from_diffusers(weights, arch.depth_double, arch.depth_single)
    logger.info("imported flux weights (%s layout) from %s", layout, path)
    return params


# ---------------------------------------------------------------------------------
# VAE (diffusers AutoencoderKL)
# ---------------------------------------------------------------------------------


def _conv(weights: Mapping[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    # torch conv (O, I, kh, kw) -> flax (kh, kw, I, O)
    out = {"kernel": _float(weights[f"{key}.weight"]).permute(2, 3, 1, 0)}
    if f"{key}.bias" in weights:
        out["bias"] = _float(weights[f"{key}.bias"])
    return out


def _norm(weights: Mapping[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    return {"scale": _float(weights[f"{key}.weight"]), "bias": _float(weights[f"{key}.bias"])}


def _vae_resnet(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    block = {
        "norm1": _norm(w, f"{src}.norm1"),
        "conv1": _conv(w, f"{src}.conv1"),
        "norm2": _norm(w, f"{src}.norm2"),
        "conv2": _conv(w, f"{src}.conv2"),
    }
    if f"{src}.conv_shortcut.weight" in w:
        block["conv_shortcut"] = _conv(w, f"{src}.conv_shortcut")
    return block


def _vae_attn(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    if f"{src}.to_q.weight" in w:  # modern diffusers Attention (Linear)
        return {
            "norm": _norm(w, f"{src}.group_norm"),
            "to_q": _linear(w, f"{src}.to_q"),
            "to_k": _linear(w, f"{src}.to_k"),
            "to_v": _linear(w, f"{src}.to_v"),
            "to_out": _linear(w, f"{src}.to_out.0"),
        }

    # legacy layout: 1x1 convs q/k/v/proj_out -> Dense kernels
    def conv1x1(key):
        return {"kernel": _float(w[f"{key}.weight"])[:, :, 0, 0].t(), "bias": _float(w[f"{key}.bias"])}

    return {
        "norm": _norm(w, f"{src}.norm"),
        "to_q": conv1x1(f"{src}.q"),
        "to_k": conv1x1(f"{src}.k"),
        "to_v": conv1x1(f"{src}.v"),
        "to_out": conv1x1(f"{src}.proj_out"),
    }


def vae_params_from_diffusers(weights: Mapping[str, torch.Tensor], config) -> Dict[str, Any]:
    w = weights
    levels = len(config.channel_multipliers)
    blocks = config.layers_per_block
    encoder: Dict[str, Any] = {
        "conv_in": _conv(w, "encoder.conv_in"),
        "mid_block_1": _vae_resnet(w, "encoder.mid_block.resnets.0"),
        "mid_block_2": _vae_resnet(w, "encoder.mid_block.resnets.1"),
        "mid_attn": _vae_attn(w, "encoder.mid_block.attentions.0"),
        "norm_out": _norm(w, "encoder.conv_norm_out"),
        "conv_out": _conv(w, "encoder.conv_out"),
    }
    for level in range(levels):
        for block in range(blocks):
            encoder[f"down_{level}_block_{block}"] = _vae_resnet(w, f"encoder.down_blocks.{level}.resnets.{block}")
        if level < levels - 1:
            encoder[f"down_{level}_downsample"] = _conv(w, f"encoder.down_blocks.{level}.downsamplers.0.conv")
    decoder: Dict[str, Any] = {
        "conv_in": _conv(w, "decoder.conv_in"),
        "mid_block_1": _vae_resnet(w, "decoder.mid_block.resnets.0"),
        "mid_block_2": _vae_resnet(w, "decoder.mid_block.resnets.1"),
        "mid_attn": _vae_attn(w, "decoder.mid_block.attentions.0"),
        "norm_out": _norm(w, "decoder.conv_norm_out"),
        "conv_out": _conv(w, "decoder.conv_out"),
    }
    for level in range(levels):
        for block in range(blocks + 1):
            decoder[f"up_{level}_block_{block}"] = _vae_resnet(w, f"decoder.up_blocks.{level}.resnets.{block}")
        if level < levels - 1:
            decoder[f"up_{level}_upsample"] = _conv(w, f"decoder.up_blocks.{level}.upsamplers.0.conv")
    params = {"encoder": encoder, "decoder": decoder}
    if "quant_conv.weight" in w:
        params["quant_conv"] = _conv(w, "quant_conv")
    if "post_quant_conv.weight" in w:
        params["post_quant_conv"] = _conv(w, "post_quant_conv")
    return params


def load_vae_params(vae, path: str) -> Dict[str, Any]:
    """``{"params": tree}`` for ``models/vae.py::AutoencoderKL`` from a
    diffusers dir (a ``vae/`` subfolder is found) or a single file with
    ``encoder.*``/``decoder.*`` keys (a ``vae.`` prefix is dropped)."""
    if os.path.isdir(path) and os.path.isdir(os.path.join(path, "vae")):
        path = os.path.join(path, "vae")
    weights = read_safetensors(path)
    weights = {k[len("vae."):] if k.startswith("vae.") else k: v for k, v in weights.items()}
    missing = [k for k in ("quant_conv.weight", "post_quant_conv.weight") if k not in weights]
    if missing:
        # FLUX.1-dev's VAE (use_quant_conv / use_post_quant_conv false) has
        # neither conv; the module, as the JAX one, always applies both
        raise NotImplementedError(
            f"{path}: the VAE checkpoint has no {' / '.join(k.split('.')[0] for k in missing)} "
            "(a VAE with use_quant_conv=false, as FLUX.1-dev's); AutoencoderKL always applies both "
            "convs, so this file does not load (ROADMAP Queue 3)"
        )
    return {"params": vae_params_from_diffusers(weights, vae.config)}


# ---------------------------------------------------------------------------------
# SD3 (diffusers SD3Transformer2DModel)
# ---------------------------------------------------------------------------------


def _swap_halves_linear(node: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers ``AdaLayerNormContinuous`` emits (scale, shift); the port's
    modulation (shift, scale): swap the two output halves of a (in, out) kernel."""
    kernel = node["kernel"]
    half = kernel.shape[1] // 2
    out = {"kernel": torch.cat([kernel[:, half:], kernel[:, :half]], dim=1)}
    if "bias" in node:
        out["bias"] = torch.cat([node["bias"][half:], node["bias"][:half]])
    return out


def sd3_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers SD3 transformer: the patchify conv
    as a dense kernel in (ph, pw, c) row order, the position table as (side,
    side, dim), the last block's text modulation (an ``AdaLayerNormContinuous``)
    and ``norm_out`` with their halves swapped."""
    w = weights
    dim = arch.hidden_size
    conv = _float(w["pos_embed.proj.weight"])  # (dim, C, p, p) -> ((p p C), dim)
    params: Dict[str, Any] = {
        "patch_in": {"kernel": conv.permute(2, 3, 1, 0).reshape(-1, dim), "bias": _float(w["pos_embed.proj.bias"])},
        "context_in": _linear(w, "context_embedder"),
        "time_in": {
            "in_layer": _linear(w, "time_text_embed.timestep_embedder.linear_1"),
            "out_layer": _linear(w, "time_text_embed.timestep_embedder.linear_2"),
        },
        "pooled_in": {
            "in_layer": _linear(w, "time_text_embed.text_embedder.linear_1"),
            "out_layer": _linear(w, "time_text_embed.text_embedder.linear_2"),
        },
        "final_mod": {"lin": _swap_halves_linear(_linear(w, "norm_out.linear"))},
        "final_proj": _linear(w, "proj_out"),
    }
    if arch.pos_embed_max_size:
        side = arch.pos_embed_max_size
        params["pos_embed"] = _float(w["pos_embed.pos_embed"]).reshape(side, side, dim)
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        block: Dict[str, Any] = {
            "img_mod": {"lin": _linear(w, f"{src}.norm1.linear")},
            "img_attn_q": _linear(w, f"{src}.attn.to_q"),
            "img_attn_k": _linear(w, f"{src}.attn.to_k"),
            "img_attn_v": _linear(w, f"{src}.attn.to_v"),
            "txt_attn_q": _linear(w, f"{src}.attn.add_q_proj"),
            "txt_attn_k": _linear(w, f"{src}.attn.add_k_proj"),
            "txt_attn_v": _linear(w, f"{src}.attn.add_v_proj"),
            "img_attn_proj": _linear(w, f"{src}.attn.to_out.0"),
            "img_mlp_in": _linear(w, f"{src}.ff.net.0.proj"),
            "img_mlp_out": _linear(w, f"{src}.ff.net.2"),
        }
        if i == arch.depth - 1:  # context_pre_only
            block["txt_mod"] = {"lin": _swap_halves_linear(_linear(w, f"{src}.norm1_context.linear"))}
        else:
            block["txt_mod"] = {"lin": _linear(w, f"{src}.norm1_context.linear")}
            block["txt_attn_proj"] = _linear(w, f"{src}.attn.to_add_out")
            block["txt_mlp_in"] = _linear(w, f"{src}.ff_context.net.0.proj")
            block["txt_mlp_out"] = _linear(w, f"{src}.ff_context.net.2")
        if arch.qk_norm and f"{src}.attn.norm_q.weight" in w:
            block["img_attn_norm_q"] = _scale(w, f"{src}.attn.norm_q.weight")
            block["img_attn_norm_k"] = _scale(w, f"{src}.attn.norm_k.weight")
            block["txt_attn_norm_q"] = _scale(w, f"{src}.attn.norm_added_q.weight")
            block["txt_attn_norm_k"] = _scale(w, f"{src}.attn.norm_added_k.weight")
        params[f"block_{i}"] = block
    return params


def load_sd3_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers SD3 / SD3.5 transformer
    (a model dir with ``transformer/`` shards, or one file)."""
    params = sd3_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported sd3 weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# UNet (diffusers UNet2DConditionModel: SDXL, and SD 1.x / 2.x on the same arch)
# ---------------------------------------------------------------------------------


def _maybe_conv1x1_as_linear(w: Mapping[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    """SD 1.x spatial-transformer proj_in/out are 1x1 convs; SDXL's are Linear."""
    weight = _float(w[f"{key}.weight"])
    if weight.dim() == 4:
        weight = weight[:, :, 0, 0]
    out = {"kernel": weight.t()}
    if f"{key}.bias" in w:
        out["bias"] = _float(w[f"{key}.bias"])
    return out


def _unet_resnet(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    block = {
        "GroupNorm_0": _norm(w, f"{src}.norm1"),
        "conv1": _conv(w, f"{src}.conv1"),
        "time_emb_proj": _linear(w, f"{src}.time_emb_proj"),
        "GroupNorm_1": _norm(w, f"{src}.norm2"),
        "conv2": _conv(w, f"{src}.conv2"),
    }
    if f"{src}.conv_shortcut.weight" in w:
        block["conv_shortcut"] = _conv(w, f"{src}.conv_shortcut")
    return block


def _unet_tblock(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    def attn(name: str) -> Dict[str, Any]:
        return {proj: _linear(w, f"{src}.{name}.{theirs}")
                for proj, theirs in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0"))}

    return {
        "norm1": _norm(w, f"{src}.norm1"),
        "attn1": attn("attn1"),
        "norm2": _norm(w, f"{src}.norm2"),
        "attn2": attn("attn2"),
        "norm3": _norm(w, f"{src}.norm3"),
        "ff_proj": _linear(w, f"{src}.ff.net.0.proj"),
        "ff_out": _linear(w, f"{src}.ff.net.2"),
    }


def _unet_spatial(w: Mapping[str, torch.Tensor], src: str, depth: int) -> Dict[str, Any]:
    block: Dict[str, Any] = {
        "GroupNorm_0": _norm(w, f"{src}.norm"),
        "proj_in": _maybe_conv1x1_as_linear(w, f"{src}.proj_in"),
        "proj_out": _maybe_conv1x1_as_linear(w, f"{src}.proj_out"),
    }
    for i in range(depth):
        block[f"blocks_{i}"] = _unet_tblock(w, f"{src}.transformer_blocks.{i}")
    return block


def unet_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers UNet of ``arch`` (``UNetConfig``):
    diffusers up block ``u`` is level ``levels - 1 - u``."""
    w = weights
    levels = len(arch.block_out_channels)
    lpb = arch.layers_per_block
    params: Dict[str, Any] = {
        "conv_in": _conv(w, "conv_in"),
        "time_embed_0": _linear(w, "time_embedding.linear_1"),
        "time_embed_2": _linear(w, "time_embedding.linear_2"),
        "conv_norm_out": _norm(w, "conv_norm_out"),
        "conv_out": _conv(w, "conv_out"),
        "mid_res_0": _unet_resnet(w, "mid_block.resnets.0"),
        "mid_res_1": _unet_resnet(w, "mid_block.resnets.1"),
        "mid_attn": _unet_spatial(w, "mid_block.attentions.0", arch.depth_at(levels - 1)),
    }
    if "add_embedding.linear_1.weight" in w:
        params["add_embed_0"] = _linear(w, "add_embedding.linear_1")
        params["add_embed_2"] = _linear(w, "add_embedding.linear_2")
    if "class_embedding.linear_1.weight" in w:
        # class_embed_type="timestep": the module refuses it (ROADMAP Queue 1 item 6)
        params["class_embed_0"] = _linear(w, "class_embedding.linear_1")
        params["class_embed_2"] = _linear(w, "class_embedding.linear_2")
    for level in range(levels):
        has_attn = arch.cross_attention_blocks[level]
        for block in range(lpb):
            params[f"down_{level}_res_{block}"] = _unet_resnet(w, f"down_blocks.{level}.resnets.{block}")
            if has_attn:
                params[f"down_{level}_attn_{block}"] = _unet_spatial(
                    w, f"down_blocks.{level}.attentions.{block}", arch.depth_at(level))
        if level < levels - 1:
            params[f"down_{level}_downsample"] = {"conv": _conv(w, f"down_blocks.{level}.downsamplers.0.conv")}
    for u in range(levels):
        level = levels - 1 - u
        has_attn = arch.cross_attention_blocks[level]
        for block in range(lpb + 1):
            params[f"up_{level}_res_{block}"] = _unet_resnet(w, f"up_blocks.{u}.resnets.{block}")
            if has_attn:
                params[f"up_{level}_attn_{block}"] = _unet_spatial(
                    w, f"up_blocks.{u}.attentions.{block}", arch.depth_at(level))
        if level > 0:
            params[f"up_{level}_upsample"] = {"conv": _conv(w, f"up_blocks.{u}.upsamplers.0.conv")}
    return params


def load_unet_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers UNet (a model dir with a
    ``unet/`` subfolder, or one file)."""
    params = unet_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported unet weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# PixArt (diffusers PixArtTransformer2DModel: pos_embed.proj conv, caption_projection
# gelu MLP, adaln_single, per-block scale_shift_table + attn1/attn2/ff)
# ---------------------------------------------------------------------------------


def pixart_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers PixArt transformer of ``arch``
    (``PixartConfig``): the patchify conv as a (p, p, C) -> dim dense kernel,
    the tables reshaped to (6, dim) and (2, dim)."""
    w = weights
    dim = arch.hidden_size
    conv = _float(w["pos_embed.proj.weight"])  # (dim, C, p, p)
    params: Dict[str, Any] = {
        "patch_in": {"kernel": conv.permute(2, 3, 1, 0).reshape(-1, dim), "bias": _float(w["pos_embed.proj.bias"])},
        "caption_in_1": _linear(w, "caption_projection.linear_1"),
        "caption_in_2": _linear(w, "caption_projection.linear_2"),
        "time_in": {
            "in_layer": _linear(w, "adaln_single.emb.timestep_embedder.linear_1"),
            "out_layer": _linear(w, "adaln_single.emb.timestep_embedder.linear_2"),
        },
        "time_proj": _linear(w, "adaln_single.linear"),
        "final_scale_shift_table": _float(w["scale_shift_table"]).reshape(2, dim),
        "final_proj": _linear(w, "proj_out"),
    }
    table = (("attn1_q", "attn1.to_q"), ("attn1_k", "attn1.to_k"), ("attn1_v", "attn1.to_v"),
             ("attn1_proj", "attn1.to_out.0"), ("attn2_q", "attn2.to_q"), ("attn2_k", "attn2.to_k"),
             ("attn2_v", "attn2.to_v"), ("attn2_proj", "attn2.to_out.0"), ("ff_in", "ff.net.0.proj"),
             ("ff_out", "ff.net.2"))
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        block: Dict[str, Any] = {"scale_shift_table": _float(w[f"{src}.scale_shift_table"]).reshape(6, dim)}
        for ours, theirs in table:
            block[ours] = _linear(w, f"{src}.{theirs}")
        params[f"block_{i}"] = block
    return params


def load_pixart_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers PixArt transformer (a
    model dir with a ``transformer/`` subfolder, or one file)."""
    params = pixart_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported pixart weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# AuraFlow (diffusers AuraFlowTransformer2DModel: learned position table,
# register tokens, joint + single blocks, SwiGLU feed-forwards, bias-free linears)
# ---------------------------------------------------------------------------------


def _aura_ff(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {name: _linear(w, f"{src}.{name}") for name in ("linear_1", "linear_2", "out_projection")}


def auraflow_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers AuraFlow transformer of ``arch``
    (``AuraFlowConfig``): the position table and register tokens without the
    checkpoint's leading batch axis."""
    w = weights
    params: Dict[str, Any] = {
        "patch_in": _linear(w, "pos_embed.proj"),
        "pos_embed": _float(w["pos_embed.pos_embed"]).reshape(-1, arch.hidden_size),
        "context_in": _linear(w, "context_embedder"),
        "register_tokens": _float(w["register_tokens"]).reshape(-1, arch.hidden_size),
        "time_in": {
            "in_layer": _linear(w, "time_step_proj.linear_1"),
            "out_layer": _linear(w, "time_step_proj.linear_2"),
        },
        "final_mod": _linear(w, "norm_out.linear"),
        "final_proj": _linear(w, "proj_out"),
    }
    attention = (("attn_q", "attn.to_q"), ("attn_k", "attn.to_k"), ("attn_v", "attn.to_v"),
                 ("attn_proj", "attn.to_out.0"))
    joint = attention + (("attn_add_q", "attn.add_q_proj"), ("attn_add_k", "attn.add_k_proj"),
                         ("attn_add_v", "attn.add_v_proj"), ("attn_add_proj", "attn.to_add_out"))
    for i in range(arch.depth_double):
        src = f"joint_transformer_blocks.{i}"
        block: Dict[str, Any] = {"norm1_lin": _linear(w, f"{src}.norm1.linear"),
                                 "norm1_context_lin": _linear(w, f"{src}.norm1_context.linear"),
                                 "ff": _aura_ff(w, f"{src}.ff"), "ff_context": _aura_ff(w, f"{src}.ff_context")}
        for ours, theirs in joint:
            block[ours] = _linear(w, f"{src}.{theirs}")
        params[f"double_{i}"] = block
    for i in range(arch.depth_single):
        src = f"single_transformer_blocks.{i}"
        block = {"norm1_lin": _linear(w, f"{src}.norm1.linear"), "ff": _aura_ff(w, f"{src}.ff")}
        for ours, theirs in attention:
            block[ours] = _linear(w, f"{src}.{theirs}")
        params[f"single_{i}"] = block
    return params


def load_auraflow_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers AuraFlow transformer (a
    model dir with a ``transformer/`` subfolder, or one file)."""
    params = auraflow_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported auraflow weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Wan (diffusers WanTransformer3DModel: Conv3d patch embed, condition_embedder,
# per-block scale_shift_table, attn1 / attn2 with q and k RMSNorms, affine norm2)
# ---------------------------------------------------------------------------------


def wan_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers Wan transformer of ``arch``
    (``WanConfig``): the Conv3d patch embed (dim, C, pt, ph, pw) as a dense
    ((pt, ph, pw, C), dim) kernel, the tables reshaped to (6, dim) and (2,
    dim).  An I2V file's image embedder and ``add_k_proj`` / ``add_v_proj``
    have no place in the JAX module and are left unread, as the JAX importer
    leaves them."""
    w = weights
    dim = arch.hidden_size
    conv = _float(w["patch_embedding.weight"])  # (dim, C, pt, ph, pw)
    params: Dict[str, Any] = {
        "patch_in": {"kernel": conv.permute(2, 3, 4, 1, 0).reshape(-1, dim),
                     "bias": _float(w["patch_embedding.bias"])},
        "text_in0": _linear(w, "condition_embedder.text_embedder.linear_1"),
        "text_in2": _linear(w, "condition_embedder.text_embedder.linear_2"),
        "time_in": {
            "in_layer": _linear(w, "condition_embedder.time_embedder.linear_1"),
            "out_layer": _linear(w, "condition_embedder.time_embedder.linear_2"),
        },
        "time_proj": _linear(w, "condition_embedder.time_proj"),
        "final_scale_shift_table": _float(w["scale_shift_table"]).reshape(2, dim),
        "final_proj": _linear(w, "proj_out"),
    }
    table = (("self_attn_q", "attn1.to_q"), ("self_attn_k", "attn1.to_k"), ("self_attn_v", "attn1.to_v"),
             ("self_attn_proj", "attn1.to_out.0"), ("cross_attn_q", "attn2.to_q"), ("cross_attn_k", "attn2.to_k"),
             ("cross_attn_v", "attn2.to_v"), ("cross_attn_proj", "attn2.to_out.0"), ("ffn_in", "ffn.net.0.proj"),
             ("ffn_out", "ffn.net.2"))
    for i in range(arch.depth):
        src = f"blocks.{i}"
        block: Dict[str, Any] = {"scale_shift_table": _float(w[f"{src}.scale_shift_table"]).reshape(6, dim),
                                 # the JAX LayerNorm wrapper nests its affine params one level down
                                 "cross_norm": {"LayerNorm_0": _norm(w, f"{src}.norm2")}}
        for ours, theirs in table:
            block[ours] = _linear(w, f"{src}.{theirs}")
        if arch.qk_norm and f"{src}.attn1.norm_q.weight" in w:
            for ours, theirs in (("self_attn_norm_q", "attn1.norm_q"), ("self_attn_norm_k", "attn1.norm_k"),
                                 ("cross_attn_norm_q", "attn2.norm_q"), ("cross_attn_norm_k", "attn2.norm_k")):
                block[ours] = _scale(w, f"{src}.{theirs}.weight")
        params[f"block_{i}"] = block
    return params


def load_wan_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers Wan transformer (a
    model dir with a ``transformer/`` subfolder, or one file)."""
    params = wan_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported wan weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# LTX-Video (diffusers LTXVideoTransformer3DModel: proj_in, caption_projection,
# adaLN-single time_embed, per-block scale_shift_table, qk-RMS-normed attn1 / attn2)
# ---------------------------------------------------------------------------------


def ltx_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers LTX-Video transformer of ``arch``
    (``LTXConfig``): the tables reshaped to (6, dim) and (2, dim)."""
    w = weights
    dim = arch.hidden_size
    params: Dict[str, Any] = {
        "patch_in": _linear(w, "proj_in"),
        "caption_in_1": _linear(w, "caption_projection.linear_1"),
        "caption_in_2": _linear(w, "caption_projection.linear_2"),
        "time_in": {
            "in_layer": _linear(w, "time_embed.emb.timestep_embedder.linear_1"),
            "out_layer": _linear(w, "time_embed.emb.timestep_embedder.linear_2"),
        },
        "time_proj": _linear(w, "time_embed.linear"),
        "final_scale_shift_table": _float(w["scale_shift_table"]).reshape(2, dim),
        "final_proj": _linear(w, "proj_out"),
    }
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        block: Dict[str, Any] = {"scale_shift_table": _float(w[f"{src}.scale_shift_table"]).reshape(6, dim),
                                 "ff_in": _linear(w, f"{src}.ff.net.0.proj"), "ff_out": _linear(w, f"{src}.ff.net.2")}
        for attn in ("attn1", "attn2"):
            for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj", "to_out.0")):
                block[f"{attn}_{ours}"] = _linear(w, f"{src}.{attn}.{theirs}")
            for norm in ("norm_q", "norm_k"):
                block[f"{attn}_{norm}"] = _scale(w, f"{src}.{attn}.{norm}.weight")
        params[f"block_{i}"] = block
    return params


def load_ltx_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers LTX-Video transformer
    (a model dir with a ``transformer/`` subfolder, or one file)."""
    params = ltx_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported ltxvideo weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Chroma (diffusers ChromaTransformer2DModel: Flux topology, the per-block
# modulation pruned into the distilled-guidance approximator)
# ---------------------------------------------------------------------------------


def chroma_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers Chroma transformer of ``arch``
    (``ChromaConfig``).  Unlike both Flux importers it does not reorder
    ``x_embedder`` / ``proj_out`` from diffusers' (c, ph, pw) packing to the
    port's (ph, pw, c): the JAX importer does not (ROADMAP Queue 3)."""
    w = weights
    approx: Dict[str, Any] = {
        "in_proj": _linear(w, "distilled_guidance_layer.in_proj"),
        "out_proj": _linear(w, "distilled_guidance_layer.out_proj"),
    }
    for i in range(arch.approximator_layers):
        approx[f"layer_{i}_1"] = _linear(w, f"distilled_guidance_layer.layers.{i}.linear_1")
        approx[f"layer_{i}_2"] = _linear(w, f"distilled_guidance_layer.layers.{i}.linear_2")
        approx[f"norm_{i}"] = _scale(w, f"distilled_guidance_layer.norms.{i}.weight")
    params: Dict[str, Any] = {"img_in": _linear(w, "x_embedder"), "txt_in": _linear(w, "context_embedder"),
                              "final_proj": _linear(w, "proj_out"), "approximator": approx}
    for i in range(arch.depth_double):
        p = f"transformer_blocks.{i}"
        params[f"double_{i}"] = {
            "img_attn_q": _linear(w, f"{p}.attn.to_q"),
            "img_attn_k": _linear(w, f"{p}.attn.to_k"),
            "img_attn_v": _linear(w, f"{p}.attn.to_v"),
            "txt_attn_q": _linear(w, f"{p}.attn.add_q_proj"),
            "txt_attn_k": _linear(w, f"{p}.attn.add_k_proj"),
            "txt_attn_v": _linear(w, f"{p}.attn.add_v_proj"),
            "img_attn_norm_q": _scale(w, f"{p}.attn.norm_q.weight"),
            "img_attn_norm_k": _scale(w, f"{p}.attn.norm_k.weight"),
            "txt_attn_norm_q": _scale(w, f"{p}.attn.norm_added_q.weight"),
            "txt_attn_norm_k": _scale(w, f"{p}.attn.norm_added_k.weight"),
            "img_attn_proj": _linear(w, f"{p}.attn.to_out.0"),
            "txt_attn_proj": _linear(w, f"{p}.attn.to_add_out"),
            "img_mlp": {"proj_in": _linear(w, f"{p}.ff.net.0.proj"), "proj_out": _linear(w, f"{p}.ff.net.2")},
            "txt_mlp": {"proj_in": _linear(w, f"{p}.ff_context.net.0.proj"),
                        "proj_out": _linear(w, f"{p}.ff_context.net.2")},
        }
    for i in range(arch.depth_single):
        p = f"single_transformer_blocks.{i}"
        parts = [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v", f"{p}.proj_mlp"]
        params[f"single_{i}"] = {
            "linear1": {"kernel": torch.cat([_float(w[f"{part}.weight"]) for part in parts]).t(),
                        "bias": torch.cat([_float(w[f"{part}.bias"]) for part in parts])},
            "linear2": _linear(w, f"{p}.proj_out"),
            "norm_q": _scale(w, f"{p}.attn.norm_q.weight"),
            "norm_k": _scale(w, f"{p}.attn.norm_k.weight"),
        }
    return params


def load_chroma_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers Chroma transformer
    (a model dir with a ``transformer/`` subfolder, or one file)."""
    params = chroma_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported chroma weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Lumina2 (diffusers Lumina2Transformer2DModel: Next-DiT with context / noise
# refiners and GQA blocks)
# ---------------------------------------------------------------------------------


def _lumina2_block(w: Mapping[str, torch.Tensor], src: str, modulated: bool) -> Dict[str, Any]:
    block: Dict[str, Any] = {
        "attn_q": _linear(w, f"{src}.attn.to_q"),
        "attn_k": _linear(w, f"{src}.attn.to_k"),
        "attn_v": _linear(w, f"{src}.attn.to_v"),
        "norm_q": _scale(w, f"{src}.attn.norm_q.weight"),
        "norm_k": _scale(w, f"{src}.attn.norm_k.weight"),
        "attn_proj": _linear(w, f"{src}.attn.to_out.0"),
        "feed_forward": {name: _linear(w, f"{src}.feed_forward.{name}")
                         for name in ("linear_1", "linear_2", "linear_3")},
        "norm2": _scale(w, f"{src}.norm2.weight"),
        "ffn_norm1": _scale(w, f"{src}.ffn_norm1.weight"),
        "ffn_norm2": _scale(w, f"{src}.ffn_norm2.weight"),
    }
    if modulated:
        block["norm1_linear"] = _linear(w, f"{src}.norm1.linear")
        block["norm1_norm"] = _scale(w, f"{src}.norm1.norm.weight")
    else:
        block["norm1_norm"] = _scale(w, f"{src}.norm1.weight")
    return block


def lumina2_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers Lumina2 transformer of ``arch`` (``Lumina2Config``)."""
    w = weights
    params: Dict[str, Any] = {
        "patch_in": _linear(w, "x_embedder"),
        "time_in": {
            "in_layer": _linear(w, "time_caption_embed.timestep_embedder.linear_1"),
            "out_layer": _linear(w, "time_caption_embed.timestep_embedder.linear_2"),
        },
        "cap_norm": _scale(w, "time_caption_embed.caption_embedder.0.weight"),
        "cap_in": _linear(w, "time_caption_embed.caption_embedder.1"),
        "final_mod": _linear(w, "norm_out.linear_1"),
        "final_proj": _linear(w, "norm_out.linear_2"),
    }
    for i in range(arch.refiner_depth):
        params[f"context_refiner_{i}"] = _lumina2_block(w, f"context_refiner.{i}", modulated=False)
        params[f"noise_refiner_{i}"] = _lumina2_block(w, f"noise_refiner.{i}", modulated=True)
    for i in range(arch.depth):
        params[f"layer_{i}"] = _lumina2_block(w, f"layers.{i}", modulated=True)
    return params


def load_lumina2_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers Lumina2 transformer
    (a model dir with a ``transformer/`` subfolder, or one file)."""
    params = lumina2_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported lumina2 weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Kandinsky 5.0 (Kandinsky5Transformer3DModel: time / text / pooled / visual
# embeddings, text and visual transformer blocks, the modulated out layer)
# ---------------------------------------------------------------------------------


def _k5_attention(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {"to_query": _linear(w, f"{src}.to_query"), "to_key": _linear(w, f"{src}.to_key"),
            "to_value": _linear(w, f"{src}.to_value"), "out_layer": _linear(w, f"{src}.out_layer"),
            "query_norm": _float(w[f"{src}.query_norm.weight"]), "key_norm": _float(w[f"{src}.key_norm.weight"])}


def _k5_ff(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {"in_layer": _linear(w, f"{src}.in_layer"), "out_layer": _linear(w, f"{src}.out_layer")}


def kandinsky5_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a Kandinsky 5.0 transformer of ``arch``
    (``Kandinsky5Config``): the affine text and pooled norms as flax
    ``LayerNorm`` scale / bias, the per-head q / k norm scales as the
    attention's own parameters."""
    w = weights
    params: Dict[str, Any] = {
        "time_in": _linear(w, "time_embeddings.in_layer"),
        "time_out": _linear(w, "time_embeddings.out_layer"),
        "text_in": _linear(w, "text_embeddings.in_layer"),
        "text_norm": _norm(w, "text_embeddings.norm"),
        "pooled_in": _linear(w, "pooled_text_embeddings.in_layer"),
        "pooled_norm": _norm(w, "pooled_text_embeddings.norm"),
        "visual_in": _linear(w, "visual_embeddings.in_layer"),
        "out_modulation": {"out_layer": _linear(w, "out_layer.modulation.out_layer")},
        "out_proj": _linear(w, "out_layer.out_layer"),
    }
    for i in range(arch.num_text_blocks):
        src = f"text_transformer_blocks.{i}"
        params[f"text_block_{i}"] = {
            "text_modulation": {"out_layer": _linear(w, f"{src}.text_modulation.out_layer")},
            "self_attention": _k5_attention(w, f"{src}.self_attention"),
            "feed_forward": _k5_ff(w, f"{src}.feed_forward"),
        }
    for i in range(arch.num_visual_blocks):
        src = f"visual_transformer_blocks.{i}"
        params[f"visual_block_{i}"] = {
            "visual_modulation": {"out_layer": _linear(w, f"{src}.visual_modulation.out_layer")},
            "self_attention": _k5_attention(w, f"{src}.self_attention"),
            "cross_attention": _k5_attention(w, f"{src}.cross_attention"),
            "feed_forward": _k5_ff(w, f"{src}.feed_forward"),
        }
    return params


def load_kandinsky5_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a Kandinsky 5.0 transformer (a
    model dir with a ``transformer/`` subfolder, or one file)."""
    params = kandinsky5_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported kandinsky5 weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# HunyuanVideo 1.5 (HunyuanVideo15Transformer3DModel: the token refiner, the
# ByT5 and image projections, the dual-stream blocks)
# ---------------------------------------------------------------------------------


def hunyuanvideo_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers HunyuanVideo 1.5 transformer of
    ``arch`` (``HunyuanVideo15Config``): the Conv3d patch embed (dim, C, pt,
    ph, pw) as a dense ((pt, ph, pw, C), dim) kernel, the affine LayerNorms
    one level down (the JAX ``LayerNorm`` wrapper's ``LayerNorm_0``)."""
    w = weights
    dim = arch.hidden_size
    conv = _float(w["x_embedder.proj.weight"])  # (dim, C, pt, ph, pw)
    params: Dict[str, Any] = {
        "patch_in": {"kernel": conv.permute(2, 3, 4, 1, 0).reshape(-1, dim), "bias": _float(w["x_embedder.proj.bias"])},
        "time_in": {"in_layer": _linear(w, "time_embed.timestep_embedder.linear_1"),
                    "out_layer": _linear(w, "time_embed.timestep_embedder.linear_2")},
        "cond_type_embed": _float(w["cond_type_embed.weight"]),
        "byt5_norm": {"LayerNorm_0": _norm(w, "context_embedder_2.norm")},
        "byt5_in_1": _linear(w, "context_embedder_2.linear_1"),
        "byt5_in_2": _linear(w, "context_embedder_2.linear_2"),
        "byt5_in_3": _linear(w, "context_embedder_2.linear_3"),
        "img_embed_norm_in": {"LayerNorm_0": _norm(w, "image_embedder.norm_in")},
        "img_embed_in_1": _linear(w, "image_embedder.linear_1"),
        "img_embed_in_2": _linear(w, "image_embedder.linear_2"),
        "img_embed_norm_out": {"LayerNorm_0": _norm(w, "image_embedder.norm_out")},
        "final_mod": _linear(w, "norm_out.linear"),
        "final_proj": _linear(w, "proj_out"),
    }
    prefix = "context_embedder.time_text_embed"
    refiner: Dict[str, Any] = {
        "time_in": {"in_layer": _linear(w, f"{prefix}.timestep_embedder.linear_1"),
                    "out_layer": _linear(w, f"{prefix}.timestep_embedder.linear_2")},
        "text_in": {"in_layer": _linear(w, f"{prefix}.text_embedder.linear_1"),
                    "out_layer": _linear(w, f"{prefix}.text_embedder.linear_2")},
        "proj_in": _linear(w, "context_embedder.proj_in"),
    }
    table = (("attn_q", "attn.to_q"), ("attn_k", "attn.to_k"), ("attn_v", "attn.to_v"),
             ("attn_proj", "attn.to_out.0"), ("ff_in", "ff.net.0.proj"), ("ff_out", "ff.net.2"),
             ("adanorm_lin", "norm_out.linear"))
    for i in range(arch.refiner_depth):
        src = f"context_embedder.token_refiner.refiner_blocks.{i}"
        block: Dict[str, Any] = {"norm1": {"LayerNorm_0": _norm(w, f"{src}.norm1")},
                                 "norm2": {"LayerNorm_0": _norm(w, f"{src}.norm2")}}
        for ours, theirs in table:
            block[ours] = _linear(w, f"{src}.{theirs}")
        refiner[f"block_{i}"] = block
    params["refiner"] = refiner
    table = (("norm1_lin", "norm1.linear"), ("norm1_context_lin", "norm1_context.linear"),
             ("img_attn_q", "attn.to_q"), ("img_attn_k", "attn.to_k"), ("img_attn_v", "attn.to_v"),
             ("txt_attn_q", "attn.add_q_proj"), ("txt_attn_k", "attn.add_k_proj"), ("txt_attn_v", "attn.add_v_proj"),
             ("img_attn_proj", "attn.to_out.0"), ("txt_attn_proj", "attn.to_add_out"),
             ("img_mlp_in", "ff.net.0.proj"), ("img_mlp_out", "ff.net.2"),
             ("txt_mlp_in", "ff_context.net.0.proj"), ("txt_mlp_out", "ff_context.net.2"))
    norms = (("img_attn_norm_q", "attn.norm_q"), ("img_attn_norm_k", "attn.norm_k"),
             ("txt_attn_norm_q", "attn.norm_added_q"), ("txt_attn_norm_k", "attn.norm_added_k"))
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        block = {ours: _linear(w, f"{src}.{theirs}") for ours, theirs in table}
        block.update({ours: _scale(w, f"{src}.{theirs}.weight") for ours, theirs in norms})
        params[f"block_{i}"] = block
    return params


def load_hunyuanvideo_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers HunyuanVideo 1.5
    transformer (a model dir with a ``transformer/`` subfolder, or one file)."""
    params = hunyuanvideo_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported hunyuanvideo weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Qwen-Image (QwenImageTransformer2DModel; MageFlow and Z-Image share the layout)
# ---------------------------------------------------------------------------------


def qwen_image_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers Qwen-Image transformer of ``arch``
    (``QwenImageConfig``); ``norm_out`` emits (scale, shift) as the port's
    head does, so nothing is swapped."""
    w = weights
    params: Dict[str, Any] = {
        "img_in": _linear(w, "img_in"),
        "txt_in": _linear(w, "txt_in"),
        "txt_norm": _scale(w, "txt_norm.weight"),
        "time_in": {"in_layer": _linear(w, "time_text_embed.timestep_embedder.linear_1"),
                    "out_layer": _linear(w, "time_text_embed.timestep_embedder.linear_2")},
        "final_mod": _linear(w, "norm_out.linear"),
        "final_proj": _linear(w, "proj_out"),
    }
    table = (("img_mod", "img_mod.1"), ("txt_mod", "txt_mod.1"),
             ("img_attn_q", "attn.to_q"), ("img_attn_k", "attn.to_k"), ("img_attn_v", "attn.to_v"),
             ("txt_attn_q", "attn.add_q_proj"), ("txt_attn_k", "attn.add_k_proj"), ("txt_attn_v", "attn.add_v_proj"),
             ("img_attn_proj", "attn.to_out.0"), ("txt_attn_proj", "attn.to_add_out"),
             ("img_mlp_in", "img_mlp.net.0.proj"), ("img_mlp_out", "img_mlp.net.2"),
             ("txt_mlp_in", "txt_mlp.net.0.proj"), ("txt_mlp_out", "txt_mlp.net.2"))
    norms = (("img_attn_norm_q", "attn.norm_q"), ("img_attn_norm_k", "attn.norm_k"),
             ("txt_attn_norm_q", "attn.norm_added_q"), ("txt_attn_norm_k", "attn.norm_added_k"))
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        block = {ours: _linear(w, f"{src}.{theirs}") for ours, theirs in table}
        block.update({ours: _scale(w, f"{src}.{theirs}.weight") for ours, theirs in norms})
        params[f"block_{i}"] = block
    return params


def load_qwen_image_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers Qwen-Image (MageFlow,
    Z-Image) transformer (a model dir with a ``transformer/`` subfolder, or one file)."""
    params = qwen_image_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported %s weights from %s", model.NAME, path)
    return params


# ---------------------------------------------------------------------------------
# HiDream-I1 (HiDreamImageTransformer2DModel: double / single stream blocks, MoE)
# ---------------------------------------------------------------------------------


def _hidream_ffn(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {name: _linear(w, f"{src}.{name}") for name in ("w1", "w2", "w3")}


def _hidream_moe(w: Mapping[str, torch.Tensor], src: str, num_experts: int) -> Dict[str, Any]:
    """The gate (E, dim) and the per-expert torch (out, in) weights stacked into (E, in, out)."""
    stack = lambda name: torch.stack([_float(w[f"{src}.experts.{e}.{name}.weight"]).t()  # noqa: E731
                                      for e in range(num_experts)])
    return {"gate": _float(w[f"{src}.gate.weight"]), "experts_w1": stack("w1"), "experts_w2": stack("w2"),
            "experts_w3": stack("w3"), "shared_experts": _hidream_ffn(w, f"{src}.shared_experts")}


def _hidream_attn(w: Mapping[str, torch.Tensor], src: str, text_branch: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for suffix in ("", "_t") if text_branch else ("",):
        out.update({f"attn_{n}{suffix}": _linear(w, f"{src}.to_{n}{suffix}") for n in ("q", "k", "v")})
        out[f"attn_proj{suffix}"] = _linear(w, f"{src}.to_out{suffix}")
        out[f"q_rms{suffix}"] = _float(w[f"{src}.q_rms_norm{suffix}.weight"])
        out[f"k_rms{suffix}"] = _float(w[f"{src}.k_rms_norm{suffix}.weight"])
    return out


def hidream_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers HiDream-I1 transformer of ``arch``
    (``HiDreamConfig``): the T5 caption projection is the last of the
    ``caption_projection`` list, after one per block."""
    w = weights
    n_blocks = arch.depth_double + arch.depth_single
    params: Dict[str, Any] = {
        "patch_in": _linear(w, "x_embedder.proj"),
        "time_in": {"in_layer": _linear(w, "t_embedder.timestep_embedder.linear_1"),
                    "out_layer": _linear(w, "t_embedder.timestep_embedder.linear_2")},
        "pooled_in": {"in_layer": _linear(w, "p_embedder.pooled_embedder.linear_1"),
                      "out_layer": _linear(w, "p_embedder.pooled_embedder.linear_2")},
        "caption_proj_t5": _linear(w, f"caption_projection.{n_blocks}.linear"),
        "final_mod": _linear(w, "final_layer.adaLN_modulation.1"),
        "final_proj": _linear(w, "final_layer.linear"),
    }
    for i in range(n_blocks):
        params[f"caption_proj_{i}"] = _linear(w, f"caption_projection.{i}.linear")
    for i in range(arch.depth_double):
        src = f"double_stream_blocks.{i}.block"
        params[f"double_{i}"] = {"ada": _linear(w, f"{src}.adaLN_modulation.1"),
                                 **_hidream_attn(w, f"{src}.attn1", text_branch=True),
                                 "ff_i": _hidream_moe(w, f"{src}.ff_i", arch.num_experts),
                                 "ff_t": _hidream_ffn(w, f"{src}.ff_t")}
    for i in range(arch.depth_single):
        src = f"single_stream_blocks.{i}.block"
        params[f"single_{i}"] = {"ada": _linear(w, f"{src}.adaLN_modulation.1"),
                                 **_hidream_attn(w, f"{src}.attn1", text_branch=False),
                                 "ff_i": _hidream_moe(w, f"{src}.ff_i", arch.num_experts)}
    return params


def load_hidream_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers HiDream-I1 transformer
    (a model dir with a ``transformer/`` subfolder, or one file)."""
    params = hidream_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported hidream weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# FLUX.2 (Flux2Transformer2DModel: global modulation, fused single blocks, no biases)
# ---------------------------------------------------------------------------------


def flux2_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers FLUX.2 transformer of ``arch``
    (``Flux2Config``); ``norm_out`` emits (scale, shift) as the port's head
    does, so nothing is swapped."""
    w = weights
    params: Dict[str, Any] = {
        "patch_in": _linear(w, "x_embedder"),
        "txt_in": _linear(w, "context_embedder"),
        "time_in_1": _linear(w, "time_guidance_embed.timestep_embedder.linear_1"),
        "time_in_2": _linear(w, "time_guidance_embed.timestep_embedder.linear_2"),
        "mod_double_img": _linear(w, "double_stream_modulation_img.linear"),
        "mod_double_txt": _linear(w, "double_stream_modulation_txt.linear"),
        "mod_single": _linear(w, "single_stream_modulation.linear"),
        "final_mod": _linear(w, "norm_out.linear"),
        "final_proj": _linear(w, "proj_out"),
    }
    if arch.guidance_embed:
        params["guidance_in_1"] = _linear(w, "time_guidance_embed.guidance_embedder.linear_1")
        params["guidance_in_2"] = _linear(w, "time_guidance_embed.guidance_embedder.linear_2")
    double = (("attn_q", "attn.to_q"), ("attn_k", "attn.to_k"), ("attn_v", "attn.to_v"),
              ("attn_add_q", "attn.add_q_proj"), ("attn_add_k", "attn.add_k_proj"), ("attn_add_v", "attn.add_v_proj"),
              ("attn_proj", "attn.to_out.0"), ("attn_add_proj", "attn.to_add_out"),
              ("ff_in", "ff.linear_in"), ("ff_out", "ff.linear_out"),
              ("ff_context_in", "ff_context.linear_in"), ("ff_context_out", "ff_context.linear_out"))
    norms = ("norm_q", "norm_k", "norm_added_q", "norm_added_k")
    for i in range(arch.depth_double):
        src = f"transformer_blocks.{i}"
        block = {ours: _linear(w, f"{src}.{theirs}") for ours, theirs in double}
        block.update({name: _scale(w, f"{src}.attn.{name}.weight") for name in norms})
        params[f"double_{i}"] = block
    for i in range(arch.depth_single):
        src = f"single_transformer_blocks.{i}"
        params[f"single_{i}"] = {"qkv_mlp": _linear(w, f"{src}.attn.to_qkv_mlp_proj"),
                                 "norm_q": _scale(w, f"{src}.attn.norm_q.weight"),
                                 "norm_k": _scale(w, f"{src}.attn.norm_k.weight"),
                                 "proj_out": _linear(w, f"{src}.attn.to_out")}
    return params


def load_flux2_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers FLUX.2 transformer (a
    model dir with a ``transformer/`` subfolder, or one file)."""
    params = flux2_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported flux2 weights from %s", path)
    return params


def longcat_image_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a LongCat-Image transformer of ``arch``: the
    diffusers Flux layout with a bare ``time_embed.timestep_embedder`` (no
    pooled-text or guidance embedder), read as Flux's after the rename."""
    renamed = {("time_text_embed." + key[len("time_embed."):] if key.startswith("time_embed.") else key): value
               for key, value in weights.items()}
    return flux_params_from_diffusers(renamed, arch.depth_double, arch.depth_single)


def load_longcat_image_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a LongCat-Image transformer (a model
    dir with a ``transformer/`` subfolder, or one file)."""
    params = longcat_image_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported longcat_image weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Z-Image-Omni (ZImageOmniTransformer2DModel: the refiner stacks, the layers and
# per-patch embedders keyed "patch-fpatch")
# ---------------------------------------------------------------------------------


def _z_omni_block(w: Mapping[str, torch.Tensor], src: str, modulated: bool) -> Dict[str, Any]:
    block: Dict[str, Any] = {
        "attn_q": _linear(w, f"{src}.attention.to_q"),
        "attn_k": _linear(w, f"{src}.attention.to_k"),
        "attn_v": _linear(w, f"{src}.attention.to_v"),
        "attn_proj": _linear(w, f"{src}.attention.to_out.0"),
        "norm_q": _scale(w, f"{src}.attention.norm_q.weight"),
        "norm_k": _scale(w, f"{src}.attention.norm_k.weight"),
        "feed_forward": {name: _linear(w, f"{src}.feed_forward.{name}") for name in ("w1", "w2", "w3")},
        "attention_norm1": _scale(w, f"{src}.attention_norm1.weight"),
        "attention_norm2": _scale(w, f"{src}.attention_norm2.weight"),
        "ffn_norm1": _scale(w, f"{src}.ffn_norm1.weight"),
        "ffn_norm2": _scale(w, f"{src}.ffn_norm2.weight"),
    }
    if modulated:
        block["adaLN_modulation"] = _linear(w, f"{src}.adaLN_modulation.0")
    return block


def z_image_omni_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a Z-Image-Omni transformer of ``arch``
    (``ZImageOmniConfig``); the image embedder and final layer are the
    ``"{patch}-1"`` entries, and the SigLIP modules are read where the file
    has them."""
    w = weights
    patch_key = f"{arch.patch_size}-1"
    params: Dict[str, Any] = {
        "t_in": _linear(w, "t_embedder.mlp.0"),
        "t_out": _linear(w, "t_embedder.mlp.2"),
        "x_embedder": _linear(w, f"all_x_embedder.{patch_key}"),
        "cap_norm": _scale(w, "cap_embedder.0.weight"),
        "cap_embedder": _linear(w, "cap_embedder.1"),
        "cap_pad_token": _float(w["cap_pad_token"]),
        "final_adaLN": _linear(w, f"all_final_layer.{patch_key}.adaLN_modulation.1"),
        "final_linear": _linear(w, f"all_final_layer.{patch_key}.linear"),
    }
    if "siglip_embedder.1.weight" in w:
        params["siglip_norm"] = _scale(w, "siglip_embedder.0.weight")
        params["siglip_embedder"] = _linear(w, "siglip_embedder.1")
    for i in range(arch.refiner_depth):
        params[f"noise_refiner_{i}"] = _z_omni_block(w, f"noise_refiner.{i}", modulated=True)
        params[f"context_refiner_{i}"] = _z_omni_block(w, f"context_refiner.{i}", modulated=False)
        if f"siglip_refiner.{i}.attention.to_q.weight" in w:
            params[f"siglip_refiner_{i}"] = _z_omni_block(w, f"siglip_refiner.{i}", modulated=False)
    for i in range(arch.depth):
        params[f"layer_{i}"] = _z_omni_block(w, f"layers.{i}", modulated=True)
    return params


def load_z_image_omni_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a Z-Image-Omni transformer (a model
    dir with a ``transformer/`` subfolder, or one file)."""
    params = z_image_omni_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported z_image_omni weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Zlab-i1 (ZlabI1Transformer2DModel: in / mid / out blocks with skip linears; the
# frozen t_embedder and the rope tables are unused and skipped)
# ---------------------------------------------------------------------------------


def _zlab_swiglu(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {"w12": _linear(w, f"{src}.w12"), "w3": _linear(w, f"{src}.w3")}


def _zlab_block(w: Mapping[str, torch.Tensor], src: str, use_skip: bool) -> Dict[str, Any]:
    block: Dict[str, Any] = {name: _scale(w, f"{src}.{name}.scale") for name in ("norm1", "norm2", "norm3", "norm4")}
    block.update({name: _linear(w, f"{src}.attn.{name}")
                  for name in ("qkv_image", "qkv_text", "proj_image", "proj_text")})
    block["q_norm"] = _scale(w, f"{src}.attn.q_norm.scale")
    block["k_norm"] = _scale(w, f"{src}.attn.k_norm.scale")
    block["mlp_image"] = _zlab_swiglu(w, f"{src}.mlp_image")
    block["mlp_text"] = _zlab_swiglu(w, f"{src}.mlp_text")
    if use_skip:
        block["skip_image"] = _linear(w, f"{src}.skip_linear_image")
        block["skip_text"] = _linear(w, f"{src}.skip_linear_text")
    return block


def _zlab_connector_attn(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {"qkv": _linear(w, f"{src}.qkv"), "q_norm": _scale(w, f"{src}.q_norm.scale"),
            "k_norm": _scale(w, f"{src}.k_norm.scale"), "proj": _linear(w, f"{src}.proj")}


def zlab_i1_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a Zlab-i1 transformer of ``arch``
    (``ZlabI1Config``): the patch conv (D, C, p, p) as a dense kernel over
    (c, ph, pw)-ordered features."""
    w = weights
    adapter = "text_encoder_adapter"
    params: Dict[str, Any] = {
        "x_embedder": {"kernel": _float(w["x_embedder.proj.weight"]).reshape(arch.hidden_size, -1).t(),
                       "bias": _float(w["x_embedder.proj.bias"])},
        "pos_embed": _float(w["pos_embed"]),
        "text_adapter": {
            "null_caption": _float(w[f"{adapter}.learnable_null_caption"]),
            "connector_in": _linear(w, f"{adapter}.connector_in"),
            **{f"connector_norm{i}": _scale(w, f"{adapter}.connector_norm{i}.scale") for i in range(1, 5)},
            "connector_attn": _zlab_connector_attn(w, f"{adapter}.connector_attn"),
            "connector_attn2": _zlab_connector_attn(w, f"{adapter}.connector_attn2"),
            "connector_mlp": _zlab_swiglu(w, f"{adapter}.connector_mlp"),
            "connector_mlp2": _zlab_swiglu(w, f"{adapter}.connector_mlp2"),
        },
        "mid": _zlab_block(w, "mid_block", use_skip=False),
        "final_norm": _scale(w, "final_layer.norm_final.scale"),
        "final_linear": _linear(w, "final_layer.linear"),
    }
    for i in range(arch.num_in_blocks):
        params[f"in_{i}"] = _zlab_block(w, f"in_blocks.{i}", use_skip=False)
        params[f"out_{i}"] = _zlab_block(w, f"out_blocks.{i}", use_skip=True)
    return params


def load_zlab_i1_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a Zlab-i1 transformer (a model dir
    with a ``transformer/`` subfolder, or one file)."""
    params = zlab_i1_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported zlab_i1 weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Krea-2 (Krea2Transformer2DModel)
# ---------------------------------------------------------------------------------


def _krea2_attn(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    node = {name: _linear(w, f"{src}.{name}") for name in ("to_q", "to_k", "to_v", "to_gate")}
    node["to_out"] = _linear(w, f"{src}.to_out.0")
    node["norm_q"] = _float(w[f"{src}.norm_q.weight"])
    node["norm_k"] = _float(w[f"{src}.norm_k.weight"])
    return node


def _krea2_ff(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {name: _linear(w, f"{src}.{name}") for name in ("gate", "up", "down")}


def _krea2_block(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {"norm1": _float(w[f"{src}.norm1.weight"]), "norm2": _float(w[f"{src}.norm2.weight"]),
            "attn": _krea2_attn(w, f"{src}.attn"), "ff": _krea2_ff(w, f"{src}.ff")}


def krea2_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a Krea-2 transformer of ``arch`` (``Krea2Config``):
    the projector (1, L) as an (L, 1) table, and ``img_in`` / ``final_linear``
    reordered from the reference's (c, ph, pw) packing to the port's (ph, pw, c)."""
    w = weights
    params: Dict[str, Any] = {
        "img_in": _linear(w, "img_in"),
        "time_in_1": _linear(w, "time_embed.linear_1"),
        "time_in_2": _linear(w, "time_embed.linear_2"),
        "time_mod_proj": _linear(w, "time_mod_proj"),
        "text_projector": _float(w["text_fusion.projector.weight"]).t(),
        "txt_norm": _float(w["txt_in.norm.weight"]),
        "txt_in_1": _linear(w, "txt_in.linear_1"),
        "txt_in_2": _linear(w, "txt_in.linear_2"),
        "final_scale_shift_table": _float(w["final_layer.scale_shift_table"]),
        "final_norm": _float(w["final_layer.norm.weight"]),
        "final_linear": _linear(w, "final_layer.linear"),
    }
    for i in range(arch.num_layerwise_text_blocks):
        params[f"text_layerwise_{i}"] = _krea2_block(w, f"text_fusion.layerwise_blocks.{i}")
    for i in range(arch.num_refiner_text_blocks):
        params[f"text_refiner_{i}"] = _krea2_block(w, f"text_fusion.refiner_blocks.{i}")
    for i in range(arch.num_layers):
        src = f"transformer_blocks.{i}"
        params[f"block_{i}"] = {"scale_shift_table": _float(w[f"{src}.scale_shift_table"]), **_krea2_block(w, src)}
    img_in, final = params["img_in"], params["final_linear"]
    img_in["kernel"] = img_in["kernel"][_flux_pack_permutation(img_in["kernel"].shape[0])]
    out_perm = _flux_pack_permutation(final["kernel"].shape[1])
    final["kernel"] = final["kernel"][:, out_perm]
    if "bias" in final:
        final["bias"] = final["bias"][out_perm]
    return params


def load_krea2_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a Krea-2 transformer (a model dir
    with a ``transformer/`` subfolder, or one file)."""
    params = krea2_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported krea2 weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# the Cosmos core (CosmosTransformer3DModel) and Anima (its adapter + core)
# ---------------------------------------------------------------------------------


def cosmos1_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch, prefix: str = "") -> Dict[str, Any]:
    """The Flax-layout tree of a Cosmos core of ``arch`` (``Cosmos1Config``)
    under the names ``prefix`` starts (Anima's ``core.``)."""
    w, p = weights, prefix
    params: Dict[str, Any] = {
        "patch_embed": _linear(w, f"{p}patch_embed.proj"),
        "t_embedder_1": _linear(w, f"{p}time_embed.t_embedder.linear_1"),
        "t_embedder_2": _linear(w, f"{p}time_embed.t_embedder.linear_2"),
        "t_norm": _float(w[f"{p}time_embed.norm.weight"]),
        "norm_out_1": _linear(w, f"{p}norm_out.linear_1"),
        "norm_out_2": _linear(w, f"{p}norm_out.linear_2"),
        "proj_out": _linear(w, f"{p}proj_out"),
    }
    if arch.learnable_pos_embed:
        for axis in "thw":
            params[f"pos_emb_{axis}"] = _float(w[f"{p}learnable_pos_embed.pos_emb_{axis}"])
    for i in range(arch.num_layers):
        src = f"{p}transformer_blocks.{i}"
        node: Dict[str, Any] = {}
        for norm, attn in (("norm1", "attn1"), ("norm2", "attn2")):
            node[norm] = {"linear_1": _linear(w, f"{src}.{norm}.linear_1"),
                          "linear_2": _linear(w, f"{src}.{norm}.linear_2")}
            for proj in ("q", "k", "v"):
                node[f"{attn}_{proj}"] = _linear(w, f"{src}.{attn}.to_{proj}")
            node[f"{attn}_out"] = _linear(w, f"{src}.{attn}.to_out.0")
            node[f"{attn}_norm_q"] = _float(w[f"{src}.{attn}.norm_q.weight"])
            node[f"{attn}_norm_k"] = _float(w[f"{src}.{attn}.norm_k.weight"])
        node["norm3"] = {"linear_1": _linear(w, f"{src}.norm3.linear_1"),
                         "linear_2": _linear(w, f"{src}.norm3.linear_2")}
        node["ff_in"] = _linear(w, f"{src}.ff.net.0.proj")
        node["ff_out"] = _linear(w, f"{src}.ff.net.2")
        params[f"block_{i}"] = node
    return params


def load_cosmos2_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a Cosmos-Predict2 transformer (a
    model dir with a ``transformer/`` subfolder, or one file)."""
    params = cosmos1_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported cosmos weights from %s", path)
    return params


def anima_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of an Anima transformer of ``arch`` (``AnimaConfig``):
    ``llm_adapter`` and the ``core.``-prefixed Cosmos core."""
    w = weights
    adapter: Dict[str, Any] = {"embed": _float(w["llm_adapter.embed.weight"]),
                               "out_proj": _linear(w, "llm_adapter.out_proj"),
                               "norm": _float(w["llm_adapter.norm.weight"])}
    for i in range(arch.adapter_layers):
        src = f"llm_adapter.blocks.{i}"
        for ours, theirs in (("self", "norm_self_attn"), ("cross", "norm_cross_attn"), ("mlp", "norm_mlp")):
            adapter[f"block_{i}_norm_{ours}"] = _float(w[f"{src}.{theirs}.weight"])
        for ours, theirs in (("self", "self_attn"), ("cross", "cross_attn")):
            node = {name: _linear(w, f"{src}.{theirs}.{name}") for name in ("q_proj", "k_proj", "v_proj", "o_proj")}
            node["q_norm"] = _float(w[f"{src}.{theirs}.q_norm.weight"])
            node["k_norm"] = _float(w[f"{src}.{theirs}.k_norm.weight"])
            adapter[f"block_{i}_{ours}"] = node
        adapter[f"block_{i}_mlp_in"] = _linear(w, f"{src}.mlp.0")
        adapter[f"block_{i}_mlp_out"] = _linear(w, f"{src}.mlp.2")
    return {"llm_adapter": adapter, "core": cosmos1_params_from_checkpoint(w, arch.core, prefix="core.")}


def load_anima_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of an Anima transformer (a model dir
    with a ``transformer/`` subfolder, or one file)."""
    params = anima_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported anima weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# OmniGen (OmniGenTransformer2DModel), ERNIE-Image and Ideogram
# ---------------------------------------------------------------------------------


def omnigen_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of an OmniGen transformer of ``arch``
    (``OmniGenConfig``): the 2 x 2 patch conv as the Dense patchifier by
    (out, in, kh, kw) -> ((kh, kw, in), out); the sincos table is recomputed,
    not read; the input-image branch of the published file is not read."""
    w = weights
    conv = _float(w["patch_embedding.output_image_proj.weight"])  # (out, in, kh, kw)
    patch = {"kernel": conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0])}
    if "patch_embedding.output_image_proj.bias" in w:
        patch["bias"] = _float(w["patch_embedding.output_image_proj.bias"])
    rms = lambda key: {"weight": _float(w[f"{key}.weight"])}  # noqa: E731
    params: Dict[str, Any] = {
        "output_image_proj": patch,
        "embed_tokens": {"embedding": _float(w["embed_tokens.weight"])},
        "t_embedder": {"linear_1": _linear(w, "t_embedder.linear_1"), "linear_2": _linear(w, "t_embedder.linear_2")},
        "time_token": {"linear_1": _linear(w, "time_token.linear_1"), "linear_2": _linear(w, "time_token.linear_2")},
        "norm": rms("norm"),
        "norm_out_linear": _linear(w, "norm_out.linear"),
        "proj_out": _linear(w, "proj_out"),
    }
    for i in range(arch.num_layers):
        src = f"layers.{i}"
        params[f"layers_{i}"] = {
            "input_layernorm": rms(f"{src}.input_layernorm"),
            "post_attention_layernorm": rms(f"{src}.post_attention_layernorm"),
            "to_q": _linear(w, f"{src}.self_attn.to_q"),
            "to_k": _linear(w, f"{src}.self_attn.to_k"),
            "to_v": _linear(w, f"{src}.self_attn.to_v"),
            "to_out": _linear(w, f"{src}.self_attn.to_out.0"),
            "gate_up_proj": _linear(w, f"{src}.mlp.gate_up_proj"),
            "down_proj": _linear(w, f"{src}.mlp.down_proj"),
        }
    return params


def load_omnigen_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of an OmniGen transformer (a model dir
    with a ``transformer/`` subfolder, or one file; names read as written,
    no prefix stripped, as the JAX importer reads them)."""
    params = omnigen_params_from_diffusers(read_safetensors(path), model.arch)
    logger.info("imported omnigen weights from %s", path)
    return params


def ernie_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of an ERNIE-Image transformer of ``arch``
    (``ErnieConfig``): ``x_embedder`` a k = 1 conv read as a Dense (no
    permutation of its input features, as the JAX importer reads it);
    ``text_proj`` only where the file has it."""
    w = weights
    conv = _float(w["x_embedder.proj.weight"])[:, :, 0, 0]  # (H, C)
    params: Dict[str, Any] = {
        "x_embedder": {"kernel": conv.t(), "bias": _float(w["x_embedder.proj.bias"])},
        "time_in": _linear(w, "time_embedding.linear_1"),
        "time_out": _linear(w, "time_embedding.linear_2"),
        "adaLN_modulation": _linear(w, "adaLN_modulation.1"),
        "final_adaLN": _linear(w, "final_norm.linear"),
        "final_linear": _linear(w, "final_linear"),
    }
    if "text_proj.weight" in w:
        params["text_proj"] = _linear(w, "text_proj")
    for i in range(arch.num_layers):
        src = f"layers.{i}"
        params[f"layer_{i}"] = {
            "adaLN_sa_ln": _float(w[f"{src}.adaLN_sa_ln.weight"]),
            "adaLN_mlp_ln": _float(w[f"{src}.adaLN_mlp_ln.weight"]),
            "to_q": _linear(w, f"{src}.self_attention.to_q"),
            "to_k": _linear(w, f"{src}.self_attention.to_k"),
            "to_v": _linear(w, f"{src}.self_attention.to_v"),
            "to_out": _linear(w, f"{src}.self_attention.to_out.0"),
            "norm_q": _float(w[f"{src}.self_attention.norm_q.weight"]),
            "norm_k": _float(w[f"{src}.self_attention.norm_k.weight"]),
            "gate_proj": _linear(w, f"{src}.mlp.gate_proj"),
            "up_proj": _linear(w, f"{src}.mlp.up_proj"),
            "linear_fc2": _linear(w, f"{src}.mlp.linear_fc2"),
        }
    return params


def load_ernie_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of an ERNIE-Image transformer."""
    params = ernie_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported ernie weights from %s", path)
    return params


def ideogram_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of an Ideogram transformer of ``arch``
    (``IdeogramConfig``): every tensor 1:1, ``input_proj`` and
    ``final_linear`` unpermuted (the JAX importer does not reorder the
    reference's (c, ph, pw) packing, whatever its family docstring says:
    ROADMAP Queue 3), the fused ``qkv`` as it is."""
    w = weights
    params: Dict[str, Any] = {
        "input_proj": _linear(w, "input_proj"),
        "llm_cond_norm": _float(w["llm_cond_norm.weight"]),
        "llm_cond_proj": _linear(w, "llm_cond_proj"),
        "t_in": _linear(w, "t_embedding.mlp_in"),
        "t_out": _linear(w, "t_embedding.mlp_out"),
        "adaln_proj": _linear(w, "adaln_proj"),
        "embed_image_indicator": _float(w["embed_image_indicator.weight"]),
        "final_linear": _linear(w, "final_layer.linear"),
        "final_adaln": _linear(w, "final_layer.adaln_modulation"),
    }
    for i in range(arch.num_layers):
        src = f"layers.{i}"
        params[f"layer_{i}"] = {
            "qkv": _linear(w, f"{src}.attention.qkv"),
            "o": _linear(w, f"{src}.attention.o"),
            "norm_q": _float(w[f"{src}.attention.norm_q.weight"]),
            "norm_k": _float(w[f"{src}.attention.norm_k.weight"]),
            "w1": _linear(w, f"{src}.feed_forward.w1"),
            "w2": _linear(w, f"{src}.feed_forward.w2"),
            "w3": _linear(w, f"{src}.feed_forward.w3"),
            "attention_norm1": _float(w[f"{src}.attention_norm1.weight"]),
            "attention_norm2": _float(w[f"{src}.attention_norm2.weight"]),
            "ffn_norm1": _float(w[f"{src}.ffn_norm1.weight"]),
            "ffn_norm2": _float(w[f"{src}.ffn_norm2.weight"]),
            "adaln_modulation": _linear(w, f"{src}.adaln_modulation"),
        }
    return params


def load_ideogram_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of an Ideogram transformer."""
    params = ideogram_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported ideogram weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# LongCat-Video, Sana and Sana-Video (the Conv3d patch embeds kept as 5-D kernels)
# ---------------------------------------------------------------------------------


def _conv_generic(weights: Mapping[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    """A torch conv (O, I, *spatial) as a flax kernel (*spatial, I, O), any rank."""
    weight = _float(weights[f"{key}.weight"])
    out = {"kernel": weight.permute(*range(2, weight.dim()), 1, 0)}
    if f"{key}.bias" in weights:
        out["bias"] = _float(weights[f"{key}.bias"])
    return out


def longcat_video_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a LongCat-Video transformer of ``arch``
    (``LongCatVideoConfig``): the Conv3d ``x_embedder``, the time and caption
    MLPs, the final AdaLN and linear, and per block the AdaLN, fused ``qkv``,
    the cross-attention's ``q_linear`` / ``kv_linear``, the SwiGLU and the
    norm ``weight`` (and ``pre_crs_attn_norm`` bias) leaves."""
    w = weights
    params: Dict[str, Any] = {
        "x_embedder": _conv_generic(w, "x_embedder.proj"),
        "t_in": _linear(w, "t_embedder.mlp.0"),
        "t_out": _linear(w, "t_embedder.mlp.2"),
        "y_in_1": _linear(w, "y_embedder.y_proj.0"),
        "y_in_2": _linear(w, "y_embedder.y_proj.2"),
        "final_adaLN": _linear(w, "final_layer.adaLN_modulation.1"),
        "final_linear": _linear(w, "final_layer.linear"),
    }
    for i in range(arch.depth):
        src = f"blocks.{i}"
        params[f"block_{i}"] = {
            "adaLN": _linear(w, f"{src}.adaLN_modulation.1"),
            "qkv": _linear(w, f"{src}.attn.qkv"),
            "attn_proj": _linear(w, f"{src}.attn.proj"),
            "q_norm": _float(w[f"{src}.attn.q_norm.weight"]),
            "k_norm": _float(w[f"{src}.attn.k_norm.weight"]),
            "pre_crs_scale": _float(w[f"{src}.pre_crs_attn_norm.weight"]),
            "pre_crs_bias": _float(w[f"{src}.pre_crs_attn_norm.bias"]),
            "crs_q": _linear(w, f"{src}.cross_attn.q_linear"),
            "crs_kv": _linear(w, f"{src}.cross_attn.kv_linear"),
            "crs_proj": _linear(w, f"{src}.cross_attn.proj"),
            "crs_q_norm": _float(w[f"{src}.cross_attn.q_norm.weight"]),
            "crs_k_norm": _float(w[f"{src}.cross_attn.k_norm.weight"]),
            "ffn_w1": _linear(w, f"{src}.ffn.w1"),
            "ffn_w2": _linear(w, f"{src}.ffn.w2"),
            "ffn_w3": _linear(w, f"{src}.ffn.w3"),
        }
    return params


def load_longcat_video_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a LongCat-Video transformer."""
    params = longcat_video_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported longcat_video weights from %s", path)
    return params


_SANA_ATTENTION = (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj", "to_out.0"))


def sana_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers Sana transformer of ``arch``
    (``SanaConfig``): the patch conv (dim, C, p, p) as a dense ((p, p, C),
    dim) kernel, the (2, dim) and (6, dim) tables reshaped, the Mix-FFN's
    three convs as flax kernels."""
    w = weights
    dim = arch.hidden_size
    conv = _float(w["patch_embed.proj.weight"])  # (dim, C, p, p)
    params: Dict[str, Any] = {
        "patch_in": {"kernel": conv.permute(2, 3, 1, 0).reshape(-1, dim), "bias": _float(w["patch_embed.proj.bias"])},
        "caption_in_1": _linear(w, "caption_projection.linear_1"),
        "caption_in_2": _linear(w, "caption_projection.linear_2"),
        "caption_norm": _scale(w, "caption_norm.weight"),
        "time_in": {"in_layer": _linear(w, "time_embed.emb.timestep_embedder.linear_1"),
                    "out_layer": _linear(w, "time_embed.emb.timestep_embedder.linear_2")},
        "time_proj": _linear(w, "time_embed.linear"),
        "final_scale_shift_table": _float(w["scale_shift_table"]).reshape(2, dim),
        "final_proj": _linear(w, "proj_out"),
    }
    for i in range(arch.depth):
        src = f"transformer_blocks.{i}"
        block: Dict[str, Any] = {"scale_shift_table": _float(w[f"{src}.scale_shift_table"]).reshape(6, dim),
                                 "ff": {conv: _conv(w, f"{src}.ff.{conv}")
                                        for conv in ("conv_inverted", "conv_depth", "conv_point")}}
        for attn in ("attn1", "attn2"):
            block.update({f"{attn}_{ours}": _linear(w, f"{src}.{attn}.{theirs}") for ours, theirs in _SANA_ATTENTION})
        params[f"block_{i}"] = block
    return params


def load_sana_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers Sana transformer."""
    params = sana_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported sana weights from %s", path)
    return params


def sanavideo_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a Sana-Video transformer of ``arch``
    (``SanaVideoConfig``): the Conv3d ``patch_embedding``, the AdaLayerNormSingle
    MLP, the caption MLP and its norm ``weight``, the tables and ``proj_out``
    read 1:1 (its features in the reference's (pt, ph, pw, C) order, which
    the DiT's unpatchify splits), and per block the bias-free self-attention
    projections, the biased cross-attention ones, the across-heads norm
    ``weight`` leaves and the four GLUMBTempConv convs."""
    w = weights
    params: Dict[str, Any] = {
        "patch_embedding": _conv_generic(w, "patch_embedding"),
        "time_in": _linear(w, "time_embed.emb.timestep_embedder.linear_1"),
        "time_out": _linear(w, "time_embed.emb.timestep_embedder.linear_2"),
        "time_mod": _linear(w, "time_embed.linear"),
        "caption_in_1": _linear(w, "caption_projection.linear_1"),
        "caption_in_2": _linear(w, "caption_projection.linear_2"),
        "caption_norm": _float(w["caption_norm.weight"]),
        "scale_shift_table": _float(w["scale_shift_table"]),
        "proj_out": _linear(w, "proj_out"),
    }
    for i in range(arch.num_layers):
        src = f"transformer_blocks.{i}"
        block: Dict[str, Any] = {"scale_shift_table": _float(w[f"{src}.scale_shift_table"]),
                                 "ff": {conv: _conv_generic(w, f"{src}.ff.{conv}")
                                        for conv in ("conv_inverted", "conv_depth", "conv_point", "conv_temp")}}
        for attn in ("attn1", "attn2"):
            block.update({f"{attn}_{ours}": _linear(w, f"{src}.{attn}.{theirs}") for ours, theirs in _SANA_ATTENTION})
            block[f"{attn}_norm_q"] = _float(w[f"{src}.{attn}.norm_q.weight"])
            block[f"{attn}_norm_k"] = _float(w[f"{src}.{attn}.norm_k.weight"])
        params[f"block_{i}"] = block
    return params


def load_sanavideo_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a Sana-Video transformer."""
    params = sanavideo_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported sanavideo weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# Cosmos3 (the flat Cosmos3OmniTransformer layout: the understanding pathway on
# ``self_attn.to_*`` / ``mlp``, the generation pathway on ``add_*_proj`` /
# ``to_add_out`` / ``mlp_moe_gen``)
# ---------------------------------------------------------------------------------


_COSMOS3_ATTENTION = {"attn_und_q": "to_q", "attn_und_k": "to_k", "attn_und_v": "to_v", "attn_und_out": "to_out",
                      "attn_gen_q": "add_q_proj", "attn_gen_k": "add_k_proj", "attn_gen_v": "add_v_proj",
                      "attn_gen_out": "to_add_out"}


def cosmos3_params_from_checkpoint(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a Cosmos3 MoT of ``arch`` (``Cosmos3Config``)."""
    w = weights

    def mlp(src):
        return {p: _linear(w, f"{src}.{p}") for p in ("gate_proj", "up_proj", "down_proj")}

    params: Dict[str, Any] = {
        "embed_tokens": _float(w["embed_tokens.weight"]),
        "norm": _float(w["norm.weight"]),
        "norm_moe_gen": _float(w["norm_moe_gen.weight"]),
        "lm_head": _linear(w, "lm_head"),
        "proj_in": _linear(w, "proj_in"),
        "proj_out": _linear(w, "proj_out"),
        "time_in_1": _linear(w, "time_embedder.linear_1"),
        "time_in_2": _linear(w, "time_embedder.linear_2"),
    }
    for i in range(arch.num_layers):
        src = f"layers.{i}"
        layer = {ours: _linear(w, f"{src}.self_attn.{theirs}") for ours, theirs in _COSMOS3_ATTENTION.items()}
        for ours, theirs in (("norm_q", "self_attn.norm_q"), ("norm_k", "self_attn.norm_k"),
                             ("norm_added_q", "self_attn.norm_added_q"), ("norm_added_k", "self_attn.norm_added_k"),
                             ("input_layernorm", "input_layernorm"),
                             ("post_attention_layernorm", "post_attention_layernorm"),
                             ("input_layernorm_moe_gen", "input_layernorm_moe_gen"),
                             ("post_attention_layernorm_moe_gen", "post_attention_layernorm_moe_gen")):
            layer[ours] = _float(w[f"{src}.{theirs}.weight"])
        layer["mlp"] = mlp(f"{src}.mlp")
        layer["mlp_moe_gen"] = mlp(f"{src}.mlp_moe_gen")
        params[f"layer_{i}"] = layer
    return params


def load_cosmos3_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a Cosmos3 MoT."""
    params = cosmos3_params_from_checkpoint(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported cosmos3 weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# LTX-2 (the diffusers LTX2VideoTransformer3DModel layout: six attentions and two
# FFNs per dual-modal block)
# ---------------------------------------------------------------------------------


def _ltx2_adaln(w: Mapping[str, torch.Tensor], src: str) -> Dict[str, Any]:
    return {"in_layer": _linear(w, f"{src}.emb.timestep_embedder.linear_1"),
            "out_layer": _linear(w, f"{src}.emb.timestep_embedder.linear_2"), "mod": _linear(w, f"{src}.linear")}


def _ltx2_attn(w: Mapping[str, torch.Tensor], src: str, gated: bool) -> Dict[str, Any]:
    out = {name: _linear(w, f"{src}.{name}") for name in ("to_q", "to_k", "to_v")}
    out.update(norm_q=_float(w[f"{src}.norm_q.weight"]), norm_k=_float(w[f"{src}.norm_k.weight"]),
               to_out=_linear(w, f"{src}.to_out.0"))
    if gated:
        out["to_gate_logits"] = _linear(w, f"{src}.to_gate_logits")
    return out


_LTX2_ADALN = (("time_embed", "time_embed"), ("audio_time_embed", "audio_time_embed"),
               ("av_ca_video_scale_shift", "av_cross_attn_video_scale_shift"),
               ("av_ca_video_a2v_gate", "av_cross_attn_video_a2v_gate"),
               ("av_ca_audio_scale_shift", "av_cross_attn_audio_scale_shift"),
               ("av_ca_audio_v2a_gate", "av_cross_attn_audio_v2a_gate"))


def ltx2_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of a diffusers LTX-2 transformer of ``arch``
    (``LTX2Config``): both streams' projections, the caption MLPs, the six
    adaLN heads and the tables, and per block the four modulation tables,
    the six attentions and the two FFNs."""
    w = weights
    params: Dict[str, Any] = {ours: _linear(w, theirs) for ours, theirs in (
        ("proj_in", "proj_in"), ("audio_proj_in", "audio_proj_in"),
        ("caption_proj_1", "caption_projection.linear_1"), ("caption_proj_2", "caption_projection.linear_2"),
        ("audio_caption_proj_1", "audio_caption_projection.linear_1"),
        ("audio_caption_proj_2", "audio_caption_projection.linear_2"),
        ("proj_out", "proj_out"), ("audio_proj_out", "audio_proj_out"))}
    params.update({ours: _ltx2_adaln(w, theirs) for ours, theirs in _LTX2_ADALN})
    params["scale_shift_table"] = _float(w["scale_shift_table"])
    params["audio_scale_shift_table"] = _float(w["audio_scale_shift_table"])
    gates = {"attn1": arch.gated_attn, "audio_attn1": arch.audio_gated_attn, "attn2": arch.gated_attn,
             "audio_attn2": arch.audio_gated_attn, "audio_to_video_attn": arch.gated_attn,
             "video_to_audio_attn": arch.audio_gated_attn}
    for i in range(arch.num_layers):
        src = f"transformer_blocks.{i}"
        block: Dict[str, Any] = {
            "scale_shift_table": _float(w[f"{src}.scale_shift_table"]),
            "audio_scale_shift_table": _float(w[f"{src}.audio_scale_shift_table"]),
            "video_ca_scale_shift_table": _float(w[f"{src}.video_a2v_cross_attn_scale_shift_table"]),
            "audio_ca_scale_shift_table": _float(w[f"{src}.audio_a2v_cross_attn_scale_shift_table"]),
        }
        block.update({attn: _ltx2_attn(w, f"{src}.{attn}", gated) for attn, gated in gates.items()})
        for ff in ("ff", "audio_ff"):
            block[ff] = {"proj_in": _linear(w, f"{src}.{ff}.net.0.proj"), "proj_out": _linear(w, f"{src}.{ff}.net.2")}
        params[f"block_{i}"] = block
    return params


def load_ltx2_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of a diffusers LTX-2 transformer."""
    params = ltx2_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported ltxvideo2 weights from %s", path)
    return params


# ---------------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------------

# ---------------------------------------------------------------------------------
# ACE-Step
# ---------------------------------------------------------------------------------


def _ln(weights: Mapping[str, torch.Tensor], key: str) -> Dict[str, Any]:
    """An affine LayerNorm under the JAX ``LayerNorm`` wrapper's ``LayerNorm_0``."""
    return {"LayerNorm_0": _norm(weights, key)}


def acestep_params_from_diffusers(weights: Mapping[str, torch.Tensor], arch) -> Dict[str, Any]:
    """The Flax-layout tree of an ACE-Step transformer of ``arch``
    (``ACEStepConfig``): the patch embed's two convs and GroupNorm, the
    conformer lyric encoder (its embedding table, linear embed, rel-pos
    attention with ``pos_bias_u`` / ``pos_bias_v``, FFN and norms), the
    conditioning embedders, each block's tables, Lite-LA and cross-attention
    projections and GLUMBConv's three 1-D convs, the SSL projector heads (the
    reference's ``projectors.{h}.{0, 2, 4}``) and the final layer."""
    w = weights
    lyric: Dict[str, Any] = {"lyric_embs": _float(w["lyric_embs.weight"]),
                             "embed_out": _linear(w, "lyric_encoder.embed.out.0"),
                             "embed_norm": _ln(w, "lyric_encoder.embed.out.1"),
                             "after_norm": _ln(w, "lyric_encoder.after_norm")}
    for i in range(arch.lyric_depth):
        src = f"lyric_encoder.encoders.{i}"
        lyric[f"layer_{i}"] = {
            "norm_mha": _ln(w, f"{src}.norm_mha"),
            **{ours: _linear(w, f"{src}.self_attn.{theirs}") for ours, theirs in (
                ("attn_q", "linear_q"), ("attn_k", "linear_k"), ("attn_v", "linear_v"), ("attn_out", "linear_out"),
                ("linear_pos", "linear_pos"))},
            "pos_bias_u": _float(w[f"{src}.self_attn.pos_bias_u"]),
            "pos_bias_v": _float(w[f"{src}.self_attn.pos_bias_v"]),
            "norm_ff": _ln(w, f"{src}.norm_ff"),
            "ff_1": _linear(w, f"{src}.feed_forward.w_1"),
            "ff_2": _linear(w, f"{src}.feed_forward.w_2"),
        }
    params: Dict[str, Any] = {
        "patch_conv": _conv(w, "proj_in.early_conv_layers.0"),
        "patch_norm": _norm(w, "proj_in.early_conv_layers.1"),
        "patch_proj": _conv(w, "proj_in.early_conv_layers.2"),
        "time_in": {"in_layer": _linear(w, "timestep_embedder.linear_1"),
                    "out_layer": _linear(w, "timestep_embedder.linear_2")},
        "t_block": _linear(w, "t_block.1"),
        "speaker_embedder": _linear(w, "speaker_embedder"),
        "genre_embedder": _linear(w, "genre_embedder"),
        "lyric_encoder": lyric,
        "lyric_proj": _linear(w, "lyric_proj"),
        "final_proj": _linear(w, "final_layer.linear"),
        "final_scale_shift_table": _float(w["final_layer.scale_shift_table"]),
    }
    for i in range(arch.num_layers):
        src = f"transformer_blocks.{i}"
        params[f"block_{i}"] = {
            "scale_shift_table": _float(w[f"{src}.scale_shift_table"]),
            **{f"attn_{ours}": _linear(w, f"{src}.attn.{theirs}") for ours, theirs in _ACE_ATTENTION},
            **{f"cross_{ours}": _linear(w, f"{src}.cross_attn.{theirs}") for ours, theirs in _ACE_ATTENTION},
            "ff": {ours: _conv_generic(w, f"{src}.ff.{theirs}.conv") for ours, theirs in (
                ("inverted", "inverted_conv"), ("depth", "depth_conv"), ("point", "point_conv"))},
        }
    for head in range(len(arch.ssl_dims)):
        for j, torch_index in enumerate((0, 2, 4)):
            params[f"projector_{head}_{j}"] = _linear(w, f"projectors.{head}.{torch_index}")
    return params


_ACE_ATTENTION = (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj", "to_out.0"))


def load_acestep_params(model, path: str) -> Dict[str, Any]:
    """The Flax-layout ``params`` tree of an ACE-Step transformer (a file or a dir of shards)."""
    params = acestep_params_from_diffusers(_strip_prefix(read_safetensors(path)), model.arch)
    logger.info("imported ace_step weights from %s", path)
    return params


_IMPORTERS = {"flux": load_flux_params, "sd3": load_sd3_params, "sdxl": load_unet_params, "sd1x": load_unet_params,
              "sd2x": load_unet_params, "pixart_sigma": load_pixart_params, "auraflow": load_auraflow_params,
              "wan": load_wan_params, "ltxvideo": load_ltx_params, "chroma": load_chroma_params,
              "lumina2": load_lumina2_params, "kandinsky5_video": load_kandinsky5_params,
              "kandinsky5_image": load_kandinsky5_params, "hunyuanvideo": load_hunyuanvideo_params,
              # MageFlow and Z-Image use the Qwen-Image block layout verbatim
              "qwen_image": load_qwen_image_params, "mageflow": load_qwen_image_params,
              "z_image": load_qwen_image_params, "hidream": load_hidream_params, "flux2": load_flux2_params,
              # Kolors is the SDXL UNet layout with a 4,096-wide cross-attention
              "kolors": load_unet_params, "longcat_image": load_longcat_image_params,
              "z_image_omni": load_z_image_omni_params, "zlab_i1": load_zlab_i1_params,
              # Boogu-Image is the Lumina2 Next-DiT layout
              "boogu_image": load_lumina2_params, "krea2": load_krea2_params, "cosmos": load_cosmos2_params,
              "anima": load_anima_params, "omnigen": load_omnigen_params, "ernie": load_ernie_params,
              "ideogram": load_ideogram_params, "longcat_video": load_longcat_video_params,
              "sana": load_sana_params, "sanavideo": load_sanavideo_params, "cosmos3": load_cosmos3_params,
              "ltxvideo2": load_ltx2_params, "ace_step": load_acestep_params,
              # wan_s2v is the Wan DiT (its audio features join the context)
              "wan_s2v": load_wan_params}


def load_transformer_params(model, module: nn.Module, path: str) -> nn.Module:
    """Import ``path`` onto ``module`` (the family's transformer, on its
    device) in place and return it.  Every base tensor of the module must
    come from the checkpoint, with its shape; LoRA adapters keep their values
    (the trainer draws them fresh first, ``layers.init_adapters``, as the JAX
    import takes them from a fresh initialisation)."""
    importer = _IMPORTERS.get(model.NAME)
    if importer is None:
        raise NotImplementedError(
            f"no weight importer for family {model.NAME!r} in the port (only {', '.join(_IMPORTERS)}; the "
            "other families are ROADMAP Queue 1 item 6)"
        )
    return load_flax_params(module, importer(model, path), keep_adapters=True)
