"""Model family registry.

Counterpart of ``simpletuner_tpu/models/registry.py``: ``ModelRegistry``
(``families``, ``metadata``, ``get``, ``create``) over a copy of the JAX
registry's family table and aliases, and ``get_model_family``, which builds
the family a config names.  Every family of the JAX registry is listed with
its metadata; ``flux``, ``sd3``, ``sdxl``, ``sd1x``, ``sd2x``,
``pixart_sigma``, ``auraflow``, ``wan``, ``ltxvideo``, ``chroma``, ``lumina2``,
``kandinsky5_image``, ``kandinsky5_video``, ``hunyuanvideo``, ``qwen_image``,
``mageflow``, ``z_image``, ``hidream``, ``flux2``, ``kolors``,
``longcat_image``, ``z_image_omni``, ``zlab_i1``, ``boogu_image``, ``krea2``,
``cosmos``, ``anima``, ``omnigen``, ``ernie``, ``ideogram``,
``longcat_video``, ``sana``, ``sanavideo``, ``cosmos3``, ``ltxvideo2``, ``ace_step`` and
``wan_s2v`` are ported
(with the JAX aliases ``sd15``, ``sd21``, ``pixart`` and ``kandinsky5-image``),
so ``get`` of any other family raises naming ROADMAP Queue 1
item 6, and an unknown name raises ``KeyError`` as in the JAX registry.
``get_model_family`` also lays the config's ``model_arch_overrides`` (a
mapping, or its JSON, of fields of the family's ``arch``) over the arch the
family chose, e.g. ``{"depth_double": 2, "depth_single": 4}`` for a Flux
checkpoint cut to its first blocks; the JAX package has no such key.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Type

# the JAX registry's families with their metadata (models/registry.py:9-51), in its order
_FAMILIES: Dict[str, Dict[str, str]] = {
    "flux": {"modality": "image", "prediction": "flow_matching"},
    "sd1x": {"modality": "image", "prediction": "epsilon"},
    "sd2x": {"modality": "image", "prediction": "v_prediction"},
    "sdxl": {"modality": "image", "prediction": "epsilon"},
    "sd3": {"modality": "image", "prediction": "flow_matching"},
    "pixart_sigma": {"modality": "image", "prediction": "epsilon"},
    "auraflow": {"modality": "image", "prediction": "flow_matching"},
    "wan": {"modality": "video", "prediction": "flow_matching"},
    "ltxvideo": {"modality": "video", "prediction": "flow_matching"},
    "ltxvideo2": {"modality": "video", "prediction": "flow_matching"},
    "ace_step": {"modality": "audio", "prediction": "flow_matching"},
    "chroma": {"modality": "image", "prediction": "flow_matching"},
    "krea2": {"modality": "image", "prediction": "flow_matching"},
    "kolors": {"modality": "image", "prediction": "epsilon"},
    "hunyuanvideo": {"modality": "video", "prediction": "flow_matching"},
    "flux2": {"modality": "image", "prediction": "flow_matching"},
    "lumina2": {"modality": "image", "prediction": "flow_matching"},
    "sana": {"modality": "image", "prediction": "flow_matching"},
    "deepfloyd": {"modality": "image", "prediction": "epsilon"},
    "mageflow": {"modality": "image", "prediction": "flow_matching"},
    "z_image": {"modality": "image", "prediction": "flow_matching"},
    "cosmos3": {"modality": "video", "prediction": "flow_matching"},
    "cosmos": {"modality": "image", "prediction": "sample"},
    "hidream": {"modality": "image", "prediction": "flow_matching"},
    "qwen_image": {"modality": "image", "prediction": "flow_matching"},
    "longcat_image": {"modality": "image", "prediction": "flow_matching"},
    "longcat_video": {"modality": "video", "prediction": "flow_matching"},
    "anima": {"modality": "image", "prediction": "flow_matching"},
    "ideogram": {"modality": "image", "prediction": "flow_matching"},
    "kandinsky5_image": {"modality": "image", "prediction": "flow_matching"},
    "kandinsky5_video": {"modality": "video", "prediction": "flow_matching"},
    "sanavideo": {"modality": "video", "prediction": "flow_matching"},
    "boogu_image": {"modality": "image", "prediction": "flow_matching"},
    "ernie": {"modality": "image", "prediction": "flow_matching"},
    "stable_cascade": {"modality": "image", "prediction": "epsilon"},
    "wan_s2v": {"modality": "video", "prediction": "flow_matching"},
    "heartmula": {"modality": "audio", "prediction": "autoregressive"},
    "omnigen": {"modality": "image", "prediction": "flow_matching"},
    "z_image_omni": {"modality": "image", "prediction": "flow_matching"},
    "zlab_i1": {"modality": "image", "prediction": "flow_matching"},
}
# the JAX registry's aliases (:53-59)
ALIASES = {"sd15": "sd1x", "sd21": "sd2x", "pixart": "pixart_sigma", "ltx2": "ltxvideo2",
           "kandinsky5-image": "kandinsky5_image"}
# the families the port builds
PORTED = ("flux", "sd3", "sdxl", "sd1x", "sd2x", "pixart_sigma", "auraflow", "wan", "ltxvideo", "chroma", "lumina2",
          "kandinsky5_image", "kandinsky5_video", "hunyuanvideo", "qwen_image", "mageflow", "z_image", "hidream",
          "flux2", "kolors", "longcat_image", "z_image_omni", "zlab_i1", "boogu_image", "krea2", "cosmos", "anima",
          "omnigen", "ernie", "ideogram", "longcat_video", "sana", "sanavideo", "cosmos3", "ltxvideo2", "ace_step",
          "wan_s2v")


class ModelRegistry:
    @staticmethod
    def families() -> List[str]:
        return list(_FAMILIES)

    @staticmethod
    def metadata(name: str) -> Dict[str, Any]:
        name = ALIASES.get(name, name)
        if name not in _FAMILIES:
            raise KeyError(f"unknown model family {name!r}; known: {list(_FAMILIES)}")
        return dict(_FAMILIES[name])

    @staticmethod
    def get(name: str) -> Type:
        ModelRegistry.metadata(name)  # unknown names raise KeyError
        family = ALIASES.get(name, name)
        if family == "flux":
            from .flux import Flux

            return Flux
        if family == "sd3":
            from .sd3 import SD3

            return SD3
        if family == "sdxl":
            from .sdxl import SDXL

            return SDXL
        if family in ("sd1x", "sd2x"):
            from .sd1x import SD1x, SD2x

            return SD1x if family == "sd1x" else SD2x
        if family == "pixart_sigma":
            from .pixart import PixartSigma

            return PixartSigma
        if family == "auraflow":
            from .auraflow import AuraFlow

            return AuraFlow
        if family == "wan":
            from .wan import Wan

            return Wan
        if family == "ltxvideo":
            from .ltxvideo import LTXVideo

            return LTXVideo
        if family == "chroma":
            from .chroma import Chroma

            return Chroma
        if family == "lumina2":
            from .lumina2 import Lumina2

            return Lumina2
        if family in ("kandinsky5_image", "kandinsky5_video"):
            from .kandinsky5 import Kandinsky5Image, Kandinsky5Video

            return Kandinsky5Image if family == "kandinsky5_image" else Kandinsky5Video
        if family == "hunyuanvideo":
            from .hunyuanvideo import HunyuanVideo

            return HunyuanVideo
        if family == "qwen_image":
            from .qwen_image import QwenImage

            return QwenImage
        if family in ("mageflow", "z_image"):
            from .mageflow import MageFlow, ZImage

            return MageFlow if family == "mageflow" else ZImage
        if family == "hidream":
            from .hidream import HiDream

            return HiDream
        if family == "flux2":
            from .flux2 import Flux2

            return Flux2
        if family == "kolors":
            from .kolors import Kolors

            return Kolors
        if family == "longcat_image":
            from .longcat_image import LongcatImage

            return LongcatImage
        if family == "z_image_omni":
            from .z_image_omni import ZImageOmni

            return ZImageOmni
        if family == "zlab_i1":
            from .zlab_i1 import ZlabI1

            return ZlabI1
        if family == "boogu_image":
            from .extended import BooguImage

            return BooguImage
        if family == "krea2":
            from .krea2 import Krea2

            return Krea2
        if family == "cosmos":
            from .cosmos2 import Cosmos2Image

            return Cosmos2Image
        if family == "anima":
            from .anima import Anima

            return Anima
        if family == "omnigen":
            from .omnigen import OmniGen

            return OmniGen
        if family == "ernie":
            from .ernie import Ernie

            return Ernie
        if family == "ideogram":
            from .ideogram import Ideogram

            return Ideogram
        if family == "longcat_video":
            from .longcat_video import LongcatVideo

            return LongcatVideo
        if family == "sana":
            from .sana import Sana

            return Sana
        if family == "sanavideo":
            from .sanavideo import SanaVideo

            return SanaVideo
        if family == "cosmos3":
            from .cosmos3 import Cosmos3

            return Cosmos3
        if family == "ltxvideo2":
            from .ltxvideo2 import LTXVideo2

            return LTXVideo2
        if family == "ace_step":
            from .ace_step import ACEStep

            return ACEStep
        if family == "wan_s2v":
            from .extended import WanS2V

            return WanS2V
        raise NotImplementedError(f"model_family={name!r} is not ported (only {', '.join(PORTED)}; "
                                  "ROADMAP Queue 1 item 6)")

    @staticmethod
    def create(name: str, config: Any):
        return ModelRegistry.get(name)(config)


def get_model_family(config: Any):
    """The model family object for ``config.model_family``."""
    family = getattr(config, "model_family", None)
    if not family:
        raise ValueError("config.model_family is required")
    model = ModelRegistry.create(family, config)
    overrides = getattr(config, "model_arch_overrides", None)
    if overrides:
        if isinstance(overrides, str):
            overrides = json.loads(overrides)
        arch = getattr(model, "arch", None)
        fields = {f.name for f in dataclasses.fields(arch)} if dataclasses.is_dataclass(arch) else set()
        unknown = sorted(set(overrides) - fields)
        if unknown:
            raise ValueError(f"model_arch_overrides: {family!r} has no arch field {unknown} "
                             f"(its fields: {sorted(fields)})")
        model.arch = dataclasses.replace(arch, **overrides)
    model.check_user_config()
    if getattr(config, "train_text_encoder", False):
        raise NotImplementedError("train_text_encoder is not ported (ROADMAP Queue 1 item 4i)")
    return model
