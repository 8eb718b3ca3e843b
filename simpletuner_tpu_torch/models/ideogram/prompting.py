"""Ideogram v4 structured-JSON captions (host code).

A copy of ``simpletuner_tpu/models/ideogram/prompting.py``, held to it by
``tests/test_torch_host_modules.py``.  Ideogram renders from a minified
single-line JSON caption with a fixed key order:

    {"high_level_description": ...,
     "style_description": {aesthetics, lighting, photo|art_style, medium,
                           color_palette?},
     "compositional_deconstruction": {"background": ..., "elements": [
         {"type": "obj"|"text", "bbox"?, "text"?, "desc", "color_palette"?}]}}

``--ideogram_auto_json`` (default on) converts plain validation/caching
prompts into this schema; JSON prompts are canonicalized.  Pinned behaviors:
hex palettes are uppercased, deduped, capped at 16 global / 5 per element;
prompts mentioning camera vocabulary get medium=photograph, everything else
medium=illustration; captions always carry >=1 "obj" element; serialization
is compact JSON with non-ASCII preserved.  Each section is described by a
(key, source-keys, default) table and one generic builder assembles the
ordered output.
"""

from __future__ import annotations

import json
import re
from collections import OrderedDict
from typing import Any, Dict, List, Optional

_HEX = re.compile(r"#(?:[0-9a-fA-F]{6})\b")

# vocabulary that flips the default medium to "photograph"
_CAMERA_WORDS = frozenset({
    "35mm", "50mm", "85mm", "aperture", "bokeh", "camera", "cinematic",
    "depth of field", "dslr", "film", "lens", "photo", "photograph",
    "photoreal", "shot",
})

# style_description defaults, in output order; the medium pair is resolved
# separately because photo vs illustration changes both keys and order
_STYLE_DEFAULTS = (
    ("aesthetics", "visually grounded, detailed"),
    ("lighting", "natural, balanced lighting"),
)
_PHOTO_PAIR = (("photo", "natural perspective, sharp focus"), ("medium", "photograph"))
_ART_PAIR = (("medium", "illustration"), ("art_style", "detailed digital illustration"))

PALETTE_LIMIT_CAPTION = 16
PALETTE_LIMIT_ELEMENT = 5


def _squash(value: Any) -> str:
    """Collapse whitespace; None-safe."""
    return " ".join(str(value or "").strip().split())


def _hex_palette(text_or_list: Any, limit: int) -> List[str]:
    """Uppercased, deduped hex colors from free text or an explicit list."""
    if isinstance(text_or_list, (list, tuple)):
        found = [str(c) for c in text_or_list if _HEX.fullmatch(str(c))]
    else:
        found = _HEX.findall(str(text_or_list or ""))
    out: List[str] = []
    for color in found:
        color = color.upper()
        if color not in out:
            out.append(color)
        if len(out) >= limit:
            break
    return out


def _mentions_camera(prompt: str) -> bool:
    lower = (prompt or "").lower()
    return any(word in lower for word in _CAMERA_WORDS)


def _style_section(style: Dict[str, Any], source_prompt: str) -> "OrderedDict[str, Any]":
    out: "OrderedDict[str, Any]" = OrderedDict(
        (key, _squash(style.get(key) or default)) for key, default in _STYLE_DEFAULTS
    )
    photographic = "photo" in style or (
        "art_style" not in style and _mentions_camera(source_prompt)
    )
    for key, default in (_PHOTO_PAIR if photographic else _ART_PAIR):
        out[key] = _squash(style.get(key) or default)
    palette = style.get("color_palette", style.get("colour_palette"))
    palette = (
        _hex_palette(palette, PALETTE_LIMIT_CAPTION)
        if palette is not None
        else _hex_palette(source_prompt, PALETTE_LIMIT_CAPTION)
    )
    if palette:
        out["color_palette"] = palette
    return out


def _element_section(element: Dict[str, Any]) -> "OrderedDict[str, Any]":
    kind = element.get("type")
    kind = kind if kind in ("obj", "text") else "obj"
    out: "OrderedDict[str, Any]" = OrderedDict(type=kind)
    bbox = element.get("bbox")
    if isinstance(bbox, (list, tuple)) and len(bbox) == 4:
        out["bbox"] = [int(float(v)) for v in bbox]
    if kind == "text":
        out["text"] = _squash(element.get("text"))
    # desc aliases accepted on input, always emitted as "desc"
    out["desc"] = _squash(
        element.get("desc") or element.get("description") or element.get("label")
    )
    palette = element.get("color_palette", element.get("colour_palette"))
    if palette:
        colors = _hex_palette(palette, PALETTE_LIMIT_ELEMENT)
        if colors:
            out["color_palette"] = colors
    return out


def canonicalize_ideogram_json_caption(
    caption: Dict[str, Any], source_prompt: str = ""
) -> "OrderedDict[str, Any]":
    """Arbitrary user JSON -> fixed-order schema with defaults filled."""
    headline = _squash(
        caption.get("high_level_description") or caption.get("description") or source_prompt
    )
    style = caption.get("style_description")
    comp = caption.get("compositional_deconstruction")
    style = style if isinstance(style, dict) else {}
    comp = comp if isinstance(comp, dict) else {}

    elements = [
        _element_section(e)
        for e in (comp.get("elements") if isinstance(comp.get("elements"), list) else [])
        if isinstance(e, dict)
    ]
    background = _squash(comp.get("background") or headline)
    if not elements:
        # every caption carries at least one obj element (the subject)
        elements = [OrderedDict(type="obj", desc=headline or background)]

    out: "OrderedDict[str, Any]" = OrderedDict()
    if headline:
        out["high_level_description"] = headline
    out["style_description"] = _style_section(style, source_prompt or headline)
    out["compositional_deconstruction"] = OrderedDict(
        background=background, elements=elements
    )
    return out


def prompt_to_ideogram_json_caption(prompt: str) -> "OrderedDict[str, Any]":
    """Plain text -> the minimal faithful caption: the prompt becomes the
    headline, the background, and the single obj element."""
    prompt = _squash(prompt)
    style: Dict[str, Any] = {}
    palette = _hex_palette(prompt, PALETTE_LIMIT_CAPTION)
    if palette:
        style["color_palette"] = palette
    pair = _PHOTO_PAIR if _mentions_camera(prompt) else _ART_PAIR
    style.update({k: v for k, v in pair if k in ("medium", "photo", "art_style")})
    return canonicalize_ideogram_json_caption(
        {
            "high_level_description": prompt,
            "style_description": style,
            "compositional_deconstruction": {
                "background": prompt,
                "elements": [{"type": "obj", "desc": prompt}],
            },
        },
        source_prompt=prompt,
    )


def serialize_ideogram_caption(caption: Dict[str, Any]) -> str:
    return json.dumps(caption, separators=(",", ":"), ensure_ascii=False)


def maybe_convert_prompt_to_ideogram_json(prompt: Optional[str], enabled: bool = True) -> str:
    """The --ideogram_auto_json entry point: plain prompt -> JSON caption,
    JSON prompt -> canonicalized, invalid JSON -> treated as plain text."""
    if not enabled:
        return prompt
    candidate = str(prompt or "").strip()
    if candidate.startswith("{"):
        try:
            parsed = json.loads(candidate, object_pairs_hook=OrderedDict)
        except json.JSONDecodeError:
            parsed = None
        if isinstance(parsed, dict):
            return serialize_ideogram_caption(
                canonicalize_ideogram_json_caption(parsed, source_prompt=candidate)
            )
    return serialize_ideogram_caption(prompt_to_ideogram_json_caption(candidate))
