"""Caption strategies (reference: helpers/prompts.py:178 ``PromptHandler``;
strategies textfile/filename/parquet/instanceprompt/csv documented in
documentation/DATALOADER.md).

The torch port's own copy of ``simpletuner_tpu/data/captions.py``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

_FILENAME_CLEANUP = re.compile(r"[_\-]+")


def caption_from_filename(path: str) -> str:
    stem = os.path.splitext(os.path.basename(path))[0]
    return _FILENAME_CLEANUP.sub(" ", stem).strip()


def caption_from_textfile(path: str, data_backend) -> Optional[str]:
    text_path = os.path.splitext(path)[0] + ".txt"
    if not data_backend.exists(text_path):
        return None
    return data_backend.read(text_path).decode("utf-8", errors="replace").strip()


def apply_caption_filters(caption: str, filters: Optional[List[str]]) -> str:
    """Drop-list / regex filter lines (reference caption_filter_list)."""
    if not filters:
        return caption
    for rule in filters:
        rule = rule.strip()
        if not rule:
            continue
        if rule.startswith("s/") and rule.count("/") >= 2:
            _, pattern, replacement = rule.split("/", 2)
            replacement = replacement.rstrip("/")
            caption = re.sub(pattern, replacement, caption)
        else:
            caption = caption.replace(rule, "")
    return caption.strip()


def get_caption(
    path: str,
    data_backend,
    strategy: str = "filename",
    instance_prompt: Optional[str] = None,
    prepend_instance_prompt: bool = False,
    only_instance_prompt: bool = False,
    caption_filters: Optional[List[str]] = None,
    metadata_row: Optional[Dict[str, Any]] = None,
    parquet_config: Optional[Dict[str, Any]] = None,
) -> str:
    if strategy == "instanceprompt" or only_instance_prompt:
        return instance_prompt or ""
    if strategy == "textfile":
        caption = caption_from_textfile(path, data_backend)
        if caption is None:
            caption = caption_from_filename(path)
    elif strategy in ("parquet", "csv", "huggingface"):
        column = (parquet_config or {}).get("caption_column", "caption")
        caption = ""
        if metadata_row:
            value = metadata_row.get(column, "")
            if isinstance(value, (list, tuple)):
                value = value[0] if value else ""
            caption = str(value)
        # csv/huggingface backends carry captions natively (url rows / dataset columns)
        if not caption and hasattr(data_backend, "caption_for"):
            caption = data_backend.caption_for(path) or ""
        if not caption:
            caption = caption_from_filename(path)
    else:
        caption = caption_from_filename(path)
    caption = apply_caption_filters(caption, caption_filters)
    if prepend_instance_prompt and instance_prompt:
        caption = f"{instance_prompt} {caption}".strip()
    return caption


def load_caption_filter_list(path: Optional[str]) -> Optional[List[str]]:
    if not path or not os.path.exists(path):
        return None
    with open(path) as handle:
        return [line.rstrip("\n") for line in handle if line.strip() and not line.startswith("#")]
