"""ACE-Step lyric tokenization.

The torch port's copy of ``simpletuner_tpu/models/ace_step/lyrics.py``
(host Python and numpy; ``tests/test_torch_host_modules.py`` holds the body
after this docstring equal to the JAX module's).  Lyrics split into lines;
each line is lowercased and whitespace-collapsed, prefixed with its
``[lang]`` tag, its spaces become ``[SPACE]``, and its BPE ids are followed
by the line-break token 2; the sequence starts with token 261.  Structure
markers (``[verse]``, ``[chorus]``) tokenize as English.  The language of a
line is a Unicode-range guess (CJK -> zh, kana -> ja, hangul -> ko, else en),
and a zh / ja / ko line raises: its transliteration libraries are not in
this build.  ``tokenizers`` is imported at the first encode.  The vocab is
resolved from an explicit ``vocab_file``, then ``$SIMPLETUNER_LYRICS_VOCAB``,
then ``<model dir>/lyrics_utils/vocab.json`` and ``<model dir>/vocab.json``;
a missing vocab raises at first use with every location looked at.  A batch
pads to a multiple of 64 ids (mask 0), an empty lyric to one masked 0.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

STRUCTURE_PATTERN = re.compile(r"\[.*?\]")  # reference pipeline.py:76
START_TOKEN = 261  # reference model.py:1436
LINE_BREAK_TOKEN = 2  # reference model.py:1440/1454
_WHITESPACE_RE = re.compile(r"\s+")

# scripts whose reference path needs transliteration libraries we don't ship
_CJK = re.compile(r"[一-鿿]")
_KANA = re.compile(r"[぀-ヿ]")
_HANGUL = re.compile(r"[가-힯]")


class LyricsTokenizer:
    """VoiceBpe-compatible lyric tokenizer over an ACE-Step vocab.json."""

    def __init__(self, vocab_file: Optional[str] = None, model_path: Optional[str] = None):
        self._vocab_file = vocab_file
        self._model_path = model_path
        self._tokenizer = None

    # ---- vocab resolution -----------------------------------------------------------
    def _resolve_vocab(self) -> str:
        candidates = []
        if self._vocab_file:
            candidates.append(self._vocab_file)
        env = os.environ.get("SIMPLETUNER_LYRICS_VOCAB")
        if env:
            candidates.append(env)
        if self._model_path:
            candidates.append(os.path.join(self._model_path, "lyrics_utils", "vocab.json"))
            candidates.append(os.path.join(self._model_path, "vocab.json"))
        for path in candidates:
            if os.path.exists(path):
                return path
        raise FileNotFoundError(
            "ACE-Step lyric tokenization needs the checkpoint's BPE vocab.json "
            f"(looked in: {candidates or ['<nothing configured>']}).  Point "
            "SIMPLETUNER_LYRICS_VOCAB at it or place lyrics_utils/vocab.json "
            "next to the pretrained model."
        )

    def _ensure(self):
        if self._tokenizer is None:
            from tokenizers import Tokenizer

            self._tokenizer = Tokenizer.from_file(self._resolve_vocab())
        return self._tokenizer

    # ---- per-line machinery ----------------------------------------------------------
    @staticmethod
    def detect_language(line: str) -> str:
        if _CJK.search(line):
            return "zh"
        if _KANA.search(line):
            return "ja"
        if _HANGUL.search(line):
            return "ko"
        return "en"

    @staticmethod
    def clean(text: str, lang: str) -> str:
        # multilingual_cleaners subset (lyric_tokenizer.py:557-577)
        if lang in ("zh", "ja", "ko"):
            raise NotImplementedError(
                f"ACE-Step lyric line {text[:40]!r} needs {lang} transliteration "
                "(pypinyin/cutlet/hangul-romanize), which is not available in "
                "this build — romanize the lyrics beforehand."
            )
        text = text.replace('"', "")
        text = text.lower()
        return _WHITESPACE_RE.sub(" ", text).strip()

    def encode_line(self, line: str, lang: str) -> List[int]:
        """One cleaned line -> BPE ids (lyric_tokenizer.py:681-688)."""
        text = self.clean(line, lang)
        text = f"[{lang}]{text}"
        text = text.replace(" ", "[SPACE]")
        return list(self._ensure().encode(text).ids)

    # ---- the reference surface ---------------------------------------------------------
    def tokenize(self, lyrics: Optional[str]) -> List[int]:
        """Whole-lyric token ids (reference _tokenize_single_lyrics)."""
        if not lyrics:
            return []
        ids = [START_TOKEN]
        for line in lyrics.split("\n"):
            line = line.strip()
            if not line:
                ids.append(LINE_BREAK_TOKEN)
                continue
            lang = "en" if STRUCTURE_PATTERN.match(line) else self.detect_language(line)
            ids += self.encode_line(line, lang) + [LINE_BREAK_TOKEN]
        return ids

    def tokenize_batch(
        self, lyrics_list: Sequence[Optional[str]], pad_multiple: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) padded to a multiple of ``pad_multiple``.

        The reference pads to the batch max (model.py:1428-1430, torch eager);
        on TPU a raw max would recompile the train step on every new length,
        so lengths round up to a small set of buckets — padding rides mask 0
        exactly like the reference's pad_sequence zeros.  Empty lyrics become
        a single masked 0 (reference :1421-1424).
        """
        token_rows: List[List[int]] = []
        mask_rows: List[List[int]] = []
        for lyrics in lyrics_list:
            ids = self.tokenize(lyrics)
            if not ids:
                token_rows.append([0])
                mask_rows.append([0])
            else:
                token_rows.append(ids)
                mask_rows.append([1] * len(ids))
        longest = max(len(r) for r in token_rows)
        pad_multiple = max(1, int(pad_multiple))
        width = ((longest + pad_multiple - 1) // pad_multiple) * pad_multiple
        ids = np.zeros((len(token_rows), width), np.int32)
        mask = np.zeros((len(token_rows), width), np.float32)
        for i, (row, mrow) in enumerate(zip(token_rows, mask_rows)):
            ids[i, : len(row)] = row
            mask[i, : len(mrow)] = mrow
        return ids, mask
