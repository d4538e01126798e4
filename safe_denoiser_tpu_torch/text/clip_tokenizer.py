"""CLIP byte-pair-encoding tokenizer (self-contained, no torch/HF deps).

The port's own copy of ``safe_denoiser_tpu/text/clip_tokenizer.py``.
``encode`` runs the native C++ BPE engine (``text/native.py``, built with
g++ at first use) as the JAX package does; where it cannot be built it
warns and takes the pure-Python path, the reference semantics, whose ids
the engine's equal. ``engine`` says which path a tokenizer takes.

The reference tokenizes through HF ``CLIPTokenizer`` (diffusers pipelines)
and a vendored OpenCLIP SimpleTokenizer (open_clip/tokenizer.py). This
implementation reproduces those semantics — byte→unicode mapping, lowercase
+ whitespace cleanup, the CLIP word regex, ``</w>`` end-of-word merges, BOS/
EOS framing, max-length 77 with EOS padding — and loads its vocabulary from
either source format:

  * HF layout:       vocab.json + merges.txt   (SD checkpoint `tokenizer/`)
  * OpenCLIP layout: bpe_simple_vocab_*.txt.gz (merge list; vocab derived)

No vocabulary data is bundled; pass the checkpoint's own tokenizer files.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import warnings
from typing import Iterable


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2-style reversible byte→unicode map (the standard BPE alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's word regex uses \p{L}/\p{N} (regex module); stdlib-re equivalent
# classes below cover the Latin + general-unicode ranges that prompts use.
_WORD_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[a-zA-ZÀ-￿]+|[0-9]|[^\sa-zA-Z0-9À-￿]+""",
    re.IGNORECASE)


class CLIPTokenizer:
    def __init__(self, merges: Iterable[tuple[str, str]],
                 vocab: dict[str, int] | None = None,
                 max_length: int = 77,
                 pad_token: str | None = None):
        self.byte_encoder = bytes_to_unicode()
        merges = [tuple(m) for m in merges]
        if vocab is None:
            # Derive the OpenCLIP vocabulary layout: bytes, bytes</w>,
            # merge outputs, then the two specials.
            chars = list(self.byte_encoder.values())
            tokens = chars + [c + "</w>" for c in chars]
            tokens += ["".join(m) for m in merges]
            tokens += ["<|startoftext|>", "<|endoftext|>"]
            vocab = {t: i for i, t in enumerate(tokens)}
        self.vocab = dict(vocab)
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.max_length = max_length
        self.bos_token_id = self.vocab["<|startoftext|>"]
        self.eos_token_id = self.vocab["<|endoftext|>"]
        # HF CLIPTokenizer pads with EOS for SD-v1; SD3's tokenizer_2
        # (OpenCLIP bigG) pads with "!" (id 0) — honor the checkpoint config
        if pad_token is not None and pad_token in self.vocab:
            self.pad_token_id = self.vocab[pad_token]
        else:
            self.pad_token_id = self.eos_token_id
        self.model_max_length = max_length
        self._cache: dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>"}

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        """Load from an HF `tokenizer/` dir or an OpenCLIP .txt.gz merge file."""
        if os.path.isdir(path):
            pad_token = None
            tc_path = os.path.join(path, "tokenizer_config.json")
            if os.path.exists(tc_path):
                with open(tc_path) as f:
                    tc = json.load(f)
                max_length = tc.get("model_max_length", max_length)
                pt = tc.get("pad_token")
                pad_token = pt.get("content") if isinstance(pt, dict) else pt
            with open(os.path.join(path, "vocab.json")) as f:
                vocab = json.load(f)
            with open(os.path.join(path, "merges.txt")) as f:
                lines = f.read().split("\n")
            merges = [tuple(l.split()) for l in lines
                      if l and not l.startswith("#") and len(l.split()) == 2]
            return cls(merges, vocab, max_length, pad_token=pad_token)
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # OpenCLIP format: first line is a header, merges 1..48894+1
        merges = [tuple(l.split()) for l in lines[1:49152 - 256 - 2 + 1]
                  if len(l.split()) == 2]
        return cls(merges, None, max_length)

    # -- BPE ----------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _native(self):
        """Lazy native C++ BPE engine (``text/native.py``); None, with a
        warning, where it cannot be built or loaded."""
        if not hasattr(self, "_native_engine"):
            try:
                from .native import NativeBPE
                merges = sorted(self.bpe_ranks, key=self.bpe_ranks.get)
                self._native_engine = NativeBPE(self.vocab, merges)
            except (RuntimeError, OSError) as e:
                warnings.warn(f"native BPE engine unavailable, the tokenizer "
                              f"takes the Python path: {e}")
                self._native_engine = None
        return self._native_engine

    @property
    def engine(self) -> str:
        """"native" or "python": the path ``encode`` takes."""
        return "python" if self._native() is None else "native"

    def encode(self, text: str) -> list[int]:
        """Raw BPE ids without BOS/EOS framing."""
        native = self._native()
        if native is not None:
            return native.encode(whitespace_clean(basic_clean(text)).lower())
        return self.encode_python(text)

    def encode_python(self, text: str) -> list[int]:
        """``encode`` on the pure-Python path (the reference semantics)."""
        text = whitespace_clean(basic_clean(text)).lower()
        ids: list[int] = []
        for token in _WORD_PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts: str | list[str], padding: str = "max_length",
                 max_length: int | None = None, truncation: bool = True):
        """HF-style call: returns {'input_ids': [[...]], 'attention_mask': [[...]]}.

        Padding uses the EOS token (HF CLIPTokenizer pad_token for SD).
        """
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        all_ids, all_mask = [], []
        for text in texts:
            ids = [self.bos_token_id] + self.encode(text) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[:max_length - 1] + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            all_ids.append(ids)
            all_mask.append(mask)
        if padding == "longest":
            longest = max(len(i) for i in all_ids)
            all_ids = [i + [self.pad_token_id] * (longest - len(i))
                       for i in all_ids]
            all_mask = [m + [0] * (longest - len(m)) for m in all_mask]
        return {"input_ids": all_ids, "attention_mask": all_mask}
