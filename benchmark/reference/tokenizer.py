"""CLIP's byte-level BPE over a vocabulary without merges, the one the
benchmark serves (the published vocabularies are not in the repository):
the 256 byte symbols, their end-of-word forms, then <|startoftext|> and
<|endoftext|>. Without merges a word's tokens are its byte symbols, the
last one in its end-of-word form.
"""

from __future__ import annotations

import html
import re

_WORD = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[a-zA-ZÀ-￿]+|[0-9]|[^\sa-zA-Z0-9À-￿]+""", re.IGNORECASE)


def _byte_symbols() -> list:
    """GPT-2's reversible byte -> symbol map, in its order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return list(zip(bs, [chr(c) for c in cs]))


class ByteTokenizer:
    def __init__(self):
        pairs = _byte_symbols()
        self.symbol = dict(pairs)
        tokens = [c for _, c in pairs] + [c + "</w>" for _, c in pairs]
        tokens += ["<|startoftext|>", "<|endoftext|>"]
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.bos = self.vocab["<|startoftext|>"]
        self.eos = self.vocab["<|endoftext|>"]

    def encode(self, text: str) -> list:
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip())
        ids = []
        for word in _WORD.findall(text.strip().lower()):
            chars = [self.symbol[b] for b in word.encode("utf-8")]
            chars[-1] += "</w>"
            ids += [self.vocab[c] for c in chars]
        return ids

    def ids(self, text: str, length: int) -> list:
        """[bos] + tokens + [eos], cut to ``length`` (ending in eos) and
        padded with eos."""
        ids = [self.bos] + self.encode(text) + [self.eos]
        if len(ids) > length:
            ids = ids[:length - 1] + [self.eos]
        return ids + [self.eos] * (length - len(ids))
