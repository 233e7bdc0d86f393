"""CLIP byte-pair-encoding tokenizer (pure python; a copy of
`vitadapter/data/tokenization.py`, which imports no framework).

Parity target: `ClipTokenizer`
(reference `wsdm2023/mmdet_custom/models/utils/tokenization/tokenization_clip.py:66`),
itself the standard CLIP simple tokenizer: byte-level unicode mapping, BPE
merges from the 16e6 vocab, `</w>` word-boundary markers, lowercasing +
whitespace cleanup, specials `<|startoftext|>` / `<|endoftext|>`.

The merge table ships with CLIP (`bpe_simple_vocab_16e6.txt.gz`); it is loaded
at runtime from `vocab_path` or `$VITADAPTER_BPE_VOCAB` rather than vendored.
"""

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte <-> printable-unicode bijection."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class ClipTokenizer:
    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, vocab_path: Optional[str] = None):
        vocab_path = vocab_path or os.environ.get("VITADAPTER_BPE_VOCAB")
        if not vocab_path or not os.path.exists(vocab_path):
            raise FileNotFoundError(
                "CLIP BPE vocab not found; set VITADAPTER_BPE_VOCAB to "
                "bpe_simple_vocab_16e6.txt.gz")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([self.SOT, self.EOT])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {self.SOT: self.SOT, self.EOT: self.EOT}
        # \p{L}/\p{N} classes approximated with ASCII ranges (stdlib `re`
        # has no unicode property escapes); identical on English text.
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
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
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(self.pat, _clean(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize_refer(self, text: str, max_len: int = 128
                       ) -> Tuple[List[int], List[int]]:
        """ids + mask with SOT/EOT, padded/truncated to max_len (reference
        `TokenizeRefer`, `wsdm2023/mmdet_custom/apis/pipeline.py`)."""
        ids = [self.encoder[self.SOT]] + self.encode(text)
        ids = ids[: max_len - 1] + [self.encoder[self.EOT]]
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        return ids + [0] * pad, mask + [0] * pad


def random_flip_refer(text: str) -> str:
    """Swap 'left'/'right' words for horizontal flips (reference
    `RandomFlipWithRefer`)."""
    def swap(m):
        w = m.group(0)
        repl = "right" if w.lower() == "left" else "left"
        return repl.capitalize() if w[0].isupper() else repl

    return re.sub(r"\b[Ll]eft\b|\b[Rr]ight\b", swap, text)
