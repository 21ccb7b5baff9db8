"""Tokenizers (port of ggmlsharp_tpu/io/tokenizer.py, its own copy: the
port imports nothing of the JAX package): llama.cpp-compatible
SentencePiece-style (SPM, the Llama family) and byte-level BPE (the GPT-2
family), built from GGUF metadata (``tokenizer.ggml.*``) or from explicit
vocabulary and merge tables.

  * SPM: text -> '▁'-prefixed symbols, greedy highest-score bigram merges
    over the vocabulary, unknown bytes fall back to <0xXX> byte tokens.
  * BPE: byte-level pre-mapping (GPT-2's bytes_to_unicode), lowest-rank
    merge first.

Pure Python by default. ``native=True`` runs the merge loop in C++
(``native/tokenize.cpp``, built by ``io.native``), with the same ids; if the
library cannot be built or loaded, encoding raises: nothing falls back.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field


def _bytes_to_unicode():
    """GPT-2's printable-byte mapping (byte -> unicode char)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_B2U = _bytes_to_unicode()
_U2B = {v: k for k, v in _B2U.items()}
_GPT2_SPLIT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+", re.UNICODE)


def _is_byte_token(t: str) -> bool:
    return len(t) == 6 and t.startswith("<0x") and t.endswith(">")


@dataclass
class SPMTokenizer:
    """Llama-family SentencePiece (greedy score-merge) tokenizer.
    native: encode through the C++ merge loop (built on first use; raises if
    it cannot be)."""

    tokens: list
    scores: list
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    add_space_prefix: bool = True
    native: bool = False
    _index: dict = field(default_factory=dict, repr=False)
    _bytes: dict = field(default_factory=dict, repr=False)
    _native_h: object = field(default=None, repr=False)

    def __post_init__(self):
        self._index = {t: i for i, t in enumerate(self.tokens)}
        for i, t in enumerate(self.tokens):
            if _is_byte_token(t):
                self._bytes[int(t[3:5], 16)] = i

    def _native(self):
        if not self.native:
            return None
        if self._native_h is None:
            from .native import NativeSPM

            self._native_h = NativeSPM(self.tokens, self.scores, self._bytes,
                                       self.unk_id)
        return self._native_h

    def encode(self, text: str, bos: bool = True) -> list:
        if self.add_space_prefix:
            text = " " + text
        text = text.replace(" ", "▁")
        nat = self._native()
        if nat is not None:
            ids = nat.encode(text)
            return [self.bos_id] + ids if bos else ids
        syms = list(text)
        # greedy merge: repeatedly join the adjacent pair whose merged
        # string is in the vocabulary with the best (highest) score
        while True:
            best, best_score = -1, -1e30
            for i in range(len(syms) - 1):
                j = self._index.get(syms[i] + syms[i + 1])
                if j is not None and self.scores[j] > best_score:
                    best, best_score = i, self.scores[j]
            if best < 0:
                break
            syms[best:best + 2] = [syms[best] + syms[best + 1]]
        out = [self.bos_id] if bos else []
        for s in syms:
            j = self._index.get(s)
            if j is not None:
                out.append(j)
            else:  # byte fallback
                for b in s.encode("utf-8"):
                    out.append(self._bytes.get(b, self.unk_id))
        return out

    def decode(self, ids) -> str:
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i in (self.bos_id, self.eos_id):
                continue
            t = self.tokens[i]
            if _is_byte_token(t):
                buf += bytes([int(t[3:5], 16)])
            else:
                buf += t.encode("utf-8")
        s = buf.decode("utf-8", errors="replace").replace("▁", " ")
        return s[1:] if self.add_space_prefix and s.startswith(" ") else s


@dataclass
class BPETokenizer:
    """GPT-2-family byte-level BPE. native: each piece's merge loop in C++
    (the regex split and byte mapping stay in Python)."""

    tokens: list
    merges: list  # ["a b", ...] rank-ordered
    eos_id: int | None = None
    native: bool = False
    _index: dict = field(default_factory=dict, repr=False)
    _ranks: dict = field(default_factory=dict, repr=False)
    _native_h: object = field(default=None, repr=False)

    def __post_init__(self):
        self._index = {t: i for i, t in enumerate(self.tokens)}
        self._ranks = {
            tuple(m.split(" ", 1)): r for r, m in enumerate(self.merges)
        }

    def _native(self):
        if not self.native:
            return None
        if self._native_h is None:
            from .native import NativeBPE

            self._native_h = NativeBPE(self.tokens, self.merges)
        return self._native_h

    def _bpe(self, word: str) -> list:
        parts = list(word)
        while len(parts) > 1:
            best_rank, best = None, -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best = r, i
            if best < 0:
                break
            parts[best:best + 2] = [parts[best] + parts[best + 1]]
        return parts

    def encode(self, text: str, bos: bool = False) -> list:
        # byte-level: the text mapped through bytes_to_unicode, split the
        # GPT-2 way (a space attaches to the following word)
        mapped = ["".join(_B2U[b] for b in piece.encode("utf-8"))
                  for piece in _GPT2_SPLIT.findall(text)]
        nat = self._native()
        if nat is not None:
            return nat.encode_pieces(mapped)
        out = []
        for m in mapped:
            for p in self._bpe(m):
                out.append(self._index.get(p, 0))
        return out

    def decode(self, ids) -> str:
        text = "".join(self.tokens[int(i)] for i in ids
                       if self.eos_id is None or int(i) != self.eos_id)
        data = bytes(_U2B[c] for c in text if c in _U2B)
        return data.decode("utf-8", errors="replace")


def from_gguf(reader, native: bool = False) -> "SPMTokenizer | BPETokenizer":
    """The tokenizer a GGUFReader's metadata describes
    (tokenizer.ggml.model / tokens / scores / merges / *_token_id)."""
    md = reader.metadata
    model = md.get("tokenizer.ggml.model", "llama")
    tokens = list(md["tokenizer.ggml.tokens"])
    if model in ("llama", "spm"):
        scores = list(md.get("tokenizer.ggml.scores", [0.0] * len(tokens)))
        return SPMTokenizer(
            tokens, scores,
            bos_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
            eos_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
            unk_id=int(md.get("tokenizer.ggml.unknown_token_id", 0)),
            native=native,
        )
    if model in ("gpt2", "bpe"):
        return BPETokenizer(
            tokens, list(md.get("tokenizer.ggml.merges", [])),
            eos_id=md.get("tokenizer.ggml.eos_token_id"), native=native,
        )
    raise ValueError(f"unknown tokenizer model {model!r}")


def train_spm_vocab(text: str, size: int = 512):
    """Train a small SentencePiece-style vocabulary on ``text`` with BPE
    merges. Returns (tokens, scores) for SPMTokenizer: 3 specials
    (<unk>/<s>/</s>), 256 byte-fallback tokens, every character seen, then
    merges learned greedily over ▁-prefixed words until ``size`` tokens.
    Scores are -merge_rank, so SPMTokenizer.encode's greedy highest-score
    merge replays the merges in training order. It lets a model file carry
    a vocabulary without a pretrained one."""
    from collections import Counter

    words = Counter("▁" + w for w in text.split() if w)
    tokens = ["<unk>", "<s>", "</s>"]
    tokens += [f"<0x{b:02X}>" for b in range(256)]
    scores = [0.0] * len(tokens)
    for c in sorted({c for w in words for c in w}):
        tokens.append(c)
        scores.append(0.0)
    seqs = {w: list(w) for w in words}
    rank = 0
    while len(tokens) < size:
        pairs = Counter()
        for w, seq in seqs.items():
            n = words[w]
            for i in range(len(seq) - 1):
                pairs[(seq[i], seq[i + 1])] += n
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merged = a + b
        tokens.append(merged)
        rank += 1
        scores.append(-float(rank))
        for seq in seqs.values():
            i = 0
            while i < len(seq) - 1:
                if seq[i] == a and seq[i + 1] == b:
                    seq[i:i + 2] = [merged]
                else:
                    i += 1
    return tokens, scores
