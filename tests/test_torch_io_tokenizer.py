"""The port's tokenizers against the JAX package's, on the CPU: SPM and BPE
ids on the corpus and on fuzzed strings (unicode, byte fallback, empty and
whitespace-only text), decode(encode(s)) round trips, train_spm_vocab,
from_gguf on a JAX-written file, and the C++ encoder (``native=True``)
against the Python one. Ids must be equal, not close."""
import os
import random
from collections import Counter

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ggmlsharp_tpu.io import gguf as jgguf
from ggmlsharp_tpu.io import tokenizer as jtok
from ggmlsharp_tpu_torch.io import gguf, native, tokenizer

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "tiny_corpus.txt")
with open(CORPUS) as _f:
    TEXT = _f.read()
FUZZ = settings(max_examples=60, deadline=None, derandomize=True,
                database=None, suppress_health_check=[HealthCheck.too_slow])
# printable and not: ASCII, Latin-1, CJK, emoji, controls (no surrogates),
# and no '▁', which SPM maps to a space
CHARS = st.characters(blacklist_categories=("Cs",), blacklist_characters="▁")
TEXTS = st.one_of(st.text(CHARS, max_size=40),
                  st.text(st.sampled_from(" \t\n"), max_size=6),
                  st.text(st.sampled_from("the quick brown fox ç 日本 ü"),
                          max_size=30))


def _spm_vocab(size=400):
    return tokenizer.train_spm_vocab(TEXT[:8000], size=size)


def _bpe_vocab(n_merges=120):
    """A byte-level BPE vocabulary learned on the corpus: every mapped byte,
    then the most frequent adjacent pairs of GPT-2 pieces."""
    pieces = Counter(
        "".join(tokenizer._B2U[b] for b in p.encode("utf-8"))
        for p in tokenizer._GPT2_SPLIT.findall(TEXT[:8000]))
    seqs = {w: list(w) for w in pieces}
    tokens = sorted(set(tokenizer._B2U.values()))
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, seq in seqs.items():
            for i in range(len(seq) - 1):
                pairs[(seq[i], seq[i + 1])] += pieces[w]
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append(f"{a} {b}")
        tokens.append(a + b)
        for seq in seqs.values():
            i = 0
            while i < len(seq) - 1:
                if seq[i] == a and seq[i + 1] == b:
                    seq[i:i + 2] = [a + b]
                else:
                    i += 1
    return tokens, merges


SPM = _spm_vocab()
BPE = _bpe_vocab()
T_SPM = tokenizer.SPMTokenizer(*SPM)
J_SPM = jtok.SPMTokenizer(*SPM)
T_BPE = tokenizer.BPETokenizer(*BPE, eos_id=None)
J_BPE = jtok.BPETokenizer(*BPE)


def test_train_spm_vocab_matches_jax():
    for text, size in ((TEXT[:8000], 400), (TEXT, 700), ("", 300)):
        assert tokenizer.train_spm_vocab(text, size) == \
            jtok.train_spm_vocab(text, size)


@pytest.mark.parametrize("bos", [True, False])
def test_spm_ids_match_jax_on_the_corpus(bos):
    for lo in range(0, 6000, 1500):
        chunk = TEXT[lo:lo + 1500]
        assert T_SPM.encode(chunk, bos=bos) == J_SPM.encode(chunk, bos=bos)


def test_bpe_ids_match_jax_on_the_corpus():
    for lo in range(0, 6000, 1500):
        chunk = TEXT[lo:lo + 1500]
        assert T_BPE.encode(chunk) == J_BPE.encode(chunk)
        assert T_BPE.decode(T_BPE.encode(chunk)) == chunk


@FUZZ
@given(TEXTS)
def test_spm_ids_match_jax_fuzz(s):
    ids = T_SPM.encode(s)
    assert ids == J_SPM.encode(s)
    assert T_SPM.decode(ids) == J_SPM.decode(ids) == s


@FUZZ
@given(TEXTS)
def test_bpe_ids_match_jax_fuzz(s):
    ids = T_BPE.encode(s)
    assert ids == J_BPE.encode(s)
    assert T_BPE.decode(ids) == J_BPE.decode(ids) == s


def test_spm_byte_fallback_and_empty():
    ids = T_SPM.encode("日本\x00", bos=False)
    byte_ids = {T_SPM._bytes[b] for b in "日本\x00".encode("utf-8")}
    assert byte_ids <= set(ids) and T_SPM.decode(ids) == "日本\x00"
    assert T_SPM.encode("", bos=True) == J_SPM.encode("", bos=True)
    assert T_SPM.encode("", bos=False) == J_SPM.encode("", bos=False)


def test_from_gguf_reads_a_jax_written_file(tmp_path):
    """An SPM vocabulary (save_gguf_llama's keys) and a BPE one (gpt2 keys),
    both written by the JAX writer: the port builds the same tokenizer."""
    import jax.numpy as jnp

    w = jgguf.GGUFWriter()
    w.add_meta("tokenizer.ggml.model", 8, "llama")
    w.add_meta("tokenizer.ggml.tokens", 9, (8, SPM[0]))
    w.add_meta("tokenizer.ggml.scores", 9, (6, SPM[1]))
    w.add_meta("tokenizer.ggml.bos_token_id", 4, 1)
    w.add_meta("tokenizer.ggml.eos_token_id", 4, 2)
    w.add_tensor("dummy", np.asarray(jnp.zeros((2, 2), jnp.float32)))
    w.write(str(tmp_path / "spm.gguf"))
    w = jgguf.GGUFWriter()
    w.add_meta("tokenizer.ggml.model", 8, "gpt2")
    w.add_meta("tokenizer.ggml.tokens", 9, (8, BPE[0]))
    w.add_meta("tokenizer.ggml.merges", 9, (8, BPE[1]))
    w.add_meta("tokenizer.ggml.eos_token_id", 4, 5)
    w.add_tensor("dummy", np.zeros((2, 2), np.float32))
    w.write(str(tmp_path / "bpe.gguf"))
    for name, cls in (("spm", tokenizer.SPMTokenizer),
                      ("bpe", tokenizer.BPETokenizer)):
        path = str(tmp_path / f"{name}.gguf")
        t = tokenizer.from_gguf(gguf.GGUFReader(path))
        j = jtok.from_gguf(jgguf.GGUFReader(path))
        assert isinstance(t, cls)
        text = TEXT[:600]
        assert t.encode(text) == j.encode(text)
        assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    assert t.eos_id == 5


def test_spm_native_matches_python_fuzz():
    """The C++ SPM encoder (built from native/tokenize.cpp into the package's
    _build/) gives the Python greedy rescan's ids on fuzzed vocabularies and
    texts: multi-byte UTF-8, byte fallback, tied scores."""
    rng = random.Random(0)
    pieces = ["a", "b", "c", "▁", "ab", "bc", "abc", "▁a", "▁ab", "ç", "aç",
              "日", "本", "日本", "e", "he", "hello", "▁the", "th", "the"]
    texts = ["hello abc", "the quick ç brown 日本", "aaaa bbbb abab",
             "▁already prefixed", "日本日本日本", "", "   spaces   ",
             "mixed日本and ascii ç end", TEXT[:2000]]
    for trial in range(20):
        vocab = ["<unk>", "<s>", "</s>"] + \
            rng.sample(pieces, rng.randint(5, len(pieces))) + \
            [f"<0x{b:02X}>" for b in range(256)]
        scores = [0.0] * 3 + [
            round(rng.choice([-1.0, -2.0, -2.0, -3.0, rng.uniform(-9, 0)]), 3)
            for _ in range(len(vocab) - 259)] + [-20.0] * 256
        nat = tokenizer.SPMTokenizer(list(vocab), list(scores), native=True)
        py = tokenizer.SPMTokenizer(list(vocab), list(scores))
        for text in texts:
            assert nat.encode(text) == py.encode(text), (trial, text)
    nat = tokenizer.SPMTokenizer(*SPM, native=True)
    assert nat.encode(TEXT[:6000]) == T_SPM.encode(TEXT[:6000])


def test_bpe_native_matches_python_fuzz():
    rng = random.Random(3)
    singles = sorted(set(tokenizer._B2U.values()))
    for trial in range(10):
        extras = ["he", "hel", "ll", "llo", "lo", "the", "th", "ab", "abc"]
        picked = rng.sample(extras, rng.randint(3, len(extras)))
        merges = [m for m in ["h e", "he l", "l l", "ll o", "l o", "t h",
                              "th e", "a b", "ab c"]
                  if "".join(m.split(" ", 1)) in picked]
        rng.shuffle(merges)
        nat = tokenizer.BPETokenizer(singles + picked, merges, native=True)
        py = tokenizer.BPETokenizer(singles + picked, merges)
        for text in ["hello the abc", "abcabc ll o", "the the he",
                     "xyzzy hello", ""]:
            assert nat.encode(text) == py.encode(text), (trial, text)
    nat = tokenizer.BPETokenizer(*BPE, native=True)
    assert nat.encode(TEXT[:6000]) == T_BPE.encode(TEXT[:6000])


def test_native_never_falls_back(monkeypatch):
    """native=True with no library to be had: encoding raises; the Python
    encoder stays the default and needs no library."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", "/nonexistent/tokenize.cpp")
    with pytest.raises(RuntimeError, match="missing"):
        tokenizer.SPMTokenizer(*SPM, native=True).encode("hello")
    with pytest.raises(RuntimeError, match="missing"):
        tokenizer.BPETokenizer(*BPE, native=True).encode("hello")
    assert tokenizer.SPMTokenizer(*SPM).encode("hello") == \
        J_SPM.encode("hello")


def test_tokenizer_available_matches_jax():
    """io.native.tokenizer_available(): the library builds and loads here,
    in both packages."""
    from ggmlsharp_tpu.io import native as jnative

    assert native.tokenizer_available() is jnative.tokenizer_available() \
        is True


def test_tokenizer_available_is_false_without_a_library(monkeypatch):
    """No source to build from: False, not an exception."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", "/nonexistent/tokenize.cpp")
    assert native.tokenizer_available() is False


def test_native_library_is_built_not_loaded_prebuilt():
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libtokenize-")
