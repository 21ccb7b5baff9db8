"""The perplexity chain (port of scripts/ppl_chain.py:45-189, the functions;
the command line is scripts/ppl_chain_torch.py): train a small Llama on a
corpus, write it as a GGUF with its vocabulary, reload it and re-tokenize
from the file, and score held-out perplexity at fp32 and in Q8_0, Q4_0,
Q4_K and Q6_K, with and without activation rounding for Q4_0 and Q4_K.

  * ``tokenize``: ``train_spm_vocab`` over the text, its SPM encoder (the
    C++ merge loop: the Python one takes minutes on the chain's corpus);
  * ``split``: the first third of the ids trains, the rest is held out;
    the train split is cut into S-token chunks (teacher-forced inputs and
    targets);
  * ``train``: full-batch Adam (``optim.opt_adam``, alpha 3e-3, no stopping
    rule) over the mean next-token NLL of every chunk at once
    (``models.common.lm_loss``: one forward of all chunks over a fresh f32
    cache);
  * ``save_and_reload``: ``save_gguf_llama`` with the tokenizer,
    ``load_gguf_llama`` and ``tokenizer_from_gguf``; the file's vocabulary
    must re-tokenize the corpus exactly;
  * ``score``: ``eval.perplexity`` of the held-out ids in S-token windows
    at fp32 and for each format (``llama.quantize_params``: only weights
    whose rows are whole 256-element groups are quantized, so at 192
    features only ``w_down`` is), ``-noQA`` rows with
    ``GGML_TPU_QUANT_ACTS`` off;
  * ``write_doc``: the table, in docs/PPL_CHAIN.md's layout.

Everything runs on the parameters' device: on the card the prefill and the
training forward go through the flash kernel, the quantized ``w_down``
through the dequant-matmuls' multi-row instances.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..device import resolve_device
from ..dtypes import GType
from ..io import (GGUFReader, SPMTokenizer, load_gguf_llama, save_gguf_llama,
                  tokenizer_from_gguf, train_spm_vocab)
from ..models import llama
from ..models.common import lm_loss
from ..optim import AdamParams, OptParams, opt_adam, value_and_grad
from .perplexity import perplexity

CORPUS_SEED = 20260820  # scripts/ppl_chain.py's make_text seed
S = 128  # chunk length of training and scoring
SIZES = {"tiny": (2, 128, 4, 256), "small": (4, 192, 6, 512)}
FORMATS = [("Q8_0", GType.Q8_0), ("Q4_0", GType.Q4_0), ("Q4_K", GType.Q4_K),
           ("Q6_K", GType.Q6_K)]
QA_AB = ("Q4_0", "Q4_K")  # formats scored again without activation rounding
ORDER = ["Q8_0", "Q4_0", "Q4_0-noQA", "Q4_K", "Q4_K-noQA", "Q6_K"]


def tokenize(text: str, vocab_size: int):
    """(tokenizer, ids int32): a vocabulary trained on ``text`` and the
    text's ids under it."""
    tokens, scores = train_spm_vocab(text, size=vocab_size)
    tk = SPMTokenizer(tokens, scores, native=True)
    return tk, np.asarray(tk.encode(text), np.int32)


def split(ids, chunk: int = S):
    """(train chunks int32 [n, chunk + 1], train length): the first third
    of ``ids`` in ``chunk``-token windows, each with its next token (inputs
    toks[:, :-1], targets toks[:, 1:], as lm_loss takes them)."""
    half = len(ids) // 3
    n = (half - 1) // chunk
    rows = np.stack([ids[i * chunk:(i + 1) * chunk + 1] for i in range(n)])
    return rows.astype(np.int32), half


def model_config(n_vocab: int, size: str = "small") -> llama.LlamaConfig:
    n_layer, n_embd, n_head, n_ff = SIZES[size]
    return llama.LlamaConfig(n_vocab=n_vocab, n_ctx=256, n_embd=n_embd,
                             n_head=n_head, n_head_kv=n_head,
                             n_layer=n_layer, n_ff=n_ff)


def train(cfg, toks, params, steps: int, alpha: float = 3e-3,
          callback=None):
    """Full-batch Adam on the teacher-forced NLL of every chunk of toks
    [n, S + 1] (on params' device). Returns (params, final nll, OptResult,
    iterations)."""
    op = OptParams(adam=AdamParams(alpha=alpha, n_iter=steps), past=0,
                   max_no_improvement=0)
    return opt_adam(value_and_grad(lambda p: lm_loss(llama.forward, cfg, p,
                                                     toks)),
                    params, op, callback)


def save_and_reload(path: str, cfg, params, tk, text: str, ids, device):
    """Write cfg, params and tk's vocabulary to one GGUF, load it onto
    ``device`` and re-tokenize ``text`` from the file's vocabulary; raises
    unless the ids equal ``ids``. Returns (cfg, params, ids) as loaded."""
    save_gguf_llama(path, cfg, params, tokenizer=tk)
    cfg2, params2 = load_gguf_llama(path, device=device)
    tk2 = tokenizer_from_gguf(GGUFReader(path), native=True)
    ids2 = np.asarray(tk2.encode(text), np.int32)
    if not np.array_equal(ids2, ids):
        raise ValueError(f"{path}: the GGUF vocabulary does not round-trip "
                         f"the corpus")
    return cfg2, params2, ids2


def score(cfg, params, heldout, chunk: int = S, formats=FORMATS,
          qa_ab=QA_AB, log=None):
    """Held-out perplexity at fp32 and in each format. Returns
    {"fp32": (ppl, n_scored), name: ppl, name + "-noQA": ppl}: the
    formats' rows with activation rounding as configured (on by default),
    the ``-noQA`` rows of ``qa_ab`` with it off."""
    ppl_fp, _, n = perplexity(llama.forward, cfg, params, heldout,
                              chunk_len=chunk)
    out = {"fp32": (ppl_fp, n)}
    if log:
        log(f"fp32 heldout ppl={ppl_fp:.4f} ({n} scored)")
    for name, gt in formats:
        qp = llama.quantize_params(params, gt, cfg=cfg)
        out[name], _, _ = perplexity(llama.forward, cfg, qp, heldout,
                                     chunk_len=chunk)
        if log:
            log(f"{name} ppl={out[name]:.4f} dppl={out[name] - ppl_fp:+.4f}")
        if name in qa_ab:
            with config.activation_rounding(False):
                p2, _, _ = perplexity(llama.forward, cfg, qp, heldout,
                                      chunk_len=chunk)
            out[name + "-noQA"] = p2
            if log:
                log(f"{name} noQA ppl={p2:.4f} dppl={p2 - ppl_fp:+.4f}")
    return out


def run_seed(seed: int, cfg, toks, steps: int, tk, text: str, ids,
             gguf_path: str, device=None, log=None):
    """One seed of the chain on ``device`` (the card unless the caller asks
    for the CPU): init from ``seed``, train, write, reload, score. Returns
    {"seed", "nll_start", "nll", "result", "iters", "train_s", "scores"}."""
    import time

    dev = resolve_device(device)
    params = llama.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                               device=dev, dtype=torch.float32)
    toks_t = torch.as_tensor(toks, device=dev)
    losses = []
    t0 = time.perf_counter()
    params, f, res, it = train(cfg, toks_t, params, steps,
                               callback=lambda i, fi: losses.append(fi))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    if log:
        log(f"trained {it} iters -> train nll={f:.3f} in {train_s:.1f} s "
            f"[{res.name}]")
    _, half = split(ids)
    cfg2, params2, ids2 = save_and_reload(gguf_path, cfg, params, tk, text,
                                          ids, dev)
    scores = score(cfg2, params2, ids2[half:], log=log)
    return {"seed": seed, "nll_start": losses[0], "nll": f,
            "result": res.name, "iters": it, "train_s": train_s,
            "scores": scores}


def dppl_table(runs) -> dict:
    """{row name: [dppl of each run]} in ORDER."""
    return {name: [r["scores"][name] - r["scores"]["fp32"][0] for r in runs]
            for name in ORDER if name in runs[0]["scores"]}


def write_doc(path: str, runs, n_sent: int, size: str, steps: int,
              n_vocab: int, card: str, wall_s: float, command: str):
    """docs/PPL_CHAIN.md's layout for the port's run, with the card."""
    n_layer, n_embd, _, n_ff = SIZES[size]
    fp = np.asarray([r["scores"]["fp32"][0] for r in runs])
    nll = [r["nll"] for r in runs]
    n_scored = runs[0]["scores"]["fp32"][1]
    with open(path, "w") as fh:
        fh.write(
            "# Perplexity chain of the PyTorch/CUDA port (held-out, "
            "multi-seed, measured end to end)\n\n"
            f"Full pipeline on the deterministic corpus "
            f"(`scripts/gen_corpus.make_text({n_sent})`, the first third "
            "trains, the rest is held out):\nthe port's Adam "
            "(`optim.opt_adam`, full batch) on the train split -> "
            "`io.save_gguf_llama` (weights + SPM vocab in one file) ->\n"
            "`io.load_gguf_llama` + `io.tokenizer_from_gguf` -> re-tokenize "
            "from the file's vocab (exact) ->\n`eval.perplexity` on the "
            "HELD-OUT ids. Regenerate: "
            f"`{command}`.\n\n"
            f"Card: {card}. Wall time of the run: {wall_s:.0f} s "
            f"(training {min(r['train_s'] for r in runs):.1f}-"
            f"{max(r['train_s'] for r in runs):.1f} s a seed).\n\n"
            f"Model: llama {n_layer}L/{n_embd}E/{n_ff}F, vocab {n_vocab}; "
            f"{len(runs)} seeds x {steps} full-batch Adam iters (train nll "
            f"{min(nll):.3f}-{max(nll):.3f}, from "
            f"{min(r['nll_start'] for r in runs):.3f}-"
            f"{max(r['nll_start'] for r in runs):.3f}); heldout ppl fp32 "
            f"{fp.mean():.3f} +/- {fp.std():.3f}; {n_scored} scored tokens "
            "per eval.\n\n"
            "| Params | dppl vs fp32 (mean of seeds) | spread "
            "(min..max) |\n|---|---|---|\n")
        for name, v in dppl_table(runs).items():
            v = np.asarray(v)
            fh.write(f"| {name} | {v.mean():+.4f} | "
                     f"{v.min():+.4f} .. {v.max():+.4f} |\n")
        fh.write(
            f"\nOnly `w_down` is quantized: `llama.quantize_params` (as the "
            f"JAX package's) quantizes a weight only when its rows are whole "
            f"256-element groups, and at {n_embd} features every other "
            f"matrix has K = {n_embd}; `w_down` (K = {n_ff}) is the one "
            "left, so each row prices one matrix a block. `-noQA` rows run "
            "the same quantized weights with `GGML_TPU_QUANT_ACTS=0` "
            "(weight-only). The corpus is synthetic, so absolute ppl is not "
            "WikiText-2's. The JAX package's CPU record of the same chain "
            "(25 iterations) is `docs/PPL_CHAIN.md`.\n")
