"""Model and tensor IO (port of ggmlsharp_tpu/io): GGUF import and export,
HF safetensors import, checkpoints and tokenizers. Loaders put tensors on
the card unless the caller passes ``device="cpu"``.

Not ported yet: the orbax checkpoint pair (it waits for the parallel
layer). The JAX package's wire -> TPU plane repacking has no counterpart.
"""

from .checkpoint import load_checkpoint, save_checkpoint
from .gguf import (GGUFReader, GGUFWriter, load_gguf_gptj, load_gguf_llama,
                   qtensor_from_wire, qtensor_to_wire, save_gguf_gptj,
                   save_gguf_llama)
from .hf import load_hf_gpt2, load_hf_gptj, load_hf_llama, read_safetensors
from .tokenizer import BPETokenizer, SPMTokenizer, train_spm_vocab
from .tokenizer import from_gguf as tokenizer_from_gguf

__all__ = [
    "BPETokenizer",
    "GGUFReader",
    "GGUFWriter",
    "load_checkpoint",
    "load_gguf_gptj",
    "load_gguf_llama",
    "load_hf_gpt2",
    "load_hf_gptj",
    "load_hf_llama",
    "qtensor_from_wire",
    "qtensor_to_wire",
    "read_safetensors",
    "save_checkpoint",
    "save_gguf_gptj",
    "save_gguf_llama",
    "SPMTokenizer",
    "tokenizer_from_gguf",
    "train_spm_vocab",
]
