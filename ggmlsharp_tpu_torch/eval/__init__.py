"""Evaluation (port of ggmlsharp_tpu/eval): perplexity and quantization
quality."""

from .perplexity import (compare_quantizers, logits_kl, nll_chunk,
                         perplexity, quantization_quality)

__all__ = ["compare_quantizers", "logits_kl", "nll_chunk", "perplexity",
           "quantization_quality"]
