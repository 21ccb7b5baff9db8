from . import common, gpt2, gptj, kv_cache, llama, sampling, speculative
from .kv_cache import KVCache, init_cache

__all__ = ["KVCache", "common", "gpt2", "gptj", "init_cache", "kv_cache",
           "llama", "sampling", "speculative"]
