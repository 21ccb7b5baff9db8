from . import common, gpt2, kv_cache, llama, sampling
from .kv_cache import KVCache, init_cache

__all__ = ["KVCache", "common", "gpt2", "init_cache", "kv_cache", "llama",
           "sampling"]
