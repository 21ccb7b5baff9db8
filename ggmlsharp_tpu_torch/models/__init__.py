from . import common, gpt2, kv_cache, llama, sampling

__all__ = ["common", "gpt2", "kv_cache", "llama", "sampling"]
