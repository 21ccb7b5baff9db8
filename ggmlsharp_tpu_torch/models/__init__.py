from . import common, kv_cache, llama, sampling

__all__ = ["common", "kv_cache", "llama", "sampling"]
