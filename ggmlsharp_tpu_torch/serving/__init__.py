"""Continuous-batching serving over the port's models (port of
ggmlsharp_tpu/serving, speculative mode included, without a device mesh)."""
from .engine import Engine, Request
from .server import EngineServer

__all__ = ["Engine", "EngineServer", "Request"]
