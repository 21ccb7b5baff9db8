"""Continuous-batching serving over the port's models (port of
ggmlsharp_tpu/serving without speculative mode and without a mesh)."""
from .engine import Engine, Request
from .server import EngineServer

__all__ = ["Engine", "EngineServer", "Request"]
