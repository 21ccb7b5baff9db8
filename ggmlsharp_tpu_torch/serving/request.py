"""The serving Request record and its stop predicate (port of
ggmlsharp_tpu/serving/request.py; torch-free)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Request:
    id: int
    prompt: list
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repeat_penalty: float = 1.0
    repeat_last_n: int = 64
    eos_id: int | None = None
    stop: list | None = None  # stop sequences: list of token-id lists
    prefix_id: int | None = None  # Engine.register_prefix handle
    on_token: object = None  # streaming callback: on_token(req, token)
    want_logprobs: bool = False  # fill out_logprobs
    out_tokens: list = field(default_factory=list)
    out_logprobs: list = field(default_factory=list)
    done: bool = False
    error: str | None = None
    # latency instrumentation (engine-stamped, perf_counter seconds)
    t_submit: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None


def _stopped(req: Request) -> bool:
    """True when the output ends with eos or any stop sequence."""
    if req.out_tokens and req.eos_id is not None \
            and req.out_tokens[-1] == req.eos_id:
        return True
    for seq in req.stop or ():
        n = len(seq)
        if n and len(req.out_tokens) >= n \
                and req.out_tokens[-n:] == list(seq):
            return True
    return False
