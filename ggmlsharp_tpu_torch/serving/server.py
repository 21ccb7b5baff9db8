"""HTTP front end for the continuous-batching Engine (stdlib only; port of
ggmlsharp_tpu/serving/server.py):

    POST /v1/generate   {"prompt": [ids], "max_new_tokens": 32,
                         "temperature": 0.7, "top_k": 40, "top_p": 0.9,
                         "repeat_penalty": 1.1, "eos_id": 2,
                         "prefix_id": 0}
        -> {"id": N, "tokens": [...], "error": null}   (blocks until done)
        Pass "stream": true for chunked NDJSON (one token a line), and
        "request_id" (any string or int) to make the request cancellable;
        streaming responses emit {"id": ...} first. With a tokenizer
        (EngineServer(..., tokenizer=...)), "text" may replace "prompt"
        and responses carry decoded "text"; without one a "text" request
        is answered 400.
    POST /v1/cancel     {"id": N} or {"request_id": X} -> {"cancelled": bool}
    GET  /v1/stats      -> Engine.stats() + uptime
    GET  /health        -> {"ok": true}

Threading model: ALL torch work happens on ONE background tick thread (the
engine loop); HTTP handler threads only append to the submission queue,
flag cancellations and wait on per-request events.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .engine import Request


class EngineServer:
    """Runs an Engine on a background tick thread and serves HTTP."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8080,
                 tokenizer=None):
        self.engine = engine
        self.tokenizer = tokenizer  # any object with encode/decode
        self.host, self.port = host, port
        self._lock = threading.Lock()  # guards engine.pending/cancel
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, Request] = {}
        self._public: dict = {}  # client request_id → engine rid
        self._next_id = 0
        self._stop = threading.Event()
        self._t0 = time.time()
        self._tick_thread = threading.Thread(target=self._loop, daemon=True)
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self.port = self._httpd.server_address[1]  # resolved when port=0

    # --- engine loop (the ONLY thread touching torch) ----------------------
    def _loop(self):
        while not self._stop.is_set():
            with self._lock:
                busy = self.engine.pending or any(
                    s is not None for s in self.engine.slots)
                if busy:
                    try:
                        self.engine.step_once()
                    except Exception as e:  # keep the server alive: fail
                        # every in-flight request instead of zombieing all
                        # blocked handler threads (the tick thread is the
                        # only one that can unblock them)
                        for r in (self.engine.pending
                                  + [x for x in self.engine.slots
                                     if x is not None]):
                            r.done, r.error = True, f"engine error: {e!r}"
                            self.engine.finished.append(r)
                        self.engine.pending.clear()
                        self.engine.slots = [None] * self.engine.B
                done, self.engine.finished = self.engine.finished, []
            for req in done:
                self._results[req.id] = req
                self._public.pop(getattr(req, "_public_id", None), None)
                ev = self._events.pop(req.id, None)
                if ev is not None:
                    ev.set()
            if not busy:
                self._stop.wait(0.005)

    def submit(self, body: dict, on_token=None, rid_box=None) -> Request:
        """Enqueue a request from a handler thread; block until finished.
        on_token(req, tok) is fired from the tick thread per token;
        rid_box (a list) receives the engine id before the wait."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            if rid_box is not None:
                rid_box.append(rid)
            req = Request(
                id=rid,
                prompt=list(body["prompt"]),
                max_new_tokens=int(body.get("max_new_tokens", 64)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                repeat_penalty=float(body.get("repeat_penalty", 1.0)),
                repeat_last_n=int(body.get("repeat_last_n", 64)),
                eos_id=body.get("eos_id"),
                stop=body.get("stop"),
                prefix_id=body.get("prefix_id"),
                on_token=on_token,
                want_logprobs=bool(body.get("logprobs", False)),
            )
            pub = body.get("request_id")
            if pub is not None:
                self._public[pub] = rid
                req._public_id = pub
            ev = threading.Event()
            self._events[rid] = ev
            self.engine.submit(req)
        ev.wait()
        return self._results.pop(rid)

    def cancel(self, rid) -> bool:
        """Cancel by engine id or client request_id, by flag only (no torch
        work on handler threads; the tick thread frees the slot and
        finishes the request on its next pass)."""
        with self._lock:
            rid = self._public.get(rid, rid)
            for r in self.engine.pending:
                if r.id == rid:
                    r.done, r.error = True, "cancelled"
                    self.engine.pending.remove(r)
                    self.engine._finished(r)
                    return True
            for r in self.engine.slots:
                if r is not None and r.id == rid and not r.done:
                    r.done, r.error = True, "cancelled"
                    return True
            # pre-admitted behind an in-flight window (not in slots until
            # the drain): still logically live — flag it (engine drain
            # finishes it with the cancelled error)
            r = self.engine._inflight_pre.get(rid)
            if r is not None and not r.done:
                r.done, r.error = True, "cancelled"
                return True
        return False

    # --- http ---------------------------------------------------------------
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer-encoding does not exist in HTTP/1.0; every
            # response carries Content-Length or proper chunk framing
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/health":
                    return self._json(200, {"ok": True})
                if self.path == "/v1/stats":
                    st = server.engine.stats()
                    st["uptime_s"] = round(time.time() - server._t0, 3)
                    return self._json(200, st)
                return self._json(404, {"error": "not found"})

            def _stream(self, body: dict):
                """Chunked NDJSON: one {"token": t} line per emitted token
                (pushed from the tick thread via on_token), then a final
                {"done": true, ...} line."""
                import queue

                q: "queue.Queue" = queue.Queue()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = json.dumps(obj).encode() + b"\n"
                    self.wfile.write(
                        f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()

                done_box, rid_box = [], []

                def waiter():
                    try:
                        done_box.append(server.submit(
                            body, on_token=lambda r, t: q.put(t),
                            rid_box=rid_box))
                    finally:
                        q.put(None)  # sentinel: ALWAYS unblock the reader

                t = threading.Thread(target=waiter, daemon=True)
                t.start()
                first = True
                while True:
                    tok = q.get()
                    if tok is None:
                        break
                    if first:  # engine id first, so clients can cancel
                        first = False
                        chunk({"id": rid_box[0]})
                    chunk({"token": tok})
                t.join()
                if not done_box:  # submit raised (malformed body)
                    chunk({"done": True, "error": "bad request"})
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                    return
                req = done_box[0]
                fin = {"done": True, "id": req.id, "tokens": req.out_tokens,
                       "error": req.error}
                if server.tokenizer is not None:
                    fin["text"] = server.tokenizer.decode(req.out_tokens)
                chunk(fin)
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "bad json"})
                if self.path == "/v1/generate":
                    if isinstance(body.get("text"), str):
                        if server.tokenizer is None:
                            return self._json(400, {
                                "error": "no tokenizer configured; send "
                                         "'prompt' as a token list"})
                        body["prompt"] = server.tokenizer.encode(
                            body.pop("text"))
                        if body.get("eos_id") is None:
                            body["eos_id"] = getattr(
                                server.tokenizer, "eos_id", None)
                    pr = body.get("prompt")
                    if not isinstance(pr, list) or not all(
                            isinstance(t, int) and not isinstance(t, bool)
                            for t in pr):
                        return self._json(
                            400, {"error": "prompt must be a list of ints"})
                    if body.get("stream"):
                        return self._stream(body)
                    req = server.submit(body)
                    out = {
                        "id": req.id,
                        "tokens": req.out_tokens,
                        "error": req.error,
                    }
                    if req.want_logprobs:
                        out["logprobs"] = req.out_logprobs
                    if server.tokenizer is not None:
                        out["text"] = server.tokenizer.decode(req.out_tokens)
                    return self._json(200, out)
                if self.path == "/v1/cancel":
                    handle = body.get("request_id",
                                      body.get("id", -1))
                    return self._json(
                        200, {"cancelled": server.cancel(handle)})
                return self._json(404, {"error": "not found"})

        return Handler

    def start(self):
        self._tick_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._http_thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._tick_thread.join(timeout=5)
