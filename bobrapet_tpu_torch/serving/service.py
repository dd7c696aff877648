"""StreamServer: the serving engine behind a step's stream.

The port's copy of ``bobrapet_tpu/serving/service.py``, with the same wire
shapes. Prompts arrive on the step's input stream, flow through the
continuous-batching engine, and completions leave on the downstream
stream. Requests batch across stream messages: a prompt that arrives
mid-decode joins the next engine tick.

Threading: the consumer thread only parks raw messages on a queue; the
serve loop alone touches the engine, its CUDA graphs and the token pick.
EOS on the input stream drains the requests in flight, emits their
completions, then closes downstream.

**One serve loop a card.** The pick kernel keeps one static scratch a card
(``csrc/pick_tokens.cu``), so it is not re-entrant: every engine on one
card must be stepped from one thread. A :class:`~.router.ServingRouter`
steps its engines in turn from its own loop, which is how several engines
share a card; never run two serve loops on one card at once.

The ``engine`` may equally be a :class:`~.router.ServingRouter`: it
duck-types the surface this loop consumes (``submit``/``step``/
``finished``/``active_slots``/``pending``).

Wire shapes (JSON over the stream frames):

    in:  {"id": <any>, "prompt": [int], "maxNewTokens": int,
          "temperature"?: float, "eos"?: int, "tenant"?: str,
          "trace"?: {"traceId": str, "spanId"?: str}}   # accepted, unread
    out: {"id": <any>, "tokens": [int], "preemptions": int,
          "prefilled"?: true}   # prefill-role engine with no router
    err: {"id": <any>, "error": str}
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any

from .engine import ServingEngine

_log = logging.getLogger(__name__)


#: input-EOS marker — a dedicated object so a client sending JSON
#: ``null`` cannot forge end-of-stream
_EOS = object()


class StreamServer:
    def __init__(self, engine: "ServingEngine | Any", consumer, producer,
                 idle_wait_s: float = 0.01):
        self.engine = engine
        self.consumer = consumer
        self.producer = producer
        self.idle_wait_s = idle_wait_s
        self._inbox: "queue.Queue[Any]" = queue.Queue()
        self._rid_to_id: dict[int, Any] = {}
        self.served = 0

    # -- consumption (thread) ---------------------------------------------

    def _consume(self) -> None:
        try:
            for msg in self.consumer:
                self._inbox.put(msg)
        except Exception as e:  # noqa: BLE001 - stream died; drain + stop
            _log.warning("serving input stream failed: %s", e)
        finally:
            self._inbox.put(_EOS)

    def _admit_from_inbox(self, block: bool) -> bool:
        """Move queued messages into the engine; returns False once the
        input stream has ended."""
        while True:
            try:
                msg = self._inbox.get(
                    timeout=self.idle_wait_s if block else 0.0
                )
            except queue.Empty:
                return True
            if msg is _EOS:
                return False
            block = False  # only ever block for the first message
            if not isinstance(msg, dict):
                # any JSON value decodes (list/str/null) — answer
                # in-band, never crash the batch
                self.producer.send({"id": None,
                                    "error": f"request must be an object, "
                                             f"got {type(msg).__name__}"})
                continue
            try:
                raw_max = msg.get("maxNewTokens")
                rid = self.engine.submit(
                    [int(t) for t in msg["prompt"]],
                    # sentinel, not `or`: an explicit 0 must reach the
                    # engine's validation, not silently become 32
                    max_new_tokens=32 if raw_max is None else int(raw_max),
                    temperature=float(msg.get("temperature") or 0.0),
                    eos_token=(int(msg["eos"]) if msg.get("eos") is not None
                               else None),
                    adapter=(int(msg["adapter"])
                             if msg.get("adapter") is not None else None),
                    tenant=str(msg.get("tenant") or ""),
                )
                self._rid_to_id[rid] = msg.get("id")
            except (KeyError, TypeError, ValueError) as e:
                # a malformed request answers in-band; the batch lives on
                self.producer.send({"id": msg.get("id"), "error": str(e)})

    # -- serve loop --------------------------------------------------------

    def run(self) -> int:
        """Serve until input EOS and every in-flight request finishes;
        returns the number of completions emitted."""
        t = threading.Thread(target=self._consume, daemon=True,
                             name="serving-consume")
        t.start()
        emitted = 0  # finished[] index already sent downstream
        open_input = True
        try:
            emitted = self._serve_loop(open_input, emitted)
        finally:
            # downstream consumers must see EOS even when the loop dies
            # (a hung consumer is worse than a truncated stream error)
            try:
                self.producer.close()
            except Exception:  # noqa: BLE001 - socket already gone
                pass
        return self.served

    def _busy(self) -> bool:
        """Prefer the engine's own ``busy`` when it has one (the router
        exposes it precisely because materializing its combined pending
        tuple per poll is allocation churn); fall back to the classic
        slots+pending check for the bare engine."""
        busy = getattr(self.engine, "busy", None)
        if busy is not None:
            return bool(busy)
        return self.engine.active_slots > 0 or bool(self.engine.pending)

    def _serve_loop(self, open_input: bool, emitted: int) -> int:
        while True:
            if open_input:
                # block briefly only when the engine would otherwise
                # spin empty — a busy engine polls without waiting
                open_input = self._admit_from_inbox(block=not self._busy())
            # busy is judged AFTER admission: a request admitted in the
            # same tick that closed the input must still be served
            if (not open_input and not self._busy()
                    and emitted == len(self.engine.finished)):
                break
            self.engine.step()
            # emit every newly finished request, in completion order
            while emitted < len(self.engine.finished):
                req = self.engine.finished[emitted]
                emitted += 1
                out = {
                    "id": self._rid_to_id.pop(req.rid, None),
                    "tokens": list(req.output),
                    "preemptions": req.preemptions,
                }
                if req.prefilled:
                    # a prefill-role engine served WITHOUT a router in
                    # front: the output is the prefill product (first
                    # token only), not a full completion — flag it so
                    # downstream can tell truncation from completion
                    out["prefilled"] = True
                self.producer.send(out)
                self.served += 1
        return emitted
