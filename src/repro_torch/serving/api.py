"""Session-oriented streaming front-end over the continuous batcher.

The port's copy of ``repro.serving.api``; ``snapshot``/``restore``
publish through the port's ``distributed.fault_tolerance``.

DESIGN.md §13: the request-level surface the examples, the load harness
(`serving/loadgen.py`), and `launch/serve.py` sit on. The batcher speaks
integer uids and returns finished token lists per step; this module wraps
it with the schema shape serving clients actually need (deepsparse's
``TextGenerationPipeline`` input/output schemas are the exemplar):

* **Typed request/response** — :class:`GenerationRequest` in,
  :class:`GenerationResponse` out, joined by a string ``session_id``
  (caller-chosen or auto-assigned; duplicates among *live* sessions are
  rejected, finished ids may be reused).
* **Per-token streaming** — a request's ``on_token`` callback fires once
  per generated token as server steps complete, each with a
  :class:`TokenEvent` carrying the token, its index, and — on the last
  event — the finish reason. Tokens are delivered exactly once per index,
  in order, even across preemption (a preempted request's re-prefill
  regenerates its identical stream; only tokens beyond the delivered
  watermark produce events).
* **Cancellation** — :meth:`StreamingServer.cancel` works in every live
  state (queued, mid-prefill admission, actively decoding, preempted);
  slot and KV-block state is released immediately and the pool stays
  invariant-clean (`tests/test_serving_api.py`). The response (and the
  final token event) report ``finish_reason="cancelled"``.
* **Backpressure** — :meth:`StreamingServer.submit` raises
  :class:`Backpressure` once ``max_queue`` sessions are waiting for
  admission, carrying the queue depth and the pool's free-block count so
  callers can shed or retry; the open-loop load generator records these
  as rejections. A rejected submit leaves zero residual state. (Admission
  itself still gates on block availability *inside* the batcher — the
  queue bound is the knob that turns that internal stall into an external
  signal instead of unbounded buffering.)

The server is a cooperative loop, not a thread: callers (or the loadgen
replay harness) interleave ``submit`` / ``cancel`` with ``step`` calls;
each ``step`` runs one engine step and returns the sessions that finished
in it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.distributed.fault_tolerance import SnapshotStore
from repro_torch.serving.batching import ContinuousBatcher
from repro_torch.serving.config import (SchedulerConfig, ServeConfig,
                                  SLOAttainment, SLOSpec)


class Backpressure(RuntimeError):
    """Raised by submit when the server is shedding load — the admission
    queue is full (``reason="queue_full"``) or the degradation ladder hit
    its top rung (``reason="shed"``).

    Carries what a shedding/retry policy needs: how many sessions are
    already waiting (``queue_depth`` vs ``max_queue``), how many KV blocks
    the pool could currently offer (``blocks_available``; None for the
    dense cache, which admits on free slots alone), and ``retry_after_s``
    — the server's estimate of when a slot frees, derived from the recent
    queue drain rate (None until enough sessions have finished to measure
    one).
    """

    def __init__(self, queue_depth: int, max_queue: Optional[int],
                 blocks_available: Optional[int],
                 retry_after_s: Optional[float] = None,
                 reason: str = "queue_full"):
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        self.blocks_available = blocks_available
        self.retry_after_s = retry_after_s
        self.reason = reason
        hint = (f"; retry after ~{retry_after_s:.2f}s"
                if retry_after_s is not None else "")
        if reason == "shed":
            msg = (f"server shedding load (degraded; {queue_depth} "
                   f"waiting{hint})")
        else:
            msg = (f"admission queue full ({queue_depth}/{max_queue} waiting"
                   + (f", {blocks_available} KV blocks free"
                      if blocks_available is not None else "") + hint + ")")
        super().__init__(msg)


class RequestRejected(ValueError):
    """A request the server can never run (malformed prompt, uid overflow,
    or a prompt+budget the KV pool cannot hold to completion). Submit
    validates before mutating anything, so rejection leaves no state."""


@dataclasses.dataclass
class GenerationRequest:
    """One generation call. ``session_id`` is the caller's handle for
    streaming and cancellation (auto-assigned when None); ``on_token``
    streams tokens as they are generated. The deadlines are latency
    budgets on the server's clock: miss the TTFT budget before the first
    token, or the total budget at any point, and the session ends with
    ``finish_reason="deadline"`` (tokens generated so far are kept).

    ``slo`` is the typed superset (DESIGN.md §16): soft TTFT/TPOT targets
    that steer chunked-prefill scheduling and are scored per class, plus
    the same hard deadlines. Give either ``slo`` or the legacy flat
    deadline fields, not both — mixing is rejected before any state."""

    prompt: np.ndarray
    max_new_tokens: int
    session_id: Optional[str] = None
    on_token: Optional[Callable[["TokenEvent"], None]] = None
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    slo: Optional[SLOSpec] = None


@dataclasses.dataclass
class TokenEvent:
    """One streamed token. ``index`` counts from 0 within the session;
    ``finish_reason`` is non-empty exactly on the session's last event,
    and ``attainment`` rides along with it when the request carried SLO
    targets (so streaming clients see met/missed without waiting for the
    response object)."""

    session_id: str
    token: int
    index: int
    finish_reason: str = ""
    attainment: Optional[SLOAttainment] = None


@dataclasses.dataclass
class GenerationResponse:
    """A finished (or cancelled) session: every generated token (stop
    token included, matching `engine.generate`), why it stopped, and its
    wall-clock latencies on the server's clock. ``ttft_s`` is None for a
    request cancelled before its first token; ``tpot_s`` needs at least
    two tokens. ``attainment`` scores those latencies against the
    request's SLO targets (None when the request carried none)."""

    session_id: str
    tokens: List[int]
    finish_reason: str
    submit_t: float
    finish_t: float
    ttft_s: Optional[float]
    tpot_s: Optional[float]
    slo: Optional[SLOSpec] = None
    attainment: Optional[SLOAttainment] = None


@dataclasses.dataclass
class _Session:
    uid: int
    session_id: str
    req: Any                        # the scheduler's Request (direct ref:
                                    # immune to the batcher's history eviction)
    on_token: Optional[Callable[[TokenEvent], None]]
    delivered: int = 0              # streaming watermark (tokens emitted)


class StreamingServer:
    """Session façade over one :class:`ContinuousBatcher`.

    Configuration arrives as one typed :class:`ServeConfig` (DESIGN.md
    §16); live collaborators (drafter, clock, fault plan, degradation
    policy, tracer) stay keyword arguments and pass through to the
    batcher. ``max_queue`` bounds the sessions waiting for admission
    (backpressure trips beyond it; None = unbounded) — it lives on
    :class:`ServeConfig` but an explicit keyword still overrides::

        server = StreamingServer(params, cfg, config=ServeConfig(
            scheduler=SchedulerConfig(n_slots=4, max_len=128),
            cache_kind="paged", max_queue=16))
        sid = server.submit(GenerationRequest(prompt, 32, on_token=print))
        while server.busy:
            for resp in server.step():
                ...

    The legacy flat keyword form (``n_slots=4, cache_kind="paged"``)
    still works through the batcher's deprecation shim.
    """

    def __init__(self, params, cfg, *,
                 config: Optional[ServeConfig] = None,
                 max_queue: Optional[int] = None,
                 **batcher_kwargs):
        self.batcher = ContinuousBatcher(params, cfg, config=config,
                                         **batcher_kwargs)
        if max_queue is None and config is not None:
            max_queue = config.max_queue
        self.max_queue = max_queue
        self._sessions: Dict[str, _Session] = {}   # live only
        self._by_uid: Dict[int, _Session] = {}
        self._next_uid = 0

    # -- introspection -------------------------------------------------------
    @property
    def busy(self) -> bool:
        return self.batcher.busy

    @property
    def queue_depth(self) -> int:
        return self.batcher.sched.queue_depth

    @property
    def metrics(self):
        return self.batcher.metrics

    def live_sessions(self) -> List[str]:
        return list(self._sessions)

    # -- submit / cancel -----------------------------------------------------
    def submit(self, request: GenerationRequest) -> str:
        """Queue a generation; returns its session id. Raises
        :class:`RequestRejected` (never-runnable request / duplicate live
        session id — permanent, don't retry) or :class:`Backpressure`
        (queue full or shedding — transient, retry after its hint). Both
        raise before any state is created, and validation runs *first*:
        a request the configured pool can never complete is rejected even
        when the queue is full, so callers learn the right failure."""
        sid = request.session_id
        if sid is None:
            sid = f"s{self._next_uid}"
        if sid in self._sessions:
            raise RequestRejected(
                f"session id {sid!r} is still live; cancel it or pick "
                f"another id")
        sched = self.batcher.sched
        if request.slo is not None:
            if (request.ttft_deadline_s is not None
                    or request.deadline_s is not None):
                raise RequestRejected(
                    "give either slo=SLOSpec(...) or the legacy flat "
                    "deadline fields, not both")
            try:
                request.slo.validate()
            except ValueError as e:
                raise RequestRejected(str(e)) from e
        try:
            sched.validate_request(request.prompt, request.max_new_tokens)
        except ValueError as e:
            raise RequestRejected(str(e)) from e
        depth = self.queue_depth
        pool = self.batcher.pool
        avail = pool.available if pool is not None else None
        if sched.shedding:
            sched.metrics.degradation_sheds += 1
            raise Backpressure(depth, self.max_queue, avail,
                               retry_after_s=sched.retry_after_s(),
                               reason="shed")
        if self.max_queue is not None and depth >= self.max_queue:
            raise Backpressure(depth, self.max_queue, avail,
                               retry_after_s=sched.retry_after_s())
        uid = self._next_uid
        try:
            req = self.batcher.submit(
                uid, request.prompt, request.max_new_tokens,
                ttft_deadline_s=request.ttft_deadline_s,
                deadline_s=request.deadline_s, slo=request.slo)
        except ValueError as e:
            raise RequestRejected(str(e)) from e
        self._next_uid += 1
        sess = _Session(uid, sid, req, request.on_token)
        self._sessions[sid] = sess
        self._by_uid[uid] = sess
        return sid

    def cancel(self, session_id: str) -> Optional[GenerationResponse]:
        """Cancel a live session in any state. Already-generated tokens are
        returned (finish_reason="cancelled"); the final token event fires
        if any token had been generated but not yet streamed. Returns None
        for unknown/finished ids (cancellation races are benign)."""
        sess = self._sessions.get(session_id)
        if sess is None:
            return None
        if self.batcher.cancel(sess.uid) is None:
            return None                       # finished in the same step
        self._drain_stream(sess, sess.req)
        return self._close(sess)

    # -- stepping ------------------------------------------------------------
    def step(self) -> List[GenerationResponse]:
        """Run one engine step; stream every newly generated token to its
        session's callback, then return the sessions that finished."""
        finished = self.batcher.step()
        # Stream in uid order (stable, independent of slot assignment).
        for sess in sorted(self._by_uid.values(), key=lambda s: s.uid):
            self._drain_stream(sess, sess.req)
        out: List[GenerationResponse] = []
        for uid in finished:
            sess = self._by_uid.get(uid)
            if sess is not None:
                out.append(self._close(sess))
        return out

    def run_until_drained(self, max_steps: int = 10_000
                          ) -> List[GenerationResponse]:
        """Step until nothing is queued or active; returns every response
        finished along the way (cancelled sessions were already returned
        by their ``cancel`` call)."""
        out: List[GenerationResponse] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.busy:
                break
        return out

    # -- crash recovery (DESIGN.md §14) --------------------------------------
    def snapshot(self, directory: str) -> str:
        """Publish a crash-consistent snapshot of the server's host state
        (scheduler queue + in-flight requests as-if-preempted, session
        watermarks, uid counter, virtual-clock time) through the atomic-
        rename machinery in `distributed.fault_tolerance`. Call at a step
        boundary only. Returns the snapshot path.

        Model params and KV blocks are deliberately NOT captured: params
        are immutable inputs, and the restored requests re-prefill their
        prompt+generated tokens on re-admission (recompute resume), which
        regenerates bitwise-identical greedy *and* sampled streams via the
        (uid, token-index)-folded keys."""
        payload = {
            "version": 1,
            "scheduler": self.batcher.sched.export_state(),
            "sessions": [
                {"sid": s.session_id, "uid": s.uid,
                 "delivered": s.delivered}
                for s in sorted(self._by_uid.values(), key=lambda s: s.uid)],
            "next_uid": self._next_uid,
        }
        t = getattr(self.batcher.sched.clock, "t", None)
        if t is not None:
            payload["clock_t"] = float(t)
        return SnapshotStore(directory).save(payload)

    @classmethod
    def restore(cls, directory: str, params, cfg, *,
                on_token: Optional[Callable[[TokenEvent], None]] = None,
                config: Optional[ServeConfig] = None,
                max_queue: Optional[int] = None,
                **batcher_kwargs) -> "StreamingServer":
        """Rebuild a server from the newest snapshot in ``directory`` —
        the crashed process's in-flight sessions resume queued (in their
        original admission order, ahead of the old queue) and stream
        *exactly once*: each restored session's delivered watermark
        suppresses re-emission of tokens already streamed before the
        crash. ``on_token`` (one callback; events carry the session id)
        reattaches streaming to every restored session. Batcher kwargs
        must match the crashed server's (same pool geometry, sampling,
        and clock kind) — the snapshot holds state, not configuration."""
        payload = SnapshotStore(directory).latest()
        if payload is None:
            raise FileNotFoundError(f"no snapshot in {directory!r}")
        server = cls(params, cfg, config=config, max_queue=max_queue,
                     **batcher_kwargs)
        clock = server.batcher.sched.clock
        if "clock_t" in payload and hasattr(clock, "t"):
            clock.t = float(payload["clock_t"])
        reqs = server.batcher.sched.restore_state(payload["scheduler"])
        by_uid = {r.uid: r for r in reqs}
        for s in payload["sessions"]:
            req = by_uid.get(int(s["uid"]))
            if req is None:
                continue          # finished before the snapshot — stale row
            sess = _Session(int(s["uid"]), s["sid"], req, on_token,
                            delivered=int(s["delivered"]))
            server._sessions[s["sid"]] = sess
            server._by_uid[sess.uid] = sess
        server._next_uid = int(payload["next_uid"])
        return server

    # -- internals -----------------------------------------------------------
    def _drain_stream(self, sess: _Session, req) -> None:
        if sess.on_token is None:
            sess.delivered = len(req.generated)
            return
        n = len(req.generated)
        for i in range(sess.delivered, n):
            last = req.done and i == n - 1
            att = self._attainment(req) if last else None
            sess.on_token(TokenEvent(
                session_id=sess.session_id, token=req.generated[i],
                index=i, finish_reason=req.finish_reason if last else "",
                attainment=att))
        sess.delivered = n

    @staticmethod
    def _attainment(req) -> Optional[SLOAttainment]:
        slo = getattr(req, "slo", None)
        if slo is None:
            return None
        return slo.attainment(req.ttft_s, req.tpot_s)

    def _close(self, sess: _Session) -> GenerationResponse:
        req = sess.req
        del self._sessions[sess.session_id]
        del self._by_uid[sess.uid]
        return GenerationResponse(
            session_id=sess.session_id, tokens=list(req.generated),
            finish_reason=req.finish_reason, submit_t=req.submit_t,
            finish_t=req.finish_t, ttft_s=req.ttft_s, tpot_s=req.tpot_s,
            slo=req.slo, attainment=self._attainment(req))
