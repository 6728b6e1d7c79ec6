"""Device-stepping layer of the serving stack (DESIGN.md §13).

The port's counterpart of ``repro.serving.step``. :class:`DeviceStepper`
owns the model params, the K/V cache (dense slots or the paged block
pool's physical blocks) and the device entry points: bucketed prefill
(``engine.prefill_into_slots`` / ``engine.prefill_into_pages``), the
per-slot-position batched decode, the speculative verify window
(``engine.verify_step``, ``spec_k > 0``) and the mixed prefill-chunk /
decode step (``engine.prefill_chunk_into_pages``, ``chunk_size > 0``).
It executes whatever the scheduling core (``serving/scheduler.py``)
planned, verbatim: a stepper call never changes scheduling state, and
the scheduler never sees a device tensor — numpy in, numpy out across
the boundary.

The cache is allocated once and written in place, every leaf of it: K/V
and latents by ``index_put_``, an RG-LRU layer's state by ``copy_``, so a
graph replay reads the state the last step left. Where the reference
jits each fixed-shape step once — decode ``[n_slots, 1]``, verify
``[n_slots, spec_k + 1]``, mixed ``[n_slots, chunk_size]`` — the port
captures each once as a CUDA graph (``graph=True``, the default on a
card): tokens, positions, block tables, poison mask, draft lengths and
sampling folds sit in static input buffers that each call fills, and a
replay leaves its results in static outputs. Before a capture the step
runs once eagerly, so the kernels' build and first-launch set-up and
``schedule.select`` happen outside it; that run writes the same K/V the
replay writes. A failed capture raises; nothing falls back to eager.
The kernel wrappers count launches as they are called, which during a
capture records rather than launches: the stepper takes those counts
back out and adds them again at every replay, so
``spmm.launch_counts()`` counts the kernels that ran.

Sampling matches ``engine.generate`` semantics for greedy decoding
(argmax); with a temperature each slot draws through
``engine.sample_per_slot`` with its (request uid, token index) fold, so
streams are independent of admission order and preemption, and verify
column j draws token index ``counts + j`` exactly as plain decode would.

Fault surface (DESIGN.md §14): an optional ``serving.faults.FaultInjector``
hooks every launch — ``check_launch`` may raise a ``TransientStepError``
*before* anything touches the device (the facade retries), and
``poison_mask`` rows get their logits overwritten with NaN inside the
decode and mixed steps, so the per-step non-finite scan (``ok``)
exercises the detection path a real numerical fault would take.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import device_of
from repro_torch.kernels import spmm
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.serving import engine, paged_cache

def _host(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A scheduler array as an int64 tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(dev)


def _fill(buf: torch.Tensor, x: np.ndarray) -> None:
    """Copy a scheduler array into a static input buffer of the step."""
    dtype = np.bool_ if buf.dtype == torch.bool else np.int64
    buf.copy_(torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)))


class DeviceStepper:
    """Owns params + cache + the prefill, decode, verify and mixed entry
    points of one server.

    ``physical_blocks`` selects the paged cache (the pool's physical block
    count, usable blocks + the trash block); None selects the dense
    ``[n_slots, max_len]`` cache. ``spec_k > 0`` adds the verify step
    (``[n_slots, spec_k + 1]``), ``chunk_size > 0`` the mixed step
    (``[n_slots, chunk_size]``); both need the paged cache. ``graph``
    (default: on for a CUDA device) runs each fixed-shape step as a
    captured CUDA graph; asking for it on the CPU raises. ``ring_len`` is
    a sliding-window config's ring on the paged cache (the dense ring
    reads it off the cache).
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 max_len: int, backend: str = "auto",
                 physical_blocks: Optional[int] = None, block_size: int = 16,
                 ring_len: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 spec_k: int = 0, chunk_size: int = 0, faults=None,
                 tracer: Optional[Tracer] = None,
                 graph: Optional[bool] = None):
        self.params = params
        self.cfg = cfg
        self.backend = backend
        self.device = device_of(params) or torch.device("cpu")
        if graph is None:
            graph = self.device.type == "cuda"
        if graph and self.device.type != "cuda":
            raise ValueError(f"graph=True needs params on a CUDA device, "
                             f"got {self.device}")
        self.graph = bool(graph)
        self.tracer = tracer if tracer is not None else get_tracer()
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.faults = faults                    # serving.faults.FaultInjector
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.paged = physical_blocks is not None
        self.ring_len = ring_len
        if (spec_k or chunk_size) and not self.paged:
            raise ValueError("the verify and mixed steps need the paged "
                             "cache (physical_blocks)")
        self.spec_k = int(spec_k)
        self.chunk_size = int(chunk_size)
        dev = self.device

        def buf(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)
        with torch.inference_mode():
            if self.paged:
                self.max_blocks = transformer.paged_blocks_per_seq(
                    cfg, max_len, block_size)
                self.cache = transformer.init_paged_cache(
                    cfg, physical_blocks, block_size, device=dev)
            else:
                self.cache = transformer.init_cache(cfg, n_slots, max_len,
                                                    device=dev)
            # static inputs of the steps (the graphs read them)
            self._tok_in = buf(n_slots, 1)
            self._pos_in = buf(n_slots)
            self._tab_in = (buf(n_slots, self.max_blocks) if self.paged
                            else None)
            self._poison_in = buf(n_slots, dtype=torch.bool)
            self._uid_in = buf(n_slots)
            self._cnt_in = buf(n_slots)
            self._vtok_in = buf(n_slots, spec_k + 1) if spec_k else None
            self._vlen_in = buf(n_slots) if spec_k else None
            self._mtok_in = buf(n_slots, chunk_size) if chunk_size else None
            self._ntok_in = buf(n_slots) if chunk_size else None
        self._no_poison = np.zeros(n_slots, bool)
        self._graphs = {}                       # op -> (CUDAGraph, outputs)
        self._graph_launches = {}               # op -> {kernel: per replay}
        self.captures = dict.fromkeys(("decode", "verify", "mixed"), 0)
        self.last_logits = None                 # logits of the last step
        self.prefill_shapes = set()             # (rows, bucket) prefilled
        self.window_shapes = set()              # (op, [n_slots, W]) run

    # -- the fixed-shape steps: read the static inputs, write the cache --
    def _decode_step(self):
        """One batched decode token for every slot, each at its own
        position: logits, the poison rows overwritten with NaN, the
        non-finite scan, and the next token (argmax, or the per-slot
        draw). Returns (tok [n_slots], ok [n_slots], logits [n_slots, V])."""
        logits, _ = transformer.forward(
            self.params, {"tokens": self._tok_in}, self.cfg, mode="decode",
            cache=self.cache, pos=self._pos_in, block_tables=self._tab_in,
            ring_len=self.ring_len if self.paged else None,
            backend=self.backend)
        logits = logits[:, -1].masked_fill(self._poison_in[:, None],
                                           float("nan"))
        ok = torch.isfinite(logits).all(dim=-1)
        tok = engine.sample_per_slot(
            logits, self._uid_in, self._cnt_in, temperature=self.temperature,
            top_k=self.top_k, seed=self.seed)
        return tok, ok, logits

    def _verify_step(self):
        """One verify window of spec_k + 1 columns for every slot
        (``engine.verify_step``): the target's tokens, the accepted draft
        counts, and the window's logits [n_slots, W, V]; the accepted
        prefix's K/V is committed, the rest goes to the trash block."""
        tokens, tables = self._vtok_in, self._tab_in
        logits, fresh = transformer.forward(
            self.params, {"tokens": tokens}, self.cfg, mode="verify",
            cache=self.cache, pos=self._pos_in, block_tables=tables,
            ring_len=self.ring_len, backend=self.backend)
        tgt, n_acc = engine.accept_drafts(
            logits, tokens, self._vlen_in, self._uid_in, self._cnt_in,
            temperature=self.temperature, top_k=self.top_k, seed=self.seed)
        cols = torch.arange(tokens.shape[1], device=tokens.device)
        transformer.commit_verify_window(
            self.cfg, self.cache, fresh, tables, self._pos_in,
            cols[None, :] <= n_acc[:, None], ring_len=self.ring_len)
        return tgt, n_acc, logits

    def _mixed_step(self):
        """The mixed prefill-chunk/decode launch
        (``engine.prefill_chunk_into_pages``): each slot's token is drawn
        from its last real column, with the (uid, token index) fold plain
        decode and bucketed admission use, so chunked streams are the
        bucketed ones. Returns (tok, ok, last logits [n_slots, V])."""
        logits, _ = engine.prefill_chunk_into_pages(
            self.params, self.cache, self._mtok_in, self._pos_in,
            self._tab_in, self._ntok_in, self.cfg, ring_len=self.ring_len,
            backend=self.backend)
        logits = logits.masked_fill(self._poison_in[:, None], float("nan"))
        ok = torch.isfinite(logits).all(dim=-1)
        tok = engine.sample_per_slot(
            logits, self._uid_in, self._cnt_in, temperature=self.temperature,
            top_k=self.top_k, seed=self.seed)
        return tok, ok, logits

    def _capture(self, op: str) -> None:
        """Run step ``op`` once eagerly (build, first-launch set-up, the
        schedules), then capture it. Raises if the capture fails. The
        eager run writes the K/V the replay writes again, but it advances
        recurrent state (an RG-LRU layer's ``h`` and ``conv``, an SSM
        layer's ``state`` and ``conv``), which is put back before the
        capture, so the replay advances it once."""
        fn = getattr(self, f"_{op}_step")
        state = transformer.state_leaves(self.cfg, self.cache)
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        # Once a capture, never a step: the warm-up's work and the state
        # restore finish before the capture begins.
        torch.cuda.synchronize(self.device)  # repro: ignore[OB-SYNC]
        graph = torch.cuda.CUDAGraph()
        before = spmm.launch_counts()
        try:
            with torch.cuda.graph(graph):
                out = fn()
        finally:
            after = spmm.launch_counts()
            captured = {k: after[k] - before[k] for k in after}
            for k, n in captured.items():   # recorded, not launched
                spmm.LAUNCHES[k] -= n
        self._graphs[op] = (graph, out)
        self._graph_launches[op] = {k: n for k, n in captured.items() if n}
        self.captures[op] += 1

    def _run(self, op: str):
        """Step ``op`` on the filled inputs: a replay of its graph
        (captured on first use), or the eager step."""
        if not self.graph:
            return getattr(self, f"_{op}_step")()
        if op not in self._graphs:
            self._capture(op)
        graph, out = self._graphs[op]
        graph.replay()
        for k, n in self._graph_launches[op].items():
            spmm.LAUNCHES[k] += n
        return out

    @property
    def graph_launches(self) -> dict:
        """Kernel launches one replay of the captured decode step makes."""
        return self.graph_launches_of("decode")

    def graph_launches_of(self, op: str) -> dict:
        """Kernel launches one replay of step ``op``'s graph makes."""
        return dict(self._graph_launches.get(op, {}))

    def _poison(self, op: str) -> np.ndarray:
        """The fault hooks of a launch: ``check_launch`` (may raise before
        anything runs) and the rows whose logits are poisoned."""
        if self.faults is None:
            return self._no_poison
        self.faults.check_launch(op)
        mask = self.faults.poison_mask(op, self.n_slots)
        return self._no_poison if mask is None else mask

    # -- execution surface the facade drives --------------------------------
    def prefill(self, tokens: np.ndarray, targets: np.ndarray,
                lens: np.ndarray) -> torch.Tensor:
        """Run one admission plan's prefill; ``targets`` is the slot vector
        (dense) or the scratch block map (paged). Returns last-position
        logits [k, V] (device tensor — fed straight to sample_admitted)."""
        if self.faults is not None:
            self.faults.check_launch("prefill")
        tr = self.tracer
        t0 = tr.clock() if tr.enabled else 0.0
        dev = self.device
        fn = (engine.prefill_into_pages if self.paged
              else engine.prefill_into_slots)
        with torch.inference_mode():
            logits, _ = fn(self.params, self.cache, _host(tokens, dev),
                           _host(targets, dev), _host(lens, dev), self.cfg,
                           backend=self.backend)
        self.prefill_shapes.add(tuple(tokens.shape))
        if tr.enabled:
            tr.span("step", "prefill", "engine", t0,
                    rows=int(tokens.shape[0]), bucket=int(tokens.shape[1]),
                    real_tokens=int(np.sum(lens)))
        if self.faults is not None:
            mask = self.faults.poison_mask("prefill", logits.shape[0])
            if mask is not None:
                logits = logits.masked_fill(
                    torch.from_numpy(mask).to(dev)[:, None], float("nan"))
        return logits

    def sample_admitted(self, logits: torch.Tensor, uids: np.ndarray,
                        counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """First token of each admitted request, via the same per-slot
        (uid, token index) draw as decode, so a preempted request's
        re-prefill redraws its identical next token. Also returns the rows'
        non-finite scan ([k] bool ``ok``) — the scheduler quarantines rows
        that fail it."""
        with torch.inference_mode():
            ok = torch.isfinite(logits).all(dim=-1)
            tok = engine.sample_per_slot(
                logits, _host(uids, self.device), _host(counts, self.device),
                temperature=self.temperature, top_k=self.top_k,
                seed=self.seed)
        return tok.cpu().numpy(), ok.cpu().numpy()

    def apply_copies(self, copies: Iterable[Tuple[int, int]]) -> None:
        """Apply the scheduler's queued copy-on-write block copies before
        the decode/verify/mixed launch reads them."""
        with torch.inference_mode():
            for src, dst in copies:
                transformer.copy_cache_block(self.cfg, self.cache, src, dst)

    def _span(self, op: str, t0: float, **args) -> None:
        self.tracer.span("step", op, "engine", t0, batch=self.n_slots,
                         graph=self.graph, **args)

    def decode(self, last_token: np.ndarray, pos: np.ndarray,
               table_arr: Optional[np.ndarray],
               uids: Optional[np.ndarray],
               counts: Optional[np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """One batched decode token for every slot (inactive slots produce
        garbage the scheduler ignores). Returns (next tokens [n_slots],
        non-finite-scan ``ok`` [n_slots] — False rows get quarantined)."""
        poison = self._poison("decode")
        tr = self.tracer
        t0 = tr.clock() if tr.enabled else 0.0
        with torch.inference_mode():
            _fill(self._tok_in, last_token[:, None])
            _fill(self._pos_in, pos)
            if self.paged:
                _fill(self._tab_in, table_arr)
            _fill(self._poison_in, poison)
            if uids is not None:
                _fill(self._uid_in, uids)
                _fill(self._cnt_in, counts)
            tok, ok, self.last_logits = self._run("decode")
            tok, ok = tok.cpu().numpy(), ok.cpu().numpy()
        if tr.enabled:
            args = {}
            if table_arr is not None:
                args["blocks_touched"] = int(
                    np.sum(table_arr != paged_cache.TRASH_BLOCK))
            self._span("decode", t0, **args)
        return tok, ok

    def mixed(self, tokens: np.ndarray, pos: np.ndarray,
              table_arr: np.ndarray, n_tokens: np.ndarray,
              uids: np.ndarray, counts: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """One mixed prefill-chunk + decode launch over every slot
        (``tokens [n_slots, chunk_size]``, ``n_tokens`` real columns per
        slot); returns (next tokens [n_slots], non-finite-scan ``ok``
        [n_slots]). The fault hooks fire on op "mixed", as decode's do."""
        poison = self._poison("mixed")
        tr = self.tracer
        t0 = tr.clock() if tr.enabled else 0.0
        self.window_shapes.add(("mixed", tuple(tokens.shape)))
        with torch.inference_mode():
            _fill(self._mtok_in, tokens)
            _fill(self._pos_in, pos)
            _fill(self._tab_in, table_arr)
            _fill(self._ntok_in, n_tokens)
            _fill(self._uid_in, uids)
            _fill(self._cnt_in, counts)
            _fill(self._poison_in, poison)
            tok, ok, self.last_logits = self._run("mixed")
            tok, ok = tok.cpu().numpy(), ok.cpu().numpy()
        if tr.enabled:
            self._span("mixed", t0, window=int(tokens.shape[1]),
                       real_positions=int(np.sum(n_tokens)))
        return tok, ok

    def verify(self, tokens: np.ndarray, pos: np.ndarray,
               table_arr: np.ndarray, draft_lens: np.ndarray,
               uids: np.ndarray, counts: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative verify window over every slot
        (``tokens [n_slots, spec_k + 1]``); returns the target-emitted
        tokens [n_slots, k+1] and the per-slot accept counts. As in the
        reference, NaN injection targets the other launches: under
        repeated faults the degradation ladder turns speculation off."""
        if self.faults is not None:
            self.faults.check_launch("verify")
        tr = self.tracer
        t0 = tr.clock() if tr.enabled else 0.0
        self.window_shapes.add(("verify", tuple(tokens.shape)))
        with torch.inference_mode():
            _fill(self._vtok_in, tokens)
            _fill(self._pos_in, pos)
            _fill(self._tab_in, table_arr)
            _fill(self._vlen_in, draft_lens)
            _fill(self._uid_in, uids)
            _fill(self._cnt_in, counts)
            tgt, n_acc, self.last_logits = self._run("verify")
            tgt, n_acc = tgt.cpu().numpy(), n_acc.cpu().numpy()
        if tr.enabled:
            self._span("verify", t0, window=int(tokens.shape[1]),
                       drafted=int(np.sum(draft_lens)))
        return tgt, n_acc
