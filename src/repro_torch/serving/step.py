"""Device-stepping layer of the serving stack (DESIGN.md §13).

The port's counterpart of ``repro.serving.step``. :class:`DeviceStepper`
owns the model params, the K/V cache (dense slots or the paged block
pool's physical blocks) and the device entry points: bucketed prefill
(``engine.prefill_into_slots`` / ``engine.prefill_into_pages``) and the
per-slot-position batched decode. It executes whatever the scheduling
core (``serving/scheduler.py``) planned, verbatim: a stepper call never
changes scheduling state, and the scheduler never sees a device tensor —
numpy in, numpy out across the boundary.

The cache is allocated once and written in place. Where the reference
jits the decode step once for its fixed ``[n_slots, 1]`` shape, the port
captures it once as a CUDA graph (``graph=True``, the default on a card):
token, position vector, block tables, poison mask and sampling folds sit
in static input buffers that each call fills, and a replay leaves the
next tokens, the non-finite scan and the logits in static outputs. Before the capture
the step runs once eagerly, so the kernels' build and first-launch set-up
and ``schedule.select`` happen outside it; that run writes the same K/V
the replay writes. A failed capture raises; nothing falls back to eager.
The kernel wrappers count launches as they are called, which during a
capture records rather than launches: the stepper takes those counts back
out and adds them again at every replay, so ``spmm.launch_counts()``
counts the kernels that ran.

Sampling matches ``engine.generate`` semantics for greedy decoding
(argmax); with a temperature each slot draws through
``engine.sample_per_slot`` with its (request uid, token index) fold, so
streams are independent of admission order and preemption.

Fault surface (DESIGN.md §14): an optional ``serving.faults.FaultInjector``
hooks every launch — ``check_launch`` may raise a ``TransientStepError``
*before* anything touches the device (the facade retries), and
``poison_mask`` rows get their logits overwritten with NaN inside the
step, so the per-step non-finite scan (``ok``) exercises the detection
path a real numerical fault would take.
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

NOT_PORTED = ("{} is not ported yet: speculative verify and chunked "
              "prefill are ROADMAP.md queue 1 item 9")


def _host(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A scheduler array as an int64 tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(dev)


def _fill(buf: torch.Tensor, x: np.ndarray) -> None:
    """Copy a scheduler array into a static input buffer of the step."""
    dtype = np.bool_ if buf.dtype == torch.bool else np.int64
    buf.copy_(torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)))


class DeviceStepper:
    """Owns params + cache + the prefill and decode entry points of one
    server.

    ``physical_blocks`` selects the paged cache (the pool's physical block
    count, usable blocks + the trash block); None selects the dense
    ``[n_slots, max_len]`` cache. ``graph`` (default: on for a CUDA
    device) runs the decode step as a captured CUDA graph; asking for it
    on the CPU raises.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 max_len: int, backend: str = "auto",
                 physical_blocks: Optional[int] = None, block_size: int = 16,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 spec_k: int = 0, chunk_size: int = 0, faults=None,
                 tracer: Optional[Tracer] = None,
                 graph: Optional[bool] = None):
        if spec_k:
            raise NotImplementedError(NOT_PORTED.format("spec_k > 0"))
        if chunk_size:
            raise NotImplementedError(NOT_PORTED.format("chunked prefill"))
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
        self.paged = physical_blocks is not None
        dev = self.device
        with torch.inference_mode():
            if self.paged:
                self.max_blocks = transformer.paged_blocks_per_seq(
                    cfg, max_len, block_size)
                self.cache = transformer.init_paged_cache(
                    cfg, physical_blocks, block_size, device=dev)
            else:
                self.cache = transformer.init_cache(cfg, n_slots, max_len,
                                                    device=dev)
            # static inputs of the decode step (the graph reads them)
            self._tok_in = torch.zeros((n_slots, 1), dtype=torch.int64,
                                       device=dev)
            self._pos_in = torch.zeros((n_slots,), dtype=torch.int64,
                                       device=dev)
            self._tab_in = (torch.zeros((n_slots, self.max_blocks),
                                        dtype=torch.int64, device=dev)
                            if self.paged else None)
            self._poison_in = torch.zeros((n_slots,), dtype=torch.bool,
                                          device=dev)
            self._uid_in = torch.zeros((n_slots,), dtype=torch.int64,
                                       device=dev)
            self._cnt_in = torch.zeros((n_slots,), dtype=torch.int64,
                                       device=dev)
        self._no_poison = np.zeros(n_slots, bool)
        self._graph = None                      # torch.cuda.CUDAGraph
        self._graph_out = None                  # (tok, ok, logits) outputs
        self.last_logits = None                 # logits of the last decode
        self._graph_launches = {}               # kernel -> launches a replay
        self.prefill_shapes = set()             # (rows, bucket) prefilled

    # -- the decode step: reads the static inputs, writes the cache ------
    def _decode_step(self):
        """One batched decode token for every slot, each at its own
        position: logits, the poison rows overwritten with NaN, the
        non-finite scan, and the next token (argmax, or the per-slot
        draw). Returns (tok [n_slots], ok [n_slots], logits [n_slots, V])."""
        logits, _ = transformer.forward(
            self.params, {"tokens": self._tok_in}, self.cfg, mode="decode",
            cache=self.cache, pos=self._pos_in, block_tables=self._tab_in,
            backend=self.backend)
        logits = logits[:, -1].masked_fill(self._poison_in[:, None],
                                           float("nan"))
        ok = torch.isfinite(logits).all(dim=-1)
        tok = engine.sample_per_slot(
            logits, self._uid_in, self._cnt_in, temperature=self.temperature,
            top_k=self.top_k, seed=self.seed)
        return tok, ok, logits

    def _capture(self) -> None:
        """Run the step once eagerly (build, first-launch set-up, the
        schedules), then capture it. Raises if the capture fails."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        before = spmm.launch_counts()
        try:
            with torch.cuda.graph(graph):
                out = self._decode_step()
        finally:
            after = spmm.launch_counts()
            captured = {k: after[k] - before[k] for k in after}
            for k, n in captured.items():   # recorded, not launched
                spmm.LAUNCHES[k] -= n
        self._graph, self._graph_out = graph, out
        self._graph_launches = {k: n for k, n in captured.items() if n}

    def _replay(self):
        if self._graph is None:
            self._capture()
        self._graph.replay()
        for k, n in self._graph_launches.items():
            spmm.LAUNCHES[k] += n
        return self._graph_out

    @property
    def graph_launches(self) -> dict:
        """Kernel launches one replay of the captured step makes."""
        return dict(self._graph_launches)

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
        the decode launch reads them."""
        with torch.inference_mode():
            for src, dst in copies:
                transformer.copy_cache_block(self.cfg, self.cache, src, dst)

    def decode(self, last_token: np.ndarray, pos: np.ndarray,
               table_arr: Optional[np.ndarray],
               uids: Optional[np.ndarray],
               counts: Optional[np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """One batched decode token for every slot (inactive slots produce
        garbage the scheduler ignores). Returns (next tokens [n_slots],
        non-finite-scan ``ok`` [n_slots] — False rows get quarantined)."""
        if self.faults is not None:
            self.faults.check_launch("decode")
            poison = self.faults.poison_mask("decode", self.n_slots)
        else:
            poison = None
        if poison is None:
            poison = self._no_poison
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
            tok, ok, self.last_logits = (self._replay() if self.graph
                                         else self._decode_step())
            tok, ok = tok.cpu().numpy(), ok.cpu().numpy()
        if tr.enabled:
            args = {"batch": self.n_slots, "graph": self.graph}
            if table_arr is not None:
                args["blocks_touched"] = int(
                    np.sum(table_arr != paged_cache.TRASH_BLOCK))
            tr.span("step", "decode", "engine", t0, **args)
        return tok, ok

    def mixed(self, *args, **kwargs):
        raise NotImplementedError(NOT_PORTED.format("the mixed step"))

    def verify(self, *args, **kwargs):
        raise NotImplementedError(NOT_PORTED.format("the verify step"))
