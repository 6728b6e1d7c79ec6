"""Trace auditor: a dispatch-level census of the port's serving steps.

The counterpart of ``repro.analysis.trace_audit``. Where the reference
walks the jaxpr of each jitted step, the port records the aten ops one
eager call of each registered entry issues, with a ``TorchDispatchMode``
(:class:`Census`), and holds what the step keeps across calls (its CUDA
graph, its prefill shapes, its schedules) to the shared budget table.
Three rule classes, the reference's:

TA-CALLBACK  a host sync inside a step: ``.item()``
             (``aten._local_scalar_dense``), an op whose output shape
             depends on the data (``nonzero``, boolean indexing), a
             device->CPU copy. On the card each one stalls the stream every
             step, and none may sit inside a captured graph. There the
             same step bodies and the graph replays also run under
             ``torch.cuda.set_sync_debug_mode("error")``, and a sync it
             raises is a finding too.
TA-UPCAST    a large bf16->f32 ``aten._to_copy`` / ``copy_`` (at least
             :data:`UPCAST_MIN_ELEMS` elements) in a bf16 step: it writes
             twice the bytes of the tensor it copies, the traffic
             Flash-LLM exists to cut. The finding names the shape, the
             elements, the f32 bytes written a call and the port's source
             frames that issued it (the allowlist matches on them). Ops
             issued inside the kernel wrappers (``kernels/spmm.py``,
             ``kernels/gemm.py``) and the plain versions they stand for
             (``kernels/ref.py``) are not audited, as the reference skips
             ``pallas_call`` bodies: their f32 arithmetic is what the CUDA
             kernels hold in registers (the KC-ACC requirement).
TA-RETRACE   an entry that accumulates more than its budget
             (``budgets.capture_budget``) after every bucket ran twice:
             CUDA-graph captures of the decode, verify and mixed steps,
             prefill shapes, schedules a SpMM shape; and on the card a
             graph replay whose LSCD launches (``graph_launches_of``) are
             not the ones the step's layers imply, one a Tiled-CSL weight.

Entries are registered on a :class:`~repro_torch.serving.step.DeviceStepper`
(:func:`stepper_entries`): bucketed prefill, the decode step, the
speculative verify window and the mixed prefill-chunk step, plus the
SpMM dispatch (:func:`spmm_entry`). :func:`default_entries` registers
the reference's five on the tinyllama smoke config on the CPU
(pseudo-paths ``trace:<entry>``); ``chip_smoke.py`` registers them on
the served OPT-30B stepper on the card (``trace:cuda:opt-30b:<entry>``;
the smoke entries on the card are ``trace:cuda:<entry>``). The
census never runs across a CUDA-graph capture: each entry's first host
call captures, and the census records one eager call of the step body
after it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import budgets
from repro_torch.analysis.findings import Finding

#: bf16->f32 copies of at least this many elements are flagged (rule
#: TA-UPCAST): 64Ki elements, 256 KiB of f32 — weight and cache scale,
#: above the reference's sampling scalars and per-row norm statistics.
UPCAST_MIN_ELEMS = 65536

#: aten ops that make the host wait for the device.
SYNC_OPS = {"aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
            "aten.nonzero", "aten.equal",
            "aten.masked_select", "aten._unique2", "aten.unique_consecutive",
            "aten.unique_dim", "aten.repeat_interleave"}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS = os.path.join(_PKG, "analysis") + os.sep
#: files whose ops the census does not audit: the kernel wrappers and the
#: plain versions the CPU runs in their place.
KERNEL_FILES = frozenset(os.path.join(_PKG, "kernels", f)
                         for f in ("spmm.py", "gemm.py", "ref.py"))
_FRAMES = 3


def _site() -> Optional[str]:
    """The port's innermost source frames of the op being dispatched
    ("models/nn.py:49 (einsum_f32acc) <- ..."), or None if a kernel
    wrapper or plain version issued it."""
    f = sys._getframe(2)
    frames = []
    while f is not None:
        path = f.f_code.co_filename
        if path in KERNEL_FILES:
            return None
        if path.startswith(_PKG) and not path.startswith(_ANALYSIS) \
                and len(frames) < _FRAMES:
            frames.append(f"{os.path.relpath(path, _PKG)}:{f.f_lineno} "
                          f"({f.f_code.co_name})")
        f = f.f_back
    return " <- ".join(frames) or "outside the port"


def _cast(name: str, args, kwargs) -> tuple:
    """(source, target dtype, target device) of a copy op (``_to_copy``,
    ``to`` in any overload, ``copy_``), else (None, None, None). Under
    inference mode the dispatcher shows ``aten.to`` itself, outside it
    ``aten._to_copy``."""
    if name == "aten._to_copy":
        return args[0], kwargs.get("dtype"), kwargs.get("device")
    if name == "aten.copy_":
        return args[1], args[0].dtype, args[0].device
    if name != "aten.to":
        return None, None, None
    dtype, dev = kwargs.get("dtype"), kwargs.get("device")
    for a in args[1:]:
        if isinstance(a, torch.dtype):
            dtype = a
        elif isinstance(a, (torch.device, str)):
            dev = a
        elif isinstance(a, torch.Tensor):
            dtype, dev = a.dtype, a.device
    return args[0], dtype, dev


class Census(TorchDispatchMode):
    """While entered, records the aten ops issued outside the kernel
    wrappers: their count, the bf16->f32 copies of at least
    :data:`UPCAST_MIN_ELEMS` elements and the host syncs, each by its
    source frames."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.upcasts: Dict[Tuple[str, tuple], List[int]] = {}
        self.syncs: Dict[Tuple[str, str], int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        name = str(func.overloadpacket)
        src, dst_dtype, dst_dev = _cast(name, args, kwargs)
        sync = None
        if src is not None and src.is_cuda and dst_dev is not None and \
                torch.device(dst_dev).type == "cpu":
            sync = "device->CPU copy"
        elif name in SYNC_OPS:
            sync = name
        elif name in ("aten.index", "aten.index_put_", "aten.index_put") \
                and any(isinstance(i, torch.Tensor)
                        and i.dtype in (torch.bool, torch.uint8)
                        for i in (args[1] or ())):
            sync = f"{name} with a boolean mask (a nonzero on the host)"
        upcast = (src is not None and src.dtype == torch.bfloat16
                  and dst_dtype == torch.float32
                  and src.numel() >= UPCAST_MIN_ELEMS)
        if upcast or sync:
            site = _site()
            if site is not None:
                if upcast:
                    rec = self.upcasts.setdefault(
                        (site, tuple(src.shape)), [0, src.numel()])
                    rec[0] += 1
                if sync:
                    key = (sync, site)
                    self.syncs[key] = self.syncs.get(key, 0) + 1
        return func(*args, **kwargs)

    @property
    def upcast_bytes(self) -> int:
        """f32 bytes the flagged upcasts write a call."""
        return sum(4 * n * elems for n, elems in self.upcasts.values())

    def findings(self, path: str) -> List[Finding]:
        out = []
        for (site, shape), (n, elems) in sorted(self.upcasts.items()):
            out.append(Finding(
                "TA-UPCAST", path, 0,
                f"bf16->f32 copy of shape {shape} ({elems} elems, "
                f"{4 * elems} B of f32 written) x{n} a call at {site}",
                hint="keep bulk tensors in bf16; upcast only reductions "
                     "(or suppress via the allowlist with a reason)"))
        for (what, site), n in sorted(self.syncs.items()):
            out.append(Finding(
                "TA-CALLBACK", path, 0,
                f"host sync {what} x{n} a call at {site}",
                hint="keep the step on the device: no .item(), no boolean "
                     "masks, no copies to the host inside a step body"))
        return out


@contextlib.contextmanager
def sync_errors():
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: any
    synchronising CUDA call raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@dataclasses.dataclass
class Built:
    """One entry, ready to audit. ``host()`` runs every bucket once through
    the entry's host call (the first call builds and captures);
    ``step()`` is one eager call of the step body on the inputs the last
    ``host()`` left; ``count()`` reads what the entry accumulated. A
    graphed stepper entry names its stepper and op."""

    step: Callable[[], Any]
    host: Callable[[], Any]
    count: Callable[[], int]
    stepper: Any = None
    op: Optional[str] = None


@dataclasses.dataclass
class EntryPoint:
    """One audited entry: ``build()`` returns a :class:`Built`;
    ``budget_params`` feed ``budgets.capture_budget(name, ...)``."""

    name: str
    build: Callable[[], Built]
    budget_params: Dict[str, int] = dataclasses.field(default_factory=dict)
    prefix: str = "trace"

    @property
    def path(self) -> str:
        return f"{self.prefix}:{self.name}"


def implied_launches(params) -> Tuple[int, int]:
    """(LSCD launches, of them grouped) one step of ``params``' layers
    makes: one a Tiled-CSL weight, a projection group (``wqkv``,
    ``gate_up``) one grouped launch."""
    from repro_torch.analysis.kernel_pass import encoded_weights
    ws = [t for _, t in encoded_weights(params.get("layers", []))]
    return len(ws), sum(t.group is not None for t in ws)


def _graph_checks(built: Built, path: str) -> Tuple[List[Finding], dict]:
    """On the card: the eager step body and a replay of its graph under
    sync-debug errors, and the replay's launches against the layers'."""
    st, op = built.stepper, built.op
    out: List[Finding] = []
    for what, fn in (("eager step body", built.step),
                     ("graph replay", lambda: st._run(op))):
        try:
            with sync_errors(), torch.inference_mode():
                fn()
        except RuntimeError as e:
            out.append(Finding(
                "TA-CALLBACK", path, 0,
                f"{what} synchronised under set_sync_debug_mode('error'): "
                f"{str(e).splitlines()[0]}",
                hint="a sync inside a step is a port fault: fix it"))
    got = st.graph_launches_of(op)
    total, grouped = implied_launches(st.params)
    n_grouped = sum(n for k, n in got.items() if "grouped" in k)
    if sum(got.values()) != total or n_grouped != grouped:
        out.append(Finding(
            "TA-RETRACE", path, 0,
            f"a {op} replay launches {got}, the layers imply {total} "
            f"LSCD launches ({grouped} grouped)",
            hint="a launch escaped the capture or ran twice"))
    return out, dict(launches_per_replay=got, implied_launches=total)


def audit_entry(entry: EntryPoint) -> Tuple[List[Finding], dict]:
    """Census of one eager step, TA-RETRACE over two passes of every
    bucket, and on the card the sync-debug and launch checks; returns
    (findings, report)."""
    built = entry.build()
    built.host()
    census = Census()
    with torch.inference_mode(), census:
        built.step()
    out = census.findings(entry.path)
    built.host()
    n = built.count()
    budget = budgets.capture_budget(entry.name, **entry.budget_params)
    if n > budget:
        out.append(Finding(
            "TA-RETRACE", entry.path, 0,
            f"{n} captures (graphs, shapes or schedules) exceed the budget "
            f"of {budget}",
            hint="a shape or a Python value leaks into a captured step; see "
                 "budgets.CAPTURE_BUDGETS"))
    report = dict(path=entry.path, ops=census.ops,
                  upcasts=sum(c for c, _ in census.upcasts.values()),
                  upcast_bytes=census.upcast_bytes,
                  syncs=sum(census.syncs.values()), captures=n,
                  budget=budget)
    if built.stepper is not None and built.stepper.graph:
        found, extra = _graph_checks(built, entry.path)
        out.extend(found)
        report.update(extra)
    return out, report


# ---------------------------------------------------------------------------
# registered entries
# ---------------------------------------------------------------------------

def _step_inputs(stepper, width: int, seed: int) -> dict:
    """Inputs of a [n_slots, width] step: tokens, every slot at position
    ``max_len // 2`` (room for the window), each slot's own blocks."""
    rng = np.random.default_rng(seed)
    S = stepper.n_slots
    tables = None
    if stepper.paged:
        mb = stepper.max_blocks
        tables = 1 + np.arange(S * mb, dtype=np.int32).reshape(S, mb)
    pos = np.full(S, stepper.max_len // 2, np.int64)
    return dict(tokens=rng.integers(0, stepper.cfg.vocab, (S, width)),
                pos=pos, tables=tables,
                uids=np.arange(7, 7 + S, dtype=np.uint32),
                counts=pos.astype(np.uint32))


def stepper_entries(stepper, *, prefix: str = "trace", rows: int = 2,
                    ops: Sequence[str] = ("prefill", "decode", "verify",
                                          "mixed")) -> List[EntryPoint]:
    """The registered entries of ``stepper``: bucketed prefill of ``rows``
    prompts at every bucket (``engine_prefill_buckets``), the decode step
    (``engine_decode_step``), and with ``spec_k`` / ``chunk_size`` the
    verify window and the mixed step. A paged stepper needs
    ``n_slots * max_blocks + 1`` physical blocks: each slot gets its own
    table."""
    from repro_torch.serving import engine
    S, cfg = stepper.n_slots, stepper.cfg
    entries = []
    if "prefill" in ops:
        def build_prefill() -> Built:
            rng = np.random.default_rng(0)
            calls = []
            for B in engine.length_buckets(stepper.max_len):
                toks = rng.integers(0, cfg.vocab, (rows, B))
                lens = np.array([B - (i % 2) for i in range(rows)])
                if stepper.paged:
                    nblk = -(-B // stepper.block_size)
                    tgt = 1 + np.arange(rows * nblk).reshape(rows, nblk)
                else:
                    tgt = np.arange(rows)
                calls.append((toks, tgt, lens))

            def host():
                for toks, tgt, lens in calls:
                    stepper.prefill(toks, tgt, lens)
            return Built(step=host, host=host,
                         count=lambda: len(stepper.prefill_shapes))
        entries.append(EntryPoint("engine_prefill_buckets", build_prefill,
                                  {"max_len": stepper.max_len}, prefix))

    def graphed(name: str, op: str, call) -> EntryPoint:
        def build() -> Built:
            return Built(step=getattr(stepper, f"_{op}_step"), host=call,
                         count=lambda: stepper.captures[op],
                         stepper=stepper, op=op)
        return EntryPoint(name, build, {}, prefix)

    if "decode" in ops:
        x = _step_inputs(stepper, 1, seed=1)
        entries.append(graphed("engine_decode_step", "decode", lambda x=x: (
            stepper.decode(x["tokens"][:, 0], x["pos"], x["tables"],
                           x["uids"], x["counts"]))))
    if "verify" in ops and stepper.spec_k:
        x = _step_inputs(stepper, stepper.spec_k + 1, seed=2)
        drafts = np.arange(S) % (stepper.spec_k + 1)
        entries.append(graphed("engine_verify_step", "verify", lambda x=x: (
            stepper.verify(x["tokens"], x["pos"], x["tables"], drafts,
                           x["uids"], x["counts"]))))
    if "mixed" in ops and stepper.chunk_size:
        x = _step_inputs(stepper, stepper.chunk_size, seed=3)
        n_tok = np.where(np.arange(S) % 2 == 0, stepper.chunk_size, 1)
        entries.append(graphed("engine_mixed_step", "mixed", lambda x=x: (
            stepper.mixed(x["tokens"], x["pos"], x["tables"], n_tok,
                          x["uids"], x["counts"]))))
    return entries


def spmm_entry(t, b: torch.Tensor, *, prefix: str = "trace") -> EntryPoint:
    """``ops.spmm(t, b)`` (``spmm_dispatch``), its schedules per shape
    counted by a kernel profiler (``obs.profile``), which notes every
    dispatch, the plain path's too."""
    from repro_torch.kernels import ops
    from repro_torch.obs import profile as obs_profile

    def build() -> Built:
        prof = obs_profile.KernelProfiler()

        def host():
            with obs_profile.profiled(prof):
                ops.spmm(t, b)

        def count() -> int:
            scheds: Dict[tuple, set] = {}
            for rec in prof.launches.values():
                key = (rec.kind, rec.m, rec.k, rec.n, rec.group,
                       rec.experts, rec.backend)
                scheds.setdefault(key, set()).add(rec.schedule)
            return max((len(s) for s in scheds.values()), default=0)
        return Built(step=lambda: ops.spmm(t, b), host=host, count=count)
    return EntryPoint("spmm_dispatch", build, {}, prefix)


_SMOKE_ARCH = "tinyllama_1_1b"
_MAX_LEN = 32


def prefix_of(device) -> str:
    """The pseudo-path prefix of entries on ``device``: ``trace`` on the
    CPU (the reference's), ``trace:cuda`` on the card."""
    kind = torch.device(device).type
    return "trace" if kind == "cpu" else f"trace:{kind}"


def default_entries(device=None) -> List[EntryPoint]:
    """The reference's five entries on the tinyllama smoke config: slot
    prefill and decode on a dense cache of 2 slots at max_len 32, the
    verify window (spec_k 3, sampled at T = 0.7) and the mixed step (chunk
    4) on a paged cache of 2 slots (block 8), and a 256 x 256 SpMM at 0.8
    against an f32 B of 8 columns. ``device`` defaults to the card; there
    the steps are CUDA graphs."""
    from repro_torch import configs
    from repro_torch.core import tiled_csl
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer
    from repro_torch.serving.step import DeviceStepper

    dev = resolve_device(device)
    prefix = prefix_of(dev)
    cfg = configs.smoke(_SMOKE_ARCH)
    params = transformer.init_model(cfg, seed=0, device=dev)
    dense = DeviceStepper(params, cfg, n_slots=2, max_len=_MAX_LEN)
    block = 8
    paged = DeviceStepper(
        params, cfg, n_slots=2, max_len=_MAX_LEN,
        physical_blocks=2 * _MAX_LEN // block + 1, block_size=block,
        spec_k=3, chunk_size=4, temperature=0.7)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    a[rng.random(a.shape) < 0.8] = 0.0
    t = tiled_csl.encode(torch.from_numpy(a).to(dev))
    b = torch.from_numpy(rng.standard_normal((256, 8)).astype(np.float32))
    return (stepper_entries(dense, prefix=prefix, ops=("prefill", "decode"))
            + stepper_entries(paged, prefix=prefix, ops=("verify", "mixed"))
            + [spmm_entry(t, b.to(dev), prefix=prefix)])


def run_trace_audit(entries: Optional[Sequence[EntryPoint]] = None, *,
                    device=None) -> Tuple[List[Finding], Dict[str, Any]]:
    """Audit ``entries`` (default: :func:`default_entries` on ``device``);
    stats carry each entry's report and the ``targets`` audited."""
    entries = list(entries) if entries is not None \
        else default_entries(device)
    out: List[Finding] = []
    reports = []
    for e in entries:
        found, report = audit_entry(e)
        out.extend(found)
        reports.append(report)
    return out, {"entries": reports, "targets": [e.path for e in entries]}
