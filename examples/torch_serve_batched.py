"""Streaming serving demo of the port over any assigned architecture.

The counterpart of ``examples/serve_batched.py``: a queue of requests
with ragged prompt lengths drained through a fixed pool of decode slots
(``serving.api.StreamingServer`` over the continuous batcher, its decode
step a CUDA graph on a card). Each request's ``on_token`` callback prints
tokens as they are generated, interleaved across sessions as the batcher
emits them; responses carry TTFT / TPOT from the server's clock.
Admission is bucketed (prompts pad to power-of-two length buckets) and
in-slot, so mixed-length traffic runs a handful of prefill shapes.

``--cancel-after N`` cancels the last-submitted session after N engine
steps, mid-stream: its slot and KV blocks are released at once (the pool
invariants are checked at exit) and the response reports
``finish_reason=cancelled`` with the tokens it had produced.

The MoE archs need slots enough that an admission's tokens split into
whole routing subgroups: at the default 3 slots, 3 rows of a 32-token
bucket are 96 tokens, which the MoE block refuses with subgroups of 64,
as the reference's does (ROADMAP.md queue 3 item 18); ``--slots 4``
serves.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py \\
          --arch minicpm3_4b [--device cpu]
      PYTHONPATH=src python examples/torch_serve_batched.py \\
          --arch qwen2_moe_a2_7b --slots 4
      (any id from repro_torch.configs.ARCH_IDS; smoke-sized weights)
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch import configs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.serving import api


def main(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama_1_1b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--eos", type=int, default=None,
                    help="token id that terminates generation early")
    ap.add_argument("--paged", action="store_true",
                    help="paged block-pool KV cache with prefix sharing")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--n-blocks", type=int, default=None)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding drafts per step (needs --paged)")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked prefill mixed steps (needs --paged)")
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--cancel-after", type=int, default=None, metavar="N",
                    help="cancel the last session after N engine steps "
                         "(demo of mid-stream cancellation)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    cfg = configs.smoke(args.arch)
    if cfg.n_codebooks:
        raise SystemExit("audio archs need codebook prompts; use the engine API")
    params = transformer.init_model(cfg, seed=0, device=dev)

    server = api.StreamingServer(params, cfg, config=api.ServeConfig(
        scheduler=api.SchedulerConfig(
            n_slots=args.slots, max_len=args.max_len, eos_id=args.eos,
            chunked_prefill=args.chunked, chunk_size=args.chunk_size,
            chunk_budget=2 * args.chunk_size),
        cache_kind="paged" if args.paged else "dense",
        block_size=args.block_size, n_blocks=args.n_blocks,
        spec_k=args.spec_k))

    t0 = time.time()

    def on_token(ev: api.TokenEvent) -> None:
        """One line per streamed token, tagged with the session and its
        running index; the last token names the finish."""
        tail = f"  <- {ev.finish_reason}" if ev.finish_reason else ""
        print(f"[{time.time() - t0:5.2f}s] {ev.session_id} "
              f"#{ev.index}: {ev.token}{tail}")

    rng = np.random.default_rng(0)
    lo = min(3, args.max_len - 1)
    hi = max(lo + 1, min(args.max_len // 2, args.max_len - 1))
    lens = rng.integers(lo, hi, args.requests)
    for i in range(args.requests):
        server.submit(api.GenerationRequest(
            prompt=rng.integers(0, cfg.vocab, lens[i]).astype(np.int64),
            max_new_tokens=int(rng.integers(4, 10)),
            session_id=f"req{i}", on_token=on_token))

    steps = 0
    responses = []
    while server.busy:
        responses.extend(server.step())
        steps += 1
        if args.cancel_after is not None and steps == args.cancel_after:
            victim = f"req{args.requests - 1}"
            resp = server.cancel(victim)
            if resp is not None:
                print(f"[{time.time() - t0:5.2f}s] cancelled {victim} after "
                      f"{steps} steps ({len(resp.tokens)} tokens out)")
                responses.append(resp)

    print()
    for r in sorted(responses, key=lambda r: r.session_id):
        lat = (f"ttft={r.ttft_s:.2f}s" if r.ttft_s is not None else "ttft=-")
        if r.tpot_s is not None:
            lat += f" tpot={r.tpot_s * 1e3:.0f}ms"
        print(f"{r.session_id}: {len(r.tokens)} tokens ({r.finish_reason}, "
              f"{lat}): {r.tokens}")

    b = server.batcher
    m = server.metrics
    print(f"\n{args.requests} ragged requests over {args.slots} slots "
          f"in {steps} engine steps; slots were reused "
          f"{max(args.requests - args.slots, 0)} times without pausing the loop")
    print(f"scheduler: occupancy={m.occupancy:.2f}  "
          f"mean_queue_wait={m.mean_queue_wait_steps:.1f} steps  "
          f"prefill={m.prefill_tokens} tok (+{m.prefill_padding_overhead:.0%} "
          f"bucket/group padding)  decode={m.decode_tokens} tok  "
          f"cancelled={m.cancelled}")
    why = ("(vs one per distinct prompt length without bucketing)"
           if b.buckets is not None else
           "(recurrent arch: exact-length admission, buckets disabled)")
    print(f"admission: {m.prefill_calls} prefill calls over buckets "
          f"{sorted(m.bucket_admits)} -> {b.prefill_compiles} prefill shapes "
          f"{why}")
    print(f"time split: admit {m.admit_time_s:.2f}s / "
          f"decode {m.decode_time_s:.2f}s")
    if args.paged:
        print(f"paged cache: {b.pool.n_blocks} blocks x {b.block_size} tok, "
              f"prefix_hit_rate={m.prefix_hit_rate:.2f}  "
              f"peak_active={m.peak_active_slots}  "
              f"preemptions={m.preemptions}")
        b.pool.check_invariants()
        assert b.pool.blocks_in_use == 0, "leaked KV blocks"
    if args.chunked:
        print(f"chunked prefill (chunk={args.chunk_size}): "
              f"mixed_steps={m.mixed_steps}  chunk_tokens={m.chunk_tokens}  "
              f"compute_positions={m.compute_positions}")
    if args.spec_k:
        print(f"speculative (k={args.spec_k}): drafted={m.drafted} "
              f"accepted={m.accepted} accept_rate={m.accept_rate:.2f}  "
              f"tokens_per_step={m.tokens_per_step:.2f}")
    return dict(cfg=cfg, params=params, responses=responses, steps=steps,
                server=server)


if __name__ == "__main__":
    main()
