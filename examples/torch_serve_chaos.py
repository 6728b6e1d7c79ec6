"""Chaos demo of the port: a stream survives injected step failures
mid-generation.

The counterpart of ``examples/serve_chaos.py``: a handful of streaming
sessions run over the paged continuous batcher on smoke-sized weights
while a seeded ``serving.faults.FaultPlan`` injects

* a **transient step error**: the decode launch raises before touching
  the device; the server retries with exponential backoff and the stream
  continues bitwise identical to a fault-free run (checked at exit);
* **NaN logits** in one slot: the per-step non-finite scan quarantines
  only that session (``finish_reason="quarantined"``, its KV blocks
  freed); every other stream keeps decoding;
* a **pool storm**: KV blocks vanish for a few steps, forcing the
  scheduler through preemption and back.

Every session ends with an explicit finish_reason, the block pool is
invariant-clean at exit, and the surviving streams match a fault-free
replay token for token; the demo prints the receipt for each.

Run:  PYTHONPATH=src python examples/torch_serve_chaos.py [--device cpu]
      PYTHONPATH=src python examples/torch_serve_chaos.py --seed 3 --requests 6
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch import configs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.serving import api, faults, loadgen


def main(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama_1_1b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    cfg = configs.smoke(args.arch)
    if cfg.n_codebooks:
        raise SystemExit("audio archs need codebook prompts; use the engine API")
    params = transformer.init_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 12)))
               .astype(np.int64) for _ in range(args.requests)]

    # One of each headline fault, scheduled a few steps in: the decode
    # retry, the slot-0 NaN quarantine, and a short block storm.
    plan = faults.FaultPlan([
        faults.FaultEvent(step=3, kind="step_error", op="decode", attempts=2),
        faults.FaultEvent(step=5, kind="nan_logits", op="decode", slot=0),
        faults.FaultEvent(step=7, kind="pool_storm", blocks=4, duration=3),
    ])
    print(f"fault plan ({len(plan)} events, "
          f"fingerprint {plan.fingerprint()[:12]}):")
    for ev in plan.events:
        print(f"  step {ev.step}: {ev.kind}")

    def serve(fault_plan):
        clock = loadgen.StepClock(dt=1.0)
        server = api.StreamingServer(params, cfg, config=api.ServeConfig(
            scheduler=api.SchedulerConfig(n_slots=args.slots,
                                          max_len=args.max_len),
            cache_kind="paged", block_size=8),
            clock=clock, fault_plan=fault_plan)
        for i, prompt in enumerate(prompts):
            server.submit(api.GenerationRequest(
                prompt=prompt, max_new_tokens=args.max_new,
                session_id=f"req{i}",
                on_token=(lambda ev: print(
                    f"    [{ev.session_id}] token[{ev.index}]={ev.token}"
                    + (f"  <{ev.finish_reason}>" if ev.finish_reason else "")))
                if fault_plan is not None else None))
        responses = []
        while server.busy:
            responses.extend(server.step())
            clock.tick()
        server.batcher.pool.check_invariants()
        assert server.batcher.pool.blocks_in_use == 0
        return server, {r.session_id: r for r in responses}

    print("\n--- chaos run (streaming) ---")
    chaos_srv, chaos = serve(plan)
    print("\n--- fault-free run (reference) ---")
    _, clean = serve(None)

    m = chaos_srv.metrics
    rep = chaos_srv.batcher.faults.report()
    print(f"\nfired {rep['fired']}/{rep['plan_events']} events "
          f"{rep['by_kind']}; retries={m.step_retries} "
          f"quarantined={m.quarantined} preemptions={m.preemptions}")
    survivors = parity = 0
    for sid, r in sorted(chaos.items()):
        want = clean[sid]
        note = ""
        if r.finish_reason == "quarantined":
            note = "  (contained: only this session failed)"
        elif r.tokens == want.tokens:
            survivors += 1
            parity += 1
            note = "  (bitwise == fault-free run)"
        print(f"  {sid}: finish_reason={r.finish_reason} "
              f"tokens={r.tokens[:6]}...{note}")
    assert all(r.finish_reason for r in chaos.values()), "hung session!"
    assert parity == survivors == len(chaos) - m.quarantined, \
        "a surviving stream diverged from the fault-free run"
    print(f"\nall {len(chaos)} sessions terminated explicitly; "
          f"{survivors} surviving streams bitwise-match the fault-free run")
    return dict(cfg=cfg, chaos=chaos, clean=clean, survivors=survivors,
                quarantined=m.quarantined, report=rep)


if __name__ == "__main__":
    main()
