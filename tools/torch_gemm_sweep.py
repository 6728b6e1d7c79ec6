#!/usr/bin/env python3
"""The port's ``dense_gemm`` over its bf16 tiles, and its fixed cost per
tile, on the card, beside ``torch.matmul``.

    python3 tools/torch_gemm_sweep.py

Needs one CUDA card. At the four OPT-30B projection shapes (N = 1024,
bf16 in and out, random inputs from a seed) it times ``dense_gemm`` at
each bf16 tile (m_tb, n_tb) in {128x128, 64x256, 128x256} and
``torch.matmul`` on the same inputs, with CUDA events and the L2 flushed
before each call (``chip_smoke.cuda_ms``). Then, at up's M = 28672 and
N = 1024 with the 128x256 tile, it times K = 1024, 2048, 4096 and 7168
(16 to 112 stages of the 64-deep ring) and fits time = fixed + stages *
per_stage: ``fixed`` is what the launch costs besides its stages (launch,
ring start, each tile's epilogue) over the 7 rounds of tiles the
persistent grid runs, so it bounds what another epilogue could save; and
K = 64, one stage a tile, where the epilogue's stores take most of the
time. Prints a line per measurement and one JSON line last.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"wqkv": (3 * 7168, 7168), "wo": (7168, 7168),
          "up": (28672, 7168), "down": (7168, 28672)}
TILES = ((128, 128), (64, 256), (128, 256))
N = 1024
PEAK_FLOPS_BF16 = 989e12


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_gemm_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import gemm
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(2 ** 28, dtype=torch.int32, device="cuda")

    def ms(fn):
        return chip_smoke.cuda_ms(torch, fn, 20, flush)

    rows = []
    for name, (m, k) in SHAPES.items():
        a = (0.1 * torch.randn((m, k), generator=gen, device="cuda")).bfloat16()
        b = (0.1 * torch.randn((k, N), generator=gen, device="cuda")).bfloat16()
        bound_ms = 2.0 * m * k * N / PEAK_FLOPS_BF16 * 1e3
        matmul_ms = ms(lambda: torch.matmul(a, b))
        for m_tb, n_tb in TILES:
            def fn():
                return gemm.dense_gemm(a, b, m_tb=m_tb, n_tb=n_tb,
                                       out_dtype=torch.bfloat16)
            t = ms(fn)
            rows.append(dict(shape=name, m=m, k=k, n=N, m_tb=m_tb, n_tb=n_tb,
                             ms=t, matmul_ms=matmul_ms, bound_ms=bound_ms))
            print(f"{name:5s} {m}x{k} N={N} {m_tb}x{n_tb}: {t:.4f} ms "
                  f"({100 * bound_ms / t:.1f}% of {bound_ms:.4f} ms; "
                  f"{t / matmul_ms:.3f}x torch.matmul {matmul_ms:.4f} ms)",
                  flush=True)
        del a, b

    m = SHAPES["up"][0]
    probe = []
    for k in (64, 1024, 2048, 4096, 7168):
        a = (0.1 * torch.randn((m, k), generator=gen, device="cuda")).bfloat16()
        b = (0.1 * torch.randn((k, N), generator=gen, device="cuda")).bfloat16()
        t = ms(lambda: gemm.dense_gemm(a, b, k_tb=64, n_tb=256,
                                       out_dtype=torch.bfloat16))
        probe.append(dict(k=k, stages=k // 64, ms=t))
        print(f"probe up M={m} K={k} N={N} 128x256: {t:.4f} ms", flush=True)
    xs = [p["stages"] for p in probe if p["k"] >= 1024]
    ys = [p["ms"] for p in probe if p["k"] >= 1024]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    per_stage = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
                 / sum((x - mx) ** 2 for x in xs))
    fixed = my - per_stage * mx
    full = fixed + per_stage * (SHAPES["up"][1] // 64)
    fit = dict(fixed_ms=fixed, per_stage_ms=per_stage, up_model_ms=full,
               fixed_share_at_up=fixed / full)
    print(f"probe fit: {fixed:.4f} ms fixed + {per_stage:.5f} ms a stage; "
          f"at K = 7168 the fixed part is {100 * fixed / full:.1f}% of "
          f"{full:.4f} ms", flush=True)
    print(f"card: {card}")
    print(json.dumps(dict(card=card, rows=rows, probe=probe, fit=fit)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
