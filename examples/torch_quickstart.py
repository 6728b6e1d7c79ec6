"""Quickstart of the port: the Flash-LLM pipeline on one card.

The counterpart of ``examples/quickstart.py``:

  1. make a dense weight, prune it to 80% unstructured sparsity
  2. reformat to Tiled-CSL (the paper's sparse encoding + AOT reorder)
  3. run the Load-as-Sparse / Compute-as-Dense SpMM (the port's CUDA
     kernel on a card, its plain PyTorch version on the CPU) and check it
     against the dense result
  4. print the memory and roofline numbers behind the paper's claim, on
     the H100's published peaks

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pruning, roofline, tiled_csl
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref

M, K, N = 1024, 1024, 16          # a skinny decode-style MatMul
SPARSITY = 0.8


def main(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")

    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(dev)

    # 1. prune (magnitude, unstructured: the paper's accuracy-preserving kind)
    w_pruned = pruning.prune(w, SPARSITY)
    print(f"pruned: {float((w_pruned == 0).float().mean()):.1%} zeros")

    # 2. reformat to Tiled-CSL
    t = tiled_csl.encode(w_pruned)
    print(f"Tiled-CSL: {t.grid} tiles of {t.m_tb}x{t.k_tb}, "
          f"max_nnz={t.max_nnz}, pad overhead {t.pad_overhead:.1%}")
    print(f"bytes: dense {t.nbytes_dense / 2 ** 20:.2f} MiB -> "
          f"sparse {t.nbytes_sparse / 2 ** 20:.2f} MiB "
          f"({t.nbytes_sparse / t.nbytes_dense:.2f}x)")

    # 3. LSCD SpMM: the CUDA kernel on a card, the plain version on the CPU
    y_kernel = ops.spmm(t, x, out_dtype=torch.float32)
    y_dense = ref.spmm_dense_oracle(w_pruned, x)
    err = float((y_kernel - y_dense).abs().max())
    print(f"kernel vs dense max err: {err:.4f} (bf16 value rounding)")

    # 4. the paper's roofline argument (Eq. 1 / Eq. 2) on H100 peaks
    d = roofline.dense_gemm_terms(M, K, N)
    s = roofline.lscd_kernel_terms(M, K, N, SPARSITY,
                                   pad_overhead=t.pad_overhead)
    print(f"roofline on H100 SXM peaks "
          f"({roofline.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16, "
          f"{roofline.HBM_BW / 1e12:.2f} TB/s HBM):")
    print(f"dense : CI={roofline.dense_gemm_ci(M, N):6.1f}  "
          f"step={d.step_time_s * 1e6:7.2f} us  bound={d.bound}")
    print(f"LSCD  : CI={roofline.lscd_ci(M, N, SPARSITY):6.1f}  "
          f"step={s.step_time_s * 1e6:7.2f} us  bound={s.bound}  "
          f"-> {d.step_time_s / s.step_time_s:.2f}x faster")
    return dict(device=name, w_pruned=w_pruned, x=x, encoded=t,
                y=y_kernel, y_dense=y_dense, err=err, dense=d, lscd=s)


if __name__ == "__main__":
    main()
