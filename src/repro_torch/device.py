"""Device resolution for the port's entry points.

Entry points take ``device`` and default to ``"cuda"``. When no card is
present they raise instead of carrying on on the CPU; a caller that
wants the CPU (the parity tests) asks for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run on the CPU")
    return dev


def device_of(tree) -> Optional[torch.device]:
    """Device of the first tensor found in a params tree (None if none)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    elif hasattr(tree, "words"):
        return tree.words.device
    else:
        return None
    for v in items:
        d = device_of(v)
        if d is not None:
            return d
    return None
