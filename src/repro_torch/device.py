"""Where the port's entry points run.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the CPU tests do).  Without a card they raise:
they never continue on the CPU in the card's place.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point should run on.

    Args:
        device: ``None`` (the current CUDA card), or anything
            ``torch.device`` accepts.

    Returns:
        The resolved ``torch.device``.

    Raises:
        RuntimeError: when a CUDA device is asked for (explicitly or by
            default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
