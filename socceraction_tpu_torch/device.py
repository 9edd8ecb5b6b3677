"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    ``None`` means the GPU. When no GPU is present the call raises: the
    port never falls back to the CPU on its own, so a run that meant to
    measure the card cannot silently measure the host. Pass
    ``device='cpu'`` to run on the CPU. A bare ``'cuda'`` resolves to the
    current card's index, so it compares equal to the device of the
    tensors placed on it.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run on the CPU'
            )
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    return dev
