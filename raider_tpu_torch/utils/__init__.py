"""Host-side helpers."""

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device needs a working card.

    Entry points default to ``'cuda'``: without CUDA that default raises here
    instead of running anywhere else.
    """
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not available; '
                           "pass device='cpu' to run on the CPU")
    return device
