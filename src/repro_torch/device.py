"""Where the port runs: CUDA unless the caller asks for the CPU (or, for
shape-only work such as the dry run, the meta device)."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device raises ``RuntimeError``
    when no card is present; the CPU and the meta device are used only
    when passed explicitly. The meta device holds no data: it is never a
    fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device`` (type, and index when
    ``device`` names one)."""
    for t in tensors:
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"tensor on {t.device}, expected {device}")


def runs_plain(device: torch.device) -> bool:
    """Whether a kernel wrapper runs its plain PyTorch version on
    ``device``: on the CPU and on the meta device (shapes only); a CUDA
    device launches the kernel."""
    return device.type in ("cpu", "meta")
