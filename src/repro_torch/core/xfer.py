"""Host-transfer accounting: the counter behind ``grb.host_transfers()``,
and the copies between host and card with their bytes.

Port of ``repro.core.xfer``. Every device->host gather inside op dispatch
bumps ``host_transfers`` (here: ``BitELL.to_ell``, the materialize
fallback). Pulling a final result (``project`` rows) is outside its scope.

``to_host`` and ``to_device`` do what ``.cpu()`` and ``.to(device)`` do,
and count the copies and bytes that cross between the host and a CUDA
device (``copies()``); a CPU graph counts none. Each opens a ``d2h`` /
``h2d`` span while ``repro_torch.tracing`` is on, whether or not it
crosses (its ``bytes`` then 0).
"""
from __future__ import annotations

import torch

from repro_torch import tracing

_host_transfers = [0]
_copies = {"d2h_copies": 0, "d2h_bytes": 0, "h2d_copies": 0, "h2d_bytes": 0}


def record(tag: str = "") -> None:
    """Count one device->host gather (tag is documentation only)."""
    del tag
    _host_transfers[0] += 1


def host_transfers() -> int:
    """Device->host gathers since process start (see module doc for scope)."""
    return _host_transfers[0]


def copies() -> dict:
    """Copies and bytes since process start, each way: ``d2h_copies``,
    ``d2h_bytes``, ``h2d_copies``, ``h2d_bytes``."""
    return dict(_copies)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def to_host(t: torch.Tensor, tag: str) -> torch.Tensor:
    """``t.cpu()``, counted when ``t`` lies on a CUDA device."""
    crosses = t.device.type == "cuda"
    n = _nbytes(t) if crosses else 0
    with tracing.span("d2h", tag=tag, bytes=n):
        out = t.cpu()
    if crosses:
        _copies["d2h_copies"] += 1
        _copies["d2h_bytes"] += n
    return out


def to_device(a, device, tag: str) -> torch.Tensor:
    """``torch.as_tensor(a).to(device)`` (``a`` a tensor or a numpy array,
    whose memory a CPU tensor shares), counted when a CPU tensor goes to a
    CUDA device."""
    t = torch.as_tensor(a)
    crosses = t.device.type == "cpu" and torch.device(device).type == "cuda"
    n = _nbytes(t) if crosses else 0
    with tracing.span("h2d", tag=tag, bytes=n):
        out = t.to(device)
    if crosses:
        _copies["h2d_copies"] += 1
        _copies["h2d_bytes"] += n
    return out
