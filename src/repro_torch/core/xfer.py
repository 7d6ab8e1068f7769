"""Host-transfer accounting: the counter behind ``grb.host_transfers()``.

Port of ``repro.core.xfer``. Every device->host gather inside op dispatch
bumps it (here: ``BitELL.to_ell``, the materialize fallback). Pulling a
final result (``project`` rows) is outside its scope.
"""
from __future__ import annotations

_host_transfers = [0]


def record(tag: str = "") -> None:
    """Count one device->host gather (tag is documentation only)."""
    del tag
    _host_transfers[0] += 1


def host_transfers() -> int:
    """Device->host gathers since process start (see module doc for scope)."""
    return _host_transfers[0]
