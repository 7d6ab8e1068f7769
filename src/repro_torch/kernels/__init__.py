"""Hand-written CUDA C++ kernels for Hopper (``csrc/*.cu``), built at first
use by ``kernels.build``, with their wrappers and launch counts — the port
of ``repro.kernels``."""


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched. Raised by
    ``kernels.build`` and the wrappers; the server reports it for a whole
    batch and never answers the batch some other way."""
