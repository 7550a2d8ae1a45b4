"""Where the Pallas kernels run.

One rule for every ``pallas_call`` in the package: on the GPU the kernel
is compiled (Triton route); on the CPU, where the CPU is the device, it
runs in the Pallas interpreter; any other platform has no route and
raises.  An explicit ``interpret=True`` stays available to tests.
"""
from __future__ import annotations

import jax


def interpret_mode(interpret: bool | None = None) -> bool:
    """Resolve a kernel's interpret flag.

    ``None`` decides from ``jax.default_backend()``: ``"gpu"`` -> False
    (compiled kernel), ``"cpu"`` -> True (interpreter).  A bool passes
    through unchanged."""
    if interpret is not None:
        return bool(interpret)
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas route for platform {platform!r}: kernels compile for "
        "'gpu' (Triton) and run interpreted on 'cpu'")
