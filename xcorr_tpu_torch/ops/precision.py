"""
:mod:`ops.precision` -- The process-wide TF32 switch, held under one lock
=========================================================================

``torch.backends.cuda.matmul.allow_tf32`` belongs to the whole process,
and cuBLAS reads it when a float32 product is launched. The port turns
it on only for the products of a ``precision='default'`` four-step call
(:mod:`ops.fft4`), and every float32 product it runs on the card (the
four-step plans, the IIR filter's chunk carry in :mod:`ops.filter`)
launches inside :func:`products` under :data:`lock`: a ``'default'``
call in one thread (the engine runs device tasks in several) then never
puts another thread's product into TF32.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["lock", "products", "pin_fp32", "tf32_enabled"]

#: held while the switch may be on, and around every float32 product
#: that must not see it on; re-entrant, so that a plan call holding it
#: may set the switch for some of its products
lock = threading.RLock()


def pin_fp32():
    """Switch TF32 off for float32 matmuls and cuDNN (10-bit mantissa,
    far off the 1e-6 bar)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_enabled() -> bool:
    """Whether either TF32 switch is on."""
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


@contextmanager
def products(tf32: bool = False):
    """Hold :data:`lock` over a block of float32 products, with the
    matmul TF32 switch set to ``tf32`` for the block and restored in
    ``finally``."""
    with lock:
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
