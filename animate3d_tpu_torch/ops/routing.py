"""Which implementation the ops' routers take on the card.

On a CUDA device the routers (``multi_head_attention``, ``geglu_ff``) pick
a site's path with the TPU's shape predicates and run that path's
hand-written kernel. Inside :func:`plain_ops` they pick the same path and
run its plain PyTorch version instead: the reference a forward through the
kernels is held against (the JAX package's ``attention_backend("xla")``
analogue). CPU tensors never reach a kernel.
"""

from __future__ import annotations

import contextlib
import threading

_local = threading.local()


@contextlib.contextmanager
def plain_ops():
    """Run every op in this scope (this thread) on its plain version, on
    the card too."""
    prev = getattr(_local, "plain", False)
    _local.plain = True
    try:
        yield
    finally:
        _local.plain = prev


def plain_in_scope() -> bool:
    """Whether :func:`plain_ops` is in scope on this thread."""
    return getattr(_local, "plain", False)


def kernels_enabled(device) -> bool:
    """Whether the routers launch a kernel for tensors on ``device``."""
    return device.type == "cuda" and not plain_in_scope()


def recompute_contexts():
    """``context_fn`` for ``torch.utils.checkpoint(use_reentrant=False)``:
    the recomputation, which runs in autograd's thread, takes the same
    implementations as the forward did in this thread."""
    plain = plain_in_scope()
    return contextlib.nullcontext(), (plain_ops() if plain else contextlib.nullcontext())
