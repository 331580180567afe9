"""Start MKL's vector math in every torch CPU worker thread before a test
compares torch's transcendentals with the JAX package's.

torch's CPU build routes ``exp``, ``log``, ``tanh`` (and the rest of
ATen's ``cpu/vml.h`` list) on contiguous float tensors to MKL VML
(``vmsExp`` etc., mode ``VML_HA``), split over the OpenMP threads. With
torch 2.13 and MKL 2024.2 on an AVX-512 + AMX x86 host, the first VML call
made in a worker thread can return that thread's whole chunk with relative
errors of about 1e-4: in about one process in four, the first large
``torch.exp`` of the process disagrees with its second call by ~1e-4 in
one worker's contiguous 1/8 of the elements, never in the main thread's
chunk. It happens in a process that never imports JAX. One parallel VML
call of any of these functions is enough: every later call, of any of
them, is exact (a first exp, log or tanh went wrong in 24 processes of
98; after one warm-up call, in 0 of 48).

The test modules that compare against JAX at 1e-5 call :func:`warm_vml`
at import. pytest imports every test module before the first test runs,
so in a whole run the warm-up comes before any test's first ``exp``.
"""

import torch


def warm_vml() -> None:
    """One ``torch.exp`` large enough to run on every intra-op thread
    (2^22 elements: more than the thread count times ATen's grain of
    32,768)."""
    torch.exp(torch.rand(1 << 22)).sum()
