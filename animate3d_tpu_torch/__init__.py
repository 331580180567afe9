"""PyTorch + CUDA port of the MV-VDM sampling path and trainer of ``animate3d_tpu``.

The package mirrors the JAX package's module names (``ops/attention.py``,
``models/unet_mv.py``, ``pipelines/mv_sampler.py``,
``pipelines/train_mvvdm.py``, ...). Its hot ops are
hand-written Hopper kernels under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``); nothing is compiled or loaded when the package is
imported. Every entry point runs on ``cuda`` unless the caller asks for
``cpu`` (the tests do), and raises when CUDA is asked for and absent.
"""
