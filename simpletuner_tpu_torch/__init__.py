"""simpletuner_tpu_torch — the PyTorch/CUDA port of simpletuner_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths (``simpletuner_tpu/X/y.py`` has its
counterpart at ``simpletuner_tpu_torch/X/y.py``).  Plain tensor code is
PyTorch; every Pallas kernel of the JAX package becomes a kernel written by
hand for Hopper under ``csrc/``.  This package imports neither JAX nor
anything of the JAX package: it keeps its own copies of the framework-free
host modules it needs.  Entry points: ``python -m simpletuner_tpu_torch.train``,
``.inference``, ``.bench`` and ``.bench_cache``.
"""

__version__ = "0.1.0"
