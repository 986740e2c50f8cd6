"""tak_tpu_torch: the PyTorch/CUDA port of the tak_tpu AlphaZero framework.

A second package beside `tak_tpu` (the JAX reference), importing nothing
from it.  Plain tensor code is PyTorch; every Pallas TPU kernel of the
ported paths is a hand-written CUDA kernel for Hopper (`csrc/`), built at
first use by `kernels/build.py`.  Entry points take an explicit `device`
and default to "cuda"; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
