"""bonsai_tpu_torch: the PyTorch/CUDA port of bonsai-tpu.

A Kraken-style k-mer classifier on one NVIDIA GPU, held against the JAX
package ``bonsai_tpu`` (the reference, unchanged beside it).  The layout
mirrors ``bonsai_tpu``: ``core`` (k-mer encoding), ``io`` (FASTA/FASTQ),
``native`` (the port's own copy of the host C++), ``taxonomy``,
``db`` (table, files, build), ``classify`` (pipeline, resolve, output)
and ``cli``.  The device step of ``classify`` runs three hand-written
CUDA kernels (``csrc/``, built by ``kernels.py``); each has a plain torch
version that serves CPU tensors.

This package imports torch and numpy, never jax or bonsai_tpu.
"""

__version__ = "0.1.0"
