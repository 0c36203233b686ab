"""vector_db_torch — the PyTorch/CUDA port of vector_db_tpu.

The same ``VectorDatabase`` API as ``vector_db_tpu`` (the JAX package, kept
as the reference), running on an explicit device (``"cuda"`` by default,
``"cpu"`` for tests).  Hot kernels are hand-written CUDA under ``csrc/``;
on CPU tensors their plain PyTorch versions run instead.  This package
imports ``torch`` and never ``jax``.
"""

from .api.config import (
    AnnoyConfig,
    CompressionConfig,
    CompressionType,
    HnswConfig,
    HnswPqConfig,
    IvfConfig,
    LshConfig,
    PqConfig,
)
from .api.database import IndexType, VectorDatabase
from .core.types import SearchResult, Vector

__version__ = "0.1.0"

__all__ = [
    "VectorDatabase",
    "IndexType",
    "Vector",
    "SearchResult",
    "CompressionConfig",
    "CompressionType",
    "HnswConfig",
    "HnswPqConfig",
    "PqConfig",
    "IvfConfig",
    "LshConfig",
    "AnnoyConfig",
    "__version__",
]
