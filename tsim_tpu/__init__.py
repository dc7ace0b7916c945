"""tsim_tpu: Stim-compatible GPU sampler for noisy non-Clifford circuits.

A from-scratch JAX/XLA/Pallas framework with the capabilities of tsim:
ZX-calculus stabilizer-rank compilation of noisy non-Clifford circuits into
static-shape binary tensors, sampled on the device in exact Z[w] or
float32 arithmetic.
"""

from .circuit import Circuit
from .sampler import (
    CompiledDetectorSampler,
    CompiledMeasurementSampler,
    CompiledStateProbs,
)

__version__ = "0.1.0"

__all__ = [
    "Circuit",
    "CompiledDetectorSampler",
    "CompiledMeasurementSampler",
    "CompiledStateProbs",
    "__version__",
]
