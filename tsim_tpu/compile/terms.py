"""Term-family pytrees for compiled scalar graphs.

Each compiled ZX scalar is a product of four families plus a static
prefactor; each family evaluates a batch of binary parameter vectors into an
:class:`ExactScalarArray` (semantics match reference ``tsim/compile/terms.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array

from ..core.exact_scalar import ExactScalarArray
from ..ops.gf2 import matmul_gf2
from ..utils.pytree import pytree_dataclass, static_field

# UNIT_PHASES[k] = exact coefficients of w^k in the (1, w, i, w^3) basis.
# Kept as numpy so jit embeds them as literals and importing the module
# touches no device.
UNIT_PHASES = np.array(
    [
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
        [-1, 0, 0, 0],
        [0, -1, 0, 0],
        [0, 0, -1, 0],
        [0, 0, 0, -1],
    ],
    dtype=np.int32,
)

_ONE_PLUS_PHASES = UNIT_PHASES.copy()
_ONE_PLUS_PHASES[:, 0] += 1
_IDENTITY = np.array([1, 0, 0, 0], dtype=np.int32)
# Transposed (4, 8) tables: indexing [:, k] yields leading-component layout.
UNIT_PHASES_T = UNIT_PHASES.T.copy()
_ONE_PLUS_PHASES_T = _ONE_PLUS_PHASES.T.copy()


def _identity_esa(batch: int, num_graphs: int) -> ExactScalarArray:
    c = jnp.zeros((4, batch, num_graphs), dtype=jnp.int32).at[0].set(1)
    return ExactScalarArray.from_coeffs(c)


def omega_coeffs(k: Array) -> Array:
    """Exact (4, ...) coefficients of w^k via arithmetic (gather-free).

    w^k = (-1)^(k // 4) * basis[k % 4], built from comparisons that fuse
    into the elementwise consumers.
    """
    k = k.astype(jnp.int32)
    sign = 1 - 2 * (k // 4)
    km = k % 4
    return jnp.stack([jnp.where(km == j, sign, 0) for j in range(4)], axis=0)


def one_plus_omega_coeffs(k: Array) -> Array:
    """Exact (4, ...) coefficients of 1 + w^k (gather-free)."""
    c = omega_coeffs(k)
    return c.at[0].add(1)


@pytree_dataclass
class NodePhases:
    """Product of ``1 + exp(i (alpha + pi * parity) )`` terms.

    ``phases`` stores alpha in eighth-turns (0-7); padded slots are masked to
    the multiplicative identity via ``counts``.
    Shapes (term axis leading, graph axis trailing):
    phases (T, G); params (T, G, P); counts (G,).
    """

    phases: Array
    params: Array
    counts: Array

    def evaluate(self, param_vals: Array) -> ExactScalarArray:
        T, G = self.phases.shape
        if T == 0:
            return _identity_esa(param_vals.shape[0], G)
        rowsum = matmul_gf2(self.params, param_vals)  # (B, T, G)
        phase_idx = (4 * rowsum + self.phases) % 8
        term_vals = one_plus_omega_coeffs(phase_idx)  # (4, B, T, G)
        mask = jnp.arange(T)[:, None] < self.counts[None, :]
        ident = jnp.asarray(_IDENTITY).reshape(4, 1, 1, 1)
        term_vals = jnp.where(mask[None], term_vals, ident)
        return ExactScalarArray.from_coeffs(term_vals).prod(axis=1)


@pytree_dataclass
class HalfPiPhases:
    """Sum of ``exp(i j pi/2 parity)`` exponents; coeffs in eighth-turns."""

    coeffs: Array  # (T, G) values in {0, 2, 4, 6}; 0 = padding
    params: Array  # (T, G, P)

    def evaluate(self, param_vals: Array) -> ExactScalarArray:
        T, G = self.coeffs.shape
        if T == 0:
            return _identity_esa(param_vals.shape[0], G)
        rowsum = matmul_gf2(self.params, param_vals)  # (B, T, G)
        phase_idx = (rowsum * self.coeffs) % 8
        total = jnp.sum(phase_idx, axis=1) % 8
        return ExactScalarArray.from_coeffs(omega_coeffs(total))


@pytree_dataclass
class PiProducts:
    """Product of ``(-1)^(psi * phi)`` terms, each side const xor parity."""

    psi_const: Array  # (T, G)
    psi_params: Array  # (T, G, P)
    phi_const: Array  # (T, G)
    phi_params: Array  # (T, G, P)

    def evaluate(self, param_vals: Array) -> ExactScalarArray:
        T, G = self.psi_const.shape
        if T == 0:
            return _identity_esa(param_vals.shape[0], G)
        psi = (self.psi_const + matmul_gf2(self.psi_params, param_vals)) % 2
        phi = (self.phi_const + matmul_gf2(self.phi_params, param_vals)) % 2
        exponent = jnp.sum((psi * phi) % 2, axis=1) % 2  # (B, G)
        sign = (1 - 2 * exponent).astype(jnp.int32)
        coeffs = sign[None] * jnp.asarray(_IDENTITY).reshape(4, 1, 1)
        return ExactScalarArray.from_coeffs(coeffs)


@pytree_dataclass
class PhasePairs:
    """Product of ``1 + e^{ia} + e^{ib} - e^{i(a+b)}`` terms."""

    alpha: Array  # (T, G) eighth-turns
    alpha_params: Array  # (T, G, P)
    beta: Array  # (T, G) eighth-turns
    beta_params: Array  # (T, G, P)
    counts: Array  # (G,)

    def evaluate(self, param_vals: Array) -> ExactScalarArray:
        T, G = self.alpha.shape
        if T == 0:
            return _identity_esa(param_vals.shape[0], G)
        ra = matmul_gf2(self.alpha_params, param_vals)
        rb = matmul_gf2(self.beta_params, param_vals)
        a = (self.alpha + 4 * ra) % 8
        b = (self.beta + 4 * rb) % 8
        g = (a + b) % 8
        ident = jnp.asarray(_IDENTITY).reshape(4, 1, 1, 1)
        term_vals = ident + omega_coeffs(a) + omega_coeffs(b) - omega_coeffs(g)
        mask = jnp.arange(self.alpha.shape[0])[:, None] < self.counts[None, :]
        term_vals = jnp.where(mask[None], term_vals, ident)
        return ExactScalarArray.from_coeffs(term_vals).prod(axis=1)


@pytree_dataclass
class ScalarPrefactor:
    """Per-graph static scalar: ``w^phase * dyadic * 2^power2`` plus an
    optional approximate complex factor for non-dyadic phases."""

    phase_indices: Array  # (G,) uint8 0-7
    floatfactor: Array  # (G, 4) int32 exact Z[w] element
    power2: Array  # (G,) int32
    approximate_floatfactors: Array  # (G, 2) float32 (re, im) pairs
    has_approximate_floatfactors: bool = static_field(default=False)
