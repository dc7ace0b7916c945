"""Exact evaluation of compiled scalar graphs.

Products and sums stay exact in Z[w] until one conversion at the end, to
(real, imag) float32 pairs derived from the exact Z[w] coefficients:

    re = c0 + (c1 - c3) / sqrt(2),   im = c2 + (c1 + c3) / sqrt(2)

``evaluate_abs`` (the reference for the f32 sampling path in
``sample_f32.py``, and the sampler's path for rungs that path cannot take)
returns |amplitude| directly; ``evaluate`` returns complex values for
host-side use (reference API parity with ``tsim/compile/evaluate.py``).
"""

from __future__ import annotations

import functools
import operator

import jax
import jax.numpy as jnp
from jax import Array

from ..core.exact_scalar import ExactScalarArray
from .compile import CompiledScalarGraphs
from .terms import UNIT_PHASES

_INV_SQRT2 = 0.7071067811865476


def _coeffs_to_real_imag(coeffs: Array) -> tuple[Array, Array]:
    c = coeffs.astype(jnp.float32)
    re = c[0] + (c[1] - c[3]) * _INV_SQRT2
    im = c[2] + (c[1] + c[3]) * _INV_SQRT2
    return re, im


def _evaluate_parts(circuit: CompiledScalarGraphs, param_vals: Array):
    """Shared exact product of the four families + static prefactor.

    Returns (re, im, power) per (batch, graph) -- floats plus int32 power,
    with the per-graph power2 folded in -- or signals the approximate path.
    """
    prefactor = circuit.prefactor
    from .terms import omega_coeffs

    static_phases = ExactScalarArray.from_coeffs(
        omega_coeffs(prefactor.phase_indices)
    )
    float_factor = ExactScalarArray.from_coeffs_last(prefactor.floatfactor)

    total = functools.reduce(
        operator.mul,
        [
            circuit.node_phases.evaluate(param_vals),
            circuit.halfpi_phases.evaluate(param_vals),
            circuit.pi_products.evaluate(param_vals),
            circuit.phase_pairs.evaluate(param_vals),
            static_phases,
            float_factor,
        ],
    )
    return total


def _anchor(out: Array, param_vals: Array) -> Array:
    """Tie a (possibly constant) result to the inputs.

    Parameter-free circuits constant-fold to literal outputs; a zero-valued
    data dependence keeps the program non-constant at no cost.
    """
    return out + 0.0 * jnp.sum(param_vals, axis=-1).astype(out.dtype)


@jax.jit
def evaluate_abs(circuit: CompiledScalarGraphs, param_vals: Array) -> Array:
    """|amplitude| per batch row, all-real arithmetic."""
    prefactor = circuit.prefactor
    if prefactor.phase_indices.shape[0] == 0:
        return _anchor(jnp.zeros(param_vals.shape[0], dtype=jnp.float32), param_vals)
    total = _evaluate_parts(circuit, param_vals)
    if not prefactor.has_approximate_floatfactors:
        summed = ExactScalarArray(
            coeffs=total.coeffs, power=total.power + prefactor.power2
        ).sum()
        re, im = _coeffs_to_real_imag(summed.coeffs)
        mag = jnp.sqrt(re * re + im * im)
        return _anchor(mag * jnp.exp2(summed.power.astype(jnp.float32)), param_vals)
    re, im = _coeffs_to_real_imag(total.coeffs)
    scale = jnp.exp2(
        (total.power + prefactor.power2).astype(jnp.float32)
    )
    fre = prefactor.approximate_floatfactors[..., 0] * scale
    fim = prefactor.approximate_floatfactors[..., 1] * scale
    out_re = jnp.sum(re * fre - im * fim, axis=-1)
    out_im = jnp.sum(re * fim + im * fre, axis=-1)
    return _anchor(jnp.sqrt(out_re * out_re + out_im * out_im), param_vals)


def evaluate(circuit: CompiledScalarGraphs, param_vals: Array) -> Array:
    """Complex amplitudes (host-side use)."""
    prefactor = circuit.prefactor
    if prefactor.phase_indices.shape[0] == 0:
        return jnp.zeros(param_vals.shape[0], dtype=jnp.complex64)
    total = _evaluate_parts(circuit, param_vals)
    if not prefactor.has_approximate_floatfactors:
        summed = ExactScalarArray(
            coeffs=total.coeffs, power=total.power + prefactor.power2
        ).sum()
        re, im = _coeffs_to_real_imag(summed.coeffs)
        scale = jnp.exp2(summed.power.astype(jnp.float32))
        return (re * scale) + 1j * (im * scale)
    re, im = _coeffs_to_real_imag(total.coeffs)
    scale = jnp.exp2((total.power + prefactor.power2).astype(jnp.float32))
    fre = prefactor.approximate_floatfactors[..., 0] * scale
    fim = prefactor.approximate_floatfactors[..., 1] * scale
    out_re = jnp.sum(re * fre - im * fim, axis=-1)
    out_im = jnp.sum(re * fim + im * fre, axis=-1)
    return out_re + 1j * out_im
