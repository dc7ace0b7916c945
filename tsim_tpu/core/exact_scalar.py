"""Batched exact arithmetic in Z[w] * 2^power on device, w = e^{i pi/4}.

Values are ``(c0 + c1 w + c2 i + c3 w^3) * 2^power`` with int32 coefficients
and an int32 power array. Products and sums stay exact until a single float
conversion at the end (the numerical heart of the sampler; reference
``tsim/core/exact_scalar.py`` has the same contract).

Layout: coefficients are stored with the 4-component axis LEADING (shape
``(4, ...)``), so each component is a contiguous plane over the batch and
graph axes.

Reductions run as balanced trees (one reduce step per level keeps
coefficients small by dividing common factors of 2 into ``power``): total
device-memory traffic is O(1) passes over the term array instead of one
pass per term.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

import numpy as _np

from ..utils.pytree import pytree_dataclass

# numpy scalar, NOT a device op: importing the module touches no device.
_E4 = _np.exp(1j * _np.pi / 4)

def _mul_coeffs(d1: Array, d2: Array) -> Array:
    """Multiply coefficient arrays (4, ...) in Z[w] (w^4 = -1)."""
    a1, b1, c1, e1 = d1[0], d1[1], d1[2], d1[3]
    a2, b2, c2, e2 = d2[0], d2[1], d2[2], d2[3]
    A = a1 * a2 - b1 * e2 - c1 * c2 - e1 * b2
    B = a1 * b2 + b1 * a2 - c1 * e2 - e1 * c2
    C = a1 * c2 + b1 * b2 + c1 * a2 - e1 * e2
    D = a1 * e2 + b1 * c2 + c1 * b2 + e1 * a2
    return jnp.stack([A, B, C, D], axis=0).astype(d1.dtype)


def _reduce_step(power: Array, coeffs: Array) -> tuple[Array, Array]:
    reducible = jnp.all(coeffs % 2 == 0, axis=0) & jnp.any(coeffs != 0, axis=0)
    coeffs = jnp.where(reducible[None], coeffs // 2, coeffs)
    power = jnp.where(reducible, power + 1, power)
    return power, coeffs


def _mul_with_power(x, y):
    p1, c1 = x
    p2, c2 = y
    return _reduce_step(p1 + p2, _mul_coeffs(c1, c2))


def _add_with_power(x, y):
    # Align to the smaller power. The shift is clamped: a term more than
    # 2^30 below its partner cannot be represented in int32 (nor matter at
    # float32 output precision); compile-time power balancing keeps real
    # workloads far from the clamp.
    p1, c1 = x
    p2, c2 = y
    s1 = jnp.left_shift(
        jnp.ones_like(p1), jnp.clip(p1 - p2, 0, 30)
    )[None]
    s2 = jnp.left_shift(
        jnp.ones_like(p2), jnp.clip(p2 - p1, 0, 30)
    )[None]
    return _reduce_step(jnp.minimum(p1, p2), c1 * s1 + c2 * s2)


def _reduce_tree(power, coeffs, op, value_axis):
    """Balanced-tree reduction along ``value_axis``.

    A sequential fold makes N full passes over the (4, batch, graphs)
    accumulator — the dominant HBM traffic of the sampler. Halving pairs
    instead touches each element O(1) times total (2x one pass) and keeps
    every level a wide elementwise op.

    ``value_axis`` indexes the value shape (power's axes); the corresponding
    coeffs axis is ``value_axis + 1`` (leading component axis).
    """
    power = jnp.moveaxis(power, value_axis, 0)
    coeffs = jnp.moveaxis(coeffs, value_axis + 1, 1)
    while power.shape[0] > 1:
        n = power.shape[0]
        half = n // 2
        p, c = op(
            (power[:half], coeffs[:, :half]),
            (power[half : 2 * half], coeffs[:, half : 2 * half]),
        )
        if n % 2:
            p = jnp.concatenate([p, power[-1:]], axis=0)
            c = jnp.concatenate([c, coeffs[:, -1:]], axis=1)
        power, coeffs = p, c
    return power[0], coeffs[:, 0]


@pytree_dataclass
class ExactScalarArray:
    """Array of exact Z[w]-ring scalars with power-of-2 exponents.

    ``coeffs`` has shape ``(4,) + value_shape``; ``power`` has ``value_shape``.
    """

    coeffs: Array
    power: Array

    @staticmethod
    def from_coeffs_last(coeffs_last: Array, power: Array | None = None):
        """Build from a (..., 4) trailing-axis table (host-side layout)."""
        coeffs = jnp.moveaxis(coeffs_last, -1, 0)
        if power is None:
            power = jnp.zeros(coeffs.shape[1:], dtype=jnp.int32)
        return ExactScalarArray(coeffs=coeffs, power=power)

    @staticmethod
    def from_coeffs(coeffs_first: Array, power: Array | None = None):
        """Build from a (4, ...) leading-axis coefficient array."""
        if power is None:
            power = jnp.zeros(coeffs_first.shape[1:], dtype=jnp.int32)
        return ExactScalarArray(coeffs=coeffs_first, power=power)

    @property
    def value_ndim(self) -> int:
        return self.power.ndim

    def __mul__(self, other: "ExactScalarArray") -> "ExactScalarArray":
        return ExactScalarArray(
            coeffs=_mul_coeffs(self.coeffs, other.coeffs),
            power=self.power + other.power,
        )

    def sum(self, axis: int = -1) -> "ExactScalarArray":
        if axis < 0:
            axis += self.power.ndim
        n = self.power.shape[axis]
        if n == 0:
            shape = self.power.shape[:axis] + self.power.shape[axis + 1 :]
            return ExactScalarArray.from_coeffs(
                jnp.zeros((4,) + shape, dtype=self.coeffs.dtype)
            )
        p, c = _reduce_tree(self.power, self.coeffs, _add_with_power, axis)
        return ExactScalarArray(coeffs=c, power=p)

    def prod(self, axis: int = -1) -> "ExactScalarArray":
        if axis < 0:
            axis += self.power.ndim
        n = self.power.shape[axis]
        if n == 0:
            shape = self.power.shape[:axis] + self.power.shape[axis + 1 :]
            c = jnp.zeros((4,) + shape, dtype=self.coeffs.dtype).at[0].set(1)
            return ExactScalarArray.from_coeffs(c)
        p, c = _reduce_tree(self.power, self.coeffs, _mul_with_power, axis)
        return ExactScalarArray(coeffs=c, power=p)

    def to_real_imag(self) -> tuple[Array, Array]:
        """(re, im) float32 pair including the 2^power scale."""
        c = self.coeffs.astype(jnp.float32)
        inv = 0.7071067811865476
        re = c[0] + (c[1] - c[3]) * inv
        im = c[2] + (c[1] + c[3]) * inv
        scale = jnp.exp2(self.power.astype(jnp.float32))
        return re * scale, im * scale

    def abs(self) -> Array:
        re, im = self.to_real_imag()
        return jnp.sqrt(re * re + im * im)

    def to_complex(self) -> Array:
        c = self.coeffs
        val = c[0] + c[1] * _E4 + c[2] * 1j + c[3] * _E4 * 1j
        return val * jnp.pow(2.0, self.power)
