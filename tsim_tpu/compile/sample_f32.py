"""Float32 sampling-mode evaluation of compiled scalar graphs.

The exact path (``evaluate.py``) carries four int32 Z[w] coefficients and
a power of two through every term product, as (4, B, T, G) int32 arrays.
Sampling does not need exact arithmetic: the Bernoulli draw
p = |amp_1|/|amp_prefix| tolerates ~1e-4 relative error, and the reference
implementation evaluates the same products in complex float32. This module
evaluates the term product in complex float32 with every static per-term
phase factor folded into host-precomputed cos/sin tables:

* node phases: ``1 + w^(phi + 4p)`` = ``1 + sigma * (cos, sin)(phi*pi/4)``
  with ``sigma = 1 - 2p``;
* phase pairs: ``1 + w^a + w^b - w^(a+b)`` with ``a = alpha + 4p_a``
  becomes ``1 + s_a*w^alpha + s_b*w^beta - s_a s_b w^(alpha+beta)``;
* half-pi phases: integer coefficient sum, then one staged rotation;
* pi products: the sign of the summed psi*phi parities;
* prefactor: w^phase, the Z[w] floatfactor, 2^power2 and the approximate
  factor prefold into ONE complex number per graph on the host.

Every parity is a 0/1 bf16 dot with float32 accumulation: operands are
0/1 and row sums are at most P, so the sums are exact.

:func:`evaluate_abs_f32` is the plain ``jnp`` form: the form used off
the GPU and the reference for the fused GPU kernel (``sample_triton.py``).
:func:`sample_eligible` gates on dynamic range; :func:`evaluate_abs_sample`
dispatches each ladder rung to the f32 path or to the exact path.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from .compile import CompiledScalarGraphs
from .evaluate import _anchor, evaluate_abs

# w^k = exp(i k pi / 4) tables, float32 exact-dyadic where possible.
_WC = np.cos(np.arange(8) * np.pi / 4).astype(np.float32)
_WS = np.sin(np.arange(8) * np.pi / 4).astype(np.float32)
_WC[[2, 6]] = 0.0
_WS[[0, 4]] = 0.0
_SQRT_HALF = np.float32(0.7071067811865476)


# ------------------------------------------------------------- host tables

def _complex_of_coeffs(c: np.ndarray) -> np.ndarray:
    """(4, G) int Z[w] coefficients (basis 1, w, w^2, w^3) -> (2, G) f64."""
    r = np.sqrt(0.5)
    re = c[0] + (c[1] - c[3]) * r
    im = c[2] + (c[1] + c[3]) * r
    return np.stack([re, im])


def _sample_bias(circuit: CompiledScalarGraphs) -> int:
    """Common power-of-two scale folded out of the prefactor.

    A deep ladder rung can carry a large COMMON prefactor scale (grown
    cultivation full plug: power2 in [-89, -73]) that is pure headroom
    waste inside the product: per-graph values would sit ~2^-100 and
    their squares would flush to zero in f32, while the spread around the
    common scale is small. The caller multiplies the summed magnitude by
    2^bias.
    """
    p2 = np.asarray(circuit.prefactor.power2)
    return int(p2.max()) if p2.size else 0


def sample_eligible(circuit: CompiledScalarGraphs) -> bool:
    """True if the f32 dynamic range safely covers this circuit's products.

    Per-graph |product| is bounded by 2^T1 * 4^T4 and below (nonzero case)
    by |1+w^3|^T1 * |..|^T4 >= 2^(-0.4 T1 - 0.8 T4). The prefactor's
    COMMON power-of-two scale is folded out (:func:`_sample_bias`; the
    result is rescaled after the sum), so only its per-graph SPREAD
    consumes exponent budget. Keep the budget well inside f32's +-126,
    and the bias itself within the two-step rescale's reach.
    """
    t1 = int(np.asarray(circuit.node_phases.counts).max(initial=0))
    t4 = int(np.asarray(circuit.phase_pairs.counts).max(initial=0))
    p2 = np.asarray(circuit.prefactor.power2)
    # No ``initial=`` clamp: with all-negative powers (deep rungs) a
    # 0-clamped max reads the whole scale as spread.
    spread = int(p2.max() - p2.min()) if p2.size else 0
    bias = _sample_bias(circuit)
    # Positive bias multiplies back INTO the result after the sum is
    # squared, so it consumes the same exponent budget as the product
    # terms: the rescaled magnitude reaches 2^(t1+2t4+bias), and values
    # below ~2^(bias-63) flush to zero inside total**2. Bound the joint
    # budget. Negative bias only risks underflow-to-zero of values the
    # exact path's f32 output would also flush, so it gets the full
    # two-step rescale reach.
    return t1 + 2 * t4 + spread + max(bias, 0) <= 110 and bias >= -200


def _weights(params, P: int, G: int) -> np.ndarray:
    """(T, G0, P0) 0/1 params -> (max(T, 1), P, G) bf16 dot weights.

    The graph axis pads to ``G`` and the parameter axis to ``P`` with
    zeros; an empty family gets one all-zero term, whose factor the
    tables below make exactly 1.
    """
    a = np.asarray(params, np.uint8)
    T, G0, P0 = a.shape
    out = np.zeros((max(T, 1), P, G), np.uint8)
    out[:T, :P0, :G0] = a.transpose(0, 2, 1)
    return out.astype(jnp.bfloat16.dtype)


def _table(values, G: int) -> np.ndarray:
    """(T, G0) per-term table -> (max(T, 1), G) f32, zero-padded."""
    a = np.asarray(values)
    T, G0 = a.shape
    out = np.zeros((max(T, 1), G), np.float32)
    out[:T, :G0] = a
    return out


def sample_tables(circuit: CompiledScalarGraphs, P: int, G: int) -> dict:
    """Host tables of the f32 formulation, graph axis padded to ``G``.

    Dead (t, g) slots (t past a graph's term count) and padded graphs get
    zeroed cos/sin tables, which folds their factors to exactly 1, and
    padded graphs get a zero prefactor, so they add exactly 0 to the sum.
    Weights are (T, P, G) bf16; per-term tables are (T, G) f32; ``pre``
    is the (2, G) prefolded complex prefactor scaled by 2^-bias.
    """
    npf, hp = circuit.node_phases, circuit.halfpi_phases
    pp, qp, pf = circuit.pi_products, circuit.phase_pairs, circuit.prefactor
    G0 = circuit.num_graphs

    np_ph = np.asarray(npf.phases, np.int64) & 7
    live1 = np.arange(np_ph.shape[0])[:, None] < np.asarray(npf.counts)[None, :]
    qa = np.asarray(qp.alpha, np.int64) & 7
    qb = np.asarray(qp.beta, np.int64) & 7
    qg = (qa + qb) & 7
    live4 = np.arange(qa.shape[0])[:, None] < np.asarray(qp.counts)[None, :]

    ff = np.asarray(pf.floatfactor, np.float64).reshape(G0, 4).T
    pre = _complex_of_coeffs(ff)
    wph = np.exp(1j * np.pi / 4 * (np.asarray(pf.phase_indices, np.int64) & 7))
    prec = (pre[0] + 1j * pre[1]) * wph * np.exp2(
        np.asarray(pf.power2, np.float64) - _sample_bias(circuit)
    )
    approx = np.asarray(pf.approximate_floatfactors, np.float64).reshape(G0, 2)
    prec = prec * (approx[:, 0] + 1j * approx[:, 1])

    return dict(
        np_w=_weights(npf.params, P, G),
        np_c=_table(_WC[np_ph] * live1, G),
        np_s=_table(_WS[np_ph] * live1, G),
        hp_w=_weights(hp.params, P, G),
        hp_k=_table(hp.coeffs, G),
        pp_psi_w=_weights(pp.psi_params, P, G),
        pp_psi_c=_table(pp.psi_const, G),
        pp_phi_w=_weights(pp.phi_params, P, G),
        pp_phi_c=_table(pp.phi_const, G),
        qp_a_w=_weights(qp.alpha_params, P, G),
        qp_b_w=_weights(qp.beta_params, P, G),
        qp_ca=_table(_WC[qa] * live4, G), qp_sa=_table(_WS[qa] * live4, G),
        qp_cb=_table(_WC[qb] * live4, G), qp_sb=_table(_WS[qb] * live4, G),
        qp_cg=_table(_WC[qg] * live4, G), qp_sg=_table(_WS[qg] * live4, G),
        pre=_table(np.stack([prec.real, prec.imag]), G),
    )


def rescale(mag: Array, bias: int) -> Array:
    """mag * 2^bias in two steps, each a normal f32 (|bias| <= 200 is
    guaranteed by :func:`sample_eligible`)."""
    if not bias:
        return mag
    h = bias // 2
    return mag * np.float32(2.0 ** h) * np.float32(2.0 ** (bias - h))


# ------------------------------------------------------------- plain jnp

def _parities(x: Array, w: np.ndarray) -> Array:
    """(B, P) bf16 x (T, P, G) bf16 -> (B, T, G) f32 parities in {0, 1}."""
    s = jnp.einsum("bp,tpg->btg", x, w, preferred_element_type=jnp.float32)
    return s - 2.0 * jnp.floor(s * 0.5)


def _rotate(z: Array, k: Array) -> Array:
    """z * w^k for a data-dependent int32 k (staged on k's bits)."""
    z = jnp.where((k & 1) == 1, z * np.complex64(_SQRT_HALF * (1 + 1j)), z)
    z = jnp.where((k & 2) == 2, z * np.complex64(1j), z)
    return jnp.where((k & 4) == 4, -z, z)


def evaluate_abs_f32(circuit: CompiledScalarGraphs, param_vals: Array) -> Array:
    """|amplitude| per batch row, f32 formulation in plain ``jnp``.

    Each family's parities come from one dot; XLA writes them to device
    memory and fuses the factors, the product over terms and the graph
    sum into the reductions that read them back.
    """
    B, P = param_vals.shape
    t = sample_tables(circuit, P, circuit.num_graphs)
    x = param_vals.astype(jnp.bfloat16)

    p = _parities(x, t["np_w"])
    c, s = t["np_c"], t["np_s"]
    amp = jnp.prod(lax.complex((1.0 + c) - (2.0 * c) * p, s - (2.0 * s) * p), axis=1)

    pa = 1.0 - 2.0 * _parities(x, t["qp_a_w"])
    pb = 1.0 - 2.0 * _parities(x, t["qp_b_w"])
    pg = pa * pb
    fr = 1.0 + pa * t["qp_ca"] + pb * t["qp_cb"] - pg * t["qp_cg"]
    fi = pa * t["qp_sa"] + pb * t["qp_sb"] - pg * t["qp_sg"]
    amp = amp * jnp.prod(lax.complex(fr, fi), axis=1)

    k = jnp.sum(t["hp_k"] * _parities(x, t["hp_w"]), axis=1)
    amp = _rotate(amp, k.astype(jnp.int32) & 7)

    psi_c, phi_c = t["pp_psi_c"], t["pp_phi_c"]
    psi = psi_c + (1.0 - 2.0 * psi_c) * _parities(x, t["pp_psi_w"])
    phi = phi_c + (1.0 - 2.0 * phi_c) * _parities(x, t["pp_phi_w"])
    e = jnp.sum(psi * phi, axis=1)
    amp = amp * (1.0 - 2.0 * (e - 2.0 * jnp.floor(e * 0.5)))

    pre = lax.complex(t["pre"][0], t["pre"][1])
    total = jnp.sum(amp * pre, axis=1)
    return rescale(jnp.abs(total), _sample_bias(circuit))


# ------------------------------------------------------------- dispatch

# Mode switch: "f32" forces the f32 path on every backend (tests use it on
# the CPU), "exact" forces the exact path, unset = f32 on the GPU only, so
# the CPU keeps the exact path's seeded sample streams.
_SAMPLE_MODE = os.environ.get("TSIM_TPU_SAMPLE_EVAL", "").strip()


def _use_f32_sampling() -> bool:
    if _SAMPLE_MODE in ("exact", "f32"):
        return _SAMPLE_MODE == "f32"
    return jax.default_backend() == "gpu"


def norm_deviation_tolerance() -> float:
    """Warn threshold for the sampler's marginal-normalization monitor.

    The exact path deviates only by the final float conversion (~1e-7);
    f32 products accumulate ~T * 2^-23 relative error plus cancellation
    in the graph sum, so the monitor gets a wider (still tight) band.
    """
    return 3e-3 if _use_f32_sampling() else 1e-5


def sample_path(circuit: CompiledScalarGraphs) -> str:
    """Which evaluation a sampling rung takes on the default backend:
    ``"exact"``, ``"f32"`` (plain jnp) or ``"triton"`` (the fused kernel,
    GPU only)."""
    if circuit.num_graphs == 0 or not (
        _use_f32_sampling() and sample_eligible(circuit)
    ):
        return "exact"
    return "triton" if jax.default_backend() == "gpu" else "f32"


def evaluate_abs_sample(circuit: CompiledScalarGraphs, param_vals: Array) -> Array:
    """Sampling-mode dispatch: f32 path when eligible, exact otherwise."""
    path = sample_path(circuit)
    if path == "exact":
        return evaluate_abs(circuit, param_vals)
    if path == "triton":
        from .sample_triton import evaluate_abs_f32_triton

        return _anchor(evaluate_abs_f32_triton(circuit, param_vals), param_vals)
    return _anchor(evaluate_abs_f32(circuit, param_vals), param_vals)
