"""The f32 sampling path matches the exact XLA path to f32 tolerance.

Both forms of the f32 formulation run here: the plain ``jnp`` form
(``sample_f32.evaluate_abs_f32``) and the fused Pallas kernel of the
Triton route (``sample_triton.evaluate_abs_f32_triton``) in interpret
mode. The kernel's compiled form runs only on a GPU (``chip_smoke.py``).
"""

from fractions import Fraction

import jax
import numpy as np
import pytest

import tsim_tpu
import tsim_tpu.compile.sample_f32 as sf
from tsim_tpu.compile.compile import compile_scalar_graphs
from tsim_tpu.compile.evaluate import evaluate_abs
from tsim_tpu.compile.sample_f32 import (
    evaluate_abs_f32,
    evaluate_abs_sample,
    sample_eligible,
    sample_path,
    sample_tables,
)
from tsim_tpu.compile.sample_triton import block_shape, evaluate_abs_f32_triton
from tsim_tpu.zx.graph import ZXGraph


def _triton_interpret(csg, vals):
    return evaluate_abs_f32_triton(csg, vals, interpret=True)


IMPLS = {"plain": evaluate_abs_f32, "triton": _triton_interpret}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _check(impl, csg, batch=9, seed=42):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2, size=(batch, csg.n_params)).astype(np.uint8)
    want = np.asarray(evaluate_abs(csg, vals))
    got = np.asarray(impl(csg, vals))
    assert got.shape == (batch,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def _scalar_csg(build, params=("f0", "f1")):
    g = ZXGraph()
    build(g.scalar)
    return compile_scalar_graphs([g], list(params))


def test_node_phase_term(impl):
    _check(impl, _scalar_csg(lambda s: s.add_node(0.25, ["f0"])))


def test_pi_product_term(impl):
    _check(
        impl,
        _scalar_csg(
            lambda s: s.add_pi_pair(frozenset({"f0"}), frozenset({"f1"}))
        ),
    )


def test_phase_pair_term(impl):
    _check(impl, _scalar_csg(lambda s: s.add_phase_pair(1, 7, ["f0"], ["f1"])))


def test_halfpi_term(impl):
    _check(impl, _scalar_csg(lambda s: s.add_halfpi(1, ["f0"])))


def test_mixed_families(impl):
    def build(s):
        s.add_node(0.25, ["f0"])
        s.add_node(0.75, ["f1"])
        s.add_halfpi(3, ["f0"])
        s.add_pi_pair(frozenset({"f0"}), frozenset({"f1"}))
        s.add_phase_pair(1, 7, ["f0"], ["f1"])
        s.add_phase_pair(3, 5, ["f1"], ["f0"])

    _check(impl, _scalar_csg(build))


@pytest.mark.parametrize("n_graphs", [9, 17, 40])
def test_multi_graph(impl, n_graphs):
    """Graph counts that are not multiples of the graph block: padded
    graph columns must add exactly 0."""
    graphs = []
    for k in range(1, n_graphs + 1):
        g = ZXGraph()
        for j in range(k % 3 + 1):
            g.scalar.add_node(Fraction(1, 4) * (2 * j + 1), [f"f{j % 2}"])
        if k % 2:
            g.scalar.add_phase_pair(1, 7, ["f0"], ["f1"])
        if k % 5 == 0:
            g.scalar.add_halfpi(k % 8, ["f1"])
        g.scalar.power2 -= k % 3
        graphs.append(g)
    _check(impl, compile_scalar_graphs(graphs, ["f0", "f1"]))


def _multi_family_csg(n_graphs):
    """All four term families across ``n_graphs`` graphs with differing
    per-graph term counts (dead term slots must multiply in exactly 1)."""
    graphs = []
    for k in range(1, n_graphs + 1):
        g = ZXGraph()
        g.scalar.add_node(Fraction(1, 4) * (2 * (k % 3) + 1), [f"f{k % 2}"])
        if k % 2:
            g.scalar.add_phase_pair(1, 7, ["f0"], ["f1"])
        if k % 3 == 0:
            g.scalar.add_halfpi(k % 8, ["f1"])
        if k % 4 == 0:
            g.scalar.add_pi_pair(frozenset({"f0"}), frozenset({"f1"}))
        g.scalar.power2 -= k % 3
        graphs.append(g)
    return compile_scalar_graphs(graphs, ["f0", "f1"])


@pytest.mark.parametrize("n_graphs", [23, 30])
def test_multi_family(impl, n_graphs):
    _check(impl, _multi_family_csg(n_graphs), seed=7)


@pytest.mark.parametrize("n_graphs", [9, 17])
def test_multi_graph_powers(impl, n_graphs):
    """Several graphs with differing term counts and powers of sqrt(2)."""
    graphs = []
    for k in range(1, n_graphs + 1):
        g = ZXGraph()
        for j in range(k % 3 + 1):
            g.scalar.add_node(Fraction(1, 4) * (2 * j + 1), [f"f{j % 2}"])
        if k % 2:
            g.scalar.add_halfpi(1, ["f0"])
        g.scalar.add_power(k % 5 - 2)
        graphs.append(g)
    _check(impl, compile_scalar_graphs(graphs, ["f0", "f1"]), seed=7)


def _all_csgs(circuit_text, limit=3, **kwargs):
    sampler = tsim_tpu.Circuit(circuit_text).compile_sampler(seed=0, **kwargs)
    csgs = [
        csg
        for comp in sampler._program.components
        for csg in comp.compiled_scalar_graphs
    ]
    csgs.sort(key=lambda c: c.num_graphs)
    if len(csgs) > limit:
        idx = np.linspace(0, len(csgs) - 1, limit).astype(int)
        csgs = [csgs[i] for i in idx]
    return csgs


@pytest.mark.parametrize(
    "text",
    [
        "H 0\nT 0\nX_ERROR(0.2) 0\nH 0\nM 0",
        "H 0\nH 1\nT 0\nT 1\nCNOT 0 1\nDEPOLARIZE1(0.3) 0 1\n"
        "H 1\nM 0 1\nDETECTOR rec[-1] rec[-2]",
        "H 0\nH 1\nCZ 0 1\nT 0\nX_ERROR(0.25) 1\nH 0 1\nM 0 1",
        "H 0\nS 0\nT 0\nCX 0 1\nT 1\nY_ERROR(0.1) 0\nH 0\nM 0 1",
    ],
)
def test_circuit_kernels(impl, text):
    """Real compiled rungs (ladder plugs) through the f32 path."""
    for csg in _all_csgs(text):
        if csg.num_graphs:
            _check(impl, csg)


def test_eligibility_gate():
    # A tiny circuit is eligible; an absurd power2 is not.
    csg = _scalar_csg(lambda s: s.add_node(0.25, ["f0"]))
    assert sample_eligible(csg)
    g = ZXGraph()
    g.scalar.add_node(0.25, ["f0"])
    g.scalar.power2 = 400
    big = compile_scalar_graphs([g], ["f0"])
    assert not sample_eligible(big)


def test_large_common_prefactor_bias_fold(impl):
    """A deep rung's graphs share a large negative power2 (grown
    cultivation full plug: [-89, -73]); the common scale is folded out of
    the product and restored after the sum, so the circuit stays eligible
    and exact — without the fold, per-graph products would sit ~2^-100
    and their squares would flush to zero in f32."""
    graphs = []
    for k in range(30):
        g = ZXGraph()
        g.scalar.add_node(Fraction(1, 4) * (2 * (k % 4) + 1), [f"f{k % 2}"])
        if k % 3 == 0:
            g.scalar.add_phase_pair(1, 7, ["f0"], ["f1"])
        g.scalar.power2 = -85 + (k % 7)
        graphs.append(g)
    csg = compile_scalar_graphs(graphs, ["f0", "f1"])
    assert sample_eligible(csg)
    _check(impl, csg)

    # And positive-scale bias.
    for g in graphs:
        g.scalar.power2 += 150
    csg2 = compile_scalar_graphs(graphs, ["f0", "f1"])
    assert sample_eligible(csg2)
    _check(impl, csg2)


def test_sampler_uses_f32_mode(monkeypatch):
    """End-to-end: forcing f32 sampling mode preserves the sampled
    distribution (same circuit, f32 vs exact eval, statistically close)."""
    text = "H 0\nT 0\nX_ERROR(0.2) 0\nH 0\nM 0\nH 1\nT 1\nH 1\nM 1"
    shots = 4096
    monkeypatch.setattr(sf, "_SAMPLE_MODE", "exact")
    s_exact = (
        tsim_tpu.Circuit(text).compile_sampler(seed=3).sample(shots)
    )
    monkeypatch.setattr(sf, "_SAMPLE_MODE", "f32")
    s_f32 = tsim_tpu.Circuit(text).compile_sampler(seed=3).sample(shots)
    # Same seed + same Bernoulli draws + eval error << draw granularity
    # means the bits should match almost everywhere.
    assert (s_exact != s_f32).mean() < 0.01


# ---------------------------------------------------------------- wrapper

@pytest.mark.parametrize(
    "n_params, n_graphs, want",
    [
        (2, 1, (64, 16, 16)),
        (11, 103, (64, 16, 32)),
        (17, 20, (64, 32, 32)),
        (42, 307, (64, 64, 32)),
    ],
)
def test_block_shape(n_params, n_graphs, want):
    """Parameters pad to a power of two of at least 16 and graph blocks
    are powers of two of at least 16, as the Triton dot requires."""
    assert block_shape(n_params, n_graphs) == want


@pytest.mark.parametrize("batch", [1, 63, 64, 65, 130])
def test_kernel_pads_batch(batch):
    """Batches that are not multiples of the batch block come back at
    their own length, with the padded rows sliced off."""
    csg = _multi_family_csg(40)
    _check(_triton_interpret, csg, batch=batch, seed=batch)


def test_tables_pad_to_identity():
    """Padded graphs have a zero prefactor, and dead term slots and padded
    graphs have zeroed cos/sin tables (factor exactly 1)."""
    csg = _multi_family_csg(5)
    t = sample_tables(csg, 16, 32)
    assert t["np_w"].shape == (csg.node_phases.phases.shape[0], 16, 32)
    assert t["np_w"].dtype == jax.numpy.bfloat16
    assert not t["pre"][:, 5:].any()
    for key in ("np_c", "np_s", "qp_ca", "qp_sa", "qp_cb", "qp_sb"):
        assert not t[key][:, 5:].any(), key
    counts = np.asarray(csg.phase_pairs.counts)
    for g, n in enumerate(counts):
        assert not t["qp_ca"][n:, g].any()
    # A family with no terms gets one all-zero term.
    hp_only = _scalar_csg(lambda s: s.add_halfpi(1, ["f0"]))
    t = sample_tables(hp_only, 16, 16)
    assert t["np_w"].shape == (1, 16, 16) and not t["np_c"].any()


def test_dispatch_cpu_default_is_exact(monkeypatch):
    """Unset mode on the CPU keeps the exact path (seeded streams)."""
    monkeypatch.setattr(sf, "_SAMPLE_MODE", "")
    monkeypatch.setattr(sf.jax, "default_backend", lambda: "cpu")
    csg = _multi_family_csg(9)
    assert sample_path(csg) == "exact"
    assert sf.norm_deviation_tolerance() == 1e-5


def test_dispatch_gpu_default(monkeypatch):
    """Unset mode on a GPU: eligible rungs take the fused kernel,
    ineligible and empty rungs the exact path."""
    monkeypatch.setattr(sf, "_SAMPLE_MODE", "")
    monkeypatch.setattr(sf.jax, "default_backend", lambda: "gpu")
    assert sample_path(_multi_family_csg(9)) == "triton"
    assert sf.norm_deviation_tolerance() == 3e-3
    g = ZXGraph()
    g.scalar.add_node(0.25, ["f0"])
    g.scalar.power2 = 400
    assert sample_path(compile_scalar_graphs([g], ["f0"])) == "exact"
    assert sample_path(compile_scalar_graphs([], ["f0"])) == "exact"
    monkeypatch.setattr(sf, "_SAMPLE_MODE", "exact")
    assert sample_path(_multi_family_csg(9)) == "exact"


def test_dispatch_forced_f32(monkeypatch):
    """The f32 mode switch takes the plain form off the GPU, and the
    dispatch result matches the exact path."""
    monkeypatch.setattr(sf, "_SAMPLE_MODE", "f32")
    csg = _multi_family_csg(12)
    assert sample_path(csg) == "f32"
    _check(lambda c, v: evaluate_abs_sample(c, v), csg)
