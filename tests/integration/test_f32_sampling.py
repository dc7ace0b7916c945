"""f32 sampling-mode accuracy on the real flagship workload.

On a GPU the sampler evaluates term products in complex f32
(``compile/sample_f32.py``); graph-sum cancellation is the failure mode
f32 cannot bound a priori, so the d=3 distillation benchmark's own
compiled rungs (>=100 graphs) are checked against the exact Z[w] path:

* eval-level (CPU): the three largest rungs, 512 random noise rows,
  relative agreement ~1e-5 — far inside the sampler's 3e-3 norm-monitor
  tolerance (``sample_f32.norm_deviation_tolerance``), through the plain
  form and through the Triton kernel in interpret mode;
* sampling-level (GPU): 65k shots forced-f32 vs exact detector fractions
  at 4 sigma, with the norm monitor escalated to an error.
"""

import warnings

import numpy as np
import pytest

import tsim_tpu.compile.sample_f32 as sf
from tsim_tpu.compile.evaluate import evaluate_abs
from tsim_tpu.compile.sample_f32 import evaluate_abs_f32, sample_eligible
from tsim_tpu.compile.sample_triton import evaluate_abs_f32_triton
from tsim_tpu.models.distillation import distillation_d3


@pytest.fixture(scope="module")
def d3_sampler():
    return distillation_d3(p=0.05).compile_detector_sampler(seed=0)


@pytest.mark.parametrize("form", ["plain", "triton"])
def test_f32_eval_matches_exact_on_distillation_rungs(d3_sampler, form):
    csgs = sorted(
        (
            csg
            for comp in d3_sampler._program.components
            for csg in comp.compiled_scalar_graphs
        ),
        key=lambda c: -c.num_graphs,
    )
    assert csgs[0].num_graphs >= 100  # the >=100-graph workload claim
    rng = np.random.default_rng(11)
    for csg in csgs[:3]:
        assert sample_eligible(csg)
        vals = rng.integers(0, 2, size=(512, csg.n_params)).astype(np.uint8)
        want = np.asarray(evaluate_abs(csg, vals))
        if form == "plain":
            got = np.asarray(evaluate_abs_f32(csg, vals))
        else:
            got = np.asarray(evaluate_abs_f32_triton(csg, vals, interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


@pytest.mark.gpu
def test_f32_sampling_statistics_match_exact(gpu, monkeypatch):
    shots = 1 << 16
    fracs = {}
    for mode in ("exact", "f32"):
        monkeypatch.setattr(sf, "_SAMPLE_MODE", mode)
        s = distillation_d3(p=0.05).compile_detector_sampler(seed=0)
        with warnings.catch_warnings():
            # Any norm-monitor warning (deviation past the mode's
            # tolerance) fails the test.
            warnings.simplefilter("error")
            det = s.sample(shots, batch_size=shots)
        fracs[mode] = det.mean(axis=0)
    exact, f32 = fracs["exact"], fracs["f32"]
    sigma = np.sqrt(np.maximum(exact * (1 - exact), 1e-6) / shots)
    z = np.abs(f32 - exact) / sigma
    assert z.max() < 4.0 * np.sqrt(2), (z.max(), exact, f32)
