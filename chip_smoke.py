"""Smoke run of the sampler on one GPU, through the entry points a user calls.

Phases (one process; any failure ends the run with a nonzero exit):

1. Device: JAX's default device must be a GPU.
2. Every ladder rung of d=3 distillation (batch 2^20) and of 2-check
   cultivation (batch 2^16): the f32 path (plain ``jnp`` and the fused
   Triton kernel) against the exact Z[w] path, all computed on the card,
   with warm device times for each path.
3. The 0/1 float dots (parity matmul, one-hot column take, bit-plane pack,
   noise-channel parity dot) are bit-exact against numpy.
4. ``Circuit.compile_detector_sampler()`` -> ``sample()``: f32 against
   exact detector statistics over 65,536 d=3 distillation shots, then
   4 x 2^20 d=3 distillation shots and 2^19 2-check cultivation shots, with
   every warning an error (so a norm-monitor warning fails the run).

``--four`` runs only the sharded paths on four cards and their comparison
with one unsharded card (``__graft_entry__.dryrun_multichip(4)``).

The line before the last is ``nvidia-smi``'s name and power limit; the last
line is ``{"ok": true, "device": {...}}``. Run from the repository root:

    python chip_smoke.py [--four]
"""

import argparse
import json
import time
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from tsim_tpu.utils import runtime

SEED = 20261016
RTOL, ATOL = 1e-5, 1e-8  # f32 vs exact, as tests/integration/test_f32_sampling.py
EXACT_CHUNK_BYTES = 1 << 30  # per (4, chunk, T, G) int32 array of the exact path
D3_BATCH = 1 << 20  # d=3 distillation batch, phases 2 and 4
CULT_BATCH = 1 << 16  # 2-check cultivation batch, phases 2 and 4
STAT_SHOTS = 1 << 16  # f32 vs exact statistics, phase 4
DOT_ROWS = 1 << 14  # rows of the numpy-checked parity matmul, phase 3


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, reps: int = 3):
    """(result, median warm seconds); the first call compiles."""
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, sorted(times)[len(times) // 2]


def rungs_of(sampler):
    return [
        c
        for comp in sampler._program.components
        for c in comp.compiled_scalar_graphs
    ]


def term_counts(rung):
    return (
        rung.node_phases.phases.shape[0],
        rung.halfpi_phases.coeffs.shape[0],
        rung.pi_products.psi_const.shape[0],
        rung.phase_pairs.alpha.shape[0],
    )


def exact_chunk(rung, batch: int) -> int:
    """Largest power-of-two batch chunk whose (4, chunk, T, G) int32 array
    stays within EXACT_CHUNK_BYTES."""
    per_row = 16 * max(max(term_counts(rung)), 1) * max(rung.num_graphs, 1)
    chunk = batch
    while chunk > 1 and chunk * per_row > EXACT_CHUNK_BYTES:
        chunk //= 2
    return chunk


def compare_rungs(name, sampler, batch, key):
    """Phase 2: each rung's f32 forms against the exact path on the card."""
    from tsim_tpu.compile.evaluate import evaluate_abs
    from tsim_tpu.compile.sample_f32 import evaluate_abs_f32, sample_eligible
    from tsim_tpu.compile.sample_triton import evaluate_abs_f32_triton

    totals = {"exact": 0.0, "plain": 0.0, "triton": 0.0}
    for k, rung in enumerate(rungs_of(sampler)):
        if rung.num_graphs == 0:
            log(f"  {name} rung {k}: no graphs (constant), skipped")
            continue
        assert sample_eligible(rung), (name, k)
        x = jax.random.bernoulli(
            jax.random.fold_in(key, k), 0.5, (batch, rung.n_params)
        ).astype(jnp.uint8)
        rung_dev = jax.device_put(rung)
        chunk = exact_chunk(rung, batch)

        def exact(v, rung_dev=rung_dev, chunk=chunk):
            parts = [
                evaluate_abs(rung_dev, v[i : i + chunk])
                for i in range(0, v.shape[0], chunk)
            ]
            return jnp.concatenate(parts)

        want, t_exact = timed(exact, x)
        want = np.asarray(want)
        peak = float(np.abs(want).max())
        assert np.isfinite(want).all() and peak > 0, (name, k)
        line = (
            f"  {name} rung {k}: G={rung.num_graphs} P={rung.n_params} "
            f"T={term_counts(rung)} | exact {t_exact * 1e3:.3f} ms "
            f"(chunk {chunk})"
        )
        totals["exact"] += t_exact
        for form, fn in (
            ("plain", jax.jit(lambda v, r=rung: evaluate_abs_f32(r, v))),
            ("triton", jax.jit(lambda v, r=rung: evaluate_abs_f32_triton(r, v))),
        ):
            got, t = timed(fn, x)
            got = np.asarray(got)
            assert got.shape == want.shape and np.isfinite(got).all()
            err = float(np.abs(got - want).max()) / peak
            line += f" | {form} {t * 1e3:.3f} ms, max err/peak {err:.3e}"
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            assert err <= RTOL, (name, k, form, err)
            totals[form] += t
        log(line)
    log(
        f"  {name} ladder total per batch of {batch}: "
        + ", ".join(f"{f} {t * 1e3:.3f} ms" for f, t in totals.items())
    )


def check_dots(d3, cult):
    """Phase 3: the 0/1 float dots are bit-exact on the card."""
    from tsim_tpu.ops.gf2 import matmul_gf2, static_take_columns
    from tsim_tpu.sampler import _pack_bitplanes

    rng = np.random.default_rng(SEED)
    rung = max(rungs_of(cult), key=lambda c: c.num_graphs)
    for fam, a in (
        ("pi-product psi", rung.pi_products.psi_params),
        ("half-pi", rung.halfpi_phases.params),
    ):
        a = np.asarray(a, np.uint8)
        T, G, P = a.shape
        b = rng.integers(0, 2, (DOT_ROWS, P), dtype=np.uint8)
        want = b.astype(np.float64) @ a.reshape(T * G, P).T.astype(np.float64)
        sums = jax.jit(
            lambda b, a: b.astype(jnp.float32)
            @ a.astype(jnp.float32).reshape(T * G, -1).T
        )(b, a)
        assert np.array_equal(np.asarray(sums), want), fam
        par = np.asarray(jax.jit(matmul_gf2)(a, b))
        assert np.array_equal(par, (want % 2).reshape(-1, T, G)), fam
        log(f"  matmul_gf2 ({fam}, {b.shape[0]} x {P} x {T * G}): exact")

    F = cult._channel_sampler.signature_matrix.shape[1]
    x = rng.integers(0, 2, (CULT_BATCH, F), dtype=np.uint8)
    idx = np.sort(rng.choice(F, size=min(64, F), replace=False))
    got = np.asarray(jax.jit(lambda v: static_take_columns(v, idx))(x))
    assert np.array_equal(got, x[:, idx])
    log(f"  static_take_columns (one-hot, {x.shape[0]} x {F} -> {len(idx)}): exact")

    n_out = d3._program.num_outputs
    bits = rng.integers(0, 2, (D3_BATCH, n_out), dtype=np.uint8)
    got = np.asarray(jax.jit(_pack_bitplanes)(bits))
    assert np.array_equal(got, np.packbits(bits.T, axis=1, bitorder="little"))
    log(f"  _pack_bitplanes ({bits.shape[0]} x {n_out}): exact")

    dc = cult._device_channels
    K = dc.sig_cat.shape[0]
    planes = rng.integers(0, 2, (CULT_BATCH, K), dtype=np.uint8)
    counts = jax.jit(
        lambda p: jax.lax.dot_general(
            p.astype(jnp.bfloat16),
            dc._sig_dev,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    )(planes)
    want = planes.astype(np.float64) @ dc.sig_cat.astype(np.float64)
    assert np.array_equal(np.asarray(counts), want)
    log(f"  noise-channel bf16 parity dot ({planes.shape[0]} x {K} x {dc.num_f}): exact")


def sample_and_check(sampler, shots, batch, **kw):
    """Warm with one batch, then time ``shots``; returns the samples."""
    sampler.sample(batch, batch_size=batch, **kw)
    t0 = time.perf_counter()
    det = sampler.sample(shots, batch_size=batch, **kw)
    dt = time.perf_counter() - t0
    assert det.shape == (shots, sampler._num_detectors) and det.dtype == np.bool_
    log(f"  {shots} shots in batches of {batch}: {dt:.3f} s, {shots / dt:.0f} shots/s")
    return det


def statistics(d3_circuit_fn, cult):
    """Phase 4: end to end through sample(), warnings as errors."""
    from tsim_tpu.compile import sample_f32
    from tsim_tpu.sampler import _device_run_fn

    shots = STAT_SHOTS
    fracs = {}
    mode = sample_f32._SAMPLE_MODE
    try:
        for m in ("exact", "f32"):
            sample_f32._SAMPLE_MODE = m
            s = d3_circuit_fn().compile_detector_sampler(seed=0)
            fracs[m] = s.sample(shots, batch_size=shots).mean(axis=0)
    finally:
        sample_f32._SAMPLE_MODE = mode
    exact, f32 = fracs["exact"], fracs["f32"]
    sigma = np.sqrt(np.maximum(exact * (1 - exact), 1e-6) / shots)
    z = float((np.abs(f32 - exact) / sigma).max())
    log(f"  d3 distillation f32 vs exact over {shots} shots: max detector z {z:.3f}")
    assert z < 4.0 * np.sqrt(2), z

    batch = D3_BATCH
    d3 = d3_circuit_fn().compile_detector_sampler(seed=1)
    det = sample_and_check(d3, 4 * batch, batch)
    frac = det.mean(axis=0)
    sigma = np.sqrt(np.maximum(exact * (1 - exact), 1e-6) * (1 / shots + 1 / det.shape[0]))
    z = float((np.abs(frac - exact) / sigma).max())
    log(f"  d3 distillation {det.shape[0]} shots vs exact {shots}: max detector z {z:.3f}")
    assert z < 5.0, z

    runner = _device_run_fn(d3._program, d3._device_channels, 4, batch, mesh=d3._mesh)
    compiled = runner.func.lower(
        *runner.args, jax.random.key(0), np.uint32(0)
    ).compile()
    log(f"  d3 distillation batch step memory_analysis: {compiled.memory_analysis()}")

    det = sample_and_check(
        cult, 8 * CULT_BATCH, CULT_BATCH, use_detector_reference_sample=True
    )
    assert 0 < det.mean() < 0.5, det.mean()
    stats = jax.devices()[0].memory_stats()
    log(f"  peak_bytes_in_use {stats['peak_bytes_in_use']}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the sharded paths on four cards",
    )
    args = parser.parse_args()
    runtime.use_compile_cache()

    info = runtime.require_gpu(4 if args.four else 1)
    card = runtime.gpu_name_and_power_limit()
    log(f"phase 1: {info['kind']}, {info['count']} device(s); nvidia-smi: {card}")

    if args.four:
        import __graft_entry__

        t0 = time.perf_counter()
        __graft_entry__.dryrun_multichip(4)
        log(f"sharded paths on 4 cards: {time.perf_counter() - t0:.1f} s")
    else:
        from tsim_tpu.models.cultivation import cultivation_d3
        from tsim_tpu.models.distillation import distillation_d3

        def d3_circuit():
            return distillation_d3(p=0.05)

        t0 = time.perf_counter()
        d3 = d3_circuit().compile_detector_sampler(seed=0)
        cult = cultivation_d3(p=0.001, checks=2).compile_detector_sampler(seed=0)
        log(f"host compile of both ladders: {time.perf_counter() - t0:.1f} s")

        key = jax.random.key(SEED)
        log("phase 2: every rung, f32 forms vs exact, on the card")
        compare_rungs("d3 distillation", d3, D3_BATCH, jax.random.fold_in(key, 0))
        compare_rungs(
            "2-check cultivation", cult, CULT_BATCH, jax.random.fold_in(key, 1)
        )

        log("phase 3: 0/1 float dots vs numpy")
        check_dots(d3, cult)

        log("phase 4: sample() end to end, warnings as errors")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            statistics(d3_circuit, cult)

    print(runtime.gpu_name_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": runtime.device_info()}), flush=True)


if __name__ == "__main__":
    main()
