"""Multi-workload benchmark suite: one JSON line per reference benchmark panel.

Reproduces the reference's four benchmark workloads (reference
docs/benchmarks.svg panels; BASELINE.md):

  1. d=3 15-to-1 distillation (35 qubits)   - detector shots/s
  2. d=5 distillation (85 qubits)           - detector shots/s
  3. d=3 magic-state cultivation            - detector shots/s
     (proxy 1-check / 2-check ladders plus the full-protocol
     cat-check + grow-to-d5 circuit, ``d3_cultivation_full``)
  4. d=7 rotated surface code (Clifford)    - detector shots/s

``python bench_suite.py [workload ...]`` runs the named workloads (default:
all); ``sweep`` and ``scaling`` run the error-rate sweep and the surface-code
distance scaling. The headline metric stays in bench.py (d3 distillation
only). Every JSON line names the device it ran on (platform, device kind,
device count). Needs a GPU: without one it exits nonzero.
"""

import json
import sys
import time

from tsim_tpu.utils import runtime


def _log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def _throughput(sampler, shots, batch, repeats=3, **kw):
    sampler.sample(min(shots, batch), batch_size=batch, **kw)  # warmup/compile
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = sampler.sample(shots, batch_size=batch, **kw)
        dt = time.perf_counter() - t0
        n = out[0].shape[0] if isinstance(out, tuple) else out.shape[0]
        assert n == shots
        runs.append(shots / dt)
        _log(f"  run: {shots / dt:.0f} shots/s")
    runs.sort()
    return runs[-1], runs[len(runs) // 2]


def bench_d3_distillation(p=0.05):
    from tsim_tpu.models.distillation import distillation_d3

    s = distillation_d3(p=p).compile_detector_sampler(seed=0)
    return _throughput(s, 48 << 20, 1 << 20)


def bench_d5_distillation(p=0.02):
    from tsim_tpu.models.distillation import distillation_d5

    s = distillation_d5(p=p).compile_detector_sampler(seed=0)
    return _throughput(s, 16 << 20, 1 << 19)


def bench_d3_cultivation(p=0.001):
    from tsim_tpu.models.cultivation import cultivation_d3

    _log("cultivation compile (minutes on first run)...")
    s = cultivation_d3(p=p).compile_detector_sampler(seed=0)
    return _throughput(s, 1 << 19, 1 << 16, use_detector_reference_sample=True)


def bench_d3_cultivation2():
    from tsim_tpu.models.cultivation import cultivation_d3

    _log("2-check cultivation compile (minutes on first run)...")
    s = cultivation_d3(p=0.001, checks=2).compile_detector_sampler(seed=0)
    return _throughput(s, 1 << 19, 1 << 16, use_detector_reference_sample=True)


def bench_d3_cultivation_full():
    from tsim_tpu.models.cultivation import cultivation_d3_grown

    _log("full-protocol cultivation compile (minutes on first run)...")
    s = cultivation_d3_grown(p=0.001, checks=2).compile_detector_sampler(
        seed=0
    )
    # Rank peeling cut the full plug 19.6k -> 1.1k terms, so the panel
    # sustains large batches.
    return _throughput(
        s, 1 << 21, 1 << 17, use_detector_reference_sample=True
    )


def bench_d7_surface_code(p=0.001):
    from tsim_tpu.models.surface_code import rotated_surface_code_memory_z

    c = rotated_surface_code_memory_z(
        7, 7, after_clifford_depolarization=p,
        before_measure_flip_probability=p,
        after_reset_flip_probability=p,
    )
    s = c.compile_detector_sampler(seed=0)
    # First runs pay the first-touch page-fault cost on the multi-GB
    # outputs; steady state reuses freed blocks.
    return _throughput(s, 4 << 20, 4 << 20, repeats=4)


def bench_surface_code_scaling(d=11, p=0.002):
    """BASELINE.md workload 2: d=5..11 memory with PAULI_CHANNEL_1/2
    noise, 1e6-shot batched detector+observable sampling."""
    from tsim_tpu.models.surface_code import rotated_surface_code_memory_z

    c = rotated_surface_code_memory_z(
        d, d, pauli_channel_1=(p, p / 2, p / 2),
        pauli_channel_2=tuple([p / 15] * 15),
        before_measure_flip_probability=p,
    )
    s = c.compile_detector_sampler(seed=0)
    return _throughput(s, 1 << 20, 1 << 20, repeats=4, separate_observables=True)


WORKLOADS = {
    "d3_distillation": bench_d3_distillation,
    "d5_distillation": bench_d5_distillation,
    "d3_cultivation": bench_d3_cultivation,
    "d3_cultivation2": bench_d3_cultivation2,
    "d3_cultivation_full": bench_d3_cultivation_full,
    "d7_surface_code": bench_d7_surface_code,
}

# Error-rate sweep (reference docs/benchmarks.svg plots time/shot VS error
# rate p = 1e-6..1e-2; this reproduces the figure's shape with >=3 points
# per panel, including a low-p point where host channel sampling is nearly
# free and the direct/transport paths dominate).
SWEEP = {
    "d3_distillation": (bench_d3_distillation, [1e-4, 1e-3, 1e-2, 5e-2]),
    "d5_distillation": (bench_d5_distillation, [1e-4, 1e-3, 2e-2]),
    "d7_surface_code": (bench_d7_surface_code, [1e-4, 1e-3, 1e-2]),
    # Cultivation last: each p re-runs the ZX planner (minutes of compile),
    # so a bounded run banks the cheap panels first.
    "d3_cultivation": (bench_d3_cultivation, [1e-4, 1e-3, 1e-2]),
}

SCALING_DISTANCES = [5, 7, 9, 11]


def _record_line(line, device):
    """Print one result line as soon as it is measured: a timeout mid-run
    must not lose the points already printed."""
    print(json.dumps({**line, "device": device}), flush=True)


def _run_sweep(device):
    for name, (fn, ps) in SWEEP.items():
        for p in ps:
            _log(f"=== sweep {name} p={p} ===")
            t0 = time.perf_counter()
            best, median = fn(p=p)
            line = {
                "metric": f"{name}_sweep",
                "p": p,
                "value": round(best, 1),
                "unit": "shots/s",
                "median": round(median, 1),
                "total_s": round(time.perf_counter() - t0, 1),
            }
            _record_line(line, device)


def _run_scaling(device):
    for d in SCALING_DISTANCES:
        _log(f"=== surface code scaling d={d} ===")
        t0 = time.perf_counter()
        best, median = bench_surface_code_scaling(d=d)
        line = {
            "metric": "surface_code_scaling",
            "d": d,
            "value": round(best, 1),
            "unit": "shots/s",
            "median": round(median, 1),
            "total_s": round(time.perf_counter() - t0, 1),
        }
        _record_line(line, device)


def main():
    runtime.use_compile_cache()
    device = runtime.require_gpu()
    _log(f"card: {runtime.gpu_name_and_power_limit()}")

    args = sys.argv[1:]
    if args and args[0] == "sweep":
        _run_sweep(device)
        return
    if args and args[0] == "scaling":
        _run_scaling(device)
        return
    names = args or list(WORKLOADS)
    for name in names:
        _log(f"=== {name} ===")
        t0 = time.perf_counter()
        best, median = WORKLOADS[name]()
        line = {
            "metric": name,
            "value": round(best, 1),
            "unit": "shots/s",
            "median": round(median, 1),
            "total_s": round(time.perf_counter() - t0, 1),
        }
        _record_line(line, device)


if __name__ == "__main__":
    main()
