"""Headline benchmark: detector shots/sec on 35-qubit d=3 distillation.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", "median",
"device"}, where "device" is the platform, device kind and device count as
JAX reports them. Needs a GPU: without one it exits nonzero.

Baseline normalization: the reference publishes a time-per-shot band for
tsim-CUDA on this workload (reference docs/benchmarks.svg, panel 1); at the
benchmarked error rate the GPU series sits around 1e-6 s/shot, i.e. about
1e6 shots/sec. ``vs_baseline`` is shots/sec divided by that 1e6 figure.
"""

import json
import sys
import time

from tsim_tpu.utils import runtime


def _log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


BASELINE_SHOTS_PER_SEC = 1.0e6  # tsim-CUDA-class throughput on this workload


def run_bench() -> tuple[float, float]:
    from tsim_tpu.models.distillation import distillation_d3

    t0 = time.perf_counter()
    circuit = distillation_d3(p=0.05)
    sampler = circuit.compile_detector_sampler(seed=0)
    _log(f"host compile {time.perf_counter() - t0:.0f}s")

    # 48 batches of 2^20 per timed run: the fetch pool overlaps each
    # batch's d2h with the next batches' device compute.
    batch = 1 << 20
    shots = batch * 48
    # Warm up: first call compiles the on-device run (noise sampling +
    # sampling ladder); the timed calls below reuse the jit.
    t0 = time.perf_counter()
    sampler.sample(batch * 4, batch_size=batch)
    _log(f"device warmup {time.perf_counter() - t0:.0f}s")

    # Report best AND median of 3 sustained runs.
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        det = sampler.sample(shots, batch_size=batch)
        dt = time.perf_counter() - t0
        assert det.shape[0] == shots
        runs.append(shots / dt)
        _log(f"run: {shots / dt:.0f} shots/s")
    runs.sort()
    _log(f"best {runs[-1]:.0f}, median {runs[1]:.0f} shots/s")
    return runs[-1], runs[1]


def main() -> None:
    runtime.use_compile_cache()
    device = runtime.require_gpu()
    _log(f"card: {runtime.gpu_name_and_power_limit()}")
    value, median = run_bench()
    print(
        json.dumps(
            {
                "metric": "detector_shots_per_sec_d3_distillation_35q",
                "value": round(value, 1),
                "unit": "shots/s",
                "vs_baseline": round(value / BASELINE_SHOTS_PER_SEC, 4),
                "median": round(median, 1),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
