"""Compiled samplers: autoregressive measurement/detector sampling on device.

Semantics follow reference ``tsim/sampler.py`` (autoregressive chain-rule
sampling over the plugged-circuit ladder, norm monitoring, uniform batch
sizes for JIT shape stability, direct fast paths, postselection prefilter).
Each batch is bit-packed on device and reaches the host in one device_get.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from math import ceil
from typing import TYPE_CHECKING, Literal

import jax
import jax.numpy as jnp
import numpy as np

from .compile import aot_cache
from .compile.evaluate import evaluate_abs
from .compile.pipeline import compile_program
from .compile.sample_f32 import evaluate_abs_sample, norm_deviation_tolerance
from .core.graph_prep import prepare_graph
from .core.types import CompiledComponent, CompiledProgram
from .noise.channels import ChannelSampler
from .noise.device_channels import DeviceChannelSampler
from .ops.gf2 import static_take_columns

if TYPE_CHECKING:
    from .circuit import Circuit


def _sample_component(
    component: CompiledComponent,
    f_params: jax.Array,
    key: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Autoregressively sample this component's outputs.

    Chain rule over the plugged-circuit ladder: rung k's magnitude gives the
    joint probability of the first k+1 output bits, so each new bit is
    Bernoulli(p_k / mass) against the running prefix probability ``mass``.
    Returns (samples (B, n_outputs), next_key, max_norm_deviation).
    """
    shots = f_params.shape[0]
    ladder = component.compiled_scalar_graphs
    noise_bits = static_take_columns(f_params, component.f_selection).astype(
        jnp.uint8
    )

    mass = evaluate_abs_sample(ladder[0], noise_bits)
    drawn = jnp.zeros((shots, len(ladder) - 1), dtype=jnp.uint8)
    worst = jnp.array(0.0)
    pad_one = jnp.ones((shots, 1), dtype=jnp.uint8)

    for k, rung in enumerate(ladder[1:]):
        # One probe row (shot 0 with its new bit forced to 0) rides along in
        # the same dispatch, so marginal normalization (p0 + p1 == mass) is
        # monitored without a second kernel launch.
        stacked = jnp.vstack(
            [
                jnp.hstack([noise_bits, drawn[:, :k], pad_one]),
                jnp.hstack([noise_bits[:1], drawn[:1, :k], 1 - pad_one[:1]]),
            ]
        )
        magnitudes = evaluate_abs_sample(rung, stacked)
        p_one, probe = magnitudes[:shots], magnitudes[-1]
        worst = jnp.maximum(worst, jnp.abs((probe + p_one[0]) / mass[0] - 1.0))

        key, draw_key = jax.random.split(key)
        bit = jax.random.bernoulli(draw_key, p=jnp.clip(p_one / mass, 0.0, 1.0))
        drawn = drawn.at[:, k].set(bit.astype(jnp.uint8))
        mass = jnp.where(bit, p_one, mass - p_one)

    return drawn, key, worst


def sample_component(component, f_params, key):
    # Always trace inline: every caller sits inside a program-level jit that
    # closes over the compiled tensors, keeping them concrete numpy, from
    # which the f32 path builds its tables at trace time.
    return _sample_component(component, f_params, key)


def sample_program(
    program: CompiledProgram, f_params: jax.Array, key: jax.Array
) -> jax.Array:
    """Sample all outputs; returns (B, num_outputs) bools in original order."""
    samples, max_dev = sample_program_with_deviation(program, f_params, key)
    _check_norm_deviation(max_dev)
    return samples


def sample_program_with_deviation(
    program: CompiledProgram, f_params: jax.Array, key: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Like :func:`sample_program` but returns the device-side norm-deviation
    maximum instead of syncing per call (one host check at the end of a run)."""
    results: list[jax.Array] = []
    max_dev = jnp.zeros((1,), dtype=jnp.float32)
    if program.num_outputs == 0:
        return jnp.zeros((f_params.shape[0], 0), dtype=jnp.uint8), max_dev

    if len(program.direct_f_indices) > 0:
        if f_params.shape[1] == 0:
            # Noise-free program: every direct output is a constant.
            gathered = jnp.zeros(
                (f_params.shape[0], len(program.direct_f_indices)), jnp.uint8
            )
        else:
            gathered = static_take_columns(
                f_params, program.direct_f_indices
            ).astype(jnp.uint8)
        direct_bits = gathered ^ program.direct_flips.astype(np.uint8)
        if program.direct_const_mask is not None and program.direct_const_mask.any():
            # Constant (deterministic) detectors: drop the dummy f column.
            direct_bits = jnp.where(
                program.direct_const_mask[None, :],
                program.direct_flips.astype(np.uint8)[None, :],
                direct_bits,
            )
        results.append(direct_bits)

    for component in program.components:
        samples, key, dev = sample_component(component, f_params, key)
        max_dev = jnp.maximum(max_dev, jnp.reshape(dev, (1,)).astype(jnp.float32))
        results.append(samples)

    combined = jnp.concatenate(results, axis=1)
    if program.output_reindex is not None:
        combined = static_take_columns(combined, program.output_reindex)
    return combined, max_dev


_PROGRAM_RUNNERS: dict[int, object] = {}
_DEVICE_RUNNERS: dict[tuple, object] = {}


def _batch_step_fn(
    program: CompiledProgram,
    device_channels: DeviceChannelSampler,
    batch_size: int,
):
    """(base_key, idx) -> (packed samples, norm dev) for one batch."""

    def one(base_key, idx):
        # One batch per call: multi-batch runs loop at the Python level,
        # so each batch's d2h overlaps the next batches' compute.
        k_noise = jax.random.fold_in(base_key, 2 * idx)
        k_sample = jax.random.fold_in(base_key, 2 * idx + 1)
        f_params = device_channels.sample(k_noise, batch_size)
        out, dev = sample_program_with_deviation(program, f_params, k_sample)
        return _pack_bitplanes(out), dev

    return one


def _pack_bitplanes(out: jax.Array) -> jax.Array:
    """Bit-pack sample bits on device along the SHOT axis (bitplane
    layout): d2h carries exactly num_outputs bits per shot instead of the
    ceil(n/8)-byte row packing (1.6x fewer bytes for the 5-output
    distillation workloads). Gather-free: dot with powers of two over shot
    groups of 8. (B, n) uint8 -> (n, ceil(B/8)) uint8."""
    batch, n = out.shape
    b8 = (batch + 7) // 8
    planes = out.T  # (n, B)
    if b8 * 8 != batch:
        planes = jnp.pad(planes, ((0, 0), (0, b8 * 8 - batch)))
    powers = np.asarray([1, 2, 4, 8, 16, 32, 64, 128], np.float32)
    packed = planes.reshape(n, b8, 8).astype(jnp.float32) @ powers
    return packed.astype(jnp.uint8)


def _device_run_fn(
    program: CompiledProgram,
    device_channels: DeviceChannelSampler,
    num_batches: int,
    batch_size: int,
    mesh=None,
):
    """One jit that samples noise AND runs every batch on device.

    Takes ``(base_key, batch_index)`` and folds the per-batch noise and
    sampling keys *inside* the jit, so the batch loop issues one dispatch
    per batch and no eager key ops.

    With ``mesh`` (a 1-axis ``jax.sharding.Mesh``), the batch's shot axis is
    sharded across the mesh via ``shard_map``: compiled tensors replicate on
    every device (they are tiny, SURVEY.md section 2.3), each device folds
    its mesh position into the RNG key, and the norm monitor reduces with
    ``pmax`` over the mesh. ``batch_size`` must divide by the mesh size.
    """
    # Keyed on object identity; the cache entry keeps the keyed objects
    # alive, since a GC'd program's id could be reused and hand back a jit
    # closed over the wrong (dead) program.
    cache_key = (id(program), id(device_channels), batch_size, id(mesh))
    entry = _DEVICE_RUNNERS.get(cache_key)
    if entry is not None:
        return entry[0]

    if mesh is None:
        one = _batch_step_fn(program, device_channels, batch_size)
        fn = _hoisted_jit(one, jax.random.key(0), np.uint32(0))
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]
        n_dev = mesh.devices.size
        if batch_size % n_dev:
            raise ValueError(
                f"batch_size {batch_size} must divide by mesh size {n_dev}"
            )
        local = _batch_step_fn(program, device_channels, batch_size // n_dev)

        def sharded_one(base_key, idx):
            def body(key_rep, idx_rep):
                k = jax.random.fold_in(key_rep, jax.lax.axis_index(axis))
                packed, dev = local(k, idx_rep)
                return packed, jax.lax.pmax(dev, axis)

            return jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(), P()),
                out_specs=(P(None, axis), P()),
                check_vma=False,
            )(base_key, idx)

        fn = _hoisted_jit(
            sharded_one,
            jax.random.key(0),
            np.uint32(0),
            const_sharding=NamedSharding(mesh, P()),
        )
    _DEVICE_RUNNERS[cache_key] = (fn, program, device_channels)
    return fn


def _hoisted_jit(f, *example_args, const_sharding=None):
    """jit(f) with closed-over arrays hoisted into runtime arguments.

    Closed-over numpy/device arrays lower as inline MLIR constants, which
    bloats the lowered module for big compiled tensors (channel tables,
    term tensors): the full cultivation ladder lowered to a 638 MB
    StableHLO module. (``jax.closure_convert`` does NOT help: it only
    extracts closed-over *tracers* of an outer in-progress trace; concrete
    arrays stay baked in.)

    The reliable mechanism: trace once with ``make_jaxpr`` — the resulting
    ClosedJaxpr's ``consts`` are exactly the closed-over arrays — then
    ``eval_jaxpr`` inside a jit that receives those consts as runtime
    arguments, so they lower as parameters and transfer once via
    device_put.
    """
    closed, out_shape = jax.make_jaxpr(f, return_shape=True)(*example_args)
    out_tree = jax.tree_util.tree_structure(out_shape)
    if const_sharding is not None:
        consts = [jax.device_put(c, const_sharding) for c in closed.consts]
    else:
        consts = [jax.device_put(c) for c in closed.consts]
    jaxpr = closed.jaxpr

    @jax.jit
    def call(consts, *args):
        flat_args = jax.tree_util.tree_leaves(args)
        out = jax.core.eval_jaxpr(jaxpr, consts, *flat_args)
        return jax.tree_util.tree_unflatten(out_tree, out)

    # A partial of the jit: ``fn.func.lower(*fn.args, *args)`` reaches the
    # compiled step (memory analysis) from the returned callable.
    return functools.partial(call, consts)


def _program_runner(program: CompiledProgram):
    """One cached jit per compiled program running the full batch step.

    Keeping every device op inside a single jit lets XLA fuse the whole
    step and costs one dispatch per call.
    """
    key = id(program)
    entry = _PROGRAM_RUNNERS.get(key)
    if entry is not None:
        return entry[0]
    fn = jax.jit(
        lambda f_params, k: sample_program_with_deviation(program, f_params, k)
    )
    _PROGRAM_RUNNERS[key] = (fn, program)
    return fn


def _program_runner_hoisted(program: CompiledProgram, example_f):
    """Hoisted-constant variant keyed additionally on the f shape."""
    key = (id(program), example_f.shape, "hoisted")
    entry = _PROGRAM_RUNNERS.get(key)
    if entry is not None:
        return entry[0]
    fn = _hoisted_jit(
        lambda f_params, k: sample_program_with_deviation(program, f_params, k),
        example_f,
        jax.random.key(0),
    )
    _PROGRAM_RUNNERS[key] = (fn, program)
    return fn


def _program_runner_packed(program: CompiledProgram, example_f, mesh=None):
    """(f_params, key) -> (bitplane-packed samples, norm dev), optionally
    sharding the shot axis over ``mesh`` (survivor-batching postselection
    path; the f batch arrives from the host prefilter rather than from the
    on-device channel sampler). Requires the per-device shot count to be a
    multiple of 8 when sharded."""
    key = (id(program), example_f.shape, id(mesh), "packed")
    entry = _PROGRAM_RUNNERS.get(key)
    if entry is not None:
        return entry[0]

    def step(f_params, k):
        out, dev = sample_program_with_deviation(program, f_params, k)
        return _pack_bitplanes(out), dev

    if mesh is None:
        fn = _hoisted_jit(step, example_f, jax.random.key(0))
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]
        n_dev = mesh.devices.size
        batch = example_f.shape[0]
        if batch % (8 * n_dev):
            raise ValueError(
                f"sharded batch {batch} must divide by 8 * mesh size {n_dev}"
            )

        def sharded(f_params, k):
            def body(f_blk, k_rep):
                kk = jax.random.fold_in(k_rep, jax.lax.axis_index(axis))
                packed, dev = step(f_blk, kk)
                return packed, jax.lax.pmax(dev, axis)

            return jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axis), P()),
                out_specs=(P(None, axis), P()),
                check_vma=False,
            )(f_params, k)

        fn = _hoisted_jit(
            sharded,
            example_f,
            jax.random.key(0),
            const_sharding=NamedSharding(mesh, P()),
        )
    _PROGRAM_RUNNERS[key] = (fn, program, mesh)
    return fn


_FETCH_WORKERS = 4


class _DaemonFetchPool:
    """Minimal submit/Future pool whose workers are daemon threads.

    ``concurrent.futures.ThreadPoolExecutor`` workers are non-daemon and are
    joined at interpreter exit, so a ``jax.device_get`` still in flight
    when a consumer stops early would hold up process shutdown even after
    ``shutdown(wait=False)``, which does not cancel in-flight calls.
    Daemon workers keep exit clean while preserving the submit/Future
    interface the drain loops use.
    """

    def __init__(self, max_workers: int):
        import queue
        import threading

        self._tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads = []
        for i in range(max_workers):
            t = threading.Thread(
                target=self._work, name=f"tsim-fetch-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def _work(self) -> None:
        while True:
            item = self._tasks.get()
            if item is None:
                return
            fut, fn, args = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as exc:  # noqa: BLE001 — delivered via Future
                fut.set_exception(exc)

    def submit(self, fn, *args):
        from concurrent.futures import Future

        fut = Future()
        self._tasks.put((fut, fn, args))
        return fut

    def shutdown(self, wait: bool = False, cancel_futures: bool = False) -> None:
        import queue

        if cancel_futures:
            while True:
                try:
                    item = self._tasks.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[0].cancel()
        for _ in self._threads:
            self._tasks.put(None)
        if wait:
            for t in self._threads:
                t.join()


def _drain_fetches(pending):
    """Yield ``jax.device_get(item)`` per pending batch in order, fetched
    from a small thread pool so several d2h transfers are in flight at once
    (and all overlap the host unpack and any still-running device batches).

    Prefetch is bounded (workers + 2 in flight) so giant-batch paths don't
    materialize every batch on the host at once. One device_get per batch
    fetches (samples, norm deviation) together.
    """
    from collections import deque

    if len(pending) == 1:
        yield jax.device_get(pending[0])
        return

    ex = _DaemonFetchPool(max_workers=_FETCH_WORKERS)
    try:
        it = iter(pending)
        futs: deque = deque()
        for item in it:
            futs.append(ex.submit(jax.device_get, item))
            if len(futs) >= _FETCH_WORKERS + 2:
                break
        while futs:
            out = futs.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                futs.append(ex.submit(jax.device_get, nxt))
            yield out
    finally:
        # On early consumer exit don't block on in-flight transfers; queued
        # (not yet started) fetches are cancelled.
        ex.shutdown(wait=False, cancel_futures=True)


def _check_norm_deviation(max_dev) -> None:
    # max_dev is the (1,) array of sample_program_with_deviation.
    val = float(np.asarray(jax.device_get(max_dev))[0])
    if np.isclose(val, 1):
        raise ValueError(
            "A vanishing marginal probability distribution was encountered "
            "(normalization 0). This is likely the result of an underflow "
            "error."
        )
    if val > norm_deviation_tolerance():
        warnings.warn(
            "A marginal probability was not normalized correctly "
            f"(normalization deviated from 1 by {val:.1e}). "
            "This is likely a floating point precision issue.",
            stacklevel=2,
        )


def _available_host_memory() -> int:
    try:
        import psutil

        return int(psutil.virtual_memory().available)
    except Exception:
        return 8 * 1024**3


def _resolve_mesh(mesh):
    """Resolve the sampling mesh argument.

    ``"auto"``: shard the shot axis over all local devices when the default
    backend exposes more than one accelerator (replicated compiled tensors,
    data parallelism over shots — SURVEY.md section 5.8); single-device and
    CPU backends sample unsharded. A ``jax.sharding.Mesh`` (1 axis) is used
    as given; ``None`` disables sharding.

    Sharded and unsharded runs draw different (but individually seeded and
    reproducible) sample streams: each device folds its mesh position into
    the batch key.
    """
    if mesh is None:
        return None
    if mesh == "auto":
        if jax.default_backend() == "cpu" or jax.device_count() <= 1:
            return None
        from .parallel.shard import make_shot_mesh

        return make_shot_mesh()
    if len(mesh.axis_names) != 1:
        raise ValueError("sampling mesh must have exactly one axis")
    if mesh.devices.size <= 1:
        return None
    return mesh


@dataclasses.dataclass(frozen=True)
class _DirectScatter:
    """Precomputed layout for scattering direct (Tanner-graph) output bits.

    ``fastpath`` marks the common low-noise shape where the direct bits are
    a contiguous prefix view of the f-sample array: column ``j`` of the
    f-sample IS output ``j`` with no flip, frozen constant, or permutation
    in between, so the uint8 buffer can be reinterpreted as bools with no
    gather at all (counterpart: reference sampler.py:219-236 zero-copy path,
    redesigned as an explicit plan object).
    """

    fastpath: bool
    scatter_cols: np.ndarray  # global output index of each direct entry
    out_mask: np.ndarray  # (num_outputs,) True where the output is direct
    det_mask: np.ndarray  # out_mask restricted to the detector prefix


def _plan_direct_scatter(
    *, f_cols, flips, const, reindex, order, num_outputs, num_detectors
) -> _DirectScatter:
    n = len(f_cols)
    prefix_view = n > 0 and np.array_equal(f_cols, np.arange(n))
    untouched = reindex is None and not (flips.any() or const.any())
    cols = np.asarray(order[:n], dtype=np.int32)
    mask = np.zeros(num_outputs, dtype=np.bool_)
    mask[cols] = True
    return _DirectScatter(
        fastpath=prefix_view and untouched,
        scatter_cols=cols,
        out_mask=mask,
        det_mask=mask[:num_detectors].copy(),
    )


class _CompiledSamplerBase:
    """Shared compile-and-sample machinery.

    Compiled samplers are checkpointable: :meth:`save` writes every compiled
    tensor (all numpy) plus RNG state to disk; :meth:`load` restores a
    sampler that continues the exact same sample stream without recompiling.
    """

    # ------------------------------------------------------- checkpointing
    def __getstate__(self):
        state = dict(self.__dict__)
        # jax PRNG keys don't pickle; store raw key data. The native frame
        # sampler holds a ctypes handle: rebuilt lazily after load. The
        # mesh holds live device objects: re-resolved from the restoring
        # process's devices on load.
        state["_key"] = np.asarray(jax.random.key_data(self._key))
        state["_native_frame"] = None
        state["_mesh"] = "auto" if state.get("_mesh") is not None else None
        return state

    def __setstate__(self, state):
        key_data = state.pop("_key")
        mesh = state.pop("_mesh", None)
        self.__dict__.update(state)
        self._key = jax.random.wrap_key_data(jnp.asarray(key_data))
        self._mesh = _resolve_mesh(mesh)

    def save(self, path) -> None:
        """Checkpoint the compiled sampler (tensors + RNG state)."""
        import pickle

        with open(path, "wb") as fh:
            pickle.dump(self, fh)

    @classmethod
    def load(cls, path):
        """Restore a compiled sampler saved with :meth:`save`."""
        import pickle

        with open(path, "rb") as fh:
            obj = pickle.load(fh)
        if not isinstance(obj, cls):
            raise TypeError(f"checkpoint holds {type(obj).__name__}, not {cls.__name__}")
        return obj

    def __init__(
        self,
        circuit: "Circuit",
        *,
        sample_detectors: bool,
        mode: Literal["sequential", "joint"],
        strategy: str = "cat5",
        seed: int | None = None,
        mesh="auto",
    ):
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**30))
        self._key = jax.random.key(seed)
        self._mesh = _resolve_mesh(mesh)

        import time as _time

        # AOT compile cache: compilation is a deterministic function of the
        # circuit text + flags (seed-independent), so identical circuits
        # reuse the compiled pytrees (in-process always; across processes
        # when TSIM_TPU_COMPILE_CACHE_DIR is set).
        aot_key = aot_cache.cache_key(
            str(circuit._stim_circ),
            sample_detectors=sample_detectors,
            mode=mode,
            strategy=strategy,
        )
        cached = aot_cache.fetch(aot_key)
        t0 = _time.perf_counter()
        if cached is not None:
            self._program = cached.program
            channel_probs = cached.channel_probs
            error_transform = cached.error_transform
            num_detectors = cached.num_detectors
            t1 = t2 = t0
        else:
            prepared = prepare_graph(circuit, sample_detectors=sample_detectors)
            t1 = _time.perf_counter()
            self._program = compile_program(prepared, mode=mode, strategy=strategy)
            t2 = _time.perf_counter()
            channel_probs = prepared.channel_probs
            error_transform = prepared.error_transform
            num_detectors = prepared.num_detectors
            aot_cache.store(
                aot_key,
                aot_cache.CompiledEntry(
                    program=self._program,
                    channel_probs=channel_probs,
                    error_transform=error_transform,
                    num_detectors=num_detectors,
                ),
            )

        channel_seed = int(np.random.default_rng(seed).integers(0, 2**30))
        self._channel_sampler = ChannelSampler(
            channel_probs=channel_probs,
            error_transform=error_transform,
            seed=channel_seed,
        )
        # Per-phase compile timing (seconds), a la the reference's
        # repr-as-dashboard (SURVEY.md section 5.1).
        self.compile_stats = {
            "prepare_s": round(t1 - t0, 3),
            "decompose_s": round(t2 - t1, 3),
            "channels_s": round(_time.perf_counter() - t2, 3),
        }

        self._device_channels = DeviceChannelSampler(self._channel_sampler)

        self.circuit = circuit
        self._num_detectors = num_detectors
        self._sample_detectors = sample_detectors
        self._native_frame = None
        self._native_frame_seed = int(
            np.random.default_rng(seed + 1).integers(0, 2**30)
        )

        prog = self._program
        self._direct_f_indices = np.asarray(prog.direct_f_indices)
        self._direct_flips = np.asarray(prog.direct_flips, dtype=np.bool_)
        self._direct_const_mask = (
            np.asarray(prog.direct_const_mask, dtype=np.bool_)
            if prog.direct_const_mask is not None
            else np.zeros(len(self._direct_f_indices), dtype=np.bool_)
        )
        self._direct_reindex = (
            np.asarray(prog.output_reindex) if prog.output_reindex is not None else None
        )
        self._direct = _plan_direct_scatter(
            f_cols=self._direct_f_indices,
            flips=self._direct_flips,
            const=self._direct_const_mask,
            reindex=self._direct_reindex,
            order=prog.output_order,
            num_outputs=prog.num_outputs,
            num_detectors=self._num_detectors,
        )

    # Back-compat aliases for the plan fields (used by tests / graft entry).
    @property
    def _direct_zero_copy(self) -> bool:
        return self._direct.fastpath

    @property
    def _direct_output_mask(self) -> np.ndarray:
        return self._direct.out_mask

    @property
    def _direct_detector_mask(self) -> np.ndarray:
        return self._direct.det_mask

    # ---------------------------------------------------------------- direct
    def _compute_direct_outputs(self, f_params_np: np.ndarray) -> np.ndarray:
        """Materialize the direct (Tanner-graph) bits of each output row.

        Host-side numpy; follows the scatter plan built at compile time
        (counterpart: the reference's direct fast path, sampler.py:219-261)."""
        batch = f_params_np.shape[0]
        plan = self._direct
        width = self._program.num_outputs
        n = len(self._direct_f_indices)
        if n == 0:
            return np.zeros((batch, width), dtype=np.bool_)
        if plan.fastpath:
            # Prefix view: column j of the f-sample IS direct entry j.
            bits = f_params_np[:, :n].view(np.bool_)
            if n == width:
                return bits.copy()
        elif f_params_np.shape[1] == 0:
            bits = np.broadcast_to(self._direct_flips, (batch, n)).copy()
        else:
            gathered = f_params_np[:, self._direct_f_indices]
            bits = (gathered ^ self._direct_flips).view(np.bool_)
        frozen = self._direct_const_mask
        if frozen is not None and frozen.any():
            bits = np.array(bits)
            bits[:, frozen] = self._direct_flips[frozen]
        full = np.zeros((batch, width), dtype=np.bool_)
        full[:, plan.scatter_cols] = bits
        return full

    def _compute_reference_sample(self) -> np.ndarray:
        num_f = self._channel_sampler.signature_matrix.shape[1]
        f_ref = np.zeros((1, num_f), dtype=np.uint8)
        if not self._program.components:
            return self._compute_direct_outputs(f_ref)[0]
        # The key split stays (the sample stream layout is part of the
        # seeded-determinism contract) but the device evaluation of the
        # noiseless f=0 row is deterministic: compute it once and reuse
        # (it previously ran the full ladder on device per sample() call).
        self._key, subkey = jax.random.split(self._key)
        cached = getattr(self, "_reference_cache", None)
        if cached is not None:
            return cached
        f_ref_dev = jnp.asarray(f_ref)
        out, dev = _program_runner_hoisted(self._program, f_ref_dev)(f_ref_dev, subkey)
        _check_norm_deviation(dev)
        result = np.asarray(jax.device_get(out)).view(np.bool_)[0]
        self._reference_cache = result
        return result

    # -------------------------------------------------------------- batching
    def _peak_bytes_per_sample(self) -> int:
        # Noise configurations (B, num_f) uint8 plus working copies, and the
        # on-device channel sampler's (B, C, O) one-hot intermediates.
        peak = 8 * self._channel_sampler.signature_matrix.shape[1]
        peak = max(peak, self._device_channels.peak_bytes_per_shot)
        for component in self._program.components:
            for circuit in component.compiled_scalar_graphs:
                G = circuit.num_graphs
                max_a = circuit.node_phases.phases.shape[0]
                max_b = circuit.halfpi_phases.coeffs.shape[0]
                max_c = circuit.pi_products.psi_const.shape[0]
                max_d = circuit.phase_pairs.alpha.shape[0]
                largest = max(max_a * 16, max_b * 4, max_c * 4, max_d * 16)
                peak = max(peak, G * largest * 3)
        return max(peak, 1)

    def _estimate_batch_size(self) -> int:
        device = jax.devices()[0]
        if device.platform == "cpu":
            available = _available_host_memory()
        else:
            stats = device.memory_stats()
            if not stats or "bytes_limit" not in stats:
                raise RuntimeError(
                    f"{device.device_kind} reports no memory limit "
                    f"(memory_stats() = {stats!r}); pass batch_size"
                )
            available = stats["bytes_limit"] - stats.get("bytes_in_use", 0)
        return max(1, int(available * 0.5) // self._peak_bytes_per_sample())

    def _resolve_batch_size(
        self, shots: int, batch_size: int | None, *, compute_reference: bool
    ) -> int:
        if batch_size is None:
            max_batch_size = self._estimate_batch_size()
            num_batches = max(1, ceil(shots / max_batch_size))
            batch_size = ceil(shots / num_batches)
        if compute_reference and batch_size * ceil(shots / batch_size) == shots:
            batch_size += 1
        return batch_size

    # -------------------------------------------------------------- sampling
    @staticmethod
    def _validate_shot_args(shots: int, batch_size: int | None) -> None:
        if shots < 0:
            raise ValueError(f"shots must be non-negative, got {shots}")
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, got {batch_size}")

    def _sample_batches(
        self,
        shots: int,
        batch_size: int | None = None,
        *,
        compute_reference: bool = False,
    ):
        self._validate_shot_args(shots, batch_size)

        if shots == 0:
            empty = np.empty((0, self._program.num_outputs), dtype=np.bool_)
            if compute_reference:
                return empty, np.zeros(self._program.num_outputs, dtype=np.bool_)
            return empty

        if not self._program.components:
            # Fully-direct programs: no quantum evaluation at all. Clifford
            # circuits ride the native C++ Pauli-frame sampler (bit-packed,
            # ~10M shots/s); the host geometric-skip path remains the CPU
            # default so cross-path determinism tests stay seed-stable.
            import os as _os

            use_native = (
                jax.default_backend() != "cpu"
                or _os.environ.get("TSIM_TPU_NATIVE_DIRECT") == "1"
            )
            if use_native:
                native = self._native_frame_sampler()
                if native is not None:
                    if self._sample_detectors:
                        # Joined single-allocation layout; the absolute
                        # baseline is already folded into the op stream
                        # (det_bias), so no extra pass over the multi-GB
                        # output is needed.
                        samples = native.sample_det_obs_joined(shots)
                    else:
                        rec, _, _ = native.sample(
                            shots, include_measurements=True
                        )
                        samples = rec
                    if compute_reference:
                        return samples, self._compute_reference_sample()
                    return samples
            samples = self._sample_direct(shots)
            if compute_reference:
                return samples, self._compute_reference_sample()
            return samples

        if batch_size is None:
            max_batch_size = self._estimate_batch_size()
            num_batches = max(1, ceil(shots / max_batch_size))
            batch_size = ceil(shots / num_batches)
        else:
            num_batches = ceil(shots / batch_size)
        if self._mesh is not None:
            # The shot axis shards across the mesh: round the batch up so
            # every device holds a multiple of 8 shots (each shard bitplane-
            # packs its own shots; surplus rows are trimmed after unpacking).
            q = 8 * self._mesh.devices.size
            batch_size = ((batch_size + q - 1) // q) * q

        reference: np.ndarray | None = None
        if compute_reference:
            reference = self._compute_reference_sample()

        # Fully on-device batches: noise sampling + sampling ladder in one
        # jit per batch, dispatched asynchronously from a Python loop; one
        # bit-packed uint8 d2h per batch. Per-batch keys fold inside the
        # jit; the only eager key op per call is this one split.
        self._key, base_key = jax.random.split(self._key)
        runner = _device_run_fn(
            self._program,
            self._device_channels,
            num_batches,
            batch_size,
            mesh=self._mesh,
        )
        pending = [
            runner(base_key, np.uint32(bi)) for bi in range(num_batches)
        ]
        num_outputs = self._program.num_outputs
        result = np.empty((shots, num_outputs), dtype=np.bool_)
        max_dev = np.zeros(1, dtype=np.float32)
        row = 0
        for packed, dev_h in _drain_fetches(pending):
            # Bitplane layout: (num_outputs, B/8) packed along shots.
            take = min(batch_size, shots - row)
            planes = np.unpackbits(
                np.asarray(packed), axis=1, bitorder="little"
            )[:, :take]
            result[row : row + take] = planes.T
            row += take
            max_dev = np.maximum(max_dev, np.asarray(dev_h))
        _check_norm_deviation(max_dev)

        return (result, reference) if compute_reference else result

    def _sample_batches_with_postselection(
        self,
        shots: int,
        batch_size: int | None,
        *,
        postselection_mask: np.ndarray,
        fold_detector_reference: bool = False,
        compute_reference: bool = False,
    ):
        """Postselected sampling: direct-discarded shots never reach JAX."""
        self._validate_shot_args(shots, batch_size)
        n_out = self._program.num_outputs

        if shots == 0:
            # Zero-shot contract: an all-False reference row (never
            # evaluated) and empty sample/discard arrays.
            ref0 = np.zeros(n_out, dtype=np.bool_) if compute_reference else None
            return np.empty((0, n_out), dtype=np.bool_), ref0, np.empty(0, dtype=np.bool_)

        # Columns the direct (Clifford) prefilter can postselect on without
        # any device evaluation.
        postselect_direct = postselection_mask & self._direct_detector_mask

        if not self._program.components:
            # Fully-direct program: host sampling only; nothing is ever
            # discarded here (the caller applies the mask to the rows).
            rows = self._sample_direct(shots)
            ref = self._compute_reference_sample() if compute_reference else None
            if ref is not None and fold_detector_reference:
                nd = self._num_detectors
                rows[:, :nd] ^= ref[:nd]
            return rows, ref, np.zeros(shots, dtype=np.bool_)

        if batch_size is None:
            batch_size = self._resolve_batch_size(shots, None, compute_reference=False)
        if self._mesh is not None:
            # Survivor batches shard over the mesh too; every device packs
            # its own shots, so round to a multiple of 8 * n_dev.
            q = 8 * self._mesh.devices.size
            batch_size = ((batch_size + q - 1) // q) * q

        reference = self._compute_reference_sample() if compute_reference else None

        result = np.zeros((shots, n_out), dtype=np.bool_)
        dropped = np.zeros(shots, dtype=np.bool_)
        survivor_f: list[np.ndarray] = []
        survivor_idx: list[int] = []

        # Bounded async pipeline: dispatches enqueue and start their d2h on
        # a fetch-pool thread immediately (see _drain_fetches); retires
        # consume in order, so host-side channel sampling and direct
        # prefiltering overlap everything.
        fetch_pool = _DaemonFetchPool(max_workers=_FETCH_WORKERS)
        pending: list[tuple] = []

        def _retire():
            fut, indices, n_valid = pending.pop(0)
            out, dev_h = fut.result()
            _check_norm_deviation(dev_h)
            planes = np.unpackbits(
                np.asarray(out), axis=1, bitorder="little"
            )[:, :n_valid]
            result[indices[:n_valid]] = planes.T.astype(np.bool_)

        def _dispatch(f_batch, indices, n_valid):
            self._key, subkey = jax.random.split(self._key)
            f_dev = jnp.asarray(f_batch)
            out_dev, dev = _program_runner_packed(
                self._program, f_dev, mesh=self._mesh
            )(f_dev, subkey)
            fut = fetch_pool.submit(jax.device_get, (out_dev, dev))
            pending.append((fut, list(indices), n_valid))
            while len(pending) > _FETCH_WORKERS + 2:
                _retire()

        def _flush(final=False):
            nonlocal survivor_f, survivor_idx
            while len(survivor_f) >= batch_size:
                _dispatch(np.stack(survivor_f[:batch_size]), survivor_idx[:batch_size], batch_size)
                survivor_f = survivor_f[batch_size:]
                survivor_idx = survivor_idx[batch_size:]
            if final and survivor_f:
                n_valid = len(survivor_f)
                stack = np.stack(survivor_f)
                f_batch = np.empty((batch_size, stack.shape[1]), dtype=stack.dtype)
                f_batch[:n_valid] = stack
                f_batch[n_valid:] = stack[0]
                _dispatch(f_batch, survivor_idx, n_valid)
                survivor_f = []
                survivor_idx = []

        nd = self._num_detectors
        # The prefilter only reads masked columns, and XOR distributes over
        # the mask ((a ^ r) & m == (a & m) ^ (r & m)), so the reference row
        # folds into one precomputed masked pattern instead of a per-chunk
        # XOR over the whole detector block.
        masked_ref = None
        if fold_detector_reference and reference is not None:
            masked_ref = reference[:nd] & postselect_direct

        try:
            taken = 0
            while taken < shots:
                want = min(batch_size, shots - taken)
                f_chunk = self._channel_sampler.sample(want)
                fast_bits = self._compute_direct_outputs(f_chunk)[:, :nd]
                result[taken : taken + want, :nd] = fast_bits
                sel = fast_bits & postselect_direct
                if masked_ref is not None:
                    sel ^= masked_ref
                keep = ~sel.any(axis=1)
                dropped[taken : taken + want] = ~keep
                kept_rows = np.flatnonzero(keep)
                if kept_rows.size:
                    survivor_f.extend(f_chunk[kept_rows])
                    survivor_idx.extend((taken + kept_rows).tolist())
                taken += want
                _flush()
            _flush(final=True)
            while pending:
                _retire()
        finally:
            fetch_pool.shutdown(wait=False, cancel_futures=True)

        if fold_detector_reference and reference is not None:
            det_ref = reference[:nd]
            result[~dropped, :nd] ^= det_ref
            result[dropped, :nd] ^= det_ref & self._direct_detector_mask

        if compute_reference:
            assert reference is not None
            return result, reference, dropped
        return result, None, dropped

    def _native_baseline(self) -> np.ndarray:
        """Deterministic noiseless DETECTOR outputs: the frame sampler
        returns stim-style detector flips (observables it already reports
        absolutely, via the absolute measurement record); XOR with this
        baseline gives the absolute detector values the ZX path produces."""
        num_f = self._channel_sampler.signature_matrix.shape[1]
        base = self._compute_direct_outputs(np.zeros((1, num_f), np.uint8))[0]
        return base[: self._num_detectors]

    def _native_frame_sampler(self):
        """Native C++ Pauli-frame sampler for fully-direct Clifford circuits."""
        if self._native_frame is not None:
            return self._native_frame
        try:
            if not self.circuit.is_clifford:
                return None
            from .stim_core.native_frame import NativeFrameSampler

            # Detector samplers fold the absolute baseline into the op
            # stream (det_bias): detector rows come out absolute, avoiding
            # a full XOR pass over the multi-GB unpacked output.
            det_bias = (
                self._native_baseline() if self._sample_detectors else None
            )
            self._native_frame = NativeFrameSampler(
                self.circuit.stim_circuit,
                seed=self._native_frame_seed,
                det_bias=det_bias,
            )
        except Exception:
            return None
        return self._native_frame

    def _sample_direct(self, shots: int) -> np.ndarray:
        f_params = self._channel_sampler.sample(shots)
        if self._direct_zero_copy:
            return f_params[:, : len(self._direct_f_indices)].view(np.bool_)
        if f_params.shape[1] == 0:
            result = np.broadcast_to(
                self._direct_flips, (shots, len(self._direct_f_indices))
            ).copy()
        else:
            result = f_params[:, self._direct_f_indices] ^ self._direct_flips
        if self._direct_const_mask.any():
            result[:, self._direct_const_mask] = self._direct_flips[
                self._direct_const_mask
            ]
        if self._direct_reindex is not None:
            result = result[:, self._direct_reindex]
        return result.view(np.bool_)

    def __repr__(self) -> str:
        n_direct = len(self._program.direct_f_indices)
        c_graphs, c_params = [], []
        a = b = c = d = 0
        num_outputs = []
        total_bytes = 0
        for comp in self._program.components:
            for circ in comp.compiled_scalar_graphs:
                num_outputs.append(len(comp.output_indices))
                c_graphs.append(circ.num_graphs)
                c_params.append(circ.n_params)
                a += circ.node_phases.phases.size
                b += circ.halfpi_phases.coeffs.size
                c += circ.pi_products.psi_const.size
                d += circ.phase_pairs.alpha.size + circ.phase_pairs.beta.size
                total_bytes += sum(
                    v.nbytes
                    for v in jax.tree_util.tree_leaves(circ)
                    if isinstance(v, (jax.Array, np.ndarray))
                )
        error_bits = sum(ch.num_bits for ch in self._channel_sampler.channels)

        def fmt(n):
            if n < 1024:
                return f"{n} B"
            if n < 1024**2:
                return f"{n / 1024:.1f} kB"
            return f"{n / 1024**2:.1f} MB"

        return (
            f"{type(self).__name__}({n_direct} direct, {int(np.sum(c_graphs))} graphs, "
            f"{error_bits} error channel bits, "
            f"{max(num_outputs) if num_outputs else 0} outputs for largest cc, "
            f"≤ {max(c_params) if c_params else 0} parameters, {a} A terms, "
            f"{b} B terms, {c} C terms, {d} D terms, {fmt(total_bytes)})"
        )


class CompiledMeasurementSampler(_CompiledSamplerBase):
    """Samples measurement outcomes (sequential ladder)."""

    def __init__(
        self, circuit, *, strategy: str = "cat5", seed: int | None = None,
        mesh="auto",
    ):
        super().__init__(
            circuit, sample_detectors=False, mode="sequential", seed=seed,
            strategy=strategy, mesh=mesh,
        )

    def sample(self, shots: int, *, batch_size: int | None = None) -> np.ndarray:
        return self._sample_batches(shots, batch_size)


def _maybe_bit_pack(array: np.ndarray, *, bit_packed: bool) -> np.ndarray:
    if not bit_packed:
        return array
    return np.packbits(array.astype(np.bool_), axis=1, bitorder="little")


class CompiledDetectorSampler(_CompiledSamplerBase):
    """Samples detector and observable outcomes."""

    def __init__(
        self, circuit, *, strategy: str = "cat5", seed: int | None = None,
        mesh="auto",
    ):
        super().__init__(
            circuit, sample_detectors=True, mode="sequential", seed=seed,
            strategy=strategy, mesh=mesh,
        )

    def _coerce_postselection_mask(self, mask) -> np.ndarray | None:
        """Validate a user postselection mask; collapse it to None whenever
        the Clifford prefilter has nothing to act on (no direct detector is
        selected, or the whole program is direct) — those cases sample
        identically through the plain batched path."""
        if mask is None:
            return None
        mask = np.asarray(mask, dtype=np.bool_)
        if mask.shape != (self._num_detectors,):
            raise ValueError(
                f"postselection_mask must have shape ({self._num_detectors},), "
                f"got {mask.shape}"
            )
        prefilterable = self._program.components and (
            mask & self._direct_detector_mask
        ).any()
        return mask if prefilterable else None

    def sample(
        self,
        shots: int,
        *,
        batch_size: int | None = None,
        bit_packed: bool = False,
        postselection_mask: np.ndarray | None = None,
        use_detector_reference_sample: bool = False,
        use_observable_reference_sample: bool = False,
        prepend_observables: bool = False,
        append_observables: bool = False,
        separate_observables: bool = False,
    ):
        if separate_observables and (prepend_observables or append_observables):
            raise ValueError(
                "separate_observables=True is mutually exclusive with the "
                "prepend/append observable layouts"
            )
        compute_reference = (
            use_detector_reference_sample or use_observable_reference_sample
        )

        # Fully-direct Clifford fast path: fetch detectors/observables from
        # the native frame sampler in their final (possibly bit-packed)
        # layout, skipping the unpack + repack round trip.
        import os as _os

        if (
            postselection_mask is None
            and not compute_reference
            and not prepend_observables
            and not self._program.components
            and (
                jax.default_backend() != "cpu"
                or _os.environ.get("TSIM_TPU_NATIVE_DIRECT") == "1"
            )
        ):
            native = self._native_frame_sampler()
            if native is not None:
                # det_bias folded the absolute baseline into the op stream.
                _, det, obs = native.sample(
                    shots, bit_packed=bit_packed, include_measurements=False
                )
                if separate_observables:
                    return det, obs
                if append_observables:
                    if bit_packed:
                        joined = np.concatenate(
                            [
                                np.unpackbits(det, axis=1, bitorder="little")[
                                    :, : self._num_detectors
                                ],
                                np.unpackbits(obs, axis=1, bitorder="little")[
                                    :, : self._program.num_outputs
                                    - self._num_detectors
                                ],
                            ],
                            axis=1,
                        ).astype(bool)
                        return _maybe_bit_pack(joined, bit_packed=True)
                    return np.concatenate([det, obs], axis=1)
                return det

        prefilter_mask = self._coerce_postselection_mask(postselection_mask)
        nd = self._num_detectors

        if prefilter_mask is None:
            # Plain batched path. Reference folds (detector and observable)
            # apply uniformly across every shot.
            if compute_reference:
                samples, reference = self._sample_batches(
                    shots, batch_size, compute_reference=True
                )
                if use_detector_reference_sample:
                    samples[:, :nd] ^= reference[:nd]
                if use_observable_reference_sample:
                    samples[:, nd:] ^= reference[nd:]
            else:
                samples = self._sample_batches(shots, batch_size)
        else:
            # Prefiltered path: the detector fold happens inside (it decides
            # which rows the Clifford prefilter discards); discarded rows are
            # never device-evaluated, so the observable fold only touches the
            # survivors.
            samples, reference, dropped = self._sample_batches_with_postselection(
                shots,
                batch_size,
                postselection_mask=prefilter_mask,
                fold_detector_reference=use_detector_reference_sample,
                compute_reference=compute_reference,
            )
            if use_observable_reference_sample:
                samples[~dropped, nd:] ^= reference[nd:]

        det = samples[:, : self._num_detectors]
        obs = samples[:, self._num_detectors :]

        if prepend_observables and append_observables:
            combined = np.concatenate([obs, det, obs], axis=1)
            return _maybe_bit_pack(combined, bit_packed=bit_packed)
        if append_observables:
            return _maybe_bit_pack(samples, bit_packed=bit_packed)
        if prepend_observables:
            return _maybe_bit_pack(np.concatenate([obs, det], axis=1), bit_packed=bit_packed)
        if separate_observables:
            return (
                _maybe_bit_pack(det, bit_packed=bit_packed),
                _maybe_bit_pack(obs, bit_packed=bit_packed),
            )
        return _maybe_bit_pack(det, bit_packed=bit_packed)


class CompiledStateProbs(_CompiledSamplerBase):
    """Joint-mode probability estimator: P(state | error sample)."""

    def __init__(
        self,
        circuit,
        *,
        sample_detectors: bool = False,
        strategy: str = "cat5",
        seed: int | None = None,
        mesh="auto",
    ):
        super().__init__(
            circuit, sample_detectors=sample_detectors, mode="joint", seed=seed,
            strategy=strategy, mesh=mesh,
        )

    def probability_of(self, state: np.ndarray, *, batch_size: int) -> np.ndarray:
        if batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, got {batch_size}")
        expected = self._program.num_outputs
        state = np.asarray(state)
        if state.shape != (expected,):
            raise ValueError(f"state must have shape ({expected},), got {state.shape}")
        f_samples = jnp.asarray(self._channel_sampler.sample(batch_size))
        mesh = self._mesh
        if (
            mesh is not None
            and batch_size % mesh.devices.size == 0
            and mesh.devices.size > 1
        ):
            # Shard the batch axis of the whole estimator over the mesh. All
            # ops are elementwise over shots, so XLA partitions them without
            # collectives; the state vector is replicated.
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            axis = mesh.axis_names[0]
            fn = self._state_probs_runner(f_samples.shape, mesh)
            f_samples = jax.device_put(f_samples, NamedSharding(mesh, P(axis)))
            return np.asarray(fn(f_samples, jnp.asarray(state)))
        return np.asarray(self._probability_body(f_samples, state))

    def _state_probs_runner(self, f_shape, mesh):
        """Cached batch-sharded jit of the probability estimator body."""
        key = (id(self._program), f_shape, id(mesh), "state_probs")
        entry = _PROGRAM_RUNNERS.get(key)
        if entry is not None:
            return entry[0]
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        axis = mesh.axis_names[0]
        fn = jax.jit(
            self._probability_body,
            in_shardings=(
                NamedSharding(mesh, P(axis)),
                NamedSharding(mesh, P()),
            ),
        )
        _PROGRAM_RUNNERS[key] = (fn, self._program)
        return fn

    def _probability_body(self, f_samples, state):
        """P(state | f) / norm over the batch; pure jax, shard-friendly."""
        batch_size = f_samples.shape[0]
        p_norm = jnp.ones(batch_size)
        p_joint = jnp.ones(batch_size)

        if len(self._program.direct_f_indices) > 0:
            n_direct = len(self._program.direct_f_indices)
            if f_samples.shape[1] == 0:
                gathered = jnp.zeros((batch_size, n_direct), jnp.uint8)
            else:
                gathered = static_take_columns(
                    f_samples, self._program.direct_f_indices
                ).astype(jnp.uint8)
            direct_bits = (
                gathered ^ self._program.direct_flips.astype(np.uint8)
            ).astype(jnp.bool_)
            cm = self._program.direct_const_mask
            if cm is not None and cm.any():
                direct_bits = jnp.where(
                    jnp.asarray(cm)[None, :],
                    jnp.asarray(self._program.direct_flips)[None, :],
                    direct_bits,
                )
            targets = state[np.asarray(self._program.output_order[:n_direct])]
            p_joint = p_joint * (direct_bits == jnp.asarray(targets)).all(axis=1)

        for component in self._program.components:
            assert len(component.compiled_scalar_graphs) == 2
            f_selected = static_take_columns(f_samples, component.f_selection)
            norm_circuit, joint_circuit = component.compiled_scalar_graphs
            p_norm = p_norm * evaluate_abs(norm_circuit, f_selected)
            component_state = state[np.asarray(component.output_indices, np.int32)]
            tiled = jnp.tile(jnp.asarray(component_state), (batch_size, 1))
            joint_params = jnp.hstack([f_selected, tiled])
            p_joint = p_joint * evaluate_abs(joint_circuit, joint_params)

        return p_joint / p_norm
