"""Multi-device sampling: shard the shot axis over a flat device mesh.

Compiled term tensors are tiny (reference ``SURVEY.md`` section 2.3) so they
are replicated on every device; the shot batch is sharded on its leading
axis. Each device folds its mesh position into the RNG key. The norm
monitor reduces with ``psum``-style collectives implicitly via jnp.max over
the sharded axis (done post-gather here to keep the step simple).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.types import CompiledProgram
from ..ops.gf2 import static_take_columns
from ..sampler import _sample_component


def make_shot_mesh(devices=None, axis_name: str = "shots") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def sharded_sample_program(
    program: CompiledProgram,
    mesh: Mesh,
    f_params: jax.Array,
    key: jax.Array,
    axis_name: str = "shots",
):
    """Sample all outputs with the batch axis sharded across ``mesh``.

    ``f_params`` shape (B, num_f) with B divisible by the mesh size. Returns
    (samples (B, num_outputs), max_norm_deviation (scalar)).
    """
    n_dev = mesh.devices.size

    def step(f_local, key_leaf):
        # Distinct stream per device: fold in the mesh position.
        idx = jax.lax.axis_index(axis_name)
        local_key = jax.random.fold_in(key_leaf[0], idx)
        outs = []
        max_dev = jnp.zeros(())
        if len(program.direct_f_indices) > 0:
            if f_local.shape[1] == 0:
                gathered = jnp.zeros(
                    (f_local.shape[0], len(program.direct_f_indices)), jnp.uint8
                )
            else:
                gathered = static_take_columns(
                    f_local, program.direct_f_indices
                ).astype(jnp.uint8)
            bits = gathered ^ np.asarray(program.direct_flips, dtype=np.uint8)
            if program.direct_const_mask is not None and program.direct_const_mask.any():
                bits = jnp.where(
                    np.asarray(program.direct_const_mask)[None, :],
                    np.asarray(program.direct_flips, dtype=np.uint8)[None, :],
                    bits,
                )
            outs.append(bits)
        for component in program.components:
            samples, local_key, dev = _sample_component(component, f_local, local_key)
            outs.append(samples)
            max_dev = jnp.maximum(max_dev, dev)
        combined = jnp.concatenate(outs, axis=1) if outs else jnp.zeros(
            (f_local.shape[0], 0), jnp.uint8
        )
        if program.output_reindex is not None:
            combined = static_take_columns(combined, program.output_reindex)
        max_dev = jax.lax.pmax(max_dev, axis_name)
        return combined, max_dev

    keys = jnp.broadcast_to(key, (n_dev,) + key.shape)
    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P()),
        check_vma=False,
    )
    return fn(f_params, keys)


def sharded_sampler_step(program: CompiledProgram, mesh: Mesh):
    """A jitted closure over the program for repeated sharded sampling."""

    @partial(jax.jit, static_argnums=())
    def run(f_params, key):
        return sharded_sample_program(program, mesh, f_params, key)

    return run
