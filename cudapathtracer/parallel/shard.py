"""Sharded rendering and the distributed differentiable train step.

This is the framework's distributed-communication layer — what the
reference entirely lacks (SURVEY.md §2.6/§5.8: no
NCCL/MPI, single GPU). Strategy:

* **Forward render**: pure data parallelism over pixel tiles via
  ``jax.shard_map`` — scene, BVH and camera replicated (in_specs P()), the
  Morton index array and accumulation state sharded on the ``tiles`` axis.
  No collectives at all in the forward pass; each chip owns its tile of
  the running mean. Because RNG is keyed on pixel index (ops/rng.py), the
  sharded render equals single-chip to XLA-fusion ULPs (tested; the
  paths are identical, only shape-dependent FMA contraction differs).

* **Gradient pass**: each chip differentiates the loss restricted to its
  tile, then scene-parameter cotangents are summed across chips with
  ``jax.lax.psum`` — the gradient all-reduce (NCCL over NVLink between
  the cards of one host). The psum sits inside the shard_map'd function so XLA's
  scheduler can overlap it with remaining backward work (per-chip loss
  terms are also psum'd to report the global loss).

* **Optimizer step**: after psum every chip holds identical gradients, so
  the update runs replicated (no broadcast needed).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..diff import render_grad as rg
from ..render.renderer import AccumState, render_batch
from ..utils.config import RenderConfig
from .mesh import TILE_AXIS


def _pspec(tree, spec):
    """A matching pytree of PartitionSpecs (shard_map wants exact trees)."""
    return jax.tree_util.tree_map(lambda _: spec, tree)


def _tile_pspec(tree):
    """Tile-shard every rank>=1 leaf on its leading axis; scalars (like the
    sample counter AccumState.n) are replicated."""
    return jax.tree_util.tree_map(
        lambda x: P(TILE_AXIS) if jnp.ndim(x) >= 1 else P(), tree
    )


def render_sharded(scene, bvh, cam, cfg: RenderConfig, base_key,
                   state: AccumState, num_samples: int, mesh: Mesh,
                   idx=None, prep=None) -> AccumState:
    """Progressive render with pixel tiles sharded over the mesh.

    ``state`` components are (R,) arrays laid out Morton-contiguously, so
    an even split over chips gives each chip a contiguous Morton range — a
    spatially compact tile (good traversal coherence within each chip's
    vector batches). cfg is static (closed over); only arrays cross the
    shard_map boundary.

    ``idx``: optional prebuilt Morton index array — multi-PROCESS callers
    must pass a global jax.Array sharded on the tile axis (a process-local
    jnp.arange is not addressable across hosts); single-process callers
    can leave it None.
    """
    n_dev = mesh.devices.size
    assert cfg.num_pixels % n_dev == 0, (cfg.num_pixels, n_dev)
    if idx is None:
        idx = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)

    rep = P()
    til = P(TILE_AXIS)

    fn = jax.shard_map(
        lambda sc, bv, ca, k, st, ix, pp: render_batch(
            sc, bv, ca, cfg, k, st, num_samples, idx=ix, prep=pp
        ),
        mesh=mesh,
        in_specs=(
            _pspec(scene, rep),
            _pspec(bvh, rep),
            _pspec(cam, rep),
            rep,                     # base_key
            _tile_pspec(state),      # accumulation state: sharded
            til,                     # pixel indices
            _pspec(prep, rep),       # packet precompute: replicated
        ),
        out_specs=_tile_pspec(state),
        check_vma=False,
    )
    return fn(scene, bvh, cam, base_key, state, idx, prep)


@partial(jax.jit, static_argnames=("cfg", "num_samples", "mesh"),
         donate_argnums=(5,))
def render_sharded_jit(scene, bvh, cam, cfg, base_key, state, num_samples,
                       mesh, prep=None):
    """Jitted render_sharded; cfg, num_samples and mesh are static, so a
    repeated call reuses the compiled program."""
    return render_sharded(scene, bvh, cam, cfg, base_key, state,
                          num_samples, mesh, prep=prep)


# ---------------------------------------------------------------------------
# distributed differentiable train step
# ---------------------------------------------------------------------------

def make_sharded_grad_fn(scene, cam, cfg: RenderConfig, mesh: Mesh,
                         spp: int, bvh=None, edge_samples: int = 0,
                         shadow_edge_samples: int = 0):
    """(params, target, idx_all, key) -> (global loss, psum'd grads).

    The gradient core of make_train_step, exposed so tests (and custom
    optimizer loops) can read the all-reduced gradients directly."""

    n_dev = mesh.devices.size
    assert cfg.num_pixels % n_dev == 0

    rep = P()
    til = P(TILE_AXIS)
    params0 = rg.targets_of(scene)

    edge_table = None
    if edge_samples > 0 or shadow_edge_samples > 0:
        import numpy as np

        from ..diff.edge_sampling import build_edge_table
        from ..models.scene import host_geometry

        cached = host_geometry(scene)
        if cached is not None:
            _, tris_h = cached
        else:
            tris_h = np.stack(
                [np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
                 np.asarray(scene.tri_v2)], axis=1)
        edge_table = build_edge_table(tris_h)

    def tile_loss_and_grad(params, target_tile, idx_tile, key):
        def tile_loss(p):
            s = rg.scene_with(scene, p)
            img = rg.render_image_diff(s, cam, cfg, key, spp, bvh=bvh,
                                       idx=idx_tile,
                                       edge_samples=edge_samples,
                                       edge_table=edge_table,
                                       shadow_edge_samples=(
                                           shadow_edge_samples))
            dx = img.x - target_tile.x
            dy = img.y - target_tile.y
            dz = img.z - target_tile.z
            # tile partial of the GLOBAL MEAN loss: divide by num_pixels
            # here so the psum'd gradients are gradients of that same mean
            # (round-2 latent bug: grads were psum'd of the un-divided sum,
            # num_pixels x the reported loss's gradient)
            return jnp.sum(dx * dx + dy * dy + dz * dz) / cfg.num_pixels

        loss, grads = jax.value_and_grad(tile_loss)(params)
        loss = jax.lax.psum(loss, TILE_AXIS)
        grads = jax.lax.psum(grads, TILE_AXIS)  # gradient all-reduce
        return loss, grads

    return jax.shard_map(
        tile_loss_and_grad,
        mesh=mesh,
        in_specs=(
            _pspec(params0, rep),
            _tile_pspec(params0.albedo),  # Vec3 target tile
            til,
            rep,
        ),
        out_specs=(rep, _pspec(params0, rep)),
        check_vma=False,
    )


def make_train_step(scene, cam, cfg: RenderConfig, mesh: Mesh, spp: int,
                    bvh=None, optimizer=None, learning_rate: float = 1e-2,
                    edge_samples: int = 0, shadow_edge_samples: int = 0):
    """Build a jitted distributed train step over scene parameters:

        (params, opt_state, target, key) -> (loss, params, opt_state)

    Each chip renders + differentiates its pixel tile (diff/render_grad),
    grads and loss are psum'd over the mesh, then the update runs
    replicated.
    ``optimizer``: any optax GradientTransformation; None = plain SGD with
    ``learning_rate``. ``target`` is the (R,) Morton-ordered target image
    (Vec3), sharded like the render.

    ``edge_samples`` / ``shadow_edge_samples`` enable the silhouette
    boundary gradients (diff/edge_sampling.py) INSIDE the sharded step:
    each chip draws the same global edge samples and scatters only into
    its own Morton tile, so the psum'd gradient equals the single-chip
    one (tested in tests/test_parallel.py).
    """
    idx_all = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    sharded_grad = make_sharded_grad_fn(
        scene, cam, cfg, mesh, spp, bvh=bvh, edge_samples=edge_samples,
        shadow_edge_samples=shadow_edge_samples)

    if optimizer is not None:
        import optax

        @jax.jit
        def train_step(params, opt_state, target, key):
            loss, grads = sharded_grad(params, target, idx_all, key)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return loss, params, opt_state

        return train_step

    @jax.jit
    def train_step_sgd(params, opt_state, target, key):
        loss, grads = sharded_grad(params, target, idx_all, key)
        params = jax.tree_util.tree_map(
            lambda p, g: p - learning_rate * g, params, grads
        )
        return loss, params, opt_state

    return train_step_sgd
