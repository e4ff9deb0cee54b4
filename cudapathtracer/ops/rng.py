"""Counter-based RNG for the renderer.

The reference keeps one mutable cuRAND XORWOW state per pixel
(kernel.cu:527-533) and even has a live data race on state 0 for the lens
samples (kernel.cu:547). This design removes stateful RNG entirely:
every random draw is a pure function of

    (base seed, sample index, PIXEL INDEX, draw-site id [, bounce])

via threefry key folding. Sequences differ from cuRAND but the statistics
match, which is the parity contract (SURVEY.md §7 "RNG sequence semantics":
match statistics, not streams).

Keying on the *pixel index* (not the array position) is what makes the
multi-chip path exact: a chip rendering the tile idx[a:b] draws the same
uniforms for pixel i as a single chip rendering the whole image — so a
shard_map render draws the identical random sequences as the unsharded
one (tested in tests/test_parallel.py; images agree to XLA-fusion ULPs).

A "site" is a static integer identifying a draw location in the integrator
(e.g. LENS_U1, BSDF_CHOICE at bounce b); sites are enumerated in ``Sites``
so no two collide.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_key(base_key, sample_index):
    """Key for one progressive sample pass."""
    return jax.random.fold_in(base_key, sample_index)


def pixel_keys(skey, idx):
    """Per-pixel keys for this sample: fold the Morton pixel index in.

    idx: (R,) uint32. Returns a (R,)-batched key array (the pure
    functional analogue of the reference's per-pixel curandState array,
    kernel.cu:527-533 — minus the mutability and the state-0 race).
    """
    return jax.vmap(lambda i: jax.random.fold_in(skey, i))(idx)


def uniform_site(keys, site: int, bounce=None, dtype=jnp.float32):
    """(0, 1] uniforms, one per key.

    NOTE: jax.random.uniform is [0, 1); curand_uniform is (0, 1]. The
    integrators' inequalities were written for (0, 1] (e.g. the light-pick
    scan requires randArea > 0 strictly, kernel.cu:241). We map u -> 1 - u
    to reproduce the open-at-zero interval.
    """

    def one(k):
        kk = jax.random.fold_in(k, site)
        if bounce is not None:
            kk = jax.random.fold_in(kk, bounce)
        return jax.random.uniform(kk, (), dtype)

    return 1.0 - jax.vmap(one)(keys)


def uniform_sites(keys, group: int, n: int, bounce=0, dtype=jnp.float32):
    """n independent (0, 1] uniforms per key, batched: ONE fold + counter-
    mode generation instead of the 3 threefry passes uniform_site pays per
    draw (measured ~4x cheaper for an integrator bounce's 6-8 draws at 1M
    rays). Returns (n, R).

    ``group`` identifies the draw-site GROUP (SiteGroups); the row index
    within the group identifies the draw. bounce is folded into the same
    word (group * 1024 + bounce), so groups must be spaced accordingly.
    Statistically equivalent to per-site derivation — both are threefry
    counter streams — but the VALUES differ from uniform_site's; the two
    schemes must not be mixed for the same logical draw.
    """

    def one(k):
        kk = jax.random.fold_in(k, group * 1024 + bounce)
        return jax.random.uniform(kk, (n,), dtype)

    return 1.0 - jax.vmap(one)(keys).T


class SiteGroups:
    """Group ids for uniform_sites (spaced by the 1024-bounce packing)."""

    PT_BOUNCE = 1      # rows: choice, bsdf_u1, bsdf_u2, pick, light_u, light_v
    BDPT = 2           # rows: pick, light_u, light_v, dir_u1, dir_u2,
    #                    cam_u1, cam_u2
    CAMERA = 3         # rows: lens_u1, lens_u2, jitter_x, jitter_y


# Draw-site ids (arbitrary distinct constants, kept in one place so no two
# sites collide).
class Sites:
    LENS_U1 = 1
    LENS_U2 = 101
    BSDF_CHOICE = 2
    BSDF_U1 = 3
    BSDF_U2 = 4
    LIGHT_PICK = 5
    LIGHT_U = 6
    LIGHT_V = 7
    # BDPT-specific
    BDPT_LIGHT_PICK = 10
    BDPT_LIGHT_U = 11
    BDPT_LIGHT_V = 12
    BDPT_LIGHT_DIR_U1 = 13
    BDPT_LIGHT_DIR_U2 = 14
    BDPT_CAM_BOUNCE_U1 = 15
    BDPT_CAM_BOUNCE_U2 = 16
    # anti-aliasing jitter (extension; off by default for reference parity)
    PIXEL_JITTER_X = 20
    PIXEL_JITTER_Y = 21
