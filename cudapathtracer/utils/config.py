"""Render configuration.

The reference configures everything at compile time: a #define block
(IMAGE 512x512, NUM_SAMPLES=100, NUM_BOUNCES=3, kernel.cu:28-35) plus
hard-coded scene and camera in main() (kernel.cu:590-648). This dataclass is
the replacement (SURVEY.md §5.6): one frozen, hashable config object passed
as a static jit argument.

Note the reference's sample loop runs sampleNum = 1..NUM_SAMPLES-1, i.e.
NUM_SAMPLES=100 accumulates 99 samples (kernel.cu:709-710). Our ``spp`` is
the honest count of samples actually accumulated.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    spp: int = 99                   # reference-equivalent default (see above)
    num_bounces: int = 3            # kernel.cu:33
    integrator: str = "bdpt"        # 'bdpt' (live, kernel.cu:549) | 'pt_nee'
    traversal: str = "auto"         # 'auto' (by platform, see
    #                                 render/renderer.resolve_traversal) |
    #                                 'packets' (XLA packet engine) |
    #                                 'bvh' (XLA per-ray walk) | 'cuda'
    #                                 (per-ray walk as a CUDA kernel; GPU
    #                                 only) | 'brute'
    leaf_size: int = 4
    samples_per_call: int = 1       # progressive granularity (checkpoint unit)
    sample_batch: int = 1           # samples whose BOUNCE RAYS are traced as
    #                                 one jointly-sorted batch: S x the rays
    #                                 per sort window. Radiance per sample
    #                                 and the accumulation sequence are
    #                                 bit-identical to S=1 (the RNG keys on
    #                                 absolute sample index and updates stay
    #                                 sequential). Costs ~S x transient
    #                                 device memory for the in-flight rays.
    # packet-traversal knobs (ops/packets.py). Their defaults and the auto
    # rules in render/renderer.py were chosen before the GPU port and are
    # not yet tuned for the H100.
    tile_size: int | None = None    # rays per packet tile; None = auto from
    #                                 the cluster width
    #                                 (render/renderer.resolve_tile_size)
    tile_size_vis: int | None = None  # tile size for VISIBILITY traces
    #                                 (BDPT's connection batch, the trace
    #                                 call sites that pass vis_band > 0).
    #                                 None = use tile_size for both.
    cluster_size: int | None = None  # triangles per scene cluster; None =
    #                                  renderer.adaptive_cluster_size
    max_clusters: int = 4095        # shortlist cap per tile (>= K means
    #                                 every culled-in cluster is folded)
    packet_sort: bool = True        # sort rays by octant+origin Morton
    packet_rounds: int = 1          # straggler splitting: early rounds cap
    #                                 each tile's candidate budget; stragglers
    #                                 compact into the next pass
    packet_first_round: int = 2     # round-1 candidate budget per tile
    packet_rounds_bdpt: int = 1     # straggler rounds for BDPT's traces
    two_level_cull: bool | None = None  # hierarchical cull. False = flat
    #                                 (Tl, K) cull; True = two-level
    #                                 (supercluster shortlist + member
    #                                 expansion under a slot cap — the cap
    #                                 can drop close members, which costs
    #                                 fallback work, never correctness).
    #                                 None = auto (ops/packets.py).
    super_factor: int = 8           # clusters per supercluster (F)
    super_slots: int = 16           # two-level member-expansion slots (Ms)
    sort_window: int = 0            # ray-sort window length (0 = one global
    #                                 sort). Windows sort independently;
    #                                 results are bit-identical under any
    #                                 grouping (ops/packets.py). Must be a
    #                                 multiple of tile_size.
    intersector: str = "bw"         # triangle test: 'bw' (Baldwin-Weber
    #                                 precomputed form — decision-equivalent
    #                                 to the reference's Moller-Trumbore in
    #                                 exact arithmetic, fewer operations per
    #                                 test) | 'mt' (the reference's exact
    #                                 formulation, modelLoader.h:49-123).
    #                                 Every engine runs the selected one, so
    #                                 results stay engine-independent; the
    #                                 two differ only on exact-tie shared
    #                                 edges (t to ~2e-7 relative; §7 ledger).
    # quirk flags (defaults = reference behavior; SURVEY.md §7 ledger)
    orthonormal_frame: bool = False
    light_normal_mode: str = "fixed"
    branch_pdf_correction: bool = False
    jitter: bool = False
    # accumulation
    compensated_accum: bool = True  # Kahan compensation (reference uses f64)
    # primary rays are identical every sample when the camera is a pinhole
    # (radius == 0) and jitter is off — the reference's exact live config
    # (kernel.cu:646, no sub-pixel jitter). With this flag the renderer
    # traces them once per batch instead of once per sample. Set by
    # render()/bench automatically (they see the concrete camera); only
    # valid under the pinhole/no-jitter condition.
    reuse_primary_hit: bool = False

    @property
    def num_pixels(self):
        return self.width * self.height

    def __post_init__(self):
        assert self.width > 0 and (self.width & (self.width - 1)) == 0, (
            "width must be a power of two (Morton indexing)"
        )
        assert self.height > 0 and (self.height & (self.height - 1)) == 0
        assert self.integrator in ("bdpt", "pt_nee")
        assert self.traversal in ("auto", "packets", "bvh", "cuda", "brute")
        assert self.light_normal_mode in ("fixed", "true")
        assert self.intersector in ("bw", "mt")
