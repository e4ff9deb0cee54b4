"""Keeper parity: render the reconstructed CornellBox-Original and compare
quantitatively against the reference's blessed artifacts.

The reference ships golden renders (/root/reference/keepers/*.ppm, P3
512x512) but .gitignores the scene OBJs. models/cornell_original.py
reconstructs the standard published scene data; the live camera is
hard-coded at kernel.cu:643-648. RNG streams differ by construction and
the keeper scenes include the unrecoverable models/teapot.obj, so the
comparison is DISTRIBUTIONAL over teapot-free regions (utils/keeper.py);
see tests/test_keeper_parity.py for the measured ledger (the keeper-era
build had the 2x branch-probability compensation the final source omits).

Run: python tools/keeper_parity.py [--spp 99] [--size 512] [--cpu]
Writes examples/keeper_cornell_{pt,bdpt}.png and prints a metrics JSON.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KEEPERS = "/root/reference/keepers"


def render_cornell(integrator: str, size: int, spp: int, traversal: str,
                   branch_pdf_correction: bool):
    from cudapathtracer import RenderConfig
    from cudapathtracer.models.cornell_original import (
        cornell_original_scene,
        reference_camera,
    )
    from cudapathtracer.render.renderer import finalize_image, render

    scene = cornell_original_scene()
    cam = reference_camera(size, size)
    cfg = RenderConfig(width=size, height=size, spp=spp,
                       integrator=integrator, traversal=traversal,
                       samples_per_call=min(spp, 33),
                       branch_pdf_correction=branch_pdf_correction)
    state = render(scene, cam, cfg, seed=1234)
    img = finalize_image(state, cfg)  # (H, W, 3) u8, camera-film order
    return img[:, ::-1, :]  # x-flip: the keeper PPMs store descending x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=99)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--integrator", default="both",
                    choices=["pt_nee", "bdpt", "both"])
    ap.add_argument("--traversal", default="packets")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from cudapathtracer.utils.keeper import region_ratios
    from cudapathtracer.utils.png import write_png
    from cudapathtracer.utils.ppm import read_ppm

    out = {}
    jobs = []
    if args.integrator in ("pt_nee", "both"):
        # branch correction ON: the keeper-era build had it (measured)
        jobs.append(("pt_nee", True, "cornell-original.ppm",
                     "keeper_cornell_pt"))
    if args.integrator in ("bdpt", "both"):
        jobs.append(("bdpt", False, "BDPT-FirstAttempt.ppm",
                     "keeper_cornell_bdpt"))

    for integ, corr, keeper_name, tag in jobs:
        keeper = read_ppm(os.path.join(KEEPERS, keeper_name))
        ours = render_cornell(integ, args.size, args.spp, args.traversal,
                              corr)
        write_png(os.path.join(REPO, "examples", f"{tag}.png"), ours,
                  flip_x=False)
        out[integ] = region_ratios(keeper, ours)

    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
