"""Headless app entry point (≙ renderer_rs_tpu/app/main.py,
crates/app/src/main.rs): build a scene, render frames through the Renderer,
write PNGs. Runs on the CUDA card; without one it raises.

Usage:
    python -m renderer_rs_tpu_torch.app.main --scene blinnphong \
        --width 1920 --height 1080 --frames 8 --out /tmp/out
    python -m renderer_rs_tpu_torch.app.main --scene full --textured \
        --tris 100000 --width 1920 --height 1080 --out /tmp/out
    python -m renderer_rs_tpu_torch.app.main --scene full --no-ibl --csm --out /tmp/out
    python -m renderer_rs_tpu_torch.app.main --scene gltf-pbr --out /tmp/out
    python -m renderer_rs_tpu_torch.app.main --scene triangle --width 800 \
        --height 600 --out /tmp/out
    python -m renderer_rs_tpu_torch.app.main --scene cube --frames 60 --out /tmp/out
    python -m renderer_rs_tpu_torch.app.main --scene full --gltf model.glb \
        --hdr tests/assets/sky_equirect_64x32.hdr --textured --width 1920 \
        --height 1080 --frames 3 --out /tmp/out
    python -m renderer_rs_tpu_torch.app.main --scene gltf-pbr --gltf model.glb --out /tmp/out

`--scene triangle` is the Hello Triangle and `--scene cube` the spinning
textured cube, both on the scan rasterizer; the cube turns at 1 rad/s over
`--frames` frames of 1/60 s. `--scene full --textured` is bench.py's
headline frame: the IBL environment (the default; `--no-ibl` drops it for
the hemisphere ambient), the 5-slot PBR texture set, a 1024² sun shadow
map, ACES. `--csm` switches it to four shadow cascades. `--z-form plane`
renders the shadow passes in the z-plane depth form (K7; the JAX
package's z-form knob, raster.py:297). `--pcf-res`, `--cube-res`,
`--light-res` and `--merge-gather` set the shade stage's reduced rates
(passes.ShadeRates; the JAX package's rate knobs, JAX defaults), and
`--msaa-mode super` makes an MSAA pipeline supersample the whole frame
(the Renderer's msaa_mode). `--hdr file.hdr` takes the IBL
environment from a Radiance .hdr equirect instead of the procedural sky;
`--gltf file` instances a glTF model to `--tris` triangles in place of
the sphere grid (with `--textured`, the procedural maps replace the
model's degenerate images), or with `--scene gltf-pbr` renders the model
alone. As in the JAX app
there is no alpha-cutoff flag: a MASK pipeline
(`GraphicsPipelineBuilder().alpha_cutoff(0.5)`) reaches the Renderer as
its `pipeline`. The X11 window and the scripted orbit/fly cameras wait for
ROADMAP Queue 1 item 14."""

from __future__ import annotations

import argparse
import logging
import os
import time

log = logging.getLogger("renderer_rs_tpu_torch.app")


def build(args, device):
    """The scene factory call for the parsed arguments (≙ main.py:68)."""
    from renderer_rs_tpu_torch.app.scenes import SCENES, full_scene, gltf_pbr_scene

    if args.scene == "gltf-pbr" and args.gltf:
        return gltf_pbr_scene(args.width, args.height, args.gltf, device=device)
    if args.scene == "full":
        return full_scene(
            args.width, args.height, tri_budget=args.tris, ibl=not args.no_ibl,
            csm=args.csm, textured=args.textured, hdr=args.hdr, gltf=args.gltf,
            device=device,
        )
    return SCENES[args.scene](args.width, args.height, device=device)


def main(argv=None, device="cuda") -> int:
    from renderer_rs_tpu_torch.app.scenes import SCENES
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.passes import ShadeRates
    from renderer_rs_tpu_torch.renderer.renderer import Renderer
    from renderer_rs_tpu_torch.utils.image_io import write_png

    parser = argparse.ArgumentParser(description="renderer_rs_tpu_torch headless app")
    parser.add_argument("--scene", choices=list(SCENES), default="blinnphong")
    parser.add_argument("--width", type=int, default=1280)  # ≙ main.rs:38
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--frames", type=int, default=1)
    parser.add_argument("--out", type=str, default=None, help="PNG output directory")
    parser.add_argument("--tris", type=int, default=100_000,
                        help="triangle budget for the full scene")
    parser.add_argument("--no-ibl", action="store_true",
                        help="full scene without the IBL environment: the sky as skybox only "
                             "and the hemisphere ambient")
    parser.add_argument("--csm", action="store_true",
                        help="cascaded shadow maps: four cascades instead of the single sun map "
                             "(full scene)")
    parser.add_argument("--textured", action="store_true",
                        help="the 5-slot procedural PBR texture set (full scene)")
    parser.add_argument("--hdr", type=str, default=None,
                        help="Radiance .hdr equirect environment for the full scene's IBL")
    parser.add_argument("--gltf", type=str, default=None,
                        help="glTF path (gltf-pbr scene, or instanced into the full scene)")
    parser.add_argument("--z-form", choices=["bary", "plane"], default="bary",
                        help="depth form of the shadow passes: vertex depths blended by "
                             "barycentrics, or the anchored depth plane")
    parser.add_argument("--pcf-res", choices=["yquarter", "yhalf", "half", "full"],
                        default="yquarter", help="rate of the sun's PCF term")
    parser.add_argument("--cube-res", choices=["yhalf", "yquarter", "full"], default="yhalf",
                        help="rate of the IBL specular/skybox fetch")
    parser.add_argument("--light-res", choices=["full", "yhalf"], default="full",
                        help="yhalf: the sun and IBL terms on even rows, albedo-split")
    parser.add_argument("--merge-gather", action="store_true",
                        help="the merged PCF/cube gather (both per pixel)")
    parser.add_argument("--msaa-mode", choices=["resolve", "super"], default="resolve",
                        help="an MSAA pipeline's form: shade once and id-resolve, or "
                             "supersample the whole frame")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    scene, layout, kwargs, animate = build(args, device)
    renderer = Renderer(
        RendererConfig(width=args.width, height=args.height), device=device,
        z_form=args.z_form, msaa_mode=args.msaa_mode,
        shade_rates=ShadeRates(pcf=args.pcf_res, cube=args.cube_res, light=args.light_res,
                               merge_gather=args.merge_gather),
        **kwargs
    )
    renderer.set_scene(scene, layout)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    t = 0.0
    for frame in range(args.frames):
        if animate is not None:
            renderer.update_scene(animate(renderer._scene, t, 1.0 / 60.0))
            t += 1.0 / 60.0
        img = renderer.render_frame()
        if args.out:
            write_png(os.path.join(args.out, f"frame_{frame:05d}.png"), img)
    renderer.wait_idle()
    elapsed = time.perf_counter() - t0
    log.info("%d frames in %.3fs (%.1f FPS)", args.frames, elapsed, args.frames / max(elapsed, 1e-9))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
