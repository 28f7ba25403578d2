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
map, ACES. `--csm` switches it to four shadow cascades fitted to the
camera, which follow it as `--orbit` or `--fly` moves it. `--z-form plane`
renders the shadow passes in the z-plane depth form (K7; the JAX
package's z-form knob, raster.py:297). `--pcf-res`, `--cube-res` and
`--light-res` set the shade stage's reduced rates
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
its `pipeline`.

The frame loop is the JAX app's (≙ main.rs:35-105): a Window whose
surface is the `--out` directory (frame_{n:05d}.png per presented frame)
or, without it, an X11 window (platform/x11.py) where a display is
available (libX11's own choice, the $DISPLAY it reads, or `--display`):
each frame pumps its events into the InputState, a WM resize resizes the
Renderer, closing the window ends the loop; a display that cannot be
opened falls back offscreen with a warning (the last frame kept); a Timer whose tick is each frame's dt, clamped to 0.1 s
for the camera (a build or I/O stall must not teleport it); `--orbit`
injects a scripted left-button drag and scroll into an InputState driving
an OrbitController, `--fly` holds W with a mouse-look driving an
FpsController (both need a scene with a camera); the frames still in
flight are drained and presented at the end, and the FrameStats summary
logged. `--log` is the RUST_LOG-style filter of init_logging.
`--vstage`, `--shadow-vstage`, `--clip-compact` and `--cap-big` set the
geometry forms (passes.GeometryForms; the JAX package's geometry knobs).
The scene animation (the spinning cube) steps 1/60 s a frame.

`--trace DIR` runs the frames under torch.profiler (core/profiling.trace)
with tracing on: it writes `DIR/trace.json` (the chrome trace),
`DIR/frames.jsonl` (the frame records of the run, one a line, every stamp
on the trace's clock: Unix microseconds, an event's ts plus the trace's
baseTimeNanoseconds / 1000) and logs one summary line: the mean enqueue,
fence wait, readback, present and between-frames times and the host syncs
a frame, with their sites."""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os

from renderer_rs_tpu_torch.platform.input import InputState, KeyCode, MouseButton

log = logging.getLogger("renderer_rs_tpu_torch.app")


def inject_scripted_events(inp: InputState, mode: str, frame: int) -> None:
    """The per-frame scripted event stream standing in for winit callbacks
    (≙ renderer_rs_tpu/app/main.py:34; app/src/main.rs:61-97)."""
    if mode == "orbit":
        if frame == 0:
            inp.on_mouse_move(400.0, 300.0)  # anchor (no delta on the first move)
            inp.on_mouse_press(MouseButton.LEFT)
        inp.on_mouse_move(400.0 + 8.0 * (frame + 1), 300.0 + 2.0 * (frame + 1))
        if frame % 16 == 8:
            inp.on_scroll(1.0)
    elif mode == "fly":
        if frame == 0:
            inp.on_mouse_move(400.0, 300.0)
            inp.on_key_press(KeyCode.KEY_W)
        inp.on_mouse_move(400.0 + 25.0 * (frame + 1), 300.0 + 5.0 * (frame + 1))


def apply_camera_input(inp: InputState, mode: str, controller, camera, dt: float) -> None:
    """InputState -> controller -> Camera (≙ renderer_rs_tpu/app/main.py:52;
    crates/scene/src/camera.rs:287-326, 451-507)."""
    if mode == "orbit":
        if inp.is_mouse_pressed(MouseButton.LEFT):
            controller.process_mouse_movement(*inp.mouse_delta)
        if inp.scroll_delta:
            controller.process_zoom(inp.scroll_delta)
        controller.update_camera(camera)
    else:
        controller.process_mouse_movement(*inp.mouse_delta)
        key = inp.is_key_pressed
        forward = float(key(KeyCode.KEY_W)) - float(key(KeyCode.KEY_S))
        right = float(key(KeyCode.KEY_D)) - float(key(KeyCode.KEY_A))
        up = float(key(KeyCode.SPACE)) - float(key(KeyCode.SHIFT_LEFT))
        controller.set_movement_input(forward, right, up)
        controller.update_camera(camera, dt)


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


def main(argv=None, device="cuda", sink=None) -> int:
    """Run the app on `argv`. `sink`, a callable (frame, n), takes the
    presented frames in place of `--out` (the Surface's callable sink).
    Without either, an available X display gets an X11 window (its events
    drive the input, closing it ends the loop), else the frames stay
    offscreen."""
    from renderer_rs_tpu_torch.app.scenes import SCENES
    from renderer_rs_tpu_torch.core.errors import WindowError
    from renderer_rs_tpu_torch.core.logging import init_logging
    from renderer_rs_tpu_torch.platform.window import Window

    parser = argparse.ArgumentParser(description="renderer_rs_tpu_torch headless app")
    parser.add_argument("--scene", choices=list(SCENES), default="triangle")
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
                        help="cascaded shadow maps: four cascades fitted to the camera instead "
                             "of the single sun map, refitted as the camera moves (full scene)")
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
    parser.add_argument("--msaa-mode", choices=["resolve", "super"], default="resolve",
                        help="an MSAA pipeline's form: shade once and id-resolve, or "
                             "supersample the whole frame")
    parser.add_argument("--vstage", choices=["loop", "batch"], default="loop",
                        help="vertex stage: one draw per object, or one product against "
                             "per-object column blocks")
    parser.add_argument("--shadow-vstage", choices=["world", "composed"], default=None,
                        help="shadow vertex stage: the forward stage's world positions, or "
                             "the per-object pre-composed light matrix (default by layout)")
    parser.add_argument("--clip-compact", type=int, default=16,
                        help="near-clip secondary cap max(128, T/N); 0 keeps the exact 2T "
                             "layout")
    parser.add_argument("--cap-big", type=int, default=None,
                        help="the binning's big-class cap (default max(1024, T/96))")
    parser.add_argument("--display", type=str, default=None,
                        help="X display of the window without --out (default: libX11's own, "
                             "the $DISPLAY it reads)")
    parser.add_argument("--log", type=str, default=None, help="log filter (RUST_LOG style)")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="profile the frames into DIR/trace.json and write their frame "
                             "records to DIR/frames.jsonl")
    parser.add_argument("--orbit", action="store_true",
                        help="scripted orbit-drag camera (OrbitController)")
    parser.add_argument("--fly", action="store_true",
                        help="scripted fly-forward camera (FpsController)")
    args = parser.parse_args(argv)

    init_logging(args.log)
    title = f"renderer_rs_tpu_torch [{args.scene}]"
    # a display gets a real window (the X11 blit through ctypes); otherwise
    # the surface is the PNG or array sink (≙ main.py:115-130)
    x11 = None
    if sink is None and args.out is None:
        from renderer_rs_tpu_torch.platform.x11 import X11Window, display_available

        if display_available(args.display):
            try:
                x11 = X11Window(args.width, args.height, title, display=args.display)
            except WindowError as e:  # the display may be unreachable
                log.warning("X11 window unavailable (%s); offscreen", e)
    if x11 is not None:
        sink = x11.present
    try:
        return _run(args, device, Window(args.width, args.height, title,
                                         sink=sink if sink is not None else args.out), x11)
    finally:
        if x11 is not None:
            x11.close()


def _run(args, device, window, x11) -> int:
    """The frame loop of main() on its window (and X11 window, or None)."""
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.core.timer import Timer
    from renderer_rs_tpu_torch.renderer.passes import GeometryForms, ShadeRates
    from renderer_rs_tpu_torch.renderer.renderer import Renderer
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8

    scene, layout, kwargs, animate = build(args, device)
    camera = kwargs.get("camera")
    renderer = Renderer(
        RendererConfig(width=args.width, height=args.height), device=device,
        z_form=args.z_form, msaa_mode=args.msaa_mode,
        shade_rates=ShadeRates(pcf=args.pcf_res, cube=args.cube_res, light=args.light_res),
        geometry_forms=GeometryForms(vstage=args.vstage, shadow_vstage=args.shadow_vstage,
                                     clip_compact=args.clip_compact, cap_big=args.cap_big),
        window=window, **kwargs
    )
    renderer.set_scene(scene, layout)
    if x11 is not None:
        # a WM resize -> the deferred recreate (≙ the Resized arm,
        # app/src/main.rs:67-75; renderer.resize also resizes the Window)
        x11.on_resize = renderer.resize

    ctl_mode = "orbit" if args.orbit else ("fly" if args.fly else None)
    controller = None
    if ctl_mode and camera is None:
        log.warning("--%s ignored: the %s scene has no camera", ctl_mode, args.scene)
        ctl_mode = None
    elif ctl_mode == "orbit":
        from renderer_rs_tpu_torch.scene.camera import OrbitController

        controller = OrbitController()
        controller.sync_with_camera(camera, (0.0, 0.0, 0.0))
    elif ctl_mode == "fly":
        from renderer_rs_tpu_torch.scene.camera import FpsController

        controller = FpsController()
        controller.sync_with_camera(camera)

    input_state = InputState()
    timer = Timer()  # ≙ the app timer (main.rs:77)
    t = 0.0
    if args.trace:
        profiling.clear_records()
    with profiling.trace(args.trace) if args.trace else contextlib.nullcontext():
        for frame in range(args.frames):
            input_state.begin_frame()  # ≙ about_to_wait (main.rs:99-104)
            if x11 is not None:
                # live input: the window's key, button and motion events
                # drive the InputState (≙ the winit input arms,
                # app/src/main.rs:85-97)
                if not x11.pump_events(input_state):
                    log.info("window closed")
                    break
            elif ctl_mode:
                inject_scripted_events(input_state, ctl_mode, frame)
            dt = timer.tick()
            if ctl_mode:
                # the hitch clamp: a build or I/O stall must not teleport the
                # camera
                apply_camera_input(input_state, ctl_mode, controller, camera, min(dt, 0.1))
                renderer.update_camera(camera)
            if animate is not None:
                renderer.update_scene(animate(renderer._scene, t, 1.0 / 60.0))
                t += 1.0 / 60.0
            renderer.render_frame()
    # drain the frames still in flight so every frame is presented
    for fb in renderer.wait_idle():
        window.create_surface().present(framebuffer_to_u8(fb))
    elapsed = timer.elapsed()
    log.info("%d frames in %.3fs (%.1f FPS incl. builds); steady-state %s", args.frames,
             elapsed, args.frames / max(elapsed, 1e-9), renderer.stats.summary())
    if args.trace:
        recs = profiling.records()
        with open(os.path.join(args.trace, "frames.jsonl"), "w") as fh:
            fh.writelines(json.dumps(r.to_json()) + "\n" for r in recs)
        log.info("%s", profiling.summarize(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
