"""The port's frame loop against the JAX package's (renderer/renderer.py,
renderer/frame_manager.py, renderer/depth_buffer.py, rhi/{sync,swapchain,
descriptor}.py; the counterparts of tests/test_renderer.py): present modes
and the MAILBOX slot bookkeeping, the deferred resize, the depth buffer,
descriptor validation, the shadow map kept across a resize, the swapchain,
and the three defaults the port now shares with JAX (PBR shading, MAILBOX
present, the app's triangle scene).

Bars: the frame bar of tests/test_torch_frame.py on linear frames (|d| <=
2e-3 + 2e-3*|ref| on >= 99.8% of values, max |d| < 0.05) and the golden
bar of tests/test_golden.py on uint8 frames (mean |d| < 1, < 0.5% of
pixels off by more than 8) against the JAX Renderer; bit-equal between a
resized port Renderer and a fresh one at the same extent; exact on every
count, slot and choice."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_port import exact_scene

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _frame_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3
    assert err.max() < 0.05, err.max()


def _golden_bar(out, ref):
    assert out.shape == ref.shape
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() < 1.0, diff.mean()
    assert (diff.max(axis=-1) > 8).mean() < 0.005


def _port(scene_fn="triangle", w=64, h=48, **kw):
    from renderer_rs_tpu_torch.app import scenes
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    scene, layout, kwargs, _ = getattr(scenes, f"{scene_fn}_scene")(w, h, device="cpu")
    kwargs.update(kw)
    r = Renderer(RendererConfig(width=w, height=h), device="cpu", **kwargs)
    r.set_scene(scene, layout)
    return r


@pytest.fixture(scope="module")
def jax_exact():
    """The JAX Renderer with its defaults (PBR, MAILBOX) on the exact scene:
    its linear frame at 64x48, then its presented frame after resize(48,
    32), and its MAILBOX outcome after two present=False frames."""
    from renderer_rs_tpu.core.config import RendererConfig
    from renderer_rs_tpu.platform.window import Window
    from renderer_rs_tpu.renderer.renderer import Renderer

    scene, layout = exact_scene("renderer_rs_tpu")
    r = Renderer(Window(64, 48), RendererConfig(width=64, height=48, backend="cpu"))
    r.set_scene(scene, layout)
    hdr = np.asarray(r.render_frame_hdr())
    r.render_frame(present=False)
    r.render_frame(present=False)
    pending = len(r._pending_slots)
    r.render_frame()
    mailbox = (pending, len(r._pending_slots), r.frame_manager.in_flight,
               r.frame_manager.frames_dropped, r.frame_manager.frames_retired_unpresented)
    r.resize(48, 32)
    u8 = r.render_frame()
    return hdr, u8, mailbox, r.swapchain.present_mode


def _port_exact(w=64, h=48, **kw):
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    r = Renderer(RendererConfig(width=w, height=h), device="cpu", **kw)
    r.set_scene(*exact_scene("renderer_rs_tpu_torch", device="cpu"))
    return r


def test_default_shading_is_pbr_as_in_jax(jax_exact):
    """Fault repaired: the port's Renderer defaulted to Blinn-Phong."""
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel

    r = _port_exact()
    assert r.shading == ShadingModel.PBR
    _frame_bar(r.render_frame_hdr().numpy(), jax_exact[0])


def test_mailbox_present_keeps_slots_in_step_as_in_jax(jax_exact):
    """Fault repaired: the port presented FIFO only. Two present=False
    frames, then one present: the newer frame shows, the stale one is
    dropped, and the acquired slots follow (tests/test_renderer.py:234)."""
    from renderer_rs_tpu_torch.rhi.swapchain import PRESENT_MAILBOX

    r = _port_exact()
    assert r.frame_manager.present_mode == PRESENT_MAILBOX
    assert jax_exact[3] == PRESENT_MAILBOX
    r.render_frame(present=False)
    r.render_frame(present=False)
    pending = len(r._pending_slots)
    second = r.frame_manager._in_flight[-1].wait()
    out = r.render_frame()
    fm = r.frame_manager
    got = (pending, len(r._pending_slots), fm.in_flight, fm.frames_dropped,
           fm.frames_retired_unpresented)
    # on the CPU the port's frames finish before the present, so the stale
    # one always drops; whether the JAX frame had finished is its async
    # dispatch's timing, so JAX is held to the invariants only
    assert got == (2, 0, 0, 1, 1)
    j_pending, j_after, j_in_flight, j_dropped, j_retired = jax_exact[2]
    assert (j_pending, j_retired, j_after, j_dropped + j_in_flight) == (2, 1, j_in_flight, 1)
    assert out is not None and r.last_frame is out
    del second
    r.wait_idle()


def test_resize_matches_a_fresh_renderer_and_jax(jax_exact):
    """64x48 -> 48x32: deferred to the next frame, which drains the frames
    in flight and recreates the swapchain and the depth buffer; the frame
    is bit-equal to a fresh Renderer's at 48x32 and within the golden bar
    of the JAX Renderer's after the same resize."""
    r = _port_exact()
    r.render_frame(present=False)
    r.resize(48, 32)
    assert r.config.width == 64  # not yet applied
    u8 = r.render_frame()
    assert r.config.width == 48 and r.frame_manager.in_flight == 0
    assert r.swapchain.extent == (48, 32) and r.depth_buffer.extent == (48, 32)
    fresh = _port_exact(48, 32)
    np.testing.assert_array_equal(u8, fresh.render_frame())
    assert torch.equal(r.render_frame_hdr(), fresh.render_frame_hdr())
    _golden_bar(u8, jax_exact[1])


def test_app_default_scene_is_the_triangle(tmp_path):
    """Fault repaired: app.main without --scene rendered blinnphong; as in
    the JAX app it renders the Hello Triangle (its golden, exactly)."""
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.utils.image_io import read_png

    assert main(["--width", "160", "--height", "120", "--out", str(tmp_path)], device="cpu") == 0
    assert os.listdir(tmp_path) == ["frame_00000.png"]
    np.testing.assert_array_equal(read_png(str(tmp_path / "frame_00000.png")),
                                  read_png(os.path.join(GOLDENS, "triangle_160x120.png")))


@pytest.mark.parametrize("pkg", ["renderer_rs_tpu", "renderer_rs_tpu_torch"])
def test_present_modes_are_behavioral(pkg):
    """tests/test_renderer.py:197 on both packages' FrameManager: FIFO
    presents 0, 1; MAILBOX skips the finished stale 0 and 1 and shows 2."""
    import importlib

    fm_mod = importlib.import_module(f"{pkg}.renderer.frame_manager")
    sc = importlib.import_module(f"{pkg}.rhi.swapchain")

    def frame(i):
        return np.full((2, 2, 4), float(i), np.float32)

    fm = fm_mod.FrameManager(frames_in_flight=4, present_mode=sc.PRESENT_FIFO)
    for i in range(3):
        fm.submit(frame, i)
    assert [float(fm.present_oldest()[0, 0, 0]) for _ in range(2)] == [0.0, 1.0]
    assert fm.frames_dropped == 0
    fm = fm_mod.FrameManager(frames_in_flight=4, present_mode=sc.PRESENT_MAILBOX)
    for i in range(3):
        fm.submit(frame, i)
    assert float(fm.present_oldest()[0, 0, 0]) == 2.0
    assert fm.frames_dropped == 2 and fm.in_flight == 0
    with pytest.raises(ValueError):
        fm_mod.FrameManager(present_mode="immediate")


def test_frame_manager_bounds_and_order():
    """tests/test_aux.py:153-177: at most frames_in_flight queued; FIFO
    order; a drain returns the frames still queued."""
    from renderer_rs_tpu_torch.renderer.frame_manager import FrameManager

    fm = FrameManager(frames_in_flight=2)
    for i in range(5):
        fm.submit(lambda x: torch.tensor(x) * 2.0, float(i))
        assert fm.in_flight <= 2
    assert len(fm.wait_for_all_frames()) == 2 and fm.frame_count == 5
    fm.submit(lambda x: torch.tensor(x), 1.0)
    fm.submit(lambda x: torch.tensor(x), 2.0)
    assert [float(fm.present_oldest()) for _ in range(2)] == [1.0, 2.0]
    assert fm.present_oldest() is None


def test_fences_and_frame_sync():
    """tests/test_rhi_modules.py:135-153: a fence on CPU work is signalled
    once attached; the per-slot fences start signalled; the renderer's
    frame queue holds Fences."""
    from renderer_rs_tpu_torch.renderer.frame_manager import FrameManager
    from renderer_rs_tpu_torch.rhi.sync import Fence

    f = Fence()
    assert not f.is_signaled()
    f.attach(torch.ones(8) * 2)
    assert f.is_signaled() and torch.equal(f.wait(), torch.full((8,), 2.0))
    f.reset()
    assert not f.is_signaled()
    fences = FrameManager(frames_in_flight=3).fences
    assert len(fences) == 3 and all(f.is_signaled() for f in fences)
    r = _port()
    r.render_frame(present=False)
    assert isinstance(r.frame_manager._in_flight[0], Fence)
    assert r.frame_manager.present_oldest() is not None
    r.wait_idle()


def test_swapchain_choices_match_jax():
    import renderer_rs_tpu.rhi.swapchain as js
    import renderer_rs_tpu_torch.rhi.swapchain as ps
    from renderer_rs_tpu_torch.core.errors import RhiError

    for formats in ([ps.FORMAT_LINEAR_F32, ps.FORMAT_SRGB8], [ps.FORMAT_LINEAR_F32]):
        assert ps.choose_surface_format(formats) == js.choose_surface_format(formats)
    with pytest.raises(RhiError):
        ps.choose_surface_format([])
    for modes in ([ps.PRESENT_FIFO, ps.PRESENT_MAILBOX], [ps.PRESENT_FIFO], []):
        assert ps.choose_present_mode(modes) == js.choose_present_mode(modes)
    for caps_kw in (dict(min_extent=(100, 100), max_extent=(2000, 1000)),
                    dict(current_extent=(640, 480)), dict(min_image_count=2, max_image_count=2),
                    dict(min_image_count=3)):
        pc, jc = ps.SurfaceCapabilities(**caps_kw), js.SurfaceCapabilities(**caps_kw)
        for desired in ((50, 5000), (800, 600)):
            assert ps.choose_extent(pc, desired) == js.choose_extent(jc, desired)
        assert ps.determine_image_count(pc) == js.determine_image_count(jc)
    trace = []
    for mod in (js, ps):
        sc = mod.Swapchain(64, 48)
        steps = [sc.acquire_next_image(), sc.present(0, np.zeros((48, 64, 4), np.uint8)),
                 sc.present(0, np.zeros((10, 10, 4), np.uint8)), sc.acquire_next_image()]
        sc.recreate(128, 96)
        steps += [sc.extent, sc.acquire_next_image(), sc.image_count]
        trace.append(steps)
    assert trace[0] == trace[1]
    with pytest.raises(RhiError):
        ps.Swapchain(64, 48).present(3, np.zeros((48, 64, 4), np.uint8))


def test_swapchain_backs_the_present_path():
    """tests/test_renderer.py:132: presented frames take the swapchain's
    slots in turn and reach the surface at its extent; a resize recreates
    the chain at the new extent."""
    r = _port()
    next_slots = []
    for _ in range(4):
        r.render_frame()
        next_slots.append(r.swapchain._next)
    assert next_slots == [1, 2, 0, 1] and r.last_frame.shape == (48, 64, 4)
    r.resize(96, 64)
    assert r.swapchain.stale
    for _ in range(3):
        r.render_frame()
    assert r.swapchain.extent == (96, 64) and not r.swapchain.stale
    assert r.last_frame.shape == (64, 96, 4) and r.last_frame is r.surface.last_frame
    assert r.surface.frame_count == 7 and r.stats.frame_count == 7 and r.stats.fps > 0


def test_depth_buffer_tracks_extent_and_seeds_the_attachment():
    """tests/test_renderer.py:386: recreated with the swapchain, its clear
    value kept; the frame's depth attachment clears to it."""
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    r = _port_exact()
    assert r.depth_buffer.extent == (64, 48) and r.depth_buffer.clear_depth == 1.0
    assert torch.equal(r.depth_buffer.clear(), torch.ones(48, 64))
    r.resize(96, 64)
    r.render_frame()
    assert r.depth_buffer.extent == (96, 64)
    r.depth_buffer.clear_depth = 0.5  # in front of every surface
    r.resize(64, 48)
    r.render_frame()
    assert r.depth_buffer.extent == (64, 48) and r.depth_buffer.clear_depth == 0.5
    want = forward_frame(r._scene, r._layout, r.pipeline, r.shading, 64, 48, depth_clear=0.5)
    assert torch.equal(r.render_frame_hdr(), want)
    assert not torch.equal(want, forward_frame(r._scene, r._layout, r.pipeline, r.shading,
                                               64, 48))


def test_set_scene_validates_descriptor_bindings():
    """tests/test_renderer.py:160 and test_rhi_modules.py:155, the same
    failing cases: a layout claiming textures or a shadow the scene does
    not bind raises RhiError; the IBL set needs an environment; the sets
    per shading model are JAX's."""
    import renderer_rs_tpu.rhi.descriptor as jd
    from renderer_rs_tpu.renderer.passes import ShadingModel as JaxShading
    from renderer_rs_tpu_torch.app.scenes import triangle_scene
    from renderer_rs_tpu_torch.core.errors import RhiError
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel
    from renderer_rs_tpu_torch.rhi import descriptor as pd

    r = _port("cube")
    scene, layout = r._scene, r._layout
    with pytest.raises(RhiError):
        r.set_scene(scene.replace(textures=None), layout)
    with pytest.raises(RhiError):
        r.set_scene(scene, dataclasses.replace(layout, has_shadow=True))
    tri, tri_layout, _, _ = triangle_scene(32, 32, device="cpu")
    pd.SET_FRAME.validate(tri)
    with pytest.raises(RhiError):
        pd.SET_IBL.validate(tri)
    for model in ShadingModel:
        assert len(pd.layouts_for(model)) == len(jd.layouts_for(JaxShading(model.value)))
    assert len(pd.layouts_for(ShadingModel.PBR, layout)) == 4  # + textures


def test_resize_keeps_the_shadow_map():
    """tests/test_renderer.py:102: the shadow map does not depend on the
    extent, so a resize keeps it; the resized frame equals a fresh
    Renderer's at that extent."""
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    scene, layout, kw, _ = full_scene(64, 48, tri_budget=200, ibl=False, device="cpu")
    kw = {**kw, "shadow_map_size": 64}
    kw.pop("camera")

    def make(w, h):
        r = Renderer(RendererConfig(width=w, height=h), device="cpu", **kw)
        r.set_scene(scene, layout)
        return r

    r = make(64, 48)
    r.render_frame()
    cache = r._shadow_cache
    r.resize(96, 64)
    r.render_frame()
    assert r._shadow_cache is cache
    assert torch.equal(r.render_frame_hdr(), make(96, 64).render_frame_hdr())


def test_depth_buffer_defaults_to_the_card():
    """Like every entry point of the port, the depth buffer lives on cuda
    unless the caller asks for the cpu (raising where CUDA is absent)."""
    from renderer_rs_tpu_torch.renderer.depth_buffer import DepthBuffer

    if torch.cuda.is_available():
        assert DepthBuffer(8, 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DepthBuffer(8, 4)
    assert DepthBuffer(8, 4, device="cpu").clear().device.type == "cpu"


def test_clear_state_change_and_wait_idle():
    """tests/test_renderer.py:408: a new clear colour shows at the next
    frame; wait_idle drains the frames in flight and their slots."""
    r = _port()
    corner = tuple(r.render_frame()[0, 0])
    r.clear_color = (1.0, 0.0, 0.0, 1.0)
    u8 = r.render_frame()
    assert u8[0, 0, 0] == 255 and tuple(u8[0, 0]) != corner
    r.render_frame(present=False)
    r.render_frame(present=False)
    assert len(r.wait_idle()) == 2 and r._pending_slots == []
    assert r.frame_manager.in_flight == 0


def test_renderer_takes_its_extent_from_a_window():
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.platform.window import Window
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    got = []
    r = Renderer(RendererConfig(width=10, height=10), device="cpu",
                 window=Window(64, 48, sink=lambda f, n: got.append(n)))
    assert (r.config.width, r.config.height) == (64, 48)
    r.set_scene(*exact_scene("renderer_rs_tpu_torch", device="cpu"))
    r.render_frame()
    r.render_frame()
    assert got == [0, 1]
