"""render_frame_sharded as concurrent shards (a host thread per shard, and on
CUDA a stream per shard) on meshes that name the CPU several times, and
the port's counterparts of the JAX package's multi-device tests
(tests/test_parallel.py:40, :138) against the JAX single-device frame.

- The concurrent output is BIT-equal to the sequential stitch: one
  forward_frame(band=band_spec(k, ...)) per shard, one after another,
  concatenated in shard order; on (1, 4) and (2, 4) meshes, contiguous
  and pair-interleaved, with two different frames in the (2, 4) batch.
- An exception in a shard is raised by render_frame_sharded (the first in
  shard order, the others as notes), once every shard has ended: no
  worker thread is left.
- shard_scene_batch places each frame once on each distinct device of its
  frame group, and render_frame_sharded on its output copies no scene
  tensor; a plain scene list is copied once per distinct device, not once
  per band.
- The launch counters are taken atomically under threads.
- Against JAX (tests/test_parallel.py:40, :138), on the scene whose vertex
  stage is exact in both packages (tests/_torch_port.py::exact_scene), so
  that depth can be held bit for bit: frame 2 x rows 4, ids and depth
  EXACT, colours within the bar of tests/test_torch_band.py (|d| <= 2e-3 +
  2e-3|ref| on >= 99.8% of values, max |d| < 0.05); sharded MSAA 4x after
  unshard_rows and resolve_msaa against the JAX single-device
  supersampled frame (RENDERER_MSAA=super) within the same bar. 48 rows:
  both sides shade at the exact rates."""

import sys
import threading

import numpy as np
import pytest
import torch

from _torch_port import EXACT_PROJECTION, exact_scene

torch.set_num_threads(1)

W, H = 64, 48


def _check_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} values off"
    assert err.max() < 0.05, f"max err {err.max()}"


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


@pytest.fixture(scope="module")
def port_frames():
    """Two frames of one layout on the port's exact scene (device cpu): the
    scene's own camera and the camera moved by an exact translation."""
    from renderer_rs_tpu_torch.resources.ubo import CameraUbo

    scene, layout = exact_scene("renderer_rs_tpu_torch", device="cpu")
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = (0.25, -0.125, 0.0)
    moved = scene.replace(camera=CameraUbo.create(view, EXACT_PROJECTION,
                                                  np.array([-0.25, 0.125, 0.0], np.float32)))
    return [scene, moved], layout


def _args(layout, msaa=1):
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    return layout, GraphicsPipelineBuilder().msaa_samples(msaa).build(), ShadingModel.PBR, W, H


def _sequential(scenes, mesh, layout, interleaved, msaa=1, **kw):
    """The sequential reference: one forward_frame per shard in shard order,
    each band's rows concatenated as render_frame_sharded stitches them."""
    from renderer_rs_tpu_torch.parallel import band_spec
    from renderer_rs_tpu_torch.renderer.passes import MSAA_GRIDS, forward_frame

    n_rows = mesh.shape["rows"]
    band_h = H * MSAA_GRIDS.get(msaa, (1, 1))[1] // n_rows
    return torch.stack([
        torch.cat([forward_frame(scene, *_args(layout, msaa),
                                 band=band_spec(k, n_rows, band_h, interleaved), **kw)
                   for k in range(n_rows)])
        for scene in scenes])


@pytest.mark.parametrize("frames,interleaved", [(1, False), (1, True), (2, False), (2, True)])
def test_concurrent_matches_sequential_stitch(port_frames, frames, interleaved):
    from renderer_rs_tpu_torch.parallel import make_device_mesh, render_frame_sharded

    scenes, layout = port_frames
    scenes = scenes[:frames]
    mesh = make_device_mesh(4 * frames, frame_axis=frames, devices=["cpu"] * 4 * frames)
    assert mesh.shape == {"frame": frames, "rows": 4}
    kw = dict(tonemap="aces", shadow_map_size=64)
    threads = threading.active_count()
    out = render_frame_sharded(scenes, *_args(layout), mesh, interleaved=interleaved, **kw)
    assert threading.active_count() == threads
    want = _sequential(scenes, mesh, layout, interleaved, **kw)
    assert out.shape == (frames, H, W, 4)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    if frames == 2:  # two different frames, each in its own frame group
        assert not torch.equal(out[0], out[1])


def test_concurrent_msaa_matches_sequential_stitch(port_frames):
    """MSAA 4x: the shards split the supersampled rows; bit-equal too."""
    from renderer_rs_tpu_torch.parallel import make_device_mesh, render_frame_sharded

    scenes, layout = port_frames
    mesh = make_device_mesh(8, devices=["cpu"] * 8)
    out = render_frame_sharded(scenes, *_args(layout, 4), mesh, interleaved=True)
    want = _sequential(scenes, mesh, layout, True, msaa=4)
    assert out.shape == (2, 2 * H, 2 * W, 4)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_shard_error_is_raised_and_no_worker_is_left(port_frames, monkeypatch):
    """A shard that raises makes render_frame_sharded raise that error once
    every shard has ended; with two failing shards the first in shard
    order is raised, the other named in a note. No thread stays."""
    import renderer_rs_tpu_torch.parallel.tile_shard as ts
    from renderer_rs_tpu_torch.parallel import make_device_mesh, render_frame_sharded

    scenes, layout = port_frames
    mesh = make_device_mesh(8, devices=["cpu"] * 8)
    real = ts.forward_frame
    ended = []

    def failing(bad):
        def frame(scene, *args, band, **kw):
            if band[0] in bad:
                raise RuntimeError(f"band at row {band[0]} failed")
            out = real(scene, *args, band=band, **kw)
            ended.append(band[0])
            return out
        return frame

    threads = threading.active_count()
    # contiguous bands of 12 rows: shard k starts at row 12k (k in 0..3),
    # in both frame groups
    monkeypatch.setattr(ts, "forward_frame", failing({24}))
    with pytest.raises(RuntimeError, match="band at row 24 failed"):
        render_frame_sharded(scenes, *_args(layout), mesh)
    assert sorted(ended) == [0, 0, 12, 12, 36, 36]  # every other shard ran to its end
    assert threading.active_count() == threads
    ended.clear()
    monkeypatch.setattr(ts, "forward_frame", failing({12, 36}))
    with pytest.raises(RuntimeError, match="band at row 12 failed") as info:
        render_frame_sharded(scenes, *_args(layout), mesh)
    notes = getattr(info.value, "__notes__", [])
    # shards 1 and 5 start at row 12, shards 3 and 7 at row 36: shard 1's raised
    assert [n.split(":")[0] for n in notes] == ["shard 3 failed too", "shard 5 failed too",
                                                "shard 7 failed too"]
    assert threading.active_count() == threads
    # nothing falls back: the next call renders the frame
    monkeypatch.setattr(ts, "forward_frame", real)
    assert render_frame_sharded(scenes, *_args(layout), mesh).shape == (2, H, W, 4)


def test_shard_scene_batch_places_once_and_render_copies_nothing(port_frames, monkeypatch):
    import renderer_rs_tpu_torch.parallel.tile_shard as ts
    from renderer_rs_tpu_torch.parallel import (
        make_device_mesh,
        render_frame_sharded,
        shard_scene_batch,
        stack_scenes,
    )

    scenes, layout = port_frames
    mesh = make_device_mesh(8, devices=["cpu"] * 8)
    placed_calls, seen = [], []
    real_to_device, real_frame = ts._to_device, ts.forward_frame

    def counting_to_device(scene, device):
        placed_calls.append(device)
        return real_to_device(scene, device)

    def recording_frame(scene, *args, band, **kw):
        seen.append((band[0], scene.positions.data_ptr(), scene.camera.view.data_ptr()))
        return real_frame(scene, *args, band=band, **kw)

    monkeypatch.setattr(ts, "_to_device", counting_to_device)
    monkeypatch.setattr(ts, "forward_frame", recording_frame)
    placed = shard_scene_batch(stack_scenes(scenes), mesh)
    # P("frame"): frame f once on each distinct device of frame group f
    assert len(placed) == 2 and [list(p) for p in placed] == [[torch.device("cpu")]] * 2
    assert placed_calls == [torch.device("cpu")] * 2
    placed_calls.clear()
    out = render_frame_sharded(placed, *_args(layout), mesh)
    assert placed_calls == []  # no scene tensor copied
    want = [(placed[f][torch.device("cpu")].positions.data_ptr(),
             placed[f][torch.device("cpu")].camera.view.data_ptr()) for f in range(2)]
    assert sorted(seen) == sorted((12 * k, *want[f]) for f in range(2) for k in range(4))
    # a plain list: each frame's scene placed once per distinct device, not per band
    seen.clear()
    again = render_frame_sharded(scenes, *_args(layout), mesh)
    assert placed_calls == [torch.device("cpu")] * 2 and len(seen) == 8
    assert torch.equal(out, again)
    # refusals: a batch of the wrong size, a placement that misses a device
    with pytest.raises(ValueError, match="mesh frame axis"):
        shard_scene_batch(scenes[:1], mesh)
    other = make_device_mesh(8, devices=["cpu"] * 4 + ["meta"] * 4)
    with pytest.raises(ValueError, match="not on"):
        render_frame_sharded(placed, *_args(layout), other)


def test_launch_counts_are_atomic_under_threads():
    """count_launch is the one increment of every launch counter: 16 threads
    (more than the cores) under a 1 us switch interval lose no count."""
    import renderer_rs_tpu_torch.ops.raster_cuda as rc

    def wrapper():
        pass

    wrapper.launches = wrapper.other = 0
    n_threads, per_thread = 16, 2000

    def hammer():
        for _ in range(per_thread):
            rc.count_launch(wrapper, launches=1, other=2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert (wrapper.launches, wrapper.other) == (n_threads * per_thread, 2 * n_threads * per_thread)


# --- the JAX package's multi-device tests, against its single-device frame ---

@pytest.fixture(scope="module")
def jax_exact():
    """The JAX single-device frames of the exact scene at 64x48 under
    BLINN_PHONG (tests/test_parallel.py:40's shading): the frame with its
    depth and source ids, and the supersampled MSAA 4x frame
    (RENDERER_MSAA=super, tests/test_parallel.py:150)."""
    import renderer_rs_tpu.renderer.passes as jpasses
    from renderer_rs_tpu.rhi.pipeline import GraphicsPipelineBuilder

    scene, layout = exact_scene("renderer_rs_tpu")
    shading = jpasses.ShadingModel.BLINN_PHONG
    frame = jpasses.forward_frame(scene, layout, GraphicsPipelineBuilder().build(), shading,
                                  W, H, return_depth=True, return_ids=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RENDERER_MSAA", "super")
        msaa = jpasses.forward_frame(scene, layout,
                                     GraphicsPipelineBuilder().msaa_samples(4).build(), shading,
                                     W, H)
    return tuple(np.asarray(x) for x in frame), np.asarray(msaa)


def test_sharded_matches_jax_single_device(jax_exact):
    """tests/test_parallel.py:40: frame 2 x rows 4, both frames the scene;
    each against the JAX single-device frame."""
    from renderer_rs_tpu_torch.parallel import (
        band_rows,
        band_spec,
        make_device_mesh,
        render_frame_sharded,
        stack_scenes,
    )
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    (ref, ref_depth, ref_ids), _ = jax_exact
    scene, layout = exact_scene("renderer_rs_tpu_torch", device="cpu")
    pipe, shading = GraphicsPipelineBuilder().build(), ShadingModel.BLINN_PHONG
    mesh = make_device_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape == {"frame": 2, "rows": 4}
    out = render_frame_sharded(stack_scenes([scene, scene]), layout, pipe, shading, W, H, mesh)
    assert out.shape == (2, H, W, 4)
    for f in range(2):
        _check_bar(out[f].numpy(), ref)
    assert torch.equal(out[0], out[1])
    depth, ids = torch.full((H, W), -2.0), torch.full((H, W), -2, dtype=torch.int32)
    for k in range(4):
        spec = band_spec(k, 4, H // 4, False)
        _, band_depth, band_ids = forward_frame(scene, layout, pipe, shading, W, H, band=spec,
                                                return_depth=True, return_ids=True)
        depth[band_rows(spec)], ids[band_rows(spec)] = band_depth, band_ids
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert np.array_equal(_bits(depth.numpy()), _bits(ref_depth))
    assert 0.1 < (ref_ids >= 0).mean() < 1.0


def test_msaa_sharded_matches_jax_single_device(jax_exact):
    """tests/test_parallel.py:138: MSAA 4x on frame 2 x rows 4, interleaved,
    unresolved supersampled rows, then unshard_rows and resolve_msaa,
    against the JAX supersampled single-device frame."""
    from renderer_rs_tpu_torch.parallel import (
        make_device_mesh,
        render_frame_sharded,
        resolve_msaa,
        shard_scene_batch,
        unshard_rows,
    )
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    _, ref = jax_exact
    scene, layout = exact_scene("renderer_rs_tpu_torch", device="cpu")
    mesh = make_device_mesh(8, devices=["cpu"] * 8)
    out = render_frame_sharded(shard_scene_batch([scene, scene], mesh), layout,
                               GraphicsPipelineBuilder().msaa_samples(4).build(),
                               ShadingModel.BLINN_PHONG, W, H, mesh, interleaved=True)
    assert out.shape == (2, 2 * H, 2 * W, 4)  # unresolved supersampled rows
    resolved = resolve_msaa(unshard_rows(out, 4, True), 4)
    assert resolved.shape == (2, H, W, 4)
    for f in range(2):
        _check_bar(resolved[f].numpy(), ref)
