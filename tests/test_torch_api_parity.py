"""The public names of the two packages, and the last ones the port gained
against the JAX objects: rhi/sync.py's Semaphore and FrameSync,
Swapchain.image, CubeMap.num_levels and CubeMap.face_size.

The name diff reads both packages' sources with `ast` (no module of either
package is imported for it): every public function and class of each
module and every public method of each class, by module path. The names of
the JAX package with no counterpart at the same path must be exactly
LEFT_OUT, each left out on purpose for the reason given (ROADMAP.md,
"Knob inventory" and Queue 1)."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

LEFT_OUT = {
    "core/profiling::log_pass_time":
        "nothing called it and it synchronised the device; the port's span() and frame "
        "record time the passes",
    "core/config::ensure_f32_matmuls":
        "the port switches TF32 off when it is imported (renderer_rs_tpu_torch/__init__.py)",
    "ops/clip::clip_triangles_near_v":
        "the TRI_PLANES layout of the near clip: bit-identical by construction",
    "ops/clip::compact_secondary_v":
        "the TRI_PLANES layout of the compaction: bit-identical by construction",
    "ops/raster::z_plane_mode":
        "reads the RENDERER_Z_FORM knob; the port takes the argument z_form",
    "ops/raster_binned::bin_triangles":
        "the XLA binned rasterizers' binning (Queue 1 item 4, dropped)",
    "ops/raster_binned::bin_triangles_dense":
        "the XLA binned rasterizers' binning (Queue 1 item 4, dropped)",
    "ops/raster_binned::rasterize_binned":
        "an XLA binned rasterizer, the JAX fallback off the TPU (Queue 1 item 4, dropped)",
    "ops/raster_binned::rasterize_depth_only_binned":
        "an XLA binned rasterizer, the JAX fallback off the TPU (Queue 1 item 4, dropped)",
    "ops/raster_pallas::rasterize_binned_pallas":
        "the Pallas launcher: ops/raster_cuda.py's prepare_* and raster_* with csrc/",
    "ops/raster_pallas::rasterize_depth_only_batch":
        "K6's Pallas launcher: raster_depth over N sets (ops/raster_cuda.py)",
    "ops/sampling::cube_trilinear_plan_arith":
        "the MIP_PLAN=arith plan: bit-identical to the select plan the port has",
    "ops/shadow::build_halo_rows":
        "the PCF_LAYOUT=halo table: bit-identical tap sets",
    "ops/shadow::grouped_window_reduce":
        "the PCF_LAYOUT=group reduce: bit-identical tap sets",
    "ops/shadow::halo_window_reduce":
        "the PCF_LAYOUT=halo reduce: bit-identical tap sets",
    "ops/shadow::pcf_group":
        "reads the RENDERER_PCF_GROUP knob; the port keeps the group, 32",
    "ops/shadow::pcf_layout":
        "reads the RENDERER_PCF_LAYOUT knob: bit-identical tap sets",
    "ops/shadow::shadow_window_plan":
        "the PCF window tables' plan: bit-identical tap sets",
    "renderer/renderer::Renderer.precompile_buckets":
        "the port's kernels build once per process for every extent: nothing to pre-warm",
}


def _public_names(package: str) -> set:
    names = set()
    root = ROOT / package
    for path in sorted(root.rglob("*.py")):
        module = path.relative_to(root).with_suffix("").as_posix()
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name.startswith("_"):
                continue
            names.add(f"{module}::{node.name}")
            if isinstance(node, ast.ClassDef):
                names.update(f"{module}::{node.name}.{sub.name}" for sub in node.body
                             if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_"))
    return names


def test_public_names_differ_only_by_the_left_out_set():
    jax_names = _public_names("renderer_rs_tpu")
    port_names = _public_names("renderer_rs_tpu_torch")
    assert len(jax_names) > 300
    assert sorted(jax_names - port_names) == sorted(LEFT_OUT)
    for name in ("rhi/sync::Semaphore", "rhi/sync::FrameSync.create",
                 "rhi/swapchain::Swapchain.image", "resources/texture::CubeMap.num_levels",
                 "resources/texture::CubeMap.face_size", "parallel/tile_shard::shard_scene_batch"):
        assert name in port_names
    assert all(reason.strip() for reason in LEFT_OUT.values())


def test_semaphore_and_frame_sync_match_jax():
    import renderer_rs_tpu.rhi.sync as js
    import renderer_rs_tpu_torch.rhi.sync as ps

    for name in ("", "image_available"):
        assert repr(ps.Semaphore(name)) == repr(js.Semaphore(name))
        assert ps.Semaphore(name).name == js.Semaphore(name).name
    # on the CPU (no stream) signal and wait are the JAX marker's no-ops
    sem = ps.Semaphore("edge")
    sem.wait(None)
    sem.signal(None)
    sem.wait(None)
    for signaled in (True, False):
        want, got = js.FrameSync.create(signaled), ps.FrameSync.create(signaled)
        assert ([f.name for f in dataclasses.fields(got)]
                == [f.name for f in dataclasses.fields(want)])
        assert ((got.image_available.name, got.render_finished.name)
                == (want.image_available.name, want.render_finished.name))
        assert got.in_flight.is_signaled() == want.in_flight.is_signaled() == signaled
        value = torch.ones(3)
        got.in_flight.attach(value)
        assert got.in_flight.wait() is value and got.in_flight.is_signaled()
    assert ps.FrameSync.create().in_flight.is_signaled()


def test_swapchain_image_matches_jax():
    import renderer_rs_tpu.rhi.swapchain as js
    import renderer_rs_tpu_torch.rhi.swapchain as ps

    frames = [np.full((48, 64, 4), i, np.uint8) for i in range(4)]
    trace = []
    for mod in (js, ps):
        sc = mod.Swapchain(64, 48)
        steps = [sc.image(i) is None for i in range(sc.image_count)]
        for frame in frames:
            idx, _ = sc.acquire_next_image()
            sc.present(idx, frame)
            steps.append((idx, int(sc.image(idx)[0, 0, 0]), sc.image(idx) is frame))
        sc.present(0, np.zeros((10, 10, 4), np.uint8))  # another extent: not stored
        steps.append(int(sc.image(0)[0, 0, 0]))
        sc.recreate(128, 96)
        steps.append([sc.image(i) is None for i in range(sc.image_count)])
        trace.append(steps)
    assert trace[0] == trace[1]
    assert trace[1][3:7] == [(0, 0, True), (1, 1, True), (2, 2, True), (0, 3, True)]


@pytest.mark.parametrize("generate_mips", [False, True])
def test_cube_map_levels_and_face_size_match_jax(generate_mips):
    from renderer_rs_tpu.resources.texture import CubeMap as JaxCubeMap
    from renderer_rs_tpu_torch.resources.texture import CubeMap

    faces = np.random.default_rng(0).random((6, 16, 16, 3), dtype=np.float32)
    want = JaxCubeMap.from_faces(faces, generate_mips=generate_mips)
    got = CubeMap.from_faces(faces, generate_mips=generate_mips)
    assert (got.num_levels, got.face_size) == (want.num_levels, want.face_size)
    assert (got.num_levels, got.face_size) == ((5, 16) if generate_mips else (1, 16))
    assert isinstance(got.face_size, int)
