"""The rest of the RHI and the scene checkpoint: rhi/device.py,
rhi/buffer.py, rhi/shader.py, rhi/command.py's dispatches and CommandPool,
renderer/checkpoint.py, held to the JAX package's behaviour
(tests/test_rhi_modules.py:91-196, :373-390, :475-483; tests/test_aux.py's
checkpoint tests) on the CPU.

Bars: none but exact. Buffers and dispatches are bit-equal to the direct
values and calls; the shader library registers the JAX library's 13 names
with the same stages; a checkpoint round trip (the port's own, a textured
scene's bf16 atlas and int64 index tensors included) is bit-exact, its
leaf spec is the JAX package's spec of the same scene, and a checkpoint
the JAX package saves of a bridged scene loads into the port and renders
the port's frame of that scene bit for bit."""

import pathlib
import struct

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene
from renderer_rs_tpu_torch.core.errors import RhiError, ShaderError

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


# --- command recording -------------------------------------------------------------

def test_command_state_machine():
    from renderer_rs_tpu_torch.rhi.command import CommandBuffer
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.utils import meshgen

    cb = CommandBuffer()
    with pytest.raises(RhiError):
        cb.draw_mesh(None)  # not recording
    with pytest.raises(RhiError):
        cb.dispatch(print)
    cb.begin()
    with pytest.raises(RhiError):
        cb.draw_mesh(None)  # no pipeline bound
    with pytest.raises(RhiError):
        cb.begin()  # already recording
    pipe = GraphicsPipelineBuilder().build()
    cb.bind_pipeline(pipe)
    cb.draw_mesh(meshgen.cube_mesh())
    with pytest.raises(RhiError):
        cb.execute_dispatches()  # not ended
    cb.end()
    with pytest.raises(RhiError):
        cb.bind_pipeline(pipe)  # recording ended
    cb.reset()
    assert not cb.draws and not cb.dispatches
    with pytest.raises(RhiError):
        cb.build_scene(device="cpu")  # reset to initial


def test_command_buffer_lowers_to_scene():
    from renderer_rs_tpu_torch.rhi.command import CommandBuffer
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.utils import meshgen

    pipe = GraphicsPipelineBuilder().build()
    cb = CommandBuffer().begin()
    cb.bind_pipeline(pipe)
    cb.draw_mesh(meshgen.cube_mesh())
    cb.draw_mesh(meshgen.plane_mesh(4.0))
    cb.end()
    scene, layout, pipeline = cb.build_scene(device="cpu")
    assert layout.num_objects == 2
    assert layout.num_triangles == 12 + 2
    assert pipeline is pipe


def test_command_pool():
    from renderer_rs_tpu_torch.rhi.command import CommandPool

    pool = CommandPool(transient=True)
    bufs = pool.allocate(3)
    assert pool.allocated == 3 and pool.transient
    bufs[0].begin()
    pool.reset()
    with pytest.raises(RhiError):
        bufs[0].end()  # reset back to initial
    assert pool.allocate()[0] is not bufs[0] and pool.allocated == 4


def test_dispatches_run_the_ibl_precompute_in_order():
    """The IBL precompute recorded as dispatches and run by
    execute_dispatches: each result bit-equal to the direct call."""
    from renderer_rs_tpu_torch.ops.ibl import brdf_lut, irradiance_map, prefilter_map
    from renderer_rs_tpu_torch.rhi.command import CommandBuffer

    rng = np.random.default_rng(1)
    sky = torch.from_numpy(rng.uniform(0.1, 2.0, (6, 8, 8, 3)).astype(np.float32))
    mips = (sky, sky[:, ::2, ::2].contiguous())
    cb = CommandBuffer().begin()
    cb.dispatch(irradiance_map, sky, 4)
    cb.dispatch(prefilter_map, mips, 8, 2, 4)
    cb.dispatch(brdf_lut, 8, 16, 8, "cpu")
    got = cb.end().execute_dispatches()
    want = [irradiance_map(sky, 4), prefilter_map(mips, 8, 2, 4), brdf_lut(8, 16, 8, "cpu")]
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


# --- shaders -------------------------------------------------------------------------

def test_spirv_validation():
    """≙ shader.rs:466-525's validation tests."""
    from renderer_rs_tpu_torch.rhi.shader import validate_spirv

    good = struct.pack("<I", 0x07230203) + b"\x00" * 12
    assert validate_spirv(good) == "little"
    swapped = struct.pack("<I", 0x03022307) + b"\x00" * 12
    assert validate_spirv(swapped) == "big"
    with pytest.raises(ShaderError):
        validate_spirv(b"")
    with pytest.raises(ShaderError):
        validate_spirv(good + b"\x00")  # misaligned
    with pytest.raises(ShaderError):
        validate_spirv(b"\xde\xad\xbe\xef" * 2)  # bad magic


def test_spirv_modules_validate():
    """A SPIR-V 1.6 module header (magic, version, generator, bound,
    schema) in either byte order, and every binary under the repo's
    shaders/spirv/ where that directory exists, as the JAX test validates
    the reference's binaries (tests/test_rhi_modules.py:475-483)."""
    from renderer_rs_tpu.rhi.shader import validate_spirv as jax_validate
    from renderer_rs_tpu_torch.rhi.shader import validate_spirv

    header = (0x07230203, 0x00010600, 0, 16, 0)
    for order, name in (("<", "little"), (">", "big")):
        blob = struct.pack(f"{order}5I", *header)
        assert validate_spirv(blob) == jax_validate(blob) == name
    for path in sorted((REPO / "shaders" / "spirv").glob("*.spv")):
        assert validate_spirv(path.read_bytes()) == "little", path


def test_builtin_shader_library_matches_jax():
    from renderer_rs_tpu.rhi.shader import builtin_library as jax_library
    from renderer_rs_tpu_torch.renderer import passes
    from renderer_rs_tpu_torch.rhi.shader import ShaderStage, builtin_library

    lib = builtin_library()
    ref = jax_library()
    names = sorted(lib._shaders)
    assert names == sorted(ref._shaders) and len(names) == 13
    for name in names:
        assert lib.get(name).stage.value == ref.get(name).stage.value
        assert lib.get(name).stage_create_info() == {"stage": lib.get(name).stage,
                                                     "entry": "main", "name": name}
    assert "model_pbr_ibl.frag" in lib
    assert lib.get("model.vert").stage == ShaderStage.VERTEX
    assert lib.get("model.vert").fn is passes.vertex_stage
    assert lib.get("brdf_lut.comp").stage == ShaderStage.COMPUTE
    assert lib.get("triangle.frag").fn is None
    with pytest.raises(ShaderError):
        lib.get("missing.frag")


# --- buffers and the device ------------------------------------------------------------

def test_buffer_usage_and_uploads():
    """≙ buffer.rs's tests: the usage -> placement table, write_data, the
    staging upload (tests/test_rhi_modules.py:373-390)."""
    from renderer_rs_tpu_torch.rhi.buffer import Buffer, BufferUsage

    assert BufferUsage.STORAGE.device_resident and BufferUsage.INDIRECT.device_resident
    assert not BufferUsage.VERTEX.device_resident
    b = Buffer.new_with_data(BufferUsage.VERTEX, np.zeros((4, 3), np.float32), device="cpu")
    assert b.size_bytes == 48 and b.data.device == torch.device("cpu")
    before = b.data
    assert b.write_data(3, torch.tensor([9.0, 9.0, 9.0])) is b
    np.testing.assert_array_equal(b.data[1].numpy(), [9, 9, 9])  # flat offset 3 = row 1
    np.testing.assert_array_equal(b.data[0].numpy(), [0, 0, 0])
    assert float(before.abs().sum()) == 0.0  # functional: the old tensor is unchanged
    b.upload_via_staging(np.ones((4, 3), np.float32))
    np.testing.assert_array_equal(b.data.numpy(), np.ones((4, 3), np.float32))
    assert b.data.device == torch.device("cpu")  # the upload defaults to the buffer's device
    s = Buffer(BufferUsage.STORAGE, np.arange(6, dtype=np.int32), device="cpu")
    assert s.data.dtype == torch.int32 and s.size_bytes == 24


def test_buffer_defaults_to_the_card(monkeypatch):
    """Every usage defaults to device="cuda", as every port entry point
    does (≙ the JAX Buffer placing each buffer on the default accelerator):
    without CUDA it raises rather than staying on the host."""
    from renderer_rs_tpu_torch.rhi.buffer import Buffer, BufferUsage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for usage in BufferUsage:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Buffer.new_with_data(usage, np.zeros(3, np.float32))
    b = Buffer(BufferUsage.UNIFORM, np.zeros(3, np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.upload_via_staging(np.ones(3, np.float32), "cuda")


def test_device_selection(monkeypatch):
    """rate_device: the platform score plus memory in 100 MiB units
    (≙ device.py:28-36); select_physical_device picks the best; Device
    raises without CUDA unless the CPU is asked for."""
    from renderer_rs_tpu_torch.rhi import device as rd

    cpu = rd.Device("cpu")
    assert cpu.primary == torch.device("cpu") and cpu.platform == "cpu" and cpu.score == 0
    cpu.wait_idle()
    with pytest.raises(RhiError):
        rd.select_physical_device([])
    mem = {0: 16 << 30, 1: 80 << 30}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: type("P", (), {"total_memory": mem[torch.device(d).index]}))
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert rd.rate_device(cards[1]) == 9000 + (80 << 30) // (100 << 20)
    assert rd.select_physical_device(cards + [torch.device("cpu")]) == cards[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RhiError, match="CUDA is not available"):
        rd.Device()


# --- checkpoint ---------------------------------------------------------------------------

def _leaves(scene):
    from renderer_rs_tpu_torch.renderer.checkpoint import _flatten

    return _flatten(scene)


def test_checkpoint_roundtrip(tmp_path):
    """≙ tests/test_aux.py's round trip: animate, save, load into the
    original scene's structure; every leaf and the layout exact."""
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.renderer.checkpoint import load_scene, save_scene

    scene, layout, _, animate = blinnphong_scene(64, 48, rings=4, sectors=6, device="cpu")
    scene2 = animate(scene, 1.5, 0.016)
    path = str(tmp_path / "ckpt.npz")
    save_scene(path, scene2, layout)
    restored, layout_r = load_scene(path, scene)
    assert layout_r == layout
    for (pa, a), (pb, b) in zip(_leaves(scene2), _leaves(restored), strict=True):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_structure_mismatch(tmp_path):
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene, triangle_scene
    from renderer_rs_tpu_torch.renderer.checkpoint import load_scene, save_scene

    scene, layout, _, _ = blinnphong_scene(64, 48, rings=4, sectors=6, device="cpu")
    other, _, _, _ = triangle_scene(64, 48, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    save_scene(path, scene, layout)
    with pytest.raises(ValueError, match="does not match the scene"):
        load_scene(path, other)
    wider = scene.replace(positions=torch.zeros(scene.positions.shape[0] + 1, 3))
    with pytest.raises(ValueError, match=r"\.positions: ckpt"):
        load_scene(path, wider)


@pytest.fixture(scope="module")
def textured_jax_checkpoint(tmp_path_factory):
    """A JAX checkpoint of tests/_torch_port.py::exact_scene(textured=True)
    (its bf16 trilinear material atlas, int32 index arrays) and the
    bridged port scene."""
    from _torch_port import exact_scene
    from renderer_rs_tpu.renderer.checkpoint import _leaf_spec as jax_spec
    from renderer_rs_tpu.renderer.checkpoint import save_scene as jax_save
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    js, jl = exact_scene("renderer_rs_tpu", textured=True)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jax_save(path, js, jl)
    return path, jax_spec(js), scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu")


def test_textured_checkpoint_roundtrip_and_jax_spec(textured_jax_checkpoint, tmp_path):
    """The port's round trip of a textured scene (bf16, int64 tensors) is
    exact, and its leaf spec is the JAX package's spec of the scene."""
    from renderer_rs_tpu_torch.renderer.checkpoint import _leaf_spec, load_scene, save_scene

    _, spec, (scene, layout) = textured_jax_checkpoint
    assert _leaf_spec(scene) == spec
    kinds = {str(t.dtype) for _, t in _leaves(scene)}
    assert {"torch.bfloat16", "torch.int64", "torch.int32", "torch.float32"} <= kinds
    path = str(tmp_path / "port.npz")
    save_scene(path, scene, layout)
    restored, layout_r = load_scene(path, scene)
    assert layout_r == layout
    for (_, a), (_, b) in zip(_leaves(scene), _leaves(restored), strict=True):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype ==
                                                  torch.bfloat16 else a,
                                                  b.view(torch.int16) if b.dtype ==
                                                  torch.bfloat16 else b)


def test_jax_checkpoint_loads_into_the_port_and_renders(textured_jax_checkpoint):
    """The JAX package's checkpoint of the scene loads into the bridged
    port scene's structure and renders the same port frame bit for bit."""
    from renderer_rs_tpu_torch.renderer.checkpoint import load_scene
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    path, _, (scene, layout) = textured_jax_checkpoint
    loaded, layout_l = load_scene(path, scene)
    assert layout_l == layout
    pipe = GraphicsPipelineBuilder().build()
    a = forward_frame(scene, layout, pipe, ShadingModel.PBR, 48, 32)
    b = forward_frame(loaded, layout_l, pipe, ShadingModel.PBR, 48, 32)
    assert torch.equal(a, b) and torch.isfinite(a).all()
