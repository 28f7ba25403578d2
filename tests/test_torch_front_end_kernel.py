"""The front-end kernels (ops/front_end.py, csrc/front_end.cu): the fused
frame's vertex stage, near clip, secondary compaction and setup in two or
three launches where the ATen chain of renderer/passes.py::frame_geometry
took ~640.

On the CPU: a model of the kernels in torch ops (`kernel_model`: the
object-table lookup, the per-triangle pass with the near clip's plane form
and its count of cut triangles, the scan-based compaction with its
invalid-secondary padding) equals the ATen chain
(passes.frame_geometry_chain) bit for bit: on the headline scene at a small
extent, on a camera whose near plane cuts triangles with one and with two
vertices behind, at the headline camera where it cuts the floor, with
compaction on, off and overflowing a small cap, under back-face culling,
no culling and a depth bias. frame_geometry keeps the chain on CPU
tensors, point and line topologies and vstage "batch", and its kernel
branch assembles the same FrameGeometry; launches["front_end"] is counted
only where the kernels run; the wrapper refuses CPU tensors and inputs of
the wrong dtype or shape before it builds or launches anything.

The tests marked cuda need the card and skip without one: the kernels
against the ATen chain on the card at 1920x1080, on the headline scene, on
the clipping camera and at the headline camera 5 units out, where the
floor is cut (every field bit-equal, the normals and tangents included),
ATen's three-lane sum order that the kernel follows, K2's ids, depth and
lanes and the PBR+IBL image of a frame from either front end, and the
launch count of a Renderer.render_frame loop. Run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_front_end_kernel.py`
(this file imports no JAX)."""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from renderer_rs_tpu_torch.mathx.vec import normalize
from renderer_rs_tpu_torch.ops import front_end as FE
from renderer_rs_tpu_torch.ops.clip import _intersect_plane
from renderer_rs_tpu_torch.ops.raster import setup_triangles
from renderer_rs_tpu_torch.ops.shade_cuda import _chain
from renderer_rs_tpu_torch.renderer import passes as P
from renderer_rs_tpu_torch.rhi.pipeline import (
    CullMode,
    GraphicsPipelineBuilder,
    PrimitiveTopology,
)

torch.set_num_threads(1)

PIPELINES = {
    "cull_back": GraphicsPipelineBuilder().build(),
    "cull_none": GraphicsPipelineBuilder().cull_mode(CullMode.NONE).build(),
    "bias_clamped": GraphicsPipelineBuilder().cull_mode(CullMode.NONE).depth_bias(
        1.25, 1.75, 0.0004).build(),
    "bias_negative_clamp": GraphicsPipelineBuilder().depth_bias(-2.0, -1.5, -0.0003).build(),
}


def headline_scene(width, height, device):
    """The benchmark's scene (full_scene: 97,346 textured triangles, the
    normal map bound, so every attribute lane rides)."""
    from renderer_rs_tpu_torch.app.scenes import full_scene

    scene, layout, _, _ = full_scene(width, height, tri_budget=100_000, textured=True,
                                     ibl=False, device=device)
    return scene, layout


def clipping_scene(width, height, device):
    """A camera on the top of a UV sphere (1,154 triangles with its floor):
    its near plane cuts triangles with one and with two vertices behind."""
    from renderer_rs_tpu_torch.app.scenes import _camera_ubo
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.resources.material import Material
    from renderer_rs_tpu_torch.scene.camera import Camera, Projection
    from renderer_rs_tpu_torch.utils.meshgen import plane_mesh, uv_sphere_mesh

    cam = Camera(Projection.perspective(math.radians(70), width / height, 0.1, 50.0))
    cam.position = np.array([0.0, 1.0, 0.0], np.float32)
    cam.look_at([0.0, 0.0, -4.0])
    b = SceneBuilder()
    b.add_mesh(uv_sphere_mesh(1.0, 24, 24))
    b.add_mesh(plane_mesh(40.0), material=Material(base_color=(1.0, 0.2, 0.2, 1.0),
                                                   roughness=0.9))
    b.set_camera(_camera_ubo(cam))
    return b.build(device=device)


def headline_orbit(scene, width, height, angle=1.25 * math.pi):
    """The headline scene under its own camera, the orbit 5 units out and 3
    up (bench_port/traffic/orbit.json), at `angle`: at 5 pi / 4 the floor's
    corner 0 alone lies behind the near plane, so both floor triangles are
    cut into quads; the view is not axis-aligned."""
    from renderer_rs_tpu_torch.app.scenes import _camera_ubo, _orbit_camera

    cam = _orbit_camera(width, height, distance=5.0, height_y=3.0, fov=50.0)
    cam.position = np.array([5.0 * math.sin(angle), 3.0, 5.0 * math.cos(angle)], np.float32)
    cam.look_at([0.0, 0.0, 0.0])
    return scene.replace(camera=_camera_ubo(cam).to(scene.device))


def _rows(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Rows x [N,K] through per-row matrices m [N,R,K] (or one [R,K]) as
    the kernel and cuBLAS compute x @ m.T: the fused chain over k
    (shade_cuda._chain), from a zero accumulator, so a product that is
    zero is +0."""
    m = m.expand(x.shape[0], *m.shape[-2:])
    return torch.stack([_chain(x, m[:, r].T) for r in range(m.shape[1])], dim=-1) + 0.0


def _vertices(scene, layout, starts: torch.Tensor):
    """The vertex kernel: (clip [V,4], attr [V,K])."""
    v = scene.positions.shape[0]
    obj = torch.searchsorted(starts, torch.arange(v, dtype=torch.int32, device=scene.device),
                             right=True).long() - 1
    model = scene.models[obj]
    homo = torch.cat([scene.positions, torch.ones_like(scene.positions[:, :1])], dim=-1)
    world = _rows(homo, model)
    clip = _rows(world, scene.camera.view_projection)
    n = normalize(_rows(scene.normals, scene.normal_mats[obj][:, :3, :3]))
    lanes = [world[:, :3], n]
    if layout.has_textures:
        lanes.append(scene.uvs)
        if layout.texture_slots[1]:
            t = _rows(scene.tangents[:, :3], model[:, :3, :3])
            t = normalize(t - n * torch.sum(t * n, dim=-1, keepdim=True))
            lanes += [t, scene.tangents[:, 3:4]]
    return clip, torch.cat(lanes, dim=-1)


def _clip_triangles(clip: torch.Tensor, tris: torch.Tensor):
    """The triangle kernel's case analysis over every source triangle:
    (primary [T,3,4], secondary [T,3,4], primary planes [T,9], secondary
    planes [T,9], n_behind [T]); plane (i,j) at column 3i + j. The near
    clip's plane form: a vertex with z < 0 is behind."""
    v = clip[tris]
    behind = v[..., 2] < 0.0
    n_behind = behind.sum(dim=-1)
    b0, b1 = behind[:, 0], behind[:, 1]
    sel = torch.where(n_behind == 1, torch.where(b0, 0, torch.where(b1, 1, 2)),
                      torch.where(~b0, 0, torch.where(~b1, 1, 2)))
    ib, ic = (sel + 1) % 3, (sel + 2) % 3
    ar = torch.arange(v.shape[0], device=clip.device)
    va, vb, vc = v[ar, sel], v[ar, ib], v[ar, ic]
    t_ab = _intersect_plane(va[:, 2], vb[:, 2])[:, None]
    t_ac = _intersect_plane(va[:, 2], vc[:, 2])[:, None]
    i_ab = va + t_ab * (vb - va)
    i_ac = va + t_ac * (vc - va)
    one, two = (n_behind == 1)[:, None], (n_behind == 2)[:, None]

    def pick(a, b, c):
        return torch.where(one, a, torch.where(two, b, c))

    prim = torch.stack([pick(i_ab, va, v[:, 0]), pick(vb, i_ab, v[:, 1]),
                        pick(vc, i_ac, v[:, 2])], dim=1)
    sec = torch.stack([i_ab, vc, i_ac], dim=1)
    eye = torch.eye(3, dtype=torch.float32, device=clip.device)
    ba, bb, bc = eye[sel], eye[ib], eye[ic]
    bi_ab = ba + t_ab * (bb - ba)
    bi_ac = ba + t_ac * (bc - ba)
    ident = eye[None].expand(v.shape[0], 3, 3)
    prim_pl = torch.cat([pick(bi_ab, ba, ident[:, 0]), pick(bb, bi_ab, ident[:, 1]),
                         pick(bc, bi_ac, ident[:, 2])], dim=-1)
    sec_pl = torch.cat([bi_ab, bc, bi_ac], dim=-1)
    return prim, sec, prim_pl, sec_pl, n_behind


def kernel_model(scene, layout, pipeline, width, height, cap):
    """The kernels' algorithm in torch ops (csrc/front_end.cu); cap None: no
    compaction (slots [T,2T) hold the secondaries), else the secondary
    block of min(cap, T) slots."""
    consts = FE.scene_constants(scene, layout)
    clip, attr = _vertices(scene, layout, consts.starts)
    prim, sec, prim_pl, sec_pl, n_behind = _clip_triangles(clip, scene.tris)
    t = n_behind.shape[0]
    ar = torch.arange(t, device=clip.device)
    sec_valid = n_behind == 1
    if cap is None:
        order = ar
        overflow = torch.zeros((), dtype=torch.long, device=clip.device)
    else:
        # the scan: valid secondaries by rank among them, then the invalid
        # ones after every valid one, both ascending; ranks past the cap drop
        cap = min(cap, t)
        valid_before = torch.cumsum(sec_valid.long(), 0) - sec_valid.long()
        total = sec_valid.sum()
        rank = torch.where(sec_valid, valid_before, total + (ar - valid_before))
        kept = rank < cap
        order = torch.empty(cap, dtype=torch.long, device=clip.device)
        order[rank[kept]] = ar[kept]
        overflow = torch.clamp(total - cap, min=0)
    cut = ((n_behind == 1) | (n_behind == 2)).sum()  # the blocks' adds to near_clipped
    clip_counts = torch.stack([overflow, cut])
    tri_clip = torch.cat([prim, sec[order]])
    clip_valid = torch.cat([n_behind < 3, sec_valid[order]])
    planes = torch.cat([prim_pl, sec_pl[order]])
    return FE.FrontEnd(
        clip=clip, attr=attr, tri_clip=tri_clip, clip_valid=clip_valid,
        clip_src=torch.cat([ar, order]),
        clip_planes=tuple(tuple(planes[:, 3 * i + j].contiguous() for j in range(3))
                          for i in range(3)),
        setup=setup_triangles(tri_clip, width, height, pipeline, tri_valid=clip_valid),
        mat_flat=consts.mat_flat if cap is None else consts.mat_src,
        clip_overflow=clip_counts[0], clip_counts=clip_counts,
    )


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bit_equal(got, want, name):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    diff = bits(got) != bits(want)
    assert not bool(diff.any()), f"{name}: {int(diff.sum())} of {diff.numel()} differ"


def traced_chain(scene, layout, pipeline, width, height, cap):
    """passes.frame_geometry_chain inside a traced frame record, where it
    computes its clip_counts too."""
    from renderer_rs_tpu_torch.core import profiling

    profiling.enable_tracing(True)
    try:
        with profiling.frame():
            return P.frame_geometry_chain(scene, layout, pipeline, width, height, cap)
    finally:
        profiling.enable_tracing(False)


def assert_matches_chain(fe, scene, layout, pipeline, width, height, cap):
    """Every field of the front end `fe` bit-equal to the ATen chain's
    (passes.frame_geometry_chain) on the same inputs, the clip's counters
    (clip_overflow, near_clipped) included."""
    geo = traced_chain(scene, layout, pipeline, width, height, cap)
    assert_bit_equal(fe.clip_counts, geo.clip_counts, "clip_counts")
    assert_bit_equal(fe.clip, P.vertex_stage(scene, layout).clip, "clip")
    assert_bit_equal(fe.attr, geo.attr, "attr")
    assert_bit_equal(fe.tri_clip, geo.tri_clip, "tri_clip")
    assert_bit_equal(fe.clip_valid, geo.clip_valid, "clip_valid")
    assert_bit_equal(fe.clip_src, geo.clip_src, "clip_src")
    assert_bit_equal(fe.clip_overflow, geo.clip_overflow, "clip_overflow")
    for i in range(3):
        for j in range(3):
            assert_bit_equal(fe.clip_planes[i][j], geo.clip_planes[i][j], f"plane {i}{j}")
    for f in ("xy", "z", "w", "area2", "valid"):
        assert_bit_equal(getattr(fe.setup, f), getattr(geo.setup, f), f"setup.{f}")
    # the layouts the chain leaves: dense slots, w a view of tri_clip
    assert fe.setup.w.stride() == geo.setup.w.stride()
    assert_bit_equal(fe.mat_flat, geo.mat_flat, "mat_flat")


@pytest.fixture(scope="module")
def headline():
    return headline_scene(64, 48, "cpu")


@pytest.fixture(scope="module")
def clipping():
    return clipping_scene(96, 64, "cpu")


def _behind_counts(scene, layout):
    z = P.vertex_stage(scene, layout).clip[scene.tris][..., 2]
    n = (z < 0.0).sum(-1)
    return int((n == 1).sum()), int((n == 2).sum())


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("cap", [None, "default"])
def test_plain_equals_the_chain_on_the_headline_scene(headline, pipe, cap):
    scene, layout = headline
    cap = None if cap is None else max(128, layout.num_triangles // P.CLIP_COMPACT_DEN)
    fe = kernel_model(scene, layout, PIPELINES[pipe], 64, 48, cap)
    assert_matches_chain(fe, scene, layout, PIPELINES[pipe], 64, 48, cap)


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("cap", [None, 128, 5])
def test_plain_equals_the_chain_where_the_near_plane_cuts(clipping, pipe, cap):
    """One and two vertices behind; cap 5 overflows, so the kept slots are
    the first five valid secondaries; at 128 the padding holds invalid
    secondaries after every valid one."""
    scene, layout = clipping
    one, two = _behind_counts(scene, layout)
    assert one > 5 and two > 0 and one < 128
    fe = kernel_model(scene, layout, PIPELINES[pipe], 96, 64, cap)
    assert_matches_chain(fe, scene, layout, PIPELINES[pipe], 96, 64, cap)
    if cap is not None:
        assert int(fe.clip_overflow) == max(0, one - cap)
        n_tri = layout.num_triangles
        kept = fe.clip_valid[n_tri:]
        assert int(kept.sum()) == min(one, cap) and bool(kept[:min(one, cap)].all())


@pytest.mark.parametrize("cap", [None, "default", 1])
def test_plain_equals_the_chain_at_the_headline_camera(headline, cap):
    """The headline orbit 5 units out at 5 pi / 4: two quads, so cap 1
    overflows by one; the 4-vertex floor's clip positions come from one
    product over every vertex, as the kernel's fused chain rounds them."""
    scene, layout = headline
    orbit = headline_orbit(scene, 64, 48)
    assert _behind_counts(orbit, layout) == (2, 0)
    cap = max(128, layout.num_triangles // P.CLIP_COMPACT_DEN) if cap == "default" else cap
    fe = kernel_model(orbit, layout, PIPELINES["cull_back"], 64, 48, cap)
    assert_matches_chain(fe, orbit, layout, PIPELINES["cull_back"], 64, 48, cap)
    assert fe.clip_counts.tolist() == [1 if cap == 1 else 0, 2]


def test_the_kernel_branch_assembles_the_chains_frame_geometry(clipping, monkeypatch):
    """frame_geometry's kernel branch, driven on the CPU through the
    kernels' model, gives the chain's FrameGeometry field for field."""
    scene, layout = clipping
    pipe = PIPELINES["cull_none"]
    for den in (16, 0):
        forms = P.GeometryForms(clip_compact=den)
        want = P.frame_geometry(scene, layout, pipe, 96, 64, forms)
        with monkeypatch.context() as mp:
            mp.setattr(P, "_front_end_engages", lambda *a: True)
            mp.setattr(P, "front_end", kernel_model)
            got = P.frame_geometry(scene, layout, pipe, 96, 64, forms)
        assert got.compact == want.compact == (den > 0)
        for f in ("tri_clip", "clip_valid", "attr", "clip_src", "mat_flat", "clip_overflow"):
            assert_bit_equal(getattr(got, f), getattr(want, f), f)
        for i in range(3):
            for j in range(3):
                assert_bit_equal(got.clip_planes[i][j], want.clip_planes[i][j], "plane")
        for f in ("xy", "z", "w", "area2", "valid"):
            assert_bit_equal(getattr(got.setup, f), getattr(want.setup, f), f)


def _stand_in(device):
    return types.SimpleNamespace(device=torch.device(device))


@pytest.mark.parametrize("topology", list(PrimitiveTopology))
@pytest.mark.parametrize("vstage", P.VSTAGES)
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_the_kernels_engage_on_cuda_triangles_under_the_loop(topology, vstage, device):
    pipe = dataclasses.replace(GraphicsPipelineBuilder().build(), topology=topology)
    want = (device == "cuda" and vstage == "loop" and topology in (
        PrimitiveTopology.TRIANGLE_LIST, PrimitiveTopology.TRIANGLE_STRIP,
        PrimitiveTopology.TRIANGLE_FAN))
    assert P._front_end_engages(_stand_in(device), pipe, P.GeometryForms(vstage=vstage)) == want


def test_cpu_frames_keep_the_chain_and_count_no_launch(clipping, monkeypatch):
    from renderer_rs_tpu_torch.core import profiling

    def refuse(*a, **k):
        raise AssertionError("the front-end kernels ran on CPU tensors")

    monkeypatch.setattr(P, "front_end", refuse)
    scene, layout = clipping
    with profiling.frame() as rec:
        P.frame_geometry(scene, layout, PIPELINES["cull_back"], 96, 64)
        kernel_model(scene, layout, PIPELINES["cull_back"], 96, 64, None)
    assert "front_end" not in rec.launches


def test_the_wrapper_refuses_cpu_tensors(clipping):
    scene, layout = clipping
    n0 = FE.front_end.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        FE.front_end(scene, layout, PIPELINES["cull_back"], 96, 64, None)
    assert FE.front_end.launches == n0


def _widen(x):
    return torch.cat([x, x[:, :1]], dim=-1)


# name -> (the scene made malformed, what the refusal names)
MALFORMED = {
    "int32 tris": (lambda s: s.replace(tris=s.tris.int()), "tris must be int64"),
    "a vertex id past V": (lambda s: s.replace(tris=torch.where(
        s.tris == s.tris.max(), s.positions.shape[0], s.tris)), "outside"),
    "a negative vertex id": (lambda s: s.replace(tris=torch.where(s.tris == 0, -1, s.tris)),
                             "outside"),
    "a short tri_material": (lambda s: s.replace(tri_material=s.tri_material[1:]),
                             "tri_material"),
    "float64 positions": (lambda s: s.replace(positions=s.positions.double()), "positions"),
    "[V,4] normals": (lambda s: s.replace(normals=_widen(s.normals)), "normals"),
    "[V,3] uvs": (lambda s: s.replace(uvs=_widen(s.uvs)), "uvs"),
    "[V,3] tangents": (lambda s: s.replace(tangents=s.tangents[:, :3]), "tangents"),
    "one model short": (lambda s: s.replace(models=s.models[1:]), "models"),
    "[O,3,3] normal matrices": (lambda s: s.replace(
        normal_mats=s.normal_mats[:, :3, :3].contiguous()), "normal_mats"),
}


@pytest.mark.parametrize("case", MALFORMED)
def test_the_wrapper_refuses_malformed_inputs(headline, case):
    """The kernels read raw pointers: the wrapper checks every input's
    dtype and shape, and the vertex ids' range, before it builds or
    launches anything (here on the CPU, where a launch would fail to
    build)."""
    scene, layout = headline
    assert layout.has_textures and layout.texture_slots[1]  # every lane is read
    make, match = MALFORMED[case]
    bad = make(scene)
    n0 = FE.front_end.launches
    with pytest.raises(ValueError, match=match):
        FE._launch(bad, layout, PIPELINES["cull_back"], 64, 48, None)
    assert FE.front_end.launches == n0


def test_the_wrapper_counts_under_front_end():
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.ops.raster_cuda import count_launch

    n0 = FE.front_end.launches
    with profiling.frame() as rec:
        count_launch(FE.front_end, launches=3)
    assert rec.launches == {"front_end": 3}
    assert FE.front_end.launches - n0 == 3


def test_scene_constants_are_built_once_per_scene(headline):
    scene, layout = headline
    c = FE.scene_constants(scene, layout)
    assert FE.scene_constants(scene.replace(), layout) is c  # a new camera keeps them
    assert c.starts.tolist() == [r[0] for r in layout.object_ranges]
    other = scene.replace(tri_material=scene.tri_material.clone())
    assert FE.scene_constants(other, layout) is not c
    bad = dataclasses.replace(layout, object_ranges=layout.object_ranges[1:])
    with pytest.raises(ValueError, match="cover the vertices"):
        FE.scene_constants(scene.replace(tri_material=scene.tri_material.clone()), bad)


# --- on the card -----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU build)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_scenes():
    dev = _cuda()
    headline = headline_scene(1920, 1080, dev)
    return {"headline": headline, "clipping": clipping_scene(1920, 1080, dev),
            "orbit": (headline_orbit(headline[0], 1920, 1080), headline[1])}


@pytest.mark.cuda
def test_aten_three_lane_sum_order_on_the_card():
    """csrc/front_end.cu's lane_sum: torch.sum over three lanes on the card
    adds (x0 + x2) + x1 from a +0 identity (an all -0 row sums to +0)."""
    dev = _cuda()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1 << 20, 3, generator=g) * torch.logspace(-8, 8, 3)[torch.randint(0, 3, (1 << 20, 3), generator=g)]
    x[:64] = -0.0
    x = x.to(dev)
    got = torch.sum(x, dim=-1)
    want = ((x[:, 0] + x[:, 2]) + x[:, 1]) + 0.0
    assert_bit_equal(got, want, "sum")
    assert int((got != (x[:, 0] + x[:, 1]) + x[:, 2]).sum()) > 0  # the order shows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["headline", "clipping", "orbit"])
@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("cap", [None, "default", 5])
def test_kernels_equal_the_chain_on_the_card(card_scenes, name, pipe, cap):
    scene, layout = card_scenes[name]
    if cap == "default":
        cap = max(128, layout.num_triangles // P.CLIP_COMPACT_DEN)
    n0 = FE.front_end.launches
    fe = FE.front_end(scene, layout, PIPELINES[pipe], 1920, 1080, cap)
    assert FE.front_end.launches - n0 == (2 if cap is None else 3)
    assert_matches_chain(fe, scene, layout, PIPELINES[pipe], 1920, 1080, cap)
    if name == "clipping":
        one, two = _behind_counts(scene, layout)
        assert one > 5 and two > 0
    if name == "orbit":
        assert _behind_counts(scene, layout) == (2, 0)


@pytest.mark.cuda
def test_the_frame_is_unchanged_on_the_card(monkeypatch):
    """The headline PBR+IBL frame at 1920x1080: K2's ids, depth, material
    ids and lanes, and the image, from the kernels' geometry and from the
    chain's."""
    from renderer_rs_tpu_torch.app.scenes import full_scene

    dev = _cuda()
    scene, layout, kw, _ = full_scene(1920, 1080, textured=True, device=dev)
    pipe = kw["pipeline"]
    frames = {}
    for kernels in (True, False):
        with monkeypatch.context() as mp:
            if not kernels:
                mp.setattr(P, "_front_end_engages", lambda *a: False)
            geo = P.frame_geometry(scene, layout, pipe, 1920, 1080)
            k2 = P._fused_raster(scene, layout, geo, pipe, 1080, 1920, 1.0, None)
            out = P.forward_frame(scene, layout, pipe, kw["shading"], 1920, 1080,
                                  return_depth=True, return_ids=True, tonemap=kw["tonemap"],
                                  shadow_params=kw["shadow_params"])
        frames[kernels] = (k2, out)
    (k2, out), (k2_ref, out_ref) = frames[True], frames[False]
    for name, got, want in zip(("depth", "tri_id", "mat_id", "lanes"), k2[:4], k2_ref[:4]):
        assert_bit_equal(got, want, name)
    assert (k2[1] >= 0).float().mean() > 0.3
    for name, got, want in zip(("image", "depth", "ids"), out, out_ref):
        assert_bit_equal(got, want, name)


@pytest.mark.cuda
def test_a_render_loop_counts_the_kernels():
    """Each Renderer.render_frame of the headline frame runs the front end
    as three launches (compaction on) and adds no host sync to the three
    of the frame (the inverse's check, the fence wait, the readback)."""
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    dev = _cuda()
    scene, layout, kw, _ = full_scene(1920, 1080, textured=True, device=dev)
    r = Renderer(RendererConfig(width=1920, height=1080), device=dev,
                 **{k: v for k, v in kw.items() if k != "camera"})
    r.set_scene(scene, layout)
    r.render_frame()
    n0 = FE.front_end.launches
    profiling.clear_records()
    profiling.enable_tracing()
    try:
        for _ in range(3):
            r.render_frame()
    finally:
        profiling.enable_tracing(False)
    recs = [x for x in profiling.records() if x.frame is not None]
    assert FE.front_end.launches - n0 == 9
    assert [x.launches.get("front_end") for x in recs] == [3, 3, 3]
    assert [x.syncs for x in recs] == [3, 3, 3]
