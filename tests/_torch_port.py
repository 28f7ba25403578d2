"""Shared helpers of the tests/test_torch_*.py parity tests: JAX package
state flattened to numpy for renderer_rs_tpu_torch.bridge.scene_from_numpy,
and the Pallas interpret-mode switch the JAX package's own tests use."""

import dataclasses

import numpy as np


def flatten_jax_scene(scene, layout):
    """(fields, layout_fields) of a JAX GpuScene/SceneLayout as numpy arrays
    and Python values: the whole environment (skybox, IBL maps and their
    fast-ambient form), of the textures the mips, the per-texture and the
    f32 per-material window atlases with their offsets and sizes, the
    single-gather material atlas (its bf16 bits as uint16) and the material
    -> set map, which is what the port's frames read."""

    def group(obj):
        return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}

    fields = {
        k: np.asarray(getattr(scene, k))
        for k in ("positions", "normals", "uvs", "tangents", "colors", "tris",
                  "tri_material", "models", "normal_mats")
    }
    for k in ("materials", "lights", "camera", "scene_ubo"):
        fields[k] = group(getattr(scene, k))
    for k in ("light_space_matrix", "csm_matrices", "csm_splits"):
        value = getattr(scene, k, None)
        fields[k] = None if value is None else np.asarray(value)
    env = getattr(scene, "environment", None)
    fields["environment"] = None if env is None else {
        f.name: (None if getattr(env, f.name) is None
                 else tuple(np.asarray(m) for m in getattr(env, f.name))
                 if isinstance(getattr(env, f.name), tuple) else np.asarray(getattr(env, f.name)))
        for f in dataclasses.fields(env)
    }
    tex = getattr(scene, "textures", None)
    fields["textures"] = None if tex is None else {
        "mips": tuple(np.asarray(m) for m in tex.mips),
        **{k: None if getattr(tex, k) is None else np.asarray(getattr(tex, k))
           for k in ("atlas", "atlas_offsets", "atlas_sizes", "mat_atlas", "mat_offsets",
                     "mat_sizes")},
        "mat_atlas_tri": (None if tex.mat_atlas_tri is None
                          else np.asarray(tex.mat_atlas_tri).view(np.uint16)),
        "mat_set": None if tex.mat_set is None else np.asarray(tex.mat_set),
    }
    layout_fields = {f.name: getattr(layout, f.name) for f in dataclasses.fields(layout)}
    return fields, layout_fields


def random_clip_scene(t=120, seed=4, w_lo=0.5, spread=0.3):
    """Random clip-space triangles, [3T,4] vertices + [T,3] ids (the
    tests/test_raster_pallas.py:40 `_scene` recipe). w_lo < 1e-5 puts
    vertices behind the near plane, so the near clip splits triangles;
    a larger `spread` makes larger triangles."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1.0, 1.0, (t, 1, 3)).astype(np.float32)
    off = rng.uniform(-spread, spread, (t, 3, 3)).astype(np.float32)
    pos = center + off
    pos[..., 2] = rng.uniform(0.05, 0.95, (t, 3))
    w = rng.uniform(w_lo, 3.0, (t, 3, 1)).astype(np.float32)
    clip = np.concatenate([pos * w, w], -1)
    return clip.reshape(t * 3, 4), np.arange(t * 3, dtype=np.int32).reshape(t, 3)


def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode and take its
    fused (TPU) frame path on the CPU, as tests/test_raster_pallas.py does
    (:29-37, :597)."""
    import renderer_rs_tpu.ops.raster_pallas as rp
    import renderer_rs_tpu.renderer.passes as passes

    orig = rp.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(rp.pl, "pallas_call", interp)
    monkeypatch.setattr(passes, "_use_pallas", lambda: True)


def port_renderer_kwargs(jax_kwargs):
    """A JAX scene factory's renderer kwargs as the port's Renderer takes
    them: shading and shadow parameters rebuilt by value, tonemap and
    shadow map size passed through, and the default pipeline (which every
    demo scene uses; checked by value)."""
    import dataclasses as dc
    import enum

    from renderer_rs_tpu_torch.ops.shadow import ShadowParams
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return x.value if isinstance(x, enum.Enum) else x

    pipeline = GraphicsPipelineBuilder().build()
    assert plain(dc.asdict(jax_kwargs["pipeline"])) == plain(dc.asdict(pipeline))
    out = {"pipeline": pipeline, "shading": ShadingModel(jax_kwargs["shading"].value)}
    if "shadow_params" in jax_kwargs:
        out["shadow_params"] = ShadowParams(**dc.asdict(jax_kwargs["shadow_params"]))
    for key in ("tonemap", "shadow_map_size"):
        if key in jax_kwargs:
            out[key] = jax_kwargs[key]
    return out


def _cutout_texture(size: int = 64) -> np.ndarray:
    """RGBA with a hard-edged alpha stripe pattern (alpha 0 or 1 in 16-texel
    bands), so bilinear alpha lands far from a 0.5 cutoff except on a thin
    boundary line (≙ tests/test_alpha_cutoff.py::_cutout_texture)."""
    y, x = np.mgrid[0:size, 0:size]
    a = ((x // 16) % 2).astype(np.float32)
    img = np.stack([np.full_like(a, 0.9), np.full_like(a, 0.4), np.full_like(a, 0.2), a], -1)
    return img.astype(np.float32)


def alpha_cutout_scene(width: int, height: int, layers: int = 3, dx: float = 0.15,
                       device="cuda"):
    """(scene, layout) of the alpha-cutout test stack built by the port's own
    SceneBuilder (≙ tests/test_alpha_cutoff.py::_mask_scene): `layers`
    stacked quads with the cutout texture in front of an opaque floor,
    viewed down -Z, plus 20 small cubes that lift the triangle count over
    the binned threshold. dx=0 aligns every layer's alpha-0 stripes, so
    failing-fragment stacks deeper than the 4-layer peel occur. Render it
    with `.cull_mode(CullMode.NONE).alpha_cutoff(0.5)` and PBR shading.
    Imports no JAX, so chip_smoke.py uses it too."""
    import math

    from renderer_rs_tpu_torch.app.scenes import _camera_ubo
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.resources.material import Material
    from renderer_rs_tpu_torch.resources.ubo import SceneUbo
    from renderer_rs_tpu_torch.scene.camera import Camera, Projection
    from renderer_rs_tpu_torch.scene.light import DirectionalLight, LightBank
    from renderer_rs_tpu_torch.scene.transform import Transform
    from renderer_rs_tpu_torch.utils import meshgen

    # quat_from_axis_angle(+X, pi/2) as jnp computes it: the f32 half angle,
    # its sin and cos correctly rounded; plane_mesh (+Y) then faces +Z
    half = float(np.float32(0.5) * np.float32(math.pi / 2))
    rot = np.array([math.sin(half), 0.0, 0.0, math.cos(half)], np.float32)
    b = SceneBuilder()
    mask_mat = Material(base_color=(1, 1, 1, 1), roughness=0.7, base_color_texture=0)
    for i in range(layers):
        tr = Transform().with_position([dx * i, 0.1 * i, -0.4 * i]).with_rotation(rot)
        b.add_mesh(meshgen.plane_mesh(2.0, uv_scale=1.0), tr, mask_mat if i == 0 else 0)
    b.add_mesh(meshgen.plane_mesh(6.0), Transform().with_position([0, -1.2, 0]),
               Material(base_color=(0.2, 0.6, 0.3, 1.0), roughness=0.9))
    filler = Material(base_color=(0.5, 0.2, 0.2, 1.0))
    for k in range(20):
        b.add_mesh(meshgen.cube_mesh(0.08),
                   Transform().with_position([-1.6 + 0.16 * k, -0.9, -1.0]), filler)
    b.set_textures([_cutout_texture()], size=64)
    cam = Camera(Projection.perspective(np.radians(50.0), width / height, 0.1, 50.0))
    cam.position = np.array([0.0, 0.0, 3.0], np.float32)
    cam.look_at([0.0, 0.0, 0.0])
    b.set_camera(_camera_ubo(cam))
    b.set_lights(LightBank.create(sun=DirectionalLight.create(direction=(-0.3, -1.0, -0.4))))
    b.set_scene_ubo(SceneUbo.create(ambient_color=(0.1, 0.1, 0.1)))
    return b.build(device=device)


# clip = (x, y, z - 0.5, z) for a world point (x, y, z): view = I and this
# projection make every vertex-stage product exact, so the JAX package and
# the port set up the same triangles bit for bit (their matmuls round
# apart otherwise), and the frames' depths can be held bit-equal
EXACT_PROJECTION = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -0.5], [0, 0, 1, 0]],
                            np.float32)


def exact_scene(pkg: str, masked: bool = False, textured: bool = False, device=None):
    """A SceneBuilder of `pkg` ("renderer_rs_tpu" or "renderer_rs_tpu_torch")
    whose vertex stage is exact (EXACT_PROJECTION, translations only):
    two uv spheres and a back wall, 388 triangles; `textured` puts the
    cutout texture on the wall, `masked` adds three cutout-textured quads
    in front at depths 1.4-1.8 (the alpha-cutoff stack) and makes the
    spheres coarser (64 triangles each). Returns the built (scene,
    layout); `device` goes to the port's build."""
    import importlib

    mod = {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "renderer.scene_build", "resources.material", "resources.model", "resources.ubo",
        "scene.light", "scene.transform", "utils.meshgen")}
    Material = mod["resources.material"].Material
    Transform = mod["scene.transform"].Transform

    def quad(x0, y0, x1, y1, z):
        return mod["resources.model"].Mesh(
            positions=np.array([[x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]], np.float32),
            normals=np.tile(np.array([[0, 0, -1]], np.float32), (4, 1)),
            tex_coords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
            tangents=np.tile(np.array([[1, 0, 0, 1]], np.float32), (4, 1)),
            indices=np.array([0, 1, 2, 0, 2, 3], np.uint32))

    b = mod["renderer.scene_build"].SceneBuilder()
    sphere = mod["utils.meshgen"].uv_sphere_mesh(0.6, rings=4 if masked else 8,
                                                 sectors=8 if masked else 12)
    b.add_mesh(sphere, Transform().with_position([-0.5, 0.25, 2.5]),
               Material(base_color=(0.8, 0.3, 0.2, 1.0), roughness=0.4))
    b.add_mesh(sphere, Transform().with_position([0.625, -0.125, 2.0]),
               Material(base_color=(0.2, 0.5, 0.9, 1.0), roughness=0.6, metallic=0.5))
    cutout = Material(base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.7, base_color_texture=0)
    wall = cutout if textured else Material(base_color=(0.6, 0.6, 0.5, 1.0))
    b.add_mesh(quad(-2.5, -1.5, 2.5, 1.5, 3.5), None, wall)
    if masked:
        for i in range(3):
            b.add_mesh(quad(-0.75 + 0.125 * i, -0.5, 0.75 + 0.125 * i, 0.625, 1.4 + 0.2 * i),
                       None, cutout)
    if masked or textured:
        b.set_textures([_cutout_texture()], size=64)
    b.set_camera(mod["resources.ubo"].CameraUbo.create(np.eye(4, dtype=np.float32),
                                                       EXACT_PROJECTION, np.zeros(3, np.float32)))
    light = mod["scene.light"]
    b.set_lights(light.LightBank.create(sun=light.DirectionalLight.create(
        direction=(-0.3, -1.0, 0.4))))
    b.set_scene_ubo(mod["resources.ubo"].SceneUbo.create(ambient_color=(0.2, 0.2, 0.2)))
    return b.build() if device is None else b.build(device=device)


def memoize_jax_raster(monkeypatch):
    """Run the JAX package's binned Pallas rasterizer once per distinct input
    (its launcher rasterize_binned_pallas memoized on the bytes of every
    array argument and the other arguments' values): the shade-path tests
    render many frames of one geometry, whose rasterization, in interpret
    mode, costs seconds each time and gives the same outputs."""
    import hashlib

    import jax

    import renderer_rs_tpu.ops.raster_pallas as rp

    orig = rp.rasterize_binned_pallas
    cache = {}

    def key_of(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            a = np.asarray(x)
            return ("a", a.shape, str(a.dtype), hashlib.sha1(a.tobytes()).hexdigest())
        return ("v", repr(x))

    def memo(*args, **kwargs):
        leaves, tree = jax.tree_util.tree_flatten((args, sorted(kwargs.items())))
        key = (str(tree), tuple(key_of(x) for x in leaves))
        if key not in cache:
            cache[key] = orig(*args, **kwargs)
        return cache[key]

    monkeypatch.setattr(rp, "rasterize_binned_pallas", memo)
