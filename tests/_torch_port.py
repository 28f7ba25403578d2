"""Shared helpers of the tests/test_torch_*.py parity tests: JAX package
state flattened to numpy for renderer_rs_tpu_torch.bridge.scene_from_numpy,
and the Pallas interpret-mode switch the JAX package's own tests use."""

import dataclasses

import numpy as np


def flatten_jax_scene(scene, layout):
    """(fields, layout_fields) of a JAX GpuScene/SceneLayout as numpy arrays
    and Python values (the untextured subset; of an environment only the
    skybox levels, which is what the port's frames read)."""

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
    fields["environment"] = (
        None if env is None else {"skybox_mips": tuple(np.asarray(m) for m in env.skybox_mips)}
    )
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
