"""The public helpers of the JAX package that its own tests use (ROADMAP
Queue 1 item 19), held to the JAX functions on the same numpy inputs made
from a seed, one parametrised test per module: mathx, scene/transform,
resources/ubo, resources/material, ops/srgb and core/config.

Bars: bit-equal, except where the two libraries round apart, measured on
these inputs: the pow of the sRGB pow-2.2 helpers (torch's pow against
XLA's) within 1 ulp (rtol 1.2e-7); the 3x3 inverse of the normal matrices
(torch.linalg.inv against jnp.linalg.inv) within 2 ulp of the largest
entry; transform_vectors, whose [N,3] @ [3,3] dot XLA:CPU sums in an order
not reproduced, within 1e-6 absolute on N(0,1) inputs (measured 4.8e-7).
The products of transform_point/transform_vector (the last two products
fused in turn) and of transform_points (pairwise sums) are written as
XLA:CPU's dot forms them, and normalize_or_zero adds its squares left to
right with a correctly rounded sqrt: bit-equal."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), np.abs(got - want).max()


def _rng():
    return np.random.default_rng(19)


@pytest.mark.parametrize("fn", [
    "mat4_identity", "translate_mat4", "scale_mat4", "rotate_mat4", "transform_point",
    "transform_vector", "transform_points", "transform_vectors", "quat_mul",
    "quat_from_euler_yxz", "quat_to_mat4", "normalize_or_zero", "reflect",
])
def test_mathx_matches_jax(fn):
    import jax.numpy as jnp

    import renderer_rs_tpu.mathx as jm
    import renderer_rs_tpu_torch.mathx as pm

    rng = _rng()
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    v3 = rng.normal(size=3).astype(np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    if fn == "mat4_identity":
        _bits(pm.mat4_identity(), jm.mat4_identity())
    elif fn in ("translate_mat4", "scale_mat4"):
        _bits(getattr(pm, fn)(v3), getattr(jm, fn)(v3))
    elif fn == "rotate_mat4":
        r = rng.normal(size=(3, 3)).astype(np.float32)
        _bits(pm.rotate_mat4(t(r)), jm.rotate_mat4(jnp.asarray(r)))
    elif fn in ("transform_point", "transform_vector"):
        for _ in range(16):
            m = rng.normal(size=(4, 4)).astype(np.float32)
            p = rng.normal(size=3).astype(np.float32)
            _bits(getattr(pm, fn)(t(m), t(p)), getattr(jm, fn)(jnp.asarray(m), jnp.asarray(p)))
    elif fn in ("transform_points", "transform_vectors"):
        pts = rng.normal(size=(256, 3)).astype(np.float32)
        got = getattr(pm, fn)(t(m), t(pts))
        want = getattr(jm, fn)(jnp.asarray(m), jnp.asarray(pts))
        if fn == "transform_points":
            _bits(got, want)
        else:
            # XLA's [N,3] @ [3,3] dot sums in an order not found here: ulps
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    elif fn == "quat_mul":
        a, b = rng.normal(size=(2, 4)).astype(np.float32)
        _bits(pm.quat_mul(t(a), t(b)), jm.quat_mul(jnp.asarray(a), jnp.asarray(b)))
    elif fn in ("quat_from_euler_yxz", "quat_to_mat4"):
        for yaw, pitch, roll in rng.uniform(-3.0, 3.0, (8, 3)).astype(np.float32):
            q = pm.quat_from_euler_yxz(float(yaw), float(pitch), float(roll))
            qj = jm.quat_from_euler_yxz(float(yaw), float(pitch), float(roll))
            _bits(q, qj)
            _bits(pm.quat_to_mat4(q), jm.quat_to_mat4(qj))
    elif fn == "normalize_or_zero":
        v = rng.normal(size=(32, 3)).astype(np.float32)
        v[:4] = 0.0
        v[4:8] *= 1e-13  # below eps: zero
        got = pm.normalize_or_zero(t(v))
        _bits(got, jm.normalize_or_zero(jnp.asarray(v)))
        assert (got[:8] == 0).all()
    else:
        i, n = rng.normal(size=(2, 32, 3)).astype(np.float32)
        _bits(pm.reflect(t(i), t(n)), jm.reflect(jnp.asarray(i), jnp.asarray(n)))


@pytest.mark.parametrize("what", ["parenting", "directions", "world_and_normal"])
def test_transform_matches_jax(what):
    from renderer_rs_tpu.mathx import quat_from_axis_angle as jq
    from renderer_rs_tpu.scene.transform import Transform as JT
    from renderer_rs_tpu_torch.scene.transform import Transform as PT

    rng = _rng()

    def pair(pos, axis, angle, scale):
        rot = np.array(jq(axis, angle))  # a writable copy
        return (PT().with_position(pos).with_rotation(rot).with_scale(scale),
                JT().with_position(pos).with_rotation(rot).with_scale(scale))

    axis = rng.normal(size=3).astype(np.float32)
    axis /= np.linalg.norm(axis)
    child_p, child_j = pair([1.0, 2.0, -0.5], axis, 0.7, [1.0, 2.0, 0.5])
    parent_p, parent_j = pair([-3.0, 0.25, 4.0], [0.0, 1.0, 0.0], 1.1, [2.0, 2.0, 2.0])
    if what == "parenting":
        assert not child_p.has_parent() and child_p.parent is None
        child_p.set_parent(parent_p)
        child_j.set_parent(parent_j)
        assert child_p.has_parent() and child_p.parent is not parent_p  # an owned clone
        parent_p.with_position([9.0, 9.0, 9.0])  # the clone does not follow
        _bits(child_p.world_matrix(), child_j.world_matrix())
        child_p.clear_parent()
        child_j.clear_parent()
        assert not child_p.has_parent()
        _bits(child_p.world_matrix(), child_j.world_matrix())
    elif what == "directions":
        for name in ("forward", "right", "up"):
            _bits(getattr(child_p, name)(), getattr(child_j, name)())
    else:
        child_p.set_parent(parent_p)
        child_j.set_parent(parent_j)
        _bits(child_p.world_matrix(), child_j.world_matrix())
        got, want = child_p.normal_matrix().numpy(), np.asarray(child_j.normal_matrix())
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.abs(want).max()))


@pytest.mark.parametrize("what", ["camera", "object", "directional_light"])
def test_ubo_matches_jax(what):
    import renderer_rs_tpu.resources.ubo as jubo
    import renderer_rs_tpu_torch.resources.ubo as pubo

    rng = _rng()
    view, proj, view2, proj2 = rng.normal(size=(4, 4, 4)).astype(np.float32)
    eye, eye2 = rng.normal(size=(2, 3)).astype(np.float32)
    if what == "camera":
        cam_p = pubo.CameraUbo.create(view, proj, eye)
        cam_j = jubo.CameraUbo.create(view, proj, eye)
        for got, want in ((cam_p.update_view(view2, eye2), cam_j.update_view(view2, eye2)),
                          (cam_p.update_projection(proj2), cam_j.update_projection(proj2))):
            for f in ("view", "projection", "view_projection", "camera_position"):
                _bits(getattr(got, f), getattr(want, f))
    elif what == "object":
        singular = np.diag([1.0, 1.0, 1e-7, 1.0]).astype(np.float32)
        for model in (view, singular):
            got, want = pubo.ObjectUbo.create(model), jubo.ObjectUbo.create(model)
            _bits(got.model, want.model)
            np.testing.assert_allclose(got.normal_matrix.numpy(), np.asarray(want.normal_matrix),
                                       rtol=0, atol=2 * np.spacing(
                                           np.abs(np.asarray(want.normal_matrix)).max()))
            upd = got.update_model(proj)
            _bits(upd.model, jubo.ObjectUbo.create(proj).model)
        assert np.array_equal(pubo.ObjectUbo.compute_normal_matrix(singular).numpy(), np.eye(4))
    else:
        for d in ((-0.3, -1.0, 0.4), (0.0, 0.0, 0.0)):
            got = pubo.DirectionalLightUbo.create(d, (1.0, 0.9, 0.8), 3.5)
            want = jubo.DirectionalLightUbo.create(d, (1.0, 0.9, 0.8), 3.5)
            for f in ("direction", "color", "intensity"):
                _bits(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("count", [0, 5])
def test_material_bank_matches_jax(count):
    import renderer_rs_tpu.resources.material as jmat
    import renderer_rs_tpu_torch.resources.material as pmat

    got = pmat.MaterialBank.create([pmat.Material(roughness=0.1 * i) for i in range(count)])
    want = jmat.MaterialBank.create([jmat.Material(roughness=0.1 * i) for i in range(count)])
    assert got.num_materials == want.num_materials == max(count, 1)


@pytest.mark.parametrize("size", [(1920, 1080), (800, 600), (33, 7)])
def test_config_matches_jax(size):
    from renderer_rs_tpu.core.config import RendererConfig as JC
    from renderer_rs_tpu_torch.core.config import RendererConfig as PC

    w, h = size
    assert PC(width=w, height=h).aspect_ratio() == JC(width=w, height=h).aspect_ratio()


@pytest.mark.parametrize("fn", ["linear_to_srgb_pow22", "srgb_to_linear_pow22"])
def test_srgb_matches_jax(fn):
    import renderer_rs_tpu.ops.srgb as js
    import renderer_rs_tpu_torch.ops.srgb as ps

    c = np.concatenate([np.arange(256, dtype=np.float32) / 255.0,
                        _rng().uniform(-0.5, 4.0, 256).astype(np.float32)])
    got = getattr(ps, fn)(torch.from_numpy(c)).numpy()
    want = np.asarray(getattr(js, fn)(c))
    assert (got[c <= 0] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
