"""The port's shadow path against the JAX package: the light matrix, the
shadow map of a bridged scene, the PCF and hard lookups, and the row
upsamplers.

Bars, as measured on the CPU:
- directional_light_matrix, upsample4x_y, upsample2x_y: bit-equal.
- shadow_map_pass from scene inputs: the light-space vertex matmuls differ
  by an ulp between XLA and PyTorch (tests/test_torch_frontend.py), so the
  depth map is not bit-equal: |d| <= 2e-6 everywhere (measured 5.4e-7) and
  < 10% of the texels differ at all (measured 5.5%). K1 itself is bit-equal
  on the same setup (tests/test_torch_depth_kernel.py).
- calculate_shadow on the same map and positions: the lit factor is a count
  of <= 9 hard compares over 9, so it is exact unless a tap lies within an
  ulp of the compared depth: < 0.1% of the pixels differ (measured 0 for
  PCF and for the hard lookup), none by more than one tap (1/9)."""

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas

torch.set_num_threads(1)

SIZE = 256


@pytest.fixture(scope="module")
def full_small():
    """JAX full_scene(160, 120, tri_budget=2000, ibl=False), its 256² shadow
    map as the JAX package renders it on the CPU, and the bridged scene."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import shadow_map_pass
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    js, jl, jkw, _ = full_scene(160, 120, tri_budget=2000, ibl=False)
    jmap = np.asarray(shadow_map_pass(js, jl, SIZE))
    ps, pl = scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu")
    return js, jl, jkw, jmap, ps, pl


def test_shadow_map_pass_matches(full_small, monkeypatch):
    from renderer_rs_tpu.renderer.passes import shadow_map_pass as jax_pass
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth
    from renderer_rs_tpu_torch.renderer.passes import shadow_map_pass

    js, jl, _, jmap, ps, pl = full_small
    before = raster_depth.launches
    got = shadow_map_pass(ps, pl, SIZE).numpy()
    assert raster_depth.launches == before  # CPU: the plain version
    assert got.shape == (SIZE, SIZE) and np.isfinite(got).all()
    assert (got < 1.0).mean() > 0.5  # the floor fills the light box
    err = np.abs(got - jmap)
    assert err.max() <= 2e-6, err.max()
    assert (got != jmap).mean() < 0.10, (got != jmap).mean()
    # the TPU form of the pass (Pallas K1, interpret mode) gives the JAX
    # package's CPU map bit for bit, so the bar above holds against it too
    interpret_pallas(monkeypatch)
    assert np.array_equal(np.asarray(jax_pass(js, jl, SIZE)), jmap)


def _lookup_inputs(full_small, seed=3, shape=(96, 128)):
    """World positions over the light box (and beyond its edges), unit
    normals, and the scene's own shadow map and matrix."""
    js, _, jkw, jmap, ps, _ = full_small
    rng = np.random.default_rng(seed)
    wp = rng.uniform(-4.5, 4.5, shape + (3,)).astype(np.float32)
    wp[..., 1] = rng.uniform(-0.2, 1.4, shape)
    n = rng.normal(size=shape + (3,)).astype(np.float32)
    n[..., 1] = np.abs(n[..., 1]) + 0.2
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    sun = -np.asarray(js.lights.sun_direction)
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    return wp, n, sun, jmap, np.asarray(js.light_space_matrix)


@pytest.mark.parametrize("pcf", [True, False])
def test_calculate_shadow_matches(full_small, pcf):
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.shadow import ShadowParams as JParams
    from renderer_rs_tpu.ops.shadow import calculate_shadow as jax_shadow
    from renderer_rs_tpu_torch.ops.shadow import ShadowParams, calculate_shadow

    wp, n, sun, smap, lsm = _lookup_inputs(full_small)
    kw = dict(shadow_bias=0.012, normal_bias=0.06, shadow_strength=0.8, pcf=pcf)
    want = np.asarray(jax_shadow(
        jnp.asarray(smap), jnp.asarray(lsm), jnp.asarray(wp), jnp.asarray(n),
        jnp.broadcast_to(jnp.asarray(sun), wp.shape), JParams(**kw),
    ))
    t = torch.from_numpy
    got = calculate_shadow(
        t(smap.copy()), t(lsm.copy()), t(wp), t(n), t(sun).expand(wp.shape), ShadowParams(**kw),
    ).numpy()
    assert got.shape == want.shape == wp.shape[:2]
    # every regime occurs: lit, shadowed, partial (PCF only), out of the box
    assert (want == 1.0).mean() > 0.1 and (want < 0.3).mean() > 0.02
    if pcf:
        assert ((want > 0.3) & (want < 1.0)).mean() > 0.01
    diff = np.abs(got - want)
    assert (diff > 1e-6).mean() < 1e-3, (diff > 1e-6).mean()
    assert diff.max() <= 0.8 / 9.0 + 1e-6, diff.max()


def test_shadow_lookup_survives_far_positions(full_small):
    """Positions far outside the light box, at infinity and NaN (uncovered
    pixels carry garbage) index the map in range and come out fully lit."""
    from renderer_rs_tpu_torch.ops.shadow import calculate_shadow

    _, n, sun, smap, lsm = _lookup_inputs(full_small, shape=(4, 8))
    wp = np.full((4, 8, 3), 1e30, np.float32)
    wp[1] = -1e30
    wp[2] = np.inf
    wp[3] = np.nan
    t = torch.from_numpy
    lit = calculate_shadow(t(smap.copy()), t(lsm.copy()), t(wp), t(n), t(sun).expand(wp.shape))
    assert torch.equal(lit, torch.ones_like(lit))


@pytest.mark.parametrize("rows,full", [(32, 128), (27, 106), (64, 128), (30, 59)])
def test_upsamplers_bit_equal(rows, full):
    import jax.numpy as jnp

    from renderer_rs_tpu.ops import shadow as jshadow
    from renderer_rs_tpu_torch.ops import shadow as pshadow

    s = np.random.default_rng(rows).random((rows, 40), dtype=np.float32)
    name = "upsample4x_y" if full > 2 * rows else "upsample2x_y"
    want = np.asarray(getattr(jshadow, name)(jnp.asarray(s), full))
    got = getattr(pshadow, name)(torch.from_numpy(s), full).numpy()
    assert got.shape == want.shape == (full, 40)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("direction,radius", [
    ((-0.45, -1.0, -0.35), 3.5), ((0.3, -0.8, 0.5), 7.0), ((0.0, -1.0, 0.0), 2.0),
])
def test_directional_light_matrix_bit_equal(direction, radius):
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.shadow import directional_light_matrix as jax_dlm
    from renderer_rs_tpu_torch.ops.shadow import directional_light_matrix

    center = (0.25, 0.0, -0.5)
    want = np.asarray(jax_dlm(jnp.asarray(direction, jnp.float32),
                              jnp.asarray(center, jnp.float32), radius))
    got = directional_light_matrix(direction, center, radius).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), np.abs(got - want).max()
