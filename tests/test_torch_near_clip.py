"""The near clip's two forms (ops/clip.py): the plane form, the main path's,
clips at z = 0 as renderer-rs's Vulkan clip volume 0 <= z <= w does; the w
form clips at w = 1e-5 as the JAX package does.

- The plane form against the plain reference's clip
  (bench_port/reference/raster.py::clip_near, float64) on seeded random
  triangles in a perspective_rh lens, crossing the near plane with one and
  with two vertices behind: the same polygon for each source triangle, its
  clip coordinates and source barycentrics to float32 rounding, each fan
  triangle wound as its source.
- The two forms bit-equal on every valid slot where no vertex has z < 0,
  and on the frame the benchmark's 9-out orbit renders.
- The w form bit-equal to the JAX package's clip on crossing triangles.
- The headline frame (pbr_ibl_1080p at its own camera, 5 units out and 3
  up, at an angle where the floor crosses the near plane), 320x180 on the
  CPU through Renderer.render_frame, against the benchmark's reference:
  within the check's limits under the plane form, outside them under the
  w form.
- The frame record's counters (core/profiling.py): a traced frame at the
  headline camera records near_clipped > 0 and clip_overflow == 0, one 9
  out records 0 for both; an untraced frame computes and copies nothing
  for them.

The cuda-marked test needs the card: traced render_frame calls there
record the counters with no host sync added. Run it there with
`python -m pytest --noconftest -m cuda tests/test_torch_near_clip.py`."""

import copy
import math

import numpy as np
import pytest
import torch

from bench_port import compare, spec
from bench_port.reference.raster import clip_near
from bench_port.run import ROOT
from renderer_rs_tpu_torch.core import profiling
from renderer_rs_tpu_torch.mathx.mat4 import perspective_rh
from renderer_rs_tpu_torch.ops import clip as pclip
from renderer_rs_tpu_torch.renderer import passes as P

ULP1 = 2.0 ** -23  # float32's spacing at 1
# the headline orbit (bench_port/traffic/orbit.json) at an angle where the
# floor crosses the near plane
CROSSING = 0.8


def _eye(angle: float, distance: float = 5.0):
    return (distance * math.sin(angle), 3.0, distance * math.cos(angle))


def lens_triangles(t: int, seed: int, z_lo: float = -3.0, z_hi: float = 0.3):
    """[T,3,4] clip coordinates of random view-space triangles through the
    headline lens (perspective_rh: 50 degrees, 16:9, near 0.1, far 100), so
    z = a * w + b; view depth in [z_lo, z_hi] (the near plane is at -0.1,
    the eye at 0)."""
    rng = np.random.default_rng(seed)
    centre = np.stack([rng.uniform(-2, 2, t), rng.uniform(-2, 2, t),
                       rng.uniform(z_lo, z_hi, t)], -1)[:, None]
    view = centre + rng.uniform(-0.6, 0.6, (t, 3, 3))
    view[..., 2] = np.clip(view[..., 2], z_lo, z_hi)
    homo = torch.from_numpy(np.concatenate([view, np.ones((t, 3, 1))], -1).astype(np.float32))
    return homo @ perspective_rh(math.radians(50.0), 16 / 9, 0.1, 100.0).T


def _polygons(clipped, src, bary, t):
    """Source triangle -> its distinct output vertices [n,7]: source
    barycentrics, then clip coordinates (a vertex two fan triangles share
    is one)."""
    rows = np.concatenate([bary, clipped], -1).astype(np.float64)  # [N,3,7]
    return {s: np.unique(rows[src == s].reshape(-1, 7), axis=0) for s in range(t)}


def _area2(c):
    """Signed doubled area of [N,3,4] clip-space triangles in NDC x, y."""
    xy = c[..., :2] / c[..., 3:4]
    d1, d2 = xy[:, 1] - xy[:, 0], xy[:, 2] - xy[:, 0]
    return d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_plane_form_matches_the_reference_clip(seed):
    """Tolerance: float32 rounding. From the same float32 inputs the plane
    form computes d = z_a - z_b, t = z_a / d and each coordinate a + t (b -
    a) in float32, five roundings of half an ulp each, where the reference
    computes in float64: 8 ulps of the source triangle's largest coordinate
    bound the difference of a clip coordinate, and 8 ulps of 1 that of a
    barycentric (each in [0, 1])."""
    tri = lens_triangles(400, seed)
    n_behind = (tri[..., 2] < 0).sum(-1)
    assert int((n_behind == 1).sum()) > 20 and int((n_behind == 2).sum()) > 20
    assert int((n_behind == 0).sum()) > 20 and int((n_behind == 3).sum()) > 20
    clipped, valid, src, bary = pclip.clip_triangles_near(tri, near="plane")
    keep = valid.numpy()
    got = _polygons(clipped.numpy()[keep], src.numpy()[keep], bary.numpy()[keep], len(tri))
    r_clip, r_src, r_bary, _ = clip_near(tri)
    want = _polygons(r_clip.numpy(), r_src.numpy(), r_bary.numpy(), len(tri))
    scale = tri.abs().amax(dim=(1, 2)).numpy()
    for s in range(len(tri)):
        g, w = got[s], want[s]
        assert len(g) == len(w), (s, int(n_behind[s]))
        if not len(g):
            continue
        # each vertex of the program's polygon against the nearest of the
        # reference's, by barycentrics: a one-to-one pairing
        pair = np.abs(g[:, None, :3] - w[None, :, :3]).max(-1).argmin(-1)
        assert sorted(pair) == list(range(len(w))), s
        np.testing.assert_allclose(g[:, :3], w[pair, :3], rtol=0, atol=8 * ULP1)
        np.testing.assert_allclose(g[:, 3:], w[pair, 3:], rtol=0, atol=8 * ULP1 * scale[s])
        assert (g[:, 5] >= -8 * ULP1 * scale[s]).all()  # no vertex behind the plane
    # every slot is wound as the reference's fan triangles of its source
    ref_sign = torch.zeros(len(tri), dtype=torch.float64)
    ref_sign[r_src] = torch.sign(_area2(r_clip.double()))
    slot_sign = torch.sign(_area2(clipped[valid].double()))
    assert bool((slot_sign == ref_sign[src[valid]]).all())
    # a triangle wholly behind gives no slot; the others keep their primary
    assert not bool(valid[:len(tri)][n_behind == 3].any())
    assert bool(valid[:len(tri)][n_behind < 3].all())
    assert int(pclip.near_clipped(tri)) == int(((n_behind == 1) | (n_behind == 2)).sum())


@pytest.mark.parametrize("seed", [4, 5])
def test_the_forms_are_bit_equal_where_nothing_is_behind(seed):
    """No vertex with z < 0 (every w >= near > 1e-5 in this lens): every
    valid slot, its planes, the masks and the source ids bit-equal between
    the forms, before and after the compaction. Invalid secondaries hold
    each form's unused intersection, which no stage reads."""
    tri = lens_triangles(600, seed, z_lo=-4.0, z_hi=-0.1)
    assert bool((tri[..., 2] >= 0).all()) and int(pclip.near_clipped(tri)) == 0
    a = pclip.clip_triangles_near_planes(tri, near="plane")
    b = pclip.clip_triangles_near_planes(tri, near="w")
    for x, y in ((a, b), (pclip.compact_secondary(*a, 128)[:4],
                          pclip.compact_secondary(*b, 128)[:4])):
        assert torch.equal(x[1], y[1]) and torch.equal(x[2], y[2])
        v = x[1]
        assert torch.equal(x[0][v].view(torch.int32), y[0][v].view(torch.int32))
        for i in range(3):
            for j in range(3):
                assert torch.equal(x[3][i][j][v].view(torch.int32),
                                   y[3][i][j][v].view(torch.int32))


def test_the_w_form_is_bit_equal_to_jax():
    """near="w" keeps the JAX package's clip bit for bit on triangles that
    cross w = 0: the valid flags, the source ids, and every valid slot's
    clip coordinates and source barycentrics. (XLA rounds the unused
    intersection of a few invalid slots otherwise, which no stage reads;
    the compaction's parity test holds the compacted slots.)"""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops import clip as jclip

    from _torch_port import random_clip_scene

    clip, tris = random_clip_scene(600, seed=12, w_lo=-1.0)
    tri = clip[tris]
    assert int(((tri[..., 3] < pclip.NEAR_EPS).sum(-1) == 1).sum()) > 20
    got = [x.numpy() for x in pclip.clip_triangles_near(torch.from_numpy(tri), near="w")]
    want = [np.asarray(x) for x in jclip.clip_triangles_near(jnp.asarray(tri))]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2].astype(got[2].dtype))
    v = got[1]
    for k in (0, 3):
        np.testing.assert_array_equal(got[k][v].view(np.int32), want[k][v].view(np.int32))


def test_the_forms_name_themselves():
    with pytest.raises(ValueError, match="near"):
        P.GeometryForms(near="eps")
    with pytest.raises(ValueError, match="near"):
        pclip.clip_triangles_near_planes(torch.zeros(1, 3, 4), near="eps")
    assert P.GeometryForms().near == "plane"


# --- whole frames ----------------------------------------------------------------

def _cell(width: int, height: int, tri_budget: int | None = None):
    cell = spec.load("pbr_ibl_1080p.orbit", ROOT)
    cfg = copy.deepcopy(cell.config)
    cfg.update(width=width, height=height)
    if tri_budget is not None:
        cfg["scene"]["tri_budget"] = tri_budget
    return cfg, spec.recipe(cfg["recipe"])


def _state(raw, eye):
    return dict(eye=eye, target=(0.0, 0.0, 0.0), sun_direction=raw["sun_direction"],
                sun_moves=False)


@pytest.fixture(scope="module")
def headline_frames():
    """The pbr_ibl_1080p frame at the headline camera, at an angle where
    the floor crosses the near plane, 320x180 on the CPU: the program's
    image under each near form, and the reference's."""
    cfg, recipe = _cell(320, 180)
    raw = recipe.inputs(cfg, 2 ** 33 + 5)
    state = _state(raw, _eye(CROSSING))
    ref = recipe.Reference(cfg, raw, torch.device("cpu"))
    clip = ref.scene._clip(ref.scene._vp(state))
    n = (clip[..., 2] < 0).sum(-1)
    assert int(((n == 1) | (n == 2)).sum()) > 0  # a floor triangle crosses
    want = ref.frame(state)
    prog = recipe.Program(cfg, raw, state, [torch.device("cpu")])
    got = {}
    for near in ("plane", "w"):
        prog.renderer.geometry_forms = P.GeometryForms(near=near)
        got[near] = prog.frame(state)
    prog.close()
    return got, want


def test_the_headline_camera_frame_matches_the_reference(headline_frames):
    got, want = headline_frames
    r = compare.numbers(got["plane"], want)
    assert r["px_off"] <= 1e-3 and r["mean_abs"] <= 1e-2, r


def test_the_w_form_fails_the_same_check(headline_frames):
    """The check is tight enough to see the fault the plane form cures:
    the w form's clipped vertices, at w = 1e-5, lose the floor's
    barycentrics."""
    got, want = headline_frames
    r = compare.numbers(got["w"], want)
    assert r["px_off"] > 1e-3 and r["mean_abs"] > 1e-2, r


def test_the_forms_render_the_9_out_orbit_bit_equal():
    """At the benchmark's 9-out orbit no vertex has z < 0: both forms give
    the same image, bit for bit."""
    cfg, recipe = _cell(96, 54, tri_budget=2000)
    raw = recipe.inputs(cfg, 3)
    imgs = []
    for k, angle in enumerate((0.8, 2.4)):
        state = _state(raw, _eye(angle, 9.0))
        prog = recipe.Program(cfg, raw, state, [torch.device("cpu")])
        for near in ("plane", "w"):
            prog.renderer.geometry_forms = P.GeometryForms(near=near)
            imgs.append(prog.frame(state))
        prog.close()
        assert np.array_equal(imgs[2 * k], imgs[2 * k + 1])


# --- the frame record's counters --------------------------------------------------

@pytest.fixture(scope="module")
def small_program():
    cfg, recipe = _cell(64, 48, tri_budget=2000)
    raw = recipe.inputs(cfg, 7)
    prog = recipe.Program(cfg, raw, _state(raw, _eye(CROSSING)), [torch.device("cpu")])
    yield prog, raw
    prog.close()


def _traced_frame(prog, state):
    profiling.enable_tracing(True)
    try:
        prog.frame(state)
    finally:
        profiling.enable_tracing(False)
    return profiling.records()[-1]


def test_a_traced_frame_records_the_clip_counters(small_program):
    prog, raw = small_program
    rec = _traced_frame(prog, _state(raw, _eye(CROSSING)))
    assert rec.frame is not None and rec.traced
    assert rec.counts["near_clipped"] > 0 and rec.counts["clip_overflow"] == 0
    assert rec.to_json()["counts"] == rec.counts
    rec = _traced_frame(prog, _state(raw, _eye(CROSSING, 9.0)))
    assert rec.counts == {"clip_overflow": 0, "near_clipped": 0}


def test_an_untraced_frame_counts_nothing(small_program, monkeypatch):
    """No count is computed and no copy is made for an untraced record."""
    prog, raw = small_program
    calls = []
    monkeypatch.setattr(P, "near_clipped", lambda *a: calls.append(a))
    prog.frame(_state(raw, _eye(CROSSING)))
    monkeypatch.undo()
    rec = profiling.records()[-1]
    assert rec.frame is not None and not rec.traced
    assert rec.counts == {} and not calls and not profiling._unread


def test_count_device_keeps_the_later_value_and_skips_none():
    profiling.enable_tracing(True)
    try:
        with profiling.frame() as rec:
            profiling.count_device(("a", "b"), torch.tensor([1, 2]))
            profiling.count_device(("a",), torch.tensor([5]))
            profiling.count_device(("c",), None)
    finally:
        profiling.enable_tracing(False)
    assert rec.counts == {"a": 5, "b": 2}
    with profiling.frame() as rec:
        profiling.count_device(("a",), torch.tensor([1]))
    assert rec.counts == {}


@pytest.mark.cuda
def test_traced_frames_on_the_card_record_the_counters_without_a_sync():
    """Renderer.render_frame of the headline frame at the headline camera
    (1920x1080) on the card: a traced frame records near_clipped > 0 and
    clip_overflow == 0, read after its fence with no host sync added (the
    frame's three, as test_torch_front_end_kernel.py's loop counts them);
    an untraced frame records none and makes no pinned copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the front-end kernels have no CPU build)")
    cfg, recipe = _cell(1920, 1080)
    raw = recipe.inputs(cfg, 11)
    state = _state(raw, _eye(CROSSING))
    prog = recipe.Program(cfg, raw, state, [torch.device("cuda")])
    prog.frame(state)
    pinned, empty = [], torch.empty

    def spy(*a, **kw):
        pinned.append(kw.get("pin_memory", False))
        return empty(*a, **kw)

    torch.empty = spy
    try:
        prog.frame(state)
    finally:
        torch.empty = empty
    plain = profiling.records()[-1]
    assert not any(pinned)  # the untraced frame made no copy for the counters
    rec = _traced_frame(prog, state)
    prog.close()
    assert plain.counts == {} and rec.launches.get("front_end") == 3
    assert rec.counts["near_clipped"] > 0 and rec.counts["clip_overflow"] == 0
    # the traced frame's three syncs (the inverse's check, the fence wait,
    # the readback), none in the front end
    assert rec.syncs == 3 and not profiling._unread
    assert all(span != "frame/geometry" for span, _ in rec.sync_sites), rec.sync_sites
