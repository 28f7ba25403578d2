"""Each traffic mix is a data file that the one generator reads, and is
deterministic in the seed; the recipe's inputs are deterministic in the
seed with the same work for every seed."""

import json

import pytest

from bench_port import spec, traffic
from bench_port.run import ROOT

TRAFFIC = ROOT / "bench_port" / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3]
SUN = (-0.45, -1.0, -0.35)


@pytest.mark.parametrize("mix", MIXES)
def test_mix_is_deterministic_in_the_seed(mix):
    m = traffic.load(TRAFFIC / f"{mix}.json")
    for seed in SEEDS:
        a = [traffic.Traffic(m, seed, SUN).state(k) for k in range(-3, 40)]
        b = [traffic.Traffic(m, seed, SUN).state(k) for k in range(-3, 40)]
        assert a == b
    first = {traffic.Traffic(m, s, SUN).state(0)["eye"] for s in SEEDS}
    assert len(first) == len(SEEDS)


def test_sun_sweep_moves_the_sun_and_orbit_does_not():
    sweep = traffic.Traffic(traffic.load(TRAFFIC / "sun_sweep_r9.json"), 5, SUN)
    orbit = traffic.Traffic(traffic.load(TRAFFIC / "orbit_r9.json"), 5, SUN)
    assert sweep.state(1)["sun_direction"] != sweep.state(2)["sun_direction"]
    assert orbit.state(1)["sun_direction"] == orbit.state(2)["sun_direction"] == SUN
    assert orbit.state(1)["eye"] != orbit.state(2)["eye"]


def test_camera_paths_of_data_alone():
    keys = [[[0.0, 2.0, 8.0], [0.0, 0.0, 0.0]], [[8.0, 2.0, 0.0], [0.0, 1.0, 0.0]]]
    fly = traffic.Traffic({"camera": {"path": "keyframes", "keys": keys, "frames_per_key": 10},
                           "sun": {"path": "fixed"}}, 3, SUN)
    states = [fly.state(k) for k in range(20)]
    assert len({s["eye"] for s in states[:10]}) == 10  # one key to the next, then back
    for s in states:
        assert all(min(a, b) - 1e-9 <= x <= max(a, b) + 1e-9
                   for x, a, b in zip(s["eye"], keys[0][0], keys[1][0]))
    cuts = traffic.Traffic({"camera": {"path": "keyframes", "keys": keys, "frames_per_key": 1},
                            "sun": {"path": "fixed"}}, 3, SUN)
    assert {tuple(cuts.state(k)["eye"]) for k in range(6)} == {tuple(k[0]) for k in keys}


@pytest.mark.parametrize("seed", SEEDS)
def test_inputs_are_deterministic_in_the_seed_with_the_same_work(seed):
    cfg = json.loads((ROOT / "bench_port" / "configs" / "pbr_ibl_1080p.json").read_text())
    recipe = spec.recipe(cfg["recipe"])
    a, b = recipe.inputs(cfg, seed), recipe.inputs(cfg, seed)
    assert all((x == y).all() for x, y in zip(a["textures"], b["textures"]))
    assert recipe.triangle_count(a) == 97_346
    other = recipe.inputs(cfg, seed + 1)
    assert not (other["textures"][0] == a["textures"][0]).all()
    assert [t.shape for t in other["textures"]] == [t.shape for t in a["textures"]]


@pytest.mark.parametrize("bad", [
    {"camera": {"path": "orbit", "rad_per_frame": 0.1, "distance": 9.0, "height": 3.0},
     "sun": {"path": "fixed"}, "speed": 2},
    {"camera": {"path": "spiral"}, "sun": {"path": "fixed"}},
    {"camera": {"path": "orbit", "rad_per_frame": 0.1}, "sun": {"path": "fixed"}},
])
def test_a_mix_the_generator_cannot_read_is_refused(tmp_path, bad):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(bad))
    with pytest.raises(ValueError):
        traffic.load(p)
