"""The port stands alone: importing it (and chip_smoke.py) pulls in neither
JAX nor the JAX package, its sources import neither, it turns TF32 off,
and its entry points default to CUDA and raise without it."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "renderer_rs_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_import_leaves_jax_out_of_sys_modules():
    """In a fresh interpreter (tests/conftest.py already imported jax here)."""
    code = (
        "import sys, importlib\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'renderer_rs_tpu' or m.startswith('renderer_rs_tpu.'))\n"
        "import torch\n"
        "print(bad, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout.strip()
    assert out == "[] False False", out


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import\s+(jax|renderer_rs_tpu)\b(?!_torch)|from\s+(jax|renderer_rs_tpu)\b(?!_torch))",
        re.M,
    )
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        assert not pattern.search(path.read_text()), f"{path} imports JAX or the JAX package"


def test_sources_read_no_renderer_variable():
    """The JAX package's RENDERER_* knobs are not carried over: the port
    implements their defaults and reads no such environment variable."""
    names = {p.name for p in PKG.rglob("*.py")}
    assert {"shadow.py", "pbr.py", "sampling.py", "skybox.py", "tonemap.py", "ibl.py"} <= names
    for path in list(PKG.rglob("*.py")) + list(PKG.rglob("*.cu")):
        found = re.search(r"os\.environ|getenv|RENDERER_[A-Z]", path.read_text())
        assert not found, f"{path} reads or names an environment knob: {found.group(0)}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene, full_scene, gltf_pbr_scene
    from renderer_rs_tpu_torch.renderer.renderer import Renderer
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.utils.meshgen import plane_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SceneBuilder().add_mesh(plane_mesh()).build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        blinnphong_scene(32, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        full_scene(32, 32, tri_budget=600, ibl=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gltf_pbr_scene(32, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--scene", "full", "--no-ibl", "--frames", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--frames", "1"])
    # the explicit CPU request works
    scene, layout = SceneBuilder().add_mesh(plane_mesh()).build(device="cpu")
    assert scene.device.type == "cpu" and layout.num_triangles == 2


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""  # no result lines
