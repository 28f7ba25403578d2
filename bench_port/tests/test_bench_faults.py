"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (run_cell on the CPU at a small
extent) and every other step of a run is driven, once for each fault a
cell can have: a frame that returns its state unchanged, half of the frame
left out, an answer altered where it is produced. (No cell spans cards, so
no exchange between cards can be left out.)"""

import numpy as np
import pytest

from bench_port.tests.conftest import cpu_run, small_cell


def _stale_frame(monkeypatch):
    """A frame that returns its state unchanged: the image of the frame
    before (the camera's update is lost)."""
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    real = Renderer.render_frame
    last = {}

    def render_frame(self, present=True):
        img = real(self, present)
        prev = last.get(id(self), img)
        last[id(self)] = img
        return prev

    monkeypatch.setattr(Renderer, "render_frame", render_frame)


def _half_left_out(monkeypatch):
    """Half of the frame's rows are left out: the lower half is never
    rendered and keeps zeros."""
    from renderer_rs_tpu_torch.renderer import renderer

    real = renderer.forward_frame

    def forward_frame(*a, **kw):
        out = real(*a, **kw)
        img = out[0] if isinstance(out, tuple) else out
        img[img.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(renderer, "forward_frame", forward_frame)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: a 32x32 tile (a quarter of
    the frame's height at the tests' extent) of the encoded frame is moved
    by 64 levels."""
    from renderer_rs_tpu_torch.renderer import renderer
    from renderer_rs_tpu_torch.utils import image_io

    real = image_io.framebuffer_to_u8

    def framebuffer_to_u8(fb, srgb_encode=True):
        img = real(fb, srgb_encode)
        t = min(32, img.shape[0] // 4)
        img[:t, :t, :3] = (img[:t, :t, :3].astype(np.int16) + 64).clip(0, 255).astype(np.uint8)
        return img

    monkeypatch.setattr(image_io, "framebuffer_to_u8", framebuffer_to_u8)
    monkeypatch.setattr(renderer, "framebuffer_to_u8", framebuffer_to_u8)


CELLS = ["pbr_ibl_1080p.orbit_r9", "pbr_ibl_1080p.sun_sweep_r9"]
CASES = [(c, f) for c in CELLS for f in (_stale_frame, _half_left_out, _answer_altered)]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = cpu_run(small_cell(name), seconds=0.6)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in result["check"].items() if k != "frames")


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_timed_path_is_correct(name):
    result = cpu_run(small_cell(name), seconds=0.6)
    assert result["correct"] is True
