"""Skybox pass (≙ renderer_rs_tpu/ops/skybox.py,
shaders/hlsl/{vertex,pixel}/skybox.hlsl): the per-pixel NDC grid is
unprojected with inv(VP) into world rays, and the cubemap is composited
where the depth buffer is still at the far plane. Full frames only; band
rows wait for ROADMAP Queue 1 item 15."""

from __future__ import annotations

import torch

from renderer_rs_tpu_torch.ops.sampling import sample_cubemap


def pixel_ray_directions(inv_view_proj: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """World-space ray direction per pixel [H,W,3] (skybox.py:17): the
    unprojected far-plane point (z=1, w=1) minus the unprojected near
    point, so no camera position is needed."""
    dev = inv_view_proj.device
    y = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    ndc_x = (x * 2.0 - 1.0)[None, :].expand(height, width)
    ndc_y = (y * 2.0 - 1.0)[:, None].expand(height, width)

    def unproject(z):
        clip = torch.stack(
            [ndc_x, ndc_y, torch.full_like(ndc_x, z), torch.ones_like(ndc_x)], dim=-1
        )
        world = clip @ inv_view_proj.T
        w = world[..., 3:4]
        return world[..., :3] / torch.where(w == 0.0, torch.ones_like(w), w)

    d = unproject(1.0) - unproject(0.0)
    return d / torch.clamp(torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)), min=1e-12)


def skybox_pass(color: torch.Tensor, depth: torch.Tensor, inv_view_proj: torch.Tensor,
                cubemap_faces: torch.Tensor, intensity: float = 1.0) -> torch.Tensor:
    """Composite the skybox into pixels still at the far plane (depth >= 1,
    ≙ the skybox's z=1 + LESS_OR_EQUAL depth test trick)."""
    h, w = depth.shape
    dirs = pixel_ray_directions(inv_view_proj, h, w)
    sky = sample_cubemap(cubemap_faces, dirs)[..., :3] * intensity
    sky_rgba = torch.cat([sky, torch.ones_like(sky[..., :1])], dim=-1)
    return torch.where((depth >= 1.0)[..., None], sky_rgba, color)
