"""Skybox pass (≙ renderer_rs_tpu/ops/skybox.py,
shaders/hlsl/{vertex,pixel}/skybox.hlsl): the per-pixel NDC grid is
unprojected with inv(VP) into world rays, and the cubemap is composited
where the depth buffer is still at the far plane. A band of rows
(y_offset, y_stride, y_pair) anchors its rays at the framebuffer rows it
renders."""

from __future__ import annotations

import torch

from renderer_rs_tpu_torch.ops.sampling import sample_cubemap


def pixel_ray_directions(inv_view_proj: torch.Tensor, height: int, width: int,
                         y_offset: int = 0, full_height: int | None = None,
                         y_stride: int = 1, y_pair: bool = False) -> torch.Tensor:
    """World-space ray direction per pixel [H,W,3] (skybox.py:17): the
    unprojected far-plane point (z=1, w=1) minus the unprojected near
    point, so no camera position is needed. `height` rows of a
    `full_height` framebuffer: row j is framebuffer row y_offset + j*y_stride
    (pair form: y_offset + (j//2)*2*y_stride + j%2)."""
    dev = inv_view_proj.device
    fh = full_height if full_height is not None else height
    j = torch.arange(height, device=dev)
    if y_pair:
        rows = ((j // 2) * (2 * y_stride) + (j % 2)).to(torch.float32)
    else:
        rows = j.to(torch.float32) * y_stride
    y = (rows + 0.5 + y_offset) / fh
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
                cubemap_faces: torch.Tensor, intensity: float = 1.0, y_offset: int = 0,
                full_height: int | None = None, y_stride: int = 1,
                y_pair: bool = False) -> torch.Tensor:
    """Composite the skybox into pixels still at the far plane (depth >= 1,
    ≙ the skybox's z=1 + LESS_OR_EQUAL depth test trick)."""
    h, w = depth.shape
    dirs = pixel_ray_directions(inv_view_proj, h, w, y_offset, full_height, y_stride, y_pair)
    sky = sample_cubemap(cubemap_faces, dirs)[..., :3] * intensity
    sky_rgba = torch.cat([sky, torch.ones_like(sky[..., :1])], dim=-1)
    return torch.where((depth >= 1.0)[..., None], sky_rgba, color)
