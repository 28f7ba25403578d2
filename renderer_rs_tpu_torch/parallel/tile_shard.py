"""Frame rendering over a (frame, rows) mesh: frame batch x framebuffer row
bands (≙ renderer_rs_tpu/parallel/tile_shard.py).

Each frame of the batch goes to one frame group of the mesh; within a
frame, row shard k renders only its band of rows through
forward_frame(band=...), which bins in band space and runs K3, then shades
its rows at the full per-pixel rate. Contiguous shards take rows
[k*band_h, (k+1)*band_h); interleaved shards take the row PAIRS (2k, 2k+1),
(2k+2n, 2k+2n+1), ... (load-balanced, and each 2x2 quad's rows stay on one
shard so the texture LOD matches the whole frame). Every shard renders its
own sun shadow map, as the JAX function does. Under an MSAA pipeline the
shards split the SUPERSAMPLED frame and return its rows unresolved
(forward_frame's MSAA band); unshard_rows, then resolve_msaa, give the
resolved frame. The shards run one after another on their devices (eager
PyTorch has no SPMD program); the output is stitched on the first device
of each frame group."""

from __future__ import annotations

import dataclasses

import torch

from renderer_rs_tpu_torch.ops.shadow import ShadowParams
from renderer_rs_tpu_torch.renderer.passes import (
    MSAA_GRIDS,
    GeometryForms,
    ShadeRates,
    ShadingModel,
    forward_frame,
)
from renderer_rs_tpu_torch.renderer.scene_build import GpuScene, SceneLayout
from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipeline


def stack_scenes(scenes: list[GpuScene]) -> list[GpuScene]:
    """The per-frame scenes of a batch (≙ tile_shard.py:27, which stacks
    pytrees along a leading 'frame' axis for shard_map; eager rendering
    keeps them as a list, one scene per frame group)."""
    return list(scenes)


def _to_device(scene: GpuScene, device: torch.device) -> GpuScene:
    """The scene's tensors on `device` (the same objects when already there)."""
    if scene.device == device:
        return scene
    out = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        out[f.name] = None if v is None else v.to(device)
    return GpuScene(**out)


def band_spec(k: int, n_rows: int, band_h: int, interleaved: bool) -> tuple:
    """forward_frame's band argument for row shard k of n_rows: rows
    [k*band_h, (k+1)*band_h), or the row pairs (2k, 2k+1), (2k+2n, 2k+2n+1),
    ... when interleaved."""
    return (2 * k, band_h, n_rows, True) if interleaved else (k * band_h, band_h)


def band_rows(band: tuple, device=None) -> torch.Tensor:
    """The framebuffer rows of a band (forward_frame's band argument), one
    per band row j: y_offset + j*y_stride, or y_offset + (j//2)*2*y_stride
    + j%2 in the pair form. Indexing a frame with them stitches the band."""
    y_offset, band_h = int(band[0]), int(band[1])
    stride = int(band[2]) if len(band) > 2 else 1
    pair = len(band) > 3 and bool(band[3])
    j = torch.arange(band_h, device=device)
    return y_offset + ((j // 2) * 2 * stride + j % 2 if pair else j * stride)


def render_frame_sharded(
    stacked_scene: list[GpuScene],
    layout: SceneLayout,
    pipeline: GraphicsPipeline,
    shading: ShadingModel,
    width: int,
    height: int,
    mesh,
    clear_color: tuple = (0.1, 0.1, 0.15, 1.0),
    tonemap: str = "none",
    shadow_map_size: int = 256,
    shadow_params: ShadowParams = ShadowParams(),
    interleaved: bool = False,
    shade_rates: ShadeRates = ShadeRates(),
    geometry_forms: GeometryForms = GeometryForms(),
) -> torch.Tensor:
    """Render a batch of frames over the mesh (tile_shard.py:32). Returns
    [F, H, W, 4] in shard order: contiguous bands are already the frame;
    interleaved bands need unshard_rows(). F must equal the mesh's frame
    axis. Band shards shade at the exact per-pixel rate, so on frames of
    128 rows or more the stitch differs from the single-device frame by
    the reduced rates' drift (y-quarter PCF, y-half cube fetch); ids and
    depth are equal. With an MSAA pipeline (tile_shard.py:74-100) the
    shards split the supersampled frame's H*sy rows and the result is
    [F, H*sy, W*sx, 4], unresolved: unshard_rows, then resolve_msaa.
    shade_rates goes to every band: a band's rows are not neighbours, so
    only the rates that engage on any frame take effect there (pcf="half";
    the merged gather, whose output is per pixel). geometry_forms (the
    vertex-stage forms, the clip compaction, the big-class cap) goes to
    every band and its shadow pass."""
    n_frames, n_rows = mesh.shape["frame"], mesh.shape["rows"]
    if len(stacked_scene) != n_frames:
        raise ValueError(f"scene batch {len(stacked_scene)} != mesh frame axis {n_frames}")
    _, s_y = MSAA_GRIDS.get(pipeline.msaa_samples, (1, 1))
    shard_h = height * s_y
    if shard_h % n_rows != 0:
        raise ValueError(f"height {shard_h} not divisible by rows axis {n_rows}")
    band_h = shard_h // n_rows
    if interleaved and band_h % 2 != 0:
        raise ValueError(
            f"interleaved sharding is pair-granular: band height {band_h} must be even "
            f"(height {shard_h} over {n_rows} rows)")
    frames = []
    for f, scene in enumerate(stacked_scene):
        bands = []
        for k, device in enumerate(mesh.devices[f]):
            spec = band_spec(k, n_rows, band_h, interleaved)
            band = forward_frame(
                _to_device(scene, device), layout, pipeline, shading, width, height,
                clear_color=clear_color, tonemap=tonemap, shadow_map_size=shadow_map_size,
                shadow_params=shadow_params, band=spec, shade_rates=shade_rates,
                geometry_forms=geometry_forms,
            )
            bands.append(band.to(mesh.devices[f][0]))
        frames.append(torch.cat(bands, dim=0))
    return torch.stack([fr.to(mesh.devices[0][0]) for fr in frames])


def resolve_msaa(frames: torch.Tensor, msaa_samples: int) -> torch.Tensor:
    """Box-resolve un-sharded supersampled frames [F, H*sy, W*sx, 4] from a
    render_frame_sharded run with an MSAA pipeline (tile_shard.py:145; ≙
    vkCmdResolveImage after the sharded draws): the mean over each sample
    footprint, as forward_frame's supersampling branch resolves. Apply
    after unshard_rows."""
    if msaa_samples <= 1:
        return frames
    sx, sy = MSAA_GRIDS[msaa_samples]
    f, hs, ws, c = frames.shape
    return frames.reshape(f, hs // sy, sy, ws // sx, sx, c).mean(dim=(2, 4))


def unshard_rows(frames: torch.Tensor, n_rows: int, interleaved: bool) -> torch.Tensor:
    """Reassemble [F, H, W, C] from the sharded output's row order
    (tile_shard.py:200): contiguous bands are in place; interleaved bands
    hold device k's row pairs (2k, 2k+1), (2k+2n, 2k+2n+1), ... and are
    de-interleaved by a pair-axis transpose."""
    if not interleaved:
        return frames
    f, h, w, c = frames.shape
    band_h = h // n_rows
    return (frames.reshape(f, n_rows, band_h // 2, 2, w, c)
            .transpose(1, 2).reshape(f, h, w, c))
