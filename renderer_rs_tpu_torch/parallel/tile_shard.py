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
resolved frame.

The JAX function is one shard_map program in which every shard renders at
once on its device. Eager PyTorch has no SPMD program: each shard here has
a host thread of its own and a CUDA stream of its own on its device (the
mesh keeps the streams). On the card the threads take turns to enqueue
whole bands, one band after another: side by side they hand the GIL to one
another at every launch. So on the card a sharded frame takes as long as
its bands one after another (a little longer: the threads buy nothing
there), and the shards' kernels overlapped in no case measured, on one
card or across four (PERF.md §5). On the CPU the threads compute their
bands at once. The bands are stitched on the mesh's first device, in
shard order."""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading

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
from renderer_rs_tpu_torch.rhi.sync import Semaphore


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


def shard_scene_batch(stacked_scene: list[GpuScene], mesh) -> list[dict]:
    """Place a scene batch on the mesh before rendering (tile_shard.py:138,
    device_put with the spec P('frame')): the leading axis is sharded over
    'frame' and replicated over 'rows', so frame f's scene goes once to
    every distinct device of frame group f. Returns, per frame, a dict
    {device: scene on that device}; render_frame_sharded takes it and
    copies no scene tensor. A tensor already on its device is not copied."""
    if len(stacked_scene) != mesh.shape["frame"]:
        raise ValueError(f"scene batch {len(stacked_scene)} != mesh frame axis "
                         f"{mesh.shape['frame']}")
    return [_placed(scene, devices) for scene, devices in zip(stacked_scene, mesh.devices)]


def _placed(scene, devices) -> dict:
    """{device: scene} for every distinct device of one frame group: a
    shard_scene_batch entry as it is (it must cover the devices), a
    GpuScene copied once per device that does not hold it yet."""
    if isinstance(scene, dict):
        missing = [str(d) for d in devices if d not in scene]
        if missing:
            raise ValueError(f"the placed scene is not on {missing}: "
                             "shard_scene_batch it over this mesh")
        return scene
    return {d: _to_device(scene, d) for d in dict.fromkeys(devices)}


# The GIL: a band is ~10^4 small launches, each of which drops and retakes
# the GIL, so shards that enqueue side by side hand the GIL to one another
# at every launch, which made a 1080p frame on four shards 4-5x slower than
# one thread on an NVIDIA H100 80GB HBM3 at 700 W and its 8-core host
# (renderer_rs_tpu_torch.probes.shard_forms, PERF.md §5). Each shard
# enqueues its whole band under this lock instead, one after another.
_ENQUEUE = threading.Lock()


def _render_band(scene, device, stream, done: Semaphore, args: tuple, kwargs: dict):
    """One shard's band, in the shard's own thread. On CUDA it enqueues on
    the shard's stream under its device, holding _ENQUEUE, and signals
    `done` after its last op; on the CPU it computes the band (its torch
    thread count is the caller's: PyTorch hands it to new threads)."""
    if stream is None:
        return forward_frame(scene, *args, **kwargs)
    # The current device: every op of the band path makes its tensors on
    # the scene's device and each launch wrapper takes that device's
    # current stream, which this thread sets here to the shard's stream
    # (nothing on the path uses the default stream or a bare
    # torch.cuda.synchronize).
    with _ENQUEUE, torch.cuda.device(device), torch.cuda.stream(stream):
        band = forward_frame(scene, *args, **kwargs)
        done.signal(stream)
    return band


def render_frame_sharded(
    stacked_scene: list,
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
    [F, H, W, 4] on the mesh's first device, in shard order: contiguous
    bands are already the frame; interleaved bands need unshard_rows(). F
    must equal the mesh's frame axis. stacked_scene is one GpuScene per
    frame (each copied once to every device of its frame group that does
    not hold it) or shard_scene_batch's placement (nothing copied).

    Every (frame, row) shard has a host thread and a CUDA stream of its
    own on its device (mesh.streams; none on the CPU); on the card the
    threads enqueue whole bands one after another. A shard's stream first waits
    for the caller's current stream on that device, so what the caller
    enqueued there (the scene's upload) is complete; the caller's current
    stream on each band's device waits for the band's semaphore before
    the stitch. An exception in any shard is raised here, the first in
    shard order, once every shard has ended (the others as notes on it).

    Band shards shade at the exact per-pixel rate, so on frames of 128
    rows or more the stitch differs from the single-device frame by the
    reduced rates' drift (y-quarter PCF, y-half cube fetch); ids and depth
    are equal. With an MSAA pipeline (tile_shard.py:74-100) the shards
    split the supersampled frame's H*sy rows and the result is
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
    args = (layout, pipeline, shading, width, height)
    common = dict(clear_color=clear_color, tonemap=tonemap, shadow_map_size=shadow_map_size,
                  shadow_params=shadow_params, shade_rates=shade_rates,
                  geometry_forms=geometry_forms)
    shards = []  # (device, stream, semaphore, scene, band spec), in shard order
    for f, devices in enumerate(mesh.devices):
        placed = _placed(stacked_scene[f], devices)
        for k, device in enumerate(devices):
            stream = mesh.streams[f][k]
            if stream is not None:
                # Stream order in: the shard's stream waits for the caller's
                # current stream on its device (taken in this thread: a new
                # thread's current stream is the default one)
                stream.wait_stream(torch.cuda.current_stream(device))
            shards.append((device, stream, Semaphore(f"band {f},{k}"), placed[device],
                           band_spec(k, n_rows, band_h, interleaved)))
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(shards),
                                               thread_name_prefix="shard") as pool:
        futures = [pool.submit(_render_band, scene, device, stream, done, args,
                               {**common, "band": spec})
                   for device, stream, done, scene, spec in shards]
        concurrent.futures.wait(futures)
    # Stream order out: the caller's current stream on each shard's device
    # waits for the shard's semaphore (for a shard that raised, for all its
    # stream holds), so that the copy to the output device (ordered against
    # the caller's current streams of both devices), the cat, and any reuse
    # of the scene copies made above come after the shard's last op
    for (device, stream, done, _, _), fut in zip(shards, futures):
        if stream is not None:
            caller = torch.cuda.current_stream(device)
            if fut.exception() is None:
                done.wait(caller)
            else:
                caller.wait_stream(stream)
    errors = [(i, fut.exception()) for i, fut in enumerate(futures)]
    errors = [(i, e) for i, e in errors if e is not None]
    if errors:
        first = errors[0][1]
        for i, e in errors[1:]:
            first.add_note(f"shard {i} failed too: {e!r}")
        raise first
    out_device = mesh.devices[0][0]
    bands = []
    for (device, stream, _, _, _), fut in zip(shards, futures):
        band = fut.result()
        if stream is not None:
            # the band was allocated on the shard's stream and is read on
            # the caller's: record_stream keeps the caching allocator from
            # handing its memory back to the shard's stream before then
            band.record_stream(torch.cuda.current_stream(device))
        bands.append(band.to(out_device))
    return torch.stack([torch.cat(bands[f * n_rows:(f + 1) * n_rows], dim=0)
                        for f in range(n_frames)])


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
