#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (renderer_rs_tpu_torch) on one
NVIDIA H100: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result lines):
  1. torch/CUDA versions and the card's name and power limit (nvidia-smi).
  2. Build every CUDA kernel of the port with nvcc for sm_90a (one nvcc
     per source, started together), printing the build seconds.
  3. Each kernel beside its plain PyTorch version on the real inputs of the
     flagship frames:
       - blinnphong_scene(1920, 1080, rings=160, sectors=320), T = 102,402:
         K2 (raster_resolve) on its vertex stage, near clip, setup, binning
         and table build;
       - full_scene(1920, 1080, tri_budget=100_000, ibl=False), T = 97,346:
         K1 (raster_depth) on the 1024x1024 sun shadow pass, K2 on the
         forward pass, and K4 (raster_ids) on the 3840x2160 sample pass of
         MSAA 4x and the 7680x2160 sample pass of MSAA 8x;
       - the same scene with csm=True: K6, the four 1024x1024 cascades in
         one raster_depth launch (N = 4), also against four N = 1 launches;
       - K7, raster_depth's z-plane form, on the same sun map and on the
         four cascades, also against K1/K6 on the same setups (the same
         covered texels, depth within 2e-4: the JAX contract);
       - the gather probe, each of its five bodies at 64 iterations;
       - the headline scene, full_scene(1920, 1080, tri_budget=100_000,
         textured=True) with its default IBL environment (whose one-time
         precompute is timed here): K2 on the textured frame's 61-column
         table (12 lanes: world_pos, normal, uv, tangent), K5
         (raster_peel) on its alpha-cutoff (MASK) frame's 71-column table,
         with no floor and with the layer-0 depth as floor on every pixel
         (the whole frame peels to its next-nearest fragment), and K3
         (raster_visibility) in three band forms: the whole frame
         (band (0, 1080)), the contiguous band (270, 270) and the
         pair-interleaved band (2, 270, 4, True);
       - the glTF headline scene (bench.py's gltf_dancer_fps frame):
         full_scene(1920, 1080, tri_budget=100_000, textured=True,
         gltf=<a dancer-class model>, hdr=tests/assets/sky_equirect_64x32.hdr),
         T = 103,682: six instances of a 17,280-triangle UV sphere under a
         turned, non-uniformly scaled node, no TANGENT accessor, 1x1 base
         colour and metallic-roughness images (replaced by the textured
         override) and a 1024² normal map (resized to 256²), written into
         a temporary directory from a seed by write_dancer_class_gltf; its
         build is timed whole and by stage (parse, image decode, tangents,
         resize, material atlases, the IBL chain from the .hdr); K1 on its
         sun map and K2 on its forward pass (12 lanes);
       - the many-material scene (many_material_scene(1920, 1080, **MANY)),
         T = 102,402: a 16x16 grid of UV spheres, each with its own
         material and seeded 256² base-colour image, one shared normal
         map and metallic-roughness image, 256 texture sets, over the
         material atlases' 16M-row budget (the per-slot fetch); its build
         timed, the per-texture window atlas's size and host build time
         printed; K1 on its sun map and K2 on its forward pass;
       - the fused shade (shade_fused) on the headline frame's K2 outputs
         and sun map, and its cascade form on the same frame with four
         cascades fitted to its camera, each beside its plain version; the
         cascade form also timed beside the ATen chain it replaces;
       - the front end (front_end: the vertex stage, near clip, compaction
         and setup in three launches) on the headline scene with compaction
         on, and on a camera whose near plane cuts triangles with one and
         two vertices behind, with no compaction and with a cap of 5 that
         overflows: every output field bit-equal to the ATen chain's
         (passes.frame_geometry_chain), two or three launches a call, no
         host sync; its device time, the call's, the chain's and the byte
         bound.
     K1's, K6's and K7's depth and the probe's sums must be bit-equal; K2
     must give bit-equal
     tid/depth and lanes within rtol 1e-5 / atol 1e-6; K4 bit-equal tid and
     depth; K5 bit-equal tid and depth, lanes within rtol 1e-5 / atol 1e-6;
     K3 bit-equal tid, depth and barycentrics. Every split kernel is held
     so with the main path's split plan and with every bin cut into pieces
     of FORCED_CHUNK candidates; the kernels on the shared walk (K2, K3,
     K4, K5) also with the walk's warp skip off
     (raster_cuda._without_skip); K5 also on an all-+inf floor; K5, K2
     (Blinn-Phong,
     headline), K3 (the pair-interleaved band) and K4 (MSAA 4x) also, on
     the table with every raster slot twice, under LESS_OR_EQUAL and
     GREATER_OR_EQUAL (every winner the later twin). For the shared walk
     it prints the share of (warp, candidate) pairs the warp skip removes
     (torch ops on the binning, warp_skip_counts) and the median ms with
     the skip on and off, taking turns. Prints binned pairs, densest
     bin, bin overflow, kernel ms (median of >= 20 CUDA-event timings after
     warm-up), plain ms and the kernel's roofline bound (the work of the
     bins its blocks walk, over their pixels inside the frame or band); for
     the split kernels also the plan (chunk, work items, longest piece),
     the one-block-per-bin design's committed-tree ms beside this run's, a
     sweep of the chunk over CHUNK_SWEEP, the host syncs of each binning
     and launch (none allowed), and, after the main paths, each kernel's
     device µs by torch.profiler (key init, walk, resolve or finish).
  4. The main paths through Renderer.render_frame at 1920x1080 on cuda,
     every launch counter set to 0 just before each and read just after
     (the front end's three launches a frame are held on the Blinn-Phong,
     PBR, CSM and headline loops and counted on every loop):
       - the Blinn-Phong frame: one K2 launch per frame, nothing else;
       - the PBR frame, loop A, static scene: one K2 launch per frame and
         one K1 launch in all (the shadow map is kept while its inputs do
         not change);
       - the PBR frame, loop B, moving sun (a new direction and light
         matrix each frame): one K1 and one K2 launch per frame;
       - the CSM frame, static scene: one K2 launch per frame and ONE K6
         launch in all (never four single launches);
       - the CSM frame with the cascades refitted to a moving sun every
         frame: one K6 and one K2 launch per frame;
       - the PBR frame with MSAA 4x (shade-once resolve): one K2 and one K4
         launch per frame, one K1 launch in all;
       - bench.py's MSAA 4x frame (the headline scene: textured, IBL): one
         K2 and one K4 launch per frame, one K1 in all;
       - the textured frame (full_scene(textured=True, ibl=False)), static
         scene: one K2 launch per frame, one K1 launch in all;
       - the textured frame under an alpha-cutoff (MASK) pipeline,
         GraphicsPipelineBuilder().alpha_cutoff(0.5): four K5 launches per
         frame (the 4-layer depth peel), no K2 launch, one K1 in all;
       - the headline frame (bench.py's: textured, IBL): one K2 launch per
         frame, one K1 in all, no K3;
       - the same scene through parallel.render_frame_sharded on a mesh of
         one frame x 4 rows, all on cuda:0, contiguous and then
         pair-interleaved, with the scene's 1024² map, shadow parameters
         and ACES: four K3 and four K1 launches per frame (each band
         renders its own sun map, as the JAX function does), no K2;
       - the Blinn-Phong scene under FLAT shading: one K3 launch per frame
         (the whole frame), no K2;
       - the Hello Triangle at 800x600 through app.main --scene triangle,
         and the spinning cube (animate, 5 frames): no raster kernel (the
         scan rasterizer); the triangle's PNG must cover exactly 60,000
         pixels with red, green and blue corners;
       - the headline scene with the sun map in the z-plane form under a
         moving sun: one K7 and one K2 launch per frame; the CSM scene
         refitted every frame in the z-plane form: one batched K7 and one
         K2 launch per frame; each against the bary-form frame of the same
         scene state (ids equal, colours within PLANE_DRIFT);
       - the headline frame with return_depth (its 1024² sun map rendered
         first: one K1 and one K2 a frame, nothing else; the depth
         bit-equal to K2's own on the same inputs), then transparent_pass
         over it: the transparent golden's textured checker quad and three
         more translucent quads (two untextured, one through a sphere and
         the floor), PBR with the sun map's shadow term, then ACES; the
         pass's own ms; every pixel no translucent fragment reaches at the
         opaque depth equal to the opaque frame, bit for bit;
       - the headline scene under MSAA 4x with return_depth: the
         supersampling branch, one K1 and one K2 at 3840x2160 a frame, no
         K4; the resolved depth the min over each 2x2 footprint of K2's;
       - the same through render_frame_sharded on four bands of the
         supersampled frame on cuda:0, contiguous and pair-interleaved,
         unshard_rows and resolve_msaa: four K3 and four K1 a frame; the
         bands' ids and K3 depth against the 3840x2160 frame's ids and K2
         depth wherever no binning overflowed, the resolved colours within
         p99 |d| < 0.01 of the supersampled frame's;
       - the spinning cube without culling under a two-sided stencil
         (forward_frame(rendering=RenderingConfig(stencil=...),
         return_stencil=True)): no raster kernel (the scan); the stencil
         buffer bit-equal to the port's cpu run of the same call;
       - a LINE_STRIP of 47 segments and a POINT_LIST of 48 points,
         FLAT: no raster kernel, covered and finite;
       - (f) the glTF headline frame: one K1 launch in all and one K2
         launch per frame;
       - (g) the headline scene with its environment set without finalize
         (the exact map-sampling IBL), (h) the many-material scene (the
         per-slot fetch), (i) the headline frame under ShadeRates
         light="yhalf" and the exact reference pcf="full", cube="full": one K1 launch in all and one K2 launch
         per frame each; (j) the headline frame under MSAA 4x with
         msaa_mode="super": one K1 in all, one K2 at 3840x2160 per frame,
         no K4; then the drift table: each ShadeRates variant of
         RATE_VARIANTS against the exact reference, mean and p99 of |d|
         of the tonemapped frame; the default rates must meet the JAX
         gate (p99 < 0.01, mean < 0.002);
       - (k) python -m renderer_rs_tpu_torch.app.main in-process on the
         headline scene, APP_FRAMES frames under --orbit and under --fly
         (--log, a callable sink): one K1 in all, one K2 a frame, every
         frame distinct, the app's FrameStats summary printed; K2 held to
         its plain version on an orbit frame's inputs; (l) the headline
         frame, then resize(1280, 720), then resize(1920, 1080): each
         frame bit-equal to a fresh Renderer's at its extent, no K1; (m)
         validation mode: the bind-time sweep timed, frames beside normal
         mode's, no finding; one NaN normal gives exactly one; (n) two
         render_frame(present=False) and one render_frame(): the acquired
         slots follow the MAILBOX queue, frames_dropped printed (every
         other loop presents each frame and must drop none); (o) the
         geometry forms: vstage="batch" against "loop" on the headline and
         (h) frames, taking turns (frame ms, peak device memory, the share
         of equal ids, the frame bar between them); clip_compact=0 on the
         headline frame (bit-equal to the default where clip_overflow is
         0); cap_big=T at the 3840x2160 sample extent: K4 and K2 held to
         their plain versions under the raised cap with no big-class
         overflow, the shade-once and supersampled MSAA 4x loops, and the
         stitched bands' footprint share;
       - (q) the RHI: Device() picks cuda:0; every headline scene tensor
         through Buffer.upload_via_staging, back bit-equal; the IBL
         precompute as CommandBuffer.dispatch records run by
         execute_dispatches, bit-equal to the direct calls; save_scene and
         load_scene of the headline scene, its frame bit-equal (one K1,
         one K2); app.main for 3 frames at 1920x1080 into an X11 window of
         platform/x11_server_double.py where libX11 is installed (printed
         either way): every row blitted, one K1 and one K2 a frame;
       - (r) parallel.render_frame_sharded (a host thread and a CUDA
         stream per shard, the bands enqueued in turn) against the smoke's
         sequential reference (one forward_frame(band=band_spec(k, ...))
         per shard on the default stream, stitched by band_rows), bit for
         bit, each case's launches counted on one call: the headline frame
         on a (1, 4) mesh on cuda:0, contiguous and pair-interleaved (one
         K3 and one K1 per shard), its stitched ids equal to the whole
         frame's and its colours within FRAME_BAR of the whole frame
         at the exact rates; the orbit camera's first two views on a
         (2, 2) mesh through shard_scene_batch; the JAX dry run's flagship
         frame (full_scene(256, 256, tri_budget=3000, ibl=True, csm=True,
         textured=True), interleaved; one K3 and one K6 per shard) and the
         same under MSAA 4x on the supersampled rows, unshard_rows and
         resolve_msaa; each timed in SHARD_PAIRS interleaved pairs
         (concurrent, sequential: median, min, max); where the host has
         two cards or more, the first two cases again on a mesh of
         distinct cards, bit-equal to the one-card frames, else the line
         "loop (r) cross-card: not run, 1 card";
       - the probe's own path: probes.kgather.run for the five bodies at
         4,096 iterations (µs per iteration), 30 launches.
     The frames must be finite with covered pixels; the peel, clip and bin
     overflow counters are printed. The bands' ids (forward_frame(band=...)
     with render_frame_sharded's band specs, stitched by band_rows) must
     equal the headline frame's (forward_frame), and their K3 depth the
     frame's K2 depth, wherever no band and not the frame reports
     bin_overflow; the stitched frames' colours differ from the headline
     frame's by the reduced rates' drift only (bands shade at the full
     rate): p99 of |d| < 0.01.
  5. Correctness on small inputs by the repo's own means, on the card: the
     160x120 triangle, cube, Blinn-Phong and gltf-pbr frames against
     tests/goldens/*.png
     with tests/test_golden.py's bar, and full_scene(160, 120,
     tri_budget=2000, ibl=False) single-map, with csm=True, with MSAA 4x,
     textured, and textured under the MASK pipeline on cuda against the
     same frames of the port on the cpu (PCF, sky and ACES included); the
     128x96 alpha-cutout stack (tests/_torch_port.py::alpha_cutout_scene),
     where fragments really peel, cuda against cpu; the IBL frames `full`
     and `full_textured` (full_scene(160, 120, tri_budget=2000[,
     textured=True])) against their goldens and cuda against cpu; and the
     small full_textured frame as 4 bands, contiguous and interleaved, on
     cuda: stitched ids equal to the frame's, colours within the bar. Then
     the transparent golden (tests/test_golden.py::_render_transparent)
     against its golden, and cuda against cpu: the cube's two-sided stencil
     (bit-equal), the LINE_STRIP and POINT_LIST frames (ids exact), the
     alpha-cutout stack on the scan's coverage callback under FLAT, as a
     band and in MSAA 4x's sample pass (ids exact), and the small PBR
     frame's supersampled MSAA 4x with return_depth. Then the full_hdr
     golden (full_scene(160, 120, tri_budget=2000, hdr=<the sky asset>))
     on the card, and the small glTF frame (full_scene(160, 120,
     tri_budget=8, textured=True, gltf=tests/assets/textured_quad.glb,
     hdr=...)) on cuda against cpu within the frame bar. Then each path of
     (g)-(j) at 160x128 on cuda against cpu: the exact IBL, the small
     many-material scene with the budget lowered, every rate variant and
     the exact reference, and msaa_mode="super" at 64x48. Then (k)-(o)
     at 160x128 on cuda against cpu: the orbit app's three frames (golden
     bar), a frame after resize(96, 64), validation findings on one NaN
     normal, and the frame under every geometry form at once.
  6. After the main paths, so that the frame loops follow the same kernel
     checks as before: the chunk sweeps and tie tables of K2, K3 and K4
     queued by phase 3, then each split kernel's device µs by
     torch.profiler (a profiler session slows the process's later
     launches), the shared walk's also for each skip form;
     last, loop (r)'s profiles: SHARD_PROFILED calls of each case in each
     form under torch.profiler, the device busy share and the share of
     wall time with kernels of two or more shard streams in flight, and
     each concurrent call's K3 on as many distinct streams as shards.
Then a `kernels` JSON line and, last, {"ok": true, "device": {...}}.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

H100_F32_FLOPS = 67e12  # f32 outside the tensor cores (NVIDIA data sheet, SXM)
H100_HBM_BYTES_S = 3.35e12
# f32 ops per (candidate, pixel) pair of K2's walk: 3 edges x (2 subtracts,
# 1 multiply, 1 fma = 2, 1 compare), 2 multiplies + 2 subtracts for the
# barycentrics, 1 multiply + 2 fmas for the depth, 2 compares, 1 select
OPS_PER_PAIR = 3 * 6 + 4 + 5 + 2 + 1
# K1's walk: the same edges, barycentrics and depth, then 1 compare for the
# one-sided z bound and 1 min
DEPTH_OPS_PER_PAIR = 3 * 6 + 4 + 5 + 1 + 1
# K4's walk is K2's (the payload id takes the place of the winner row)
IDS_OPS_PER_PAIR = OPS_PER_PAIR
# one corner test of the shared walk's warp skip, per (warp, candidate) pair:
# per edge 2 selects, 2 subtracts, 1 multiply, 1 fma (2), 1 compare; 2 ors
SKIP_TEST_OPS = 3 * 8 + 2
# K5's walk is K2's with one more compare (the floor) when a floor is given
PEEL_OPS_PER_PAIR = OPS_PER_PAIR + 1
# K5's winner epilogue per covered pixel: two edges (12), barycentrics and
# weights (~16), a divide, 12 lanes x 4 (two fmas, a multiply, the zero
# fold) and 12 flat folds
PEEL_OPS_PER_PIXEL = 12 + 16 + 1 + 12 * 4 + 12
# K7's walk: the same edges, no barycentrics, the depth plane as a multiply,
# an FMA (2) and an add, then the z bound and the min
ZPLANE_OPS_PER_PAIR = 3 * 6 + 4 + 1 + 1
# the table columns the candidate walk reads: edges, z plane, 1/area
WALK_COLS = 19
# K7 reads no 1/area
ZPLANE_COLS = 18
# the JAX contract of the plane form against the bary form (raster.py:297,
# tests/test_raster_pallas.py:861-900): the same texels, depth within 2e-4
ZPLANE_VS_BARY = 2e-4
PROBE_CHECK_ITERS = 64  # the probe against its plain version
PROBE_ITERS = 4096  # the JAX probe's KG_ITERS (probes/probe_kgather.py:26)
W, H = 1920, 1080
MSAA = 4  # samples: a 2x2 ordered grid, 3840x2160 sample points
SX, SY = 2, 2
BLINNPHONG = dict(rings=160, sectors=320)
FULL = dict(tri_budget=100_000, ibl=False)
HEADLINE = dict(tri_budget=100_000, textured=True)  # bench.py's frame: IBL on
SMALL_FULL = dict(tri_budget=2000, ibl=False)
# the glTF headline frame: bench.py's gltf_dancer_fps field (bench.py:185-210)
# on a dancer-class model written from a seed (write_dancer_class_gltf), its
# IBL environment from the repo's Radiance .hdr sky
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "assets")
HDR_SKY = os.path.join(ASSETS, "sky_equirect_64x32.hdr")
GLTF_HEADLINE = dict(tri_budget=100_000, textured=True)
# one UV sphere of 17,280 triangles and 8,845 vertices (the dancer's 17.2k),
# a 1024² normal map; 6 instances + the floor = 103,682 triangles
DANCER = dict(rings=60, sectors=144, normal_size=1024)
GLTF_FRAMES = 5
# (h) the many-material scene: a 16x16 grid of UV spheres of 400 triangles
# (10 rings x 20 sectors) on the floor, T = 102,402, each sphere with its own
# material and seeded 256² base-colour image, one shared normal map and one
# metallic-roughness image: 256 texture sets x 256² = 16,777,216 level-0
# rows, over the material atlases' 16,000,000-row budget (the per-slot fetch)
MANY = dict(grid=16, tex_size=256, rings=10, sectors=20)
MANY_FRAMES = 5
# (g) the headline scene with its environment set without finalize (the
# exact map-sampling IBL); (i) the headline frame's rate variants
EXACT_IBL_FRAMES = 5
RATE_FRAMES = 5
# (i) the shade rates of the drift table (renderer.passes.ShadeRates
# arguments), held against the exact reference pcf="full", cube="full"
RATE_VARIANTS = {"default": {}, "light yhalf": dict(light="yhalf"),
                 "pcf half": dict(pcf="half"), "cube yquarter": dict(cube="yquarter")}
EXACT_RATES = dict(pcf="full", cube="full")
# the JAX package's own gate on the reduced rates' drift of the tonemapped
# frame from the exact reference (probes/probe_quality.py:6, :114): p99 and
# mean of |d| over the [H,W,4] frame
DRIFT_GATE = (0.01, 0.002)
# K3's band forms on the headline frame: (y_offset, rows[, stride, pair])
K3_BANDS = {"whole frame": (0, H), "contiguous band": (270, 270),
            "pair-interleaved band": (2, 270, 4, True)}
N_BANDS = 4
# the reference's own gate on its reduced-rate drift (passes.py:1206-1212):
# a band shades at the full rate, the 1080p frame at y-quarter PCF and
# y-half cube rate
# the plane-form frame against the bary-form frame of the same scene: the
# frame bar's share of values off 2e-3 + 2e-3|ref| (0.2%) and at most one
# flipped PCF tap of the sun term after ACES (0.15). The depth forms differ
# by <= 2e-4 against a shadow bias of 0.012, so a tap flips only where a
# receiver lies within 2e-4 of the biased depth; the CPU tests measured no
# changed pixel (full_scene at 160x120 and 480x270, sun map and cascades)
PLANE_DRIFT = (0.002, 0.15)
BAND_DRIFT_P99 = 0.01
# sharded MSAA 4x at 1920x1080: the least share of pixels whose 2x2 sample
# footprint rasterized alike in the bands and the whole supersampled frame
# (the rest lie where the frame's binning dropped triangles; 95.8% and
# 96.3% measured on the H100, contiguous and pair-interleaved)
MSAA_STITCH_ALIKE = 0.95
BP_FRAMES = 5
PBR_FRAMES = 7
CSM_FRAMES = 5
MSAA_FRAMES = 5
TEX_FRAMES = 5
MASK_FRAMES = 5
HEADLINE_FRAMES = 5
HEADLINE_MSAA_FRAMES = 5
BAND_FRAMES = 5
CUBE_FRAMES = 5
PLANE_FRAMES = 5
FLAT_FRAMES = 5
TRIANGLE_FRAMES = 3
TRANSPARENT_FRAMES = 3
SUPERSAMPLE_FRAMES = 3
SHARDED_MSAA_FRAMES = 3
STENCIL_FRAMES = 3
TOPOLOGY_FRAMES = 3
TOPOLOGY_VERTICES = 48  # a few dozen points or line segments
CUTOFF = 0.5
# (k) the app loop: app.main on the headline scene, frames a scripted camera
APP_FRAMES = 30
# (l) the resize loop's extents, one frame each
RESIZE_EXTENTS = ((W, H), (1280, 720), (W, H))
VALIDATION_FRAMES = 5
# (o) frames of each geometry form
FORMS_FRAMES = 5
# (o) the share of equal winner ids between the batched and the loop vertex
# stage (they may round an ulp apart on some vertices); their frames are
# held to the frame bar besides
VSTAGE_IDS_ALIKE = 0.999
# loop (r): the bar of the stitched bands' colours against the whole frame:
# the share of values off 2e-3 + 2e-3|ref| and the max |d|
# (tests/test_raster_pallas.py:586-617)
FRAME_BAR = (0.002, 0.05)
# loop (r): render_frame_sharded's shard threads against the smoke's
# sequential reference; interleaved (concurrent, sequential) frame pairs
# timed per case, and concurrent frames profiled per case
SHARD_PAIRS = 10
SHARD_PROFILED = 1
SHARD_PROFILE_TRIES = 3
# (r) the JAX multi-chip dry run's flagship frame (__graft_entry__.py:85-101):
# textured PBR, IBL, four cascades at 256x256, 256² shadow maps, ACES
FLAGSHIP = dict(tri_budget=3000, ibl=True, csm=True, textured=True)
FLAGSHIP_SIZE = 256
# loop (q): the app's frames into the X11 window of the server double
APP_X11_FRAMES = 3
KERNEL_TIMINGS = 25
# the split kernels once more with bins cut into pieces of at most this
# many candidates: every bin of more splits
FORCED_CHUNK = 32
# the chunk sweep of the split kernels; the wrappers' default,
# ops/raster_cuda.py::SPLIT_CHUNK, is chosen from it
CHUNK_SWEEP = (32, 64, 128, 256, 512, 1024)
BREAKDOWN_CALLS = 10  # calls profiled for a split kernel's per-kernel device times
# the committed-tree medians in ms of the one-block-per-bin designs
# (PERF.md §6), printed beside this run's: constants of the log line, not
# measurements of this run
EARLIER_MS = {"K1 sun map": ("PR 6", 0.3457), "K6 cascades": ("PR 6", 10.0942),
              "K7 sun map": ("PR 6", 0.2739), "K7 cascades": ("PR 6", 7.5335),
              "K5 no floor": ("PR 6", 0.8673), "K5 layer-0 floor": ("PR 6", 0.9116),
              "K2 blinnphong flagship": ("PR 7", 1.2292), "K2 pbr flagship": ("PR 6", 0.4896),
              "K2 headline (textured, IBL)": ("PR 6", 0.5276),
              "K3 whole frame": ("PR 7", 0.4810), "K3 contiguous band": ("PR 7", 0.4509),
              "K3 pair-interleaved band": ("PR 7", 0.6586)}
SUN = (-0.45, -1.0, -0.35)  # full_scene's sun


def _moved_sun(i: int) -> tuple:
    """The scene's sun turned about the vertical by 0.15 rad per step."""
    a = 0.15 * (i + 1)
    return (SUN[0] * math.cos(a) - SUN[2] * math.sin(a), SUN[1],
            SUN[2] * math.cos(a) + SUN[0] * math.sin(a))


def _move_sun(renderer, i: int) -> None:
    """Turn the renderer's sun to _moved_sun(i): a new direction and light
    matrix, so the sun map renders anew."""
    import dataclasses

    import torch

    from renderer_rs_tpu_torch.ops.shadow import directional_light_matrix

    sun = _moved_sun(i)
    cur = renderer._scene
    lights = dataclasses.replace(
        cur.lights, sun_direction=torch.tensor(sun, dtype=torch.float32, device="cuda"))
    lsm = directional_light_matrix(sun, [0.0, 0.0, 0.0], 3.5).to("cuda")
    renderer.update_scene(cur.replace(lights=lights, light_space_matrix=lsm))


def _refit_cascades(renderer, i: int) -> None:
    """Turn the renderer's sun to _moved_sun(i): the lights and the
    camera-fitted cascades' sun, which the next render_frame refits the
    four cascades to, so they render anew."""
    import dataclasses

    import torch

    sun = _moved_sun(i)
    cur = renderer._scene
    lights = dataclasses.replace(
        cur.lights, sun_direction=torch.tensor(sun, dtype=torch.float32, device="cuda"))
    renderer.update_scene(cur.replace(
        lights=lights, csm_fit=dataclasses.replace(cur.csm_fit, sun_direction=sun)))


def write_dancer_class_gltf(directory: str, seed: int = 0, rings: int = 60, sectors: int = 144,
                            normal_size: int = 1024) -> str:
    """Write a dancer-class glTF into `directory` from `seed`, with numpy
    and the port's PNG writer; returns the .gltf path. The reference's
    dancer asset (17.2k triangles, no TANGENT accessor, a real normal map,
    base colour and metallic-roughness images stripped to 1x1 white) is
    not in the repo; this model has its shape: one mesh, a UV sphere of
    2·rings·sectors triangles with u32 indices, POSITION, NORMAL and
    TEXCOORD_0 but no TANGENT (so the loader generates tangents), under
    one node with a rotation and a non-uniform scale (so the loader bakes
    a world transform), a 1x1 white base-colour and metallic-roughness
    PNG and a normal_size² tangent-space normal map of a seeded bump
    field, all in external files (.bin and .png)."""
    import numpy as np

    from renderer_rs_tpu_torch.utils.image_io import write_png
    from renderer_rs_tpu_torch.utils.meshgen import uv_sphere_mesh

    rng = np.random.default_rng(seed)
    mesh = uv_sphere_mesh(1.0, rings, sectors)
    t = (np.arange(normal_size) + 0.5) / normal_size
    yy, xx = np.meshgrid(t, t, indexing="ij")
    bump = np.zeros((normal_size, normal_size))
    for _ in range(8):  # tileable waves of seeded frequency, phase and height
        fx, fy = rng.integers(1, 24, 2)
        bump += rng.uniform(0.002, 0.01) * np.sin(2 * np.pi * (fx * xx + fy * yy)
                                                  + rng.uniform(0.0, 2 * np.pi))
    n = np.stack([-np.gradient(bump, axis=1) * normal_size,
                  -np.gradient(bump, axis=0) * normal_size, np.ones_like(bump)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    write_png(os.path.join(directory, "normal.png"),
              np.round((n * 0.5 + 0.5) * 255.0).astype(np.uint8))
    white = np.full((1, 1, 3), 255, np.uint8)
    write_png(os.path.join(directory, "base_color.png"), white)
    write_png(os.path.join(directory, "metallic_roughness.png"), white)

    blobs = [mesh.positions, mesh.normals, mesh.tex_coords, mesh.indices.astype(np.uint32)]
    views, offset = [], 0
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": b.nbytes})
        offset += b.nbytes  # every blob is a multiple of 4 bytes
    with open(os.path.join(directory, "dancer.bin"), "wb") as f:
        f.write(b"".join(b.tobytes() for b in blobs))
    axis = np.array([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2])
    half = 0.35  # a 0.7 rad turn
    n_vert = mesh.positions.shape[0]
    doc = {
        "asset": {"version": "2.0", "generator": "chip_smoke.write_dancer_class_gltf"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0.0, 0.4, 0.0],
                   "rotation": [*(axis * math.sin(half)).tolist(), math.cos(half)],
                   "scale": [0.45, 1.3, 0.35]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                     "metallicRoughnessTexture": {"index": 1},
                                     "baseColorFactor": [0.85, 0.7, 0.6, 1.0],
                                     "metallicFactor": 0.2, "roughnessFactor": 0.7},
            "normalTexture": {"index": 2, "scale": 1.0}}],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": [{"uri": "base_color.png"}, {"uri": "metallic_roughness.png"},
                   {"uri": "normal.png"}],
        "buffers": [{"uri": "dancer.bin", "byteLength": offset}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": n_vert, "type": "VEC3",
             "min": mesh.positions.min(0).tolist(), "max": mesh.positions.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": n_vert, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": n_vert, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": mesh.indices.size,
             "type": "SCALAR"},
        ],
    }
    path = os.path.join(directory, "dancer.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def many_material_scene(width: int, height: int, grid: int = 16, tex_size: int = 256,
                        rings: int = 10, sectors: int = 20, seed: int = 0,
                        shadow_map_size: int = 1024, device="cuda"):
    """The many-material scene of loop (h): a grid x grid grid of UV spheres
    (rings x sectors) on the floor, sphere k with its own Material and its
    own seeded tex_size² base-colour image (a tinted product of two seeded
    waves), all spheres sharing one tangent-space normal map and one
    metallic-roughness image (meshgen.procedural_pbr_textures); the floor
    binds sphere 0's three images. That makes grid² texture sets. A
    shadow-mapped sun (a shadow_map_size² map), the procedural-sky IBL
    (full_scene's precompute, finalized), PBR_IBL and ACES, as in the
    headline frame. Returns (scene, layout, kwargs, the SceneBuilder's
    atlas build times in ms)."""
    import numpy as np

    from renderer_rs_tpu_torch.app.scenes import _camera_ubo, _ibl_environment, _orbit_camera
    from renderer_rs_tpu_torch.core.device import resolve_device
    from renderer_rs_tpu_torch.ops.ibl import procedural_sky_cubemap
    from renderer_rs_tpu_torch.ops.shadow import ShadowParams, directional_light_matrix
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.resources.material import Material
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.scene.light import DirectionalLight, LightBank
    from renderer_rs_tpu_torch.scene.transform import Transform
    from renderer_rs_tpu_torch.utils import meshgen

    rng = np.random.default_rng(seed)
    n = grid * grid
    t = (np.arange(tex_size, dtype=np.float32) + 0.5) / tex_size
    yy, xx = np.meshgrid(t, t, indexing="ij")
    images = []
    for _ in range(n):
        f, ph = rng.uniform(1.0, 12.0, 2), rng.uniform(0.0, 2 * np.pi, 2)
        wave = 0.65 + 0.35 * np.sin(2 * np.pi * f[0] * xx + ph[0]) * np.sin(
            2 * np.pi * f[1] * yy + ph[1])
        tint = rng.uniform(0.25, 0.95, 3).astype(np.float32)
        images.append((wave[..., None] * tint).astype(np.float32))
    maps = meshgen.procedural_pbr_textures(tex_size)
    images += [maps["normal"], maps["metallic_roughness"]]
    builder = SceneBuilder()
    builder.set_textures(images, size=tex_size)
    sphere = meshgen.uv_sphere_mesh(1.0, rings, sectors)
    spacing, radius = 0.7, 0.3
    shared = dict(normal_texture=n, metallic_roughness_texture=n + 1)
    for k in range(n):
        i, j = k % grid, k // grid
        mat = Material(base_color=(1.0, 1.0, 1.0, 1.0), metallic=float(rng.uniform(0.0, 1.0)),
                       roughness=float(rng.uniform(0.15, 0.9)), base_color_texture=k, **shared)
        tr = (Transform()
              .with_position([(i - (grid - 1) / 2) * spacing, radius,
                              (j - (grid - 1) / 2) * spacing])
              .with_scale([radius] * 3))
        builder.add_mesh(sphere, tr, mat)
    builder.add_mesh(meshgen.plane_mesh(12.0), Transform(),
                     Material(base_color=(0.55, 0.55, 0.6, 1.0), roughness=0.85,
                              base_color_texture=0, **shared))
    cam = _orbit_camera(width, height, distance=7.5, height_y=5.0, fov=50.0)
    builder.set_camera(_camera_ubo(cam))
    sun_dir = np.array(SUN, np.float32)
    builder.set_lights(LightBank.create(sun=DirectionalLight.create(direction=sun_dir,
                                                                    intensity=3.5)))
    extent = grid * spacing / 2 * math.sqrt(2) + radius
    builder.set_shadow_matrix(directional_light_matrix(sun_dir, [0.0, 0.0, 0.0], extent))
    sky = procedural_sky_cubemap(64, sun_direction=tuple(float(v) for v in sun_dir))
    builder.set_environment(_ibl_environment(sky.to(resolve_device(device))))
    scene, layout = builder.build(device=device)
    # full_scene's biases (a 3.5 light box) scaled to this light box
    kwargs = dict(
        pipeline=GraphicsPipelineBuilder().build(), shading=ShadingModel.PBR_IBL, camera=cam,
        tonemap="aces", shadow_map_size=shadow_map_size,
        shadow_params=ShadowParams(shadow_bias=0.012 * extent / 3.5,
                                   normal_bias=0.06 * extent / 3.5),
    )
    return scene, layout, kwargs, dict(builder.build_ms)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _event_times_ms(fn, n: int, warmup: int = 3) -> list[float]:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _bound(ops: float, nbytes: float):
    """The least time (ms) the card could take: the larger of the f32 ops at
    peak rate and the bytes at the memory rate, and which one it is."""
    ops_ms = ops / H100_F32_FLOPS * 1e3
    bytes_ms = nbytes / H100_HBM_BYTES_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def _walked(seg, nbx: int, rows: int, width: int):
    """The work a kernel's blocks do on one binning: a block whose 16x128
    bin lies wholly in the tile padding below `rows` returns at once, and
    only the bin's pixels inside rows x width count. Returns (the pairs of
    the walked bins, the sum over bins of pairs x valid pixels, the number
    of walked bins), over every set of seg ([..., bins + 1])."""
    import torch

    counts = (seg[..., 1:] - seg[..., :-1]).reshape(-1, nbx).to(torch.int64)
    nby = (seg.shape[-1] - 1) // nbx
    by = torch.arange(nby, device=seg.device).repeat(counts.shape[0] // nby)
    valid_rows = (rows - by * 16).clamp(0, 16)
    valid_cols = (width - torch.arange(nbx, device=seg.device) * 128).clamp(0, 128)
    walked = valid_rows > 0
    pixel_pairs = (counts * valid_rows[:, None] * valid_cols[None, :]).sum()
    return int(counts[walked].sum()), int(pixel_pairs), int(walked.sum()) * nbx


def _timed_once(fn):
    """(fn(), its ms by CUDA events): one call, for the plain walks that
    take seconds, timed where their result is compared."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _syncs(fn) -> list:
    """Where (file:line) fn() makes a synchronizing CUDA operation, by
    torch.cuda's sync debug mode (a prototype: it may miss some)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in seen
            if str(w.message).startswith("called a synchronizing CUDA operation")]


def _plan_stats(plan) -> dict:
    """The split plan's chunk, real work items, grid (the items' bound) and
    longest piece."""
    real = plan.items[plan.items[:, 0] >= 0]
    longest = int((real[:, 3] - real[:, 2]).max()) if real.shape[0] else 0
    return {"chunk": plan.chunk, "items": int(real.shape[0]), "grid": plan.items.shape[0],
            "longest_piece": longest}


def _chunk_sweep(label: str, launch, seg, n_keys: int) -> dict:
    """The kernel's median ms at each chunk of CHUNK_SWEEP: launch(plan)
    runs it on a plan built beforehand."""
    from renderer_rs_tpu_torch.ops.raster_cuda import split_plan

    out = {}
    for chunk in CHUNK_SWEEP:
        plan = split_plan(seg, n_keys, chunk)
        out[chunk] = _median(_event_times_ms(lambda plan=plan: launch(plan), KERNEL_TIMINGS))
    _log(f"{label}: chunk sweep, median ms of {KERNEL_TIMINGS} "
         f"{ {c: round(ms, 4) for c, ms in out.items()} }")
    return out


def _interleaved_ms(launches: dict, n: int) -> dict:
    """Median ms of each of `launches` (label -> fn), by CUDA events, the
    labels taking turns call by call after a warm-up of each."""
    import torch

    for fn in launches.values():
        fn()
    torch.cuda.synchronize()
    times: dict = {label: [] for label in launches}
    for _ in range(n):
        for label, fn in launches.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    return {label: _median(t) for label, t in times.items()}


# the shared walk's warp skip off (a context of ops/raster_cuda.py), held
# bit-equal to the plain version beside the main path's walk (_against_plain)
def _skip_off():
    from renderer_rs_tpu_torch.ops.raster_cuda import _without_skip

    return _without_skip()


SKIP_OFF = {"skip off": _skip_off}

# a thread, and so a warp, of the shared walk holds 8 consecutive band rows:
# half a bin (csrc/split_walk.cuh, "The skip")
PX_ROWS = 8


def corner_pick(sdx, sdy):
    """The corner of a pixel rectangle where an edge's rounded e is largest
    (csrc/split_walk.cuh, "The skip"): (the last column where sdy is not
    > 0, the last row where sdx > 0)."""
    return ~(sdy > 0.0), sdx > 0.0


def warp_misses(cols, px_lo, px_hi, py_lo, py_hi, pick=corner_pick):
    """csrc/split_walk.cuh's warp_misses as torch ops: True where a
    candidate (cols [..., >=15], the three edges' (ax, ay, sdx, sdy,
    thresh)) fails coverage at every pixel centre of [px_lo, px_hi] x
    [py_lo, py_hi] (f32, broadcast against cols[..., 0]), by one edge
    evaluation at the corner `pick` chooses. A NaN there skips nothing."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import _edge

    out = None
    for k0 in (0, 5, 10):
        ax, ay, sdx, sdy, th = (cols[..., k0 + k] for k in range(5))
        hi_x, hi_y = pick(sdx, sdy)
        e = _edge(sdx, torch.where(hi_y, py_hi, py_lo) - ay, sdy,
                  torch.where(hi_x, px_hi, px_lo) - ax)
        out = e < th if out is None else out | (e < th)
    return out


def warp_skip_counts(table, sorted_tris, seg, nbx, height, width, band=(0, 1, False)):
    """The (warp, candidate) pairs of the shared walk on one binning and
    what the warp skip leaves of them: (the pairs the skip removes, the
    pairs walked, the (candidate, pixel) pairs of the kept ones inside the
    `height` x `width` frame or band), as device scalars. A block of the
    walk has 8 warps of 32 columns x 8 consecutive band rows (j0 + 8h ..
    j0 + 8h + 7, h = warp // 4); bins wholly below `height` are not walked.
    band = (y_offset, y_stride, y_pair)."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import BIN_H, BIN_W, _band_py

    dev = table.device
    seg_l = seg.reshape(-1).long()
    n_bins = seg_l.numel() - 1
    counts = seg_l[1:] - seg_l[:-1]
    bins = torch.repeat_interleave(torch.arange(n_bins, device=dev), counts)  # [P]
    cols = table[sorted_tris[seg_l[0]:seg_l[0] + bins.numel()].long()][:, None, :15]
    warp = torch.arange(8, device=dev)
    j_lo = (bins // nbx)[:, None] * BIN_H + PX_ROWS * (warp // 4)  # [P, 8]
    x_lo = (bins % nbx)[:, None] * BIN_W + 32 * (warp % 4)
    f32 = torch.float32
    misses = warp_misses(cols, x_lo.to(f32) + 0.5, x_lo.to(f32) + 31.5, _band_py(j_lo, *band),
                         _band_py(j_lo + PX_ROWS - 1, *band))
    walked = ((bins // nbx) * BIN_H < height)[:, None].expand_as(misses)
    # a warp's pixels inside the frame: its rows below height x its columns below width
    pixels = (height - j_lo).clamp(0, PX_ROWS) * (width - x_lo).clamp(0, 32)
    kept = walked & ~misses
    return (misses & walked).sum(), walked.sum(), (pixels * kept).sum()


def _skip_counts(inputs, rows: int, width: int, band=(0, 1, False)) -> dict:
    """The shared walk's (warp, candidate) pairs on one binning (inputs:
    IdsInputs, PeelInputs, ResolveInputs, VisibilityInputs) and what the
    warp skip leaves of them (warp_skip_counts: torch ops on the binning,
    not a count inside the timed kernel)."""
    skipped, walked, kept = (int(v) for v in warp_skip_counts(
        inputs.table, inputs.sorted_tris, inputs.seg, inputs.nbx, rows, width, band))
    return {"skipped_pairs": skipped, "walked_pairs": walked, "kept_pixel_pairs": kept,
            "share": skipped / max(walked, 1)}


def _walk_ops(counts: dict, pixel_pairs: int, ops_per_pair: int) -> int:
    """The shared walk's f32 ops that this run's data needs: the skipped
    (warp, candidate) pairs are work the data provably does not need, so
    the kept pairs' (candidate, pixel) pairs at ops_per_pair, and one
    corner test per walked (warp, candidate) pair. The bound of every pixel
    pair of the walked bins (pixel_pairs) is printed beside it as all
    pairs."""
    return counts["kept_pixel_pairs"] * ops_per_pair + counts["walked_pairs"] * SKIP_TEST_OPS


def _walked_rows(inputs, walked: int) -> int:
    """The table rows the walked bins' segments name (inputs: IdsInputs,
    PeelInputs, ResolveInputs, VisibilityInputs; walked: their pairs, a
    prefix of sorted_tris): the rows a walk reads. A raster slot no bin
    holds (back-facing, off-screen) and the pad row are never read."""
    import torch

    return int(torch.unique(inputs.sorted_tris[:walked]).numel())


def _skip_forms(entry: dict, label: str, launch, counts: dict,
                breakdown: bool = False) -> None:
    """The shared walk's warp skip on one case: the share of the walk's
    (warp, candidate) pairs that it removes (_skip_counts), and the median
    ms with the skip on and off, taking turns; with breakdown=True each
    one's device µs by kernel is queued for phase_breakdown. launch() runs
    the case with the main path's plan. Stored in entry["skip"][label]."""
    import contextlib

    forms = {"on": contextlib.nullcontext, "off": _skip_off}

    def run(form):
        with forms[form]():
            launch()

    ms = _interleaved_ms({form: (lambda form=form: run(form)) for form in forms},
                         KERNEL_TIMINGS)
    res = entry.setdefault("skip", {})[label] = {**counts, "ms": ms}
    _log(f"{label}: the warp skip removes {counts['skipped_pairs']} of "
         f"{counts['walked_pairs']} (warp, candidate) pairs ({counts['share']:.2%}), keeps "
         f"{counts['kept_pixel_pairs']} (candidate, pixel) pairs; median ms of {KERNEL_TIMINGS} "
         f"with the skip on and off, in turns { {form: round(t, 4) for form, t in ms.items()} }")
    if breakdown:
        for form in forms:
            _defer_breakdown(res, form, f"{label}, skip {form}", lambda form=form: run(form),
                             None)


# the split kernels' per-kernel device times, queued by the kernel checks
# and taken by phase_breakdown after the main paths: a torch.profiler
# session leaves the process's later launches slower, which would bias the
# frame loops
_BREAKDOWNS: list = []


def _defer_breakdown(entry: dict, case: str, label: str, launch, ms_key="device_ms") -> None:
    """Queue `launch` for phase_breakdown, which stores its device µs by
    kernel in entry["device_us_by_kernel"][case] and, with ms_key, their
    sum in ms in entry[ms_key]."""
    _BREAKDOWNS.append((entry, case, label, launch, ms_key))


# checks that launch a kernel hundreds of times (the K2 and K3 chunk sweeps
# and tie tables), queued by the kernel checks and run by phase_after
# after the main paths, so that the frame loops follow the same phase 3 as
# before them
_AFTER: list = []


def phase_after() -> None:
    for check in _AFTER:
        check()
    _AFTER.clear()


def phase_breakdown() -> None:
    for entry, case, label, launch, ms_key in _BREAKDOWNS:
        us = _kernel_breakdown(label, launch)
        entry.setdefault("device_us_by_kernel", {})[case] = us
        if ms_key:
            entry[ms_key] = sum(us.values()) / 1e3
    _BREAKDOWNS.clear()


def _kernel_breakdown(label: str, launch) -> dict:
    """Device µs per call of each CUDA kernel that `launch()` runs (a split
    kernel is three: the key pass, the walk, the finish or epilogue), from
    torch.profiler over BREAKDOWN_CALLS calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BREAKDOWN_CALLS):
            launch()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
        out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / BREAKDOWN_CALLS
    _log(f"{label}: device µs per call by kernel {({k: round(v, 2) for k, v in out.items()})}")
    return out


def _split_log(label: str, ms: float, bound_ms: float, bound_by: str, plan) -> None:
    stats = _plan_stats(plan)
    pr, earlier = EARLIER_MS.get(label, (None, None))
    before = f"; {pr} committed tree {earlier}" if pr else ""
    _log(f"{label}: {ms:.4f} ms (median of {KERNEL_TIMINGS}{before}), chunk {stats['chunk']}, "
         f"work items {stats['items']} "
         f"(grid {stats['grid']}), longest piece {stats['longest_piece']}, bound "
         f"{bound_ms:.4f} ms by {bound_by}")


# the card's name and power limit as nvidia-smi gives them (phase_versions)
_CARD = ""


def phase_versions() -> None:
    global _CARD
    import torch

    _log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    _CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _log(_CARD)


def phase_build() -> None:
    from renderer_rs_tpu_torch import kernels

    t0 = time.perf_counter()
    seconds = kernels.build()
    for name in kernels.SOURCES:
        kernels.load(name)
        ptxas = kernels.library_path(name).with_suffix(".ptxas.txt")
        usage = [ln.strip() for ln in ptxas.read_text().splitlines() if "registers" in ln] if ptxas.exists() else []
        _log(f"built {name} in {seconds.get(name, 0.0):.2f}s: {'; '.join(usage)}")
    _log(f"kernel build: {time.perf_counter() - t0:.2f}s")


# the largest |err| of every _against_plain case by kernel name, main-path
# checks included: folded into the kernels line's max_abs_err
_MAX_ABS_ERR: dict[str, float] = {}


def _against_plain(name: str, label: str, launch, plain, args, plan, lanes: bool,
                   extra: dict | None = None, lanes_exact: bool = False) -> dict:
    """One case of a split winner kernel on the card, K2 or K5 (lanes=True)
    or K3 or K4, with `plan` and with FORCED_CHUNK, and with the plan inside
    each of `extra`'s contexts (form label -> context factory: the walk's
    skip off), against the plain version: every output bit-equal, except
    the lanes, held within rtol 1e-5 / atol 1e-6 (bit-equality printed),
    or bit-equal too under lanes_exact."""
    import torch

    out = launch(*args, plan=plan)
    runs = [("plan", out), (f"chunk {FORCED_CHUNK}", launch(*args, chunk=FORCED_CHUNK))]
    for form, context in (extra or {}).items():
        with context():
            runs.append((form, launch(*args, plan=plan)))
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    ok, max_abs_err = True, 0.0
    for form, got in runs:
        equal = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                 for a, b in zip(got, ref)]
        errs = [float((a - b).abs().max()) if a.numel() else 0.0
                for a, b in zip(got, ref) if a.dtype == torch.float32]
        max_abs_err = max([max_abs_err, *errs])
        if lanes:
            lanes_ok = bool(((got[2] - ref[2]).abs() <= 1e-6 + 1e-5 * ref[2].abs()).all())
            ok = ok and equal[0] and equal[1] and lanes_ok and (equal[2] or not lanes_exact)
            what = (f"tid equal {equal[1]}, depth bit-equal {equal[0]}, lanes max |err| "
                    f"{errs[-1]:.3e} (rtol 1e-5 atol 1e-6 ok {lanes_ok}, bit-equal {equal[2]})")
        else:
            ok = ok and all(equal)
            what = f"{', '.join(('depth', 'tid', 'b0', 'b1')[:len(equal)])} bit-equal {equal}"
        _log(f"{name} ({label}, {form}) vs plain: {what}, covered {int((got[1] >= 0).sum())}")
    if not ok:
        raise SystemExit(f"phase kernels: {name} disagrees with its plain version ({label})")
    _MAX_ABS_ERR[name] = max(_MAX_ABS_ERR.get(name, 0.0), max_abs_err)
    return {"max_abs_err": max_abs_err, "tid": out[1], "depth": out[0]}


def _twice(table, setup):
    """The table with every raster slot twice (the twin's id, column 19, + t,
    the raster slot count: above every id of the table) and the setup to
    bin it: each winner ties its twin."""
    import torch

    from renderer_rs_tpu_torch.ops.raster import TriangleSetup

    rows = table[:-1]
    twins = rows.clone()
    twins[:, 19] += rows.shape[0]
    return (torch.cat([rows, twins, table[-1:]]).contiguous(),
            TriangleSetup(*(torch.cat([getattr(setup, f)] * 2)
                            for f in ("xy", "z", "w", "area2", "valid"))))


def _dropped_twins(args, tid, n_slots: int):
    """Where a pixel's winner (tid, a raster slot below n_slots) has a twin
    (slot tid + n_slots) that the binning did not put in the pixel's bin:
    the class caps drop triangles (bin_overflow), and a dropped twin cannot
    win. args are a kernel's (table, sorted_tris, seg, nbx, height, width,
    ...) over [height, width] rows."""
    import torch

    sorted_tris, seg, nbx, height, width = args[1:6]
    seg_l = seg.long()
    n_bins = seg_l.numel() - 1
    stride = 2 * n_slots + 1
    bins = torch.repeat_interleave(torch.arange(n_bins, device=seg.device), seg_l[1:] - seg_l[:-1])
    binned = bins * stride + sorted_tris[seg_l[0]:seg_l[0] + bins.numel()].long()
    y = torch.arange(height, device=seg.device)[:, None] // 16
    x = torch.arange(width, device=seg.device)[None, :] // 128
    want = (y * nbx + x) * stride + tid.long() + n_slots
    return ~torch.isin(want, binned)


def _check_ties(name: str, label: str, launch, plain, args_for, n_slots: int,
                dropped_ok: bool = False) -> dict:
    """A split winner kernel's tie rules at full size, on a table with
    every raster slot twice (_twice, ids of twins from n_slots on):
    args_for(op, clear) are its arguments and plan under
    LESS_OR_EQUAL (clear 1) and GREATER_OR_EQUAL (clear 0). Every winner
    ties its twin, and LE/GE keep the last submitted: the twin. With
    dropped_ok (the table's ids are its raster slots), a winner may be the
    earlier twin where the binning's caps dropped the later one
    (_dropped_twins), as at the MSAA sample extent."""
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp

    out = {"max_abs_err": 0.0, "ms": {}}
    for op, clear in ((CompareOp.LESS_OR_EQUAL, 1.0), (CompareOp.GREATER_OR_EQUAL, 0.0)):
        args, plan = args_for(op, clear)
        case = f"{label}, twins, {op.name}"
        res = _against_plain(name, case, launch, plain, args, plan,
                             name in ("raster_resolve", "raster_peel"))
        hit = res["tid"] >= 0
        earlier = hit & (res["tid"] < n_slots)
        dropped = int((earlier & _dropped_twins(args, res["tid"], n_slots)).sum()) if dropped_ok else 0
        twin_won = int(earlier.sum()) == dropped
        _log(f"{name} ({case}): covered {int(hit.sum())}, every winner the later twin "
             f"{twin_won}" + (f" (where the binning kept it; the earlier twin won {dropped} "
                              "pixels whose later twin the binning's caps dropped)"
                              if dropped_ok else ""))
        if not (twin_won and bool(hit.any())):
            raise SystemExit(f"phase kernels: {name} ({case}) broke the tie rule")
        out["max_abs_err"] = max(out["max_abs_err"], res["max_abs_err"])
        out["ms"][op.name] = _median(_event_times_ms(
            lambda args=args, plan=plan: launch(*args, plan=plan), KERNEL_TIMINGS))
        _log(f"{name} ({case}): {out['ms'][op.name]:.4f} ms (median of {KERNEL_TIMINGS})")
    return out


def _check_resolve(label, scene, layout, pipeline, timed: bool) -> dict:
    """K2 beside its plain version on one frame's real inputs, with the main
    path's split plan and with FORCED_CHUNK; timed=True also times the plain
    version, sweeps the chunk and checks the tie rules on the table with
    every raster slot twice."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        bin_compact,
        prepare_resolve,
        raster_resolve,
        raster_resolve_plain,
        split_plan,
    )
    from renderer_rs_tpu_torch.renderer.passes import frame_geometry

    geo = frame_geometry(scene, layout, pipeline, W, H)

    def prepare():
        return prepare_resolve(geo.setup, H, W, geo.attr, scene.tris, geo.clip_src,
                               geo.clip_planes, geo.mat_flat, small_limit=layout.num_triangles)

    k2 = prepare()
    args = (k2.table, k2.sorted_tris, k2.seg, k2.nbx, H, W, k2.n_vary, k2.n_flat,
            pipeline.depth_compare_op)
    n_pairs = int(k2.n_pairs)
    densest = int((k2.seg[1:] - k2.seg[:-1]).max())
    _log(f"{label}: T={layout.num_triangles} raster slots={geo.setup.num_triangles} "
         f"bins={k2.seg.numel() - 1} binned pairs={n_pairs} densest bin={densest} "
         f"table={tuple(k2.table.shape)}; split plan {_plan_stats(k2.plan)}, with chunk "
         f"{FORCED_CHUNK} {_plan_stats(_plan_at(k2, FORCED_CHUNK))}")
    syncs = _syncs(lambda: raster_resolve(*args, plan=prepare().plan))
    _log(f"{label}: host syncs of prepare_resolve (binning, table, split plan) and the K2 "
         f"launch: {len(syncs)} {syncs}")
    if syncs:
        raise SystemExit(f"phase kernels: the K2 binning or launch synchronizes the host ({label})")
    res = _against_plain("raster_resolve", label, raster_resolve, raster_resolve_plain, args,
                         k2.plan, lanes=True, extra=SKIP_OFF)
    if not bool((res["tid"] >= 0).any()):
        raise SystemExit(f"phase kernels: raster_resolve covers no pixel ({label})")
    max_abs_err = res["max_abs_err"]

    ms = _median(_event_times_ms(lambda: raster_resolve(*args, plan=k2.plan), KERNEL_TIMINGS))
    plain_ms = _median(_event_times_ms(lambda: raster_resolve_plain(*args), 3, warmup=1)) if timed else None
    # least time for the same work: the walk's f32 ops over the frame's
    # pixels vs the bytes moved once: the 19 walk columns of every walked
    # row and the rest of every winning row (tid is the raster slot: the
    # row), the walked bins' sorted ids and segments read, outputs written
    walked, pixel_pairs, bins = _walked(k2.seg, k2.nbx, H, W)
    counts = _skip_counts(k2, H, W)
    ops = _walk_ops(counts, pixel_pairs, OPS_PER_PAIR)
    n_lanes = k2.n_vary + k2.n_flat
    walked_rows = _walked_rows(k2, walked)
    winner_rows = int(torch.unique(res["tid"][res["tid"] >= 0]).numel())
    nbytes = (walked_rows * WALK_COLS * 4 + winner_rows * (k2.table.shape[1] - WALK_COLS) * 4
              + walked * 4 + (bins + 1) * 4 + H * W * (4 + 4 + 4 * n_lanes))
    bound_ms, bound_by = _bound(ops, nbytes)
    bound_all = _bound(pixel_pairs * OPS_PER_PAIR, nbytes)[0]
    _log(f"{label}: raster_resolve {ms:.4f} ms (median of {KERNEL_TIMINGS})"
         + (f", plain {plain_ms:.2f} ms" if timed else "")
         + f", bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes: "
         f"{walked_rows} walked rows of {k2.table.shape[0]}, {winner_rows} winning rows; all "
         f"pairs {bound_all:.4f} ms)")
    _split_log(f"K2 {label}", ms, bound_ms, bound_by, k2.plan)
    out = {
        "name": "raster_resolve",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/raster_resolve.cu",
        "replaces": "renderer_rs_tpu/ops/raster_pallas.py:87",
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "bound_ms_all_pairs": bound_all,
        "host_syncs": len(syncs),
        **_plan_stats(k2.plan),
    }
    _skip_forms(out, f"K2 {label}", lambda: raster_resolve(*args, plan=k2.plan), counts,
                breakdown=timed)
    if timed:
        def after():
            out["chunk_sweep_ms"] = _chunk_sweep(
                f"K2 {label}", lambda plan: raster_resolve(*args, plan=plan), k2.seg,
                k2.sorted_tris.numel())
            table2, setup2 = _twice(k2.table, geo.setup)

            def twins(op, clear):
                sorted_tris, seg, _nby, nbx, _ = bin_compact(setup2, H, W)
                return ((table2, sorted_tris, seg, nbx, H, W, k2.n_vary, k2.n_flat, op, clear),
                        split_plan(seg, sorted_tris.numel()))

            ties = _check_ties("raster_resolve", label, raster_resolve, raster_resolve_plain,
                               twins, geo.setup.num_triangles)
            out["max_abs_err"] = max(out["max_abs_err"], ties["max_abs_err"])
            out["ms_ties"] = ties["ms"]

        _AFTER.append(after)
    _defer_breakdown(out, label, f"K2 {label}", lambda: raster_resolve(*args, plan=k2.plan))
    return out


def _check_depth(scene, layout, size: int, label: str = "sun map") -> dict:
    """K1 beside its plain version on the sun shadow pass's real inputs,
    with the main path's split plan and with FORCED_CHUNK."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        prepare_depth,
        raster_depth,
        raster_depth_plain,
    )
    from renderer_rs_tpu_torch.renderer.passes import (
        _SHADOW_PIPELINE,
        _shadow_setup,
        shadow_vertex_stage,
    )

    clip = shadow_vertex_stage(scene, layout)
    setup = _shadow_setup(clip, scene.tris, size)
    k1 = prepare_depth([setup], size, size)
    args = (k1.table, k1.sorted_tris, k1.seg, k1.nbx, size, size,
            _SHADOW_PIPELINE.depth_compare_op)
    n_pairs = int(k1.n_pairs)
    densest = int((k1.seg[:, 1:] - k1.seg[:, :-1]).max())
    big, huge = (int(v) for v in k1.bin_overflow[0].tolist())
    _log(f"shadow pass ({label}) {size}x{size}: T={layout.num_triangles} "
         f"valid={int(setup.valid.sum())} "
         f"bins={k1.seg.shape[1] - 1} binned pairs={n_pairs} densest bin={densest} "
         f"bin_overflow big {big} huge {huge} table={tuple(k1.table.shape)}")

    depth = raster_depth(*args, plan=k1.plan)
    forced = raster_depth(*args, chunk=FORCED_CHUNK)
    torch.cuda.synchronize()
    depth_p = raster_depth_plain(*args)
    torch.cuda.synchronize()
    equal = bool(torch.equal(depth.view(torch.int32), depth_p.view(torch.int32)))
    equal_forced = bool(torch.equal(forced.view(torch.int32), depth_p.view(torch.int32)))
    max_abs_err = float((depth - depth_p).abs().max())
    covered = int((depth < 1.0).sum())
    _log(f"raster_depth ({label}) vs plain: depth bit-equal {equal}, with chunk {FORCED_CHUNK} "
         f"{equal_forced} ({_plan_stats(_plan_at(k1, FORCED_CHUNK))}), max |err| "
         f"{max_abs_err:.3e}, covered texels {covered}, depth range [{float(depth.min()):.4f}, "
         f"{float(depth.max()):.4f}]")
    if not (equal and equal_forced and covered > 0 and bool(torch.isfinite(depth).all())):
        raise SystemExit(f"phase kernels: raster_depth disagrees with its plain version ({label})")

    ms = _median(_event_times_ms(lambda: raster_depth(*args, plan=k1.plan), KERNEL_TIMINGS))
    plain_ms = _median(_event_times_ms(lambda: raster_depth_plain(*args), 3, warmup=1))
    walked, pixel_pairs, bins = _walked(k1.seg, k1.nbx, size, size)
    ops = pixel_pairs * DEPTH_OPS_PER_PAIR
    nbytes = k1.table.numel() * 4 + walked * 4 + (bins + 1) * 4 + size * size * 4
    bound_ms, bound_by = _bound(ops, nbytes)
    _log(f"raster_depth ({label}): {ms:.4f} ms (median of {KERNEL_TIMINGS}), plain "
         f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, "
         f"{nbytes:.3e} bytes)")
    _split_log(f"K1 {label}", ms, bound_ms, bound_by, k1.plan)
    out = {
        "name": "raster_depth",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/raster_depth.cu",
        "replaces": "renderer_rs_tpu/ops/raster_pallas.py:203",
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        **_plan_stats(k1.plan),
        "chunk_sweep_ms": _chunk_sweep(f"K1 {label}", lambda plan: raster_depth(*args, plan=plan),
                                       k1.seg, k1.sorted_tris.numel()),
    }
    _defer_breakdown(out, label, f"K1 {label}", lambda: raster_depth(*args, plan=k1.plan))
    return out


def _plan_at(inputs, chunk: int):
    """The split plan of `inputs`' segments (DepthInputs, PeelInputs,
    ResolveInputs, VisibilityInputs) at `chunk`."""
    from renderer_rs_tpu_torch.ops.raster_cuda import split_plan

    return split_plan(inputs.seg, inputs.sorted_tris.numel(), chunk)


def _check_ids(scene, layout, pipeline) -> dict:
    """K4 beside its plain version on the sample passes of MSAA 4x
    (3840x2160) and MSAA 8x (7680x2160, K4's largest launch) of one frame
    (_check_ids_pass); the 4x entry is the kernel's row."""
    cases = {f"msaa{n}": _check_ids_pass(scene, layout, pipeline, n, sx, sy, timed=n == MSAA)
             for n, (sx, sy) in ((MSAA, (SX, SY)), (8, (4, 2)))}
    main = cases[f"msaa{MSAA}"]
    out = {
        "name": "raster_ids",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/raster_ids.cu",
        "replaces": "renderer_rs_tpu/ops/raster_pallas.py:397",
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "host_syncs": sum(c["host_syncs"] for c in cases.values()),
        "cases": cases,
    }

    def after():
        # the ties' maximum error joins the row's once they have run
        out["max_abs_err"] = max(c["max_abs_err"] for c in cases.values())

    _AFTER.append(after)
    return out


def _check_ids_pass(scene, layout, pipeline, samples: int, sx: int, sy: int,
                    timed: bool) -> dict:
    """K4 beside its plain version on one MSAA sample pass (the frame's
    geometry at sx*W x sy*H), with the main path's split plan, with
    FORCED_CHUNK and with the walk's skip off: tid and depth bit-equal.
    Times the kernel, its plain version and the skip on and off; queues its
    device µs by kernel; timed=True also queues the chunk sweep and the
    LE/GE tie tables."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        VIS_COLS,
        bin_compact,
        prepare_ids,
        raster_ids,
        raster_ids_plain,
        split_plan,
    )
    from renderer_rs_tpu_torch.renderer.passes import frame_geometry

    label = f"msaa{samples} sample pass"
    hs, ws = H * sy, W * sx
    geo = frame_geometry(scene, layout, pipeline, W, H).at_extent(pipeline, ws, hs)
    t = layout.num_triangles

    def prepare():
        return prepare_ids(geo.setup, hs, ws, geo.clip_src, small_limit=t, id_bound=t)

    k4 = prepare()
    args = (k4.table, k4.sorted_tris, k4.seg, k4.nbx, hs, ws, pipeline.depth_compare_op)
    n_pairs = int(k4.n_pairs)
    densest = int((k4.seg[1:] - k4.seg[:-1]).max())
    big, huge = (int(v) for v in k4.bin_overflow.tolist())
    one_piece = int((k4.plan.pieces == 1).sum())
    _log(f"{label} {ws}x{hs}: T={t} raster slots={geo.setup.num_triangles} "
         f"bins={k4.seg.numel() - 1} binned pairs={n_pairs} densest bin={densest} "
         f"bin_overflow big {big} huge {huge} table={tuple(k4.table.shape)}; split plan "
         f"{_plan_stats(k4.plan)} ({one_piece} bins of one piece), with chunk {FORCED_CHUNK} "
         f"{_plan_stats(_plan_at(k4, FORCED_CHUNK))}")
    syncs = _syncs(lambda: raster_ids(*args, plan=prepare().plan))
    _log(f"{label}: host syncs of prepare_ids (binning, table, split plan) and the K4 launch: "
         f"{len(syncs)} {syncs}")
    if syncs:
        raise SystemExit(f"phase kernels: the K4 binning or launch synchronizes the host ({label})")
    # bin_overflow is printed, not held to 0: the binning's class caps are
    # the reference's own (max(1024, T/96) big triangles), and at the sample
    # extent more triangles span three bins than the cap keeps
    res = _against_plain("raster_ids", label, raster_ids, raster_ids_plain, args, k4.plan,
                         lanes=False, extra=SKIP_OFF)
    covered = int((res["tid"] >= 0).sum())
    in_range = bool((res["tid"] < t).all())
    _log(f"{label}: covered samples {covered}, ids below T {in_range}")
    if not (in_range and covered > 0):
        raise SystemExit(f"phase kernels: raster_ids covers nothing or writes no source id ({label})")
    max_abs_err = res["max_abs_err"]
    del res

    ms = _median(_event_times_ms(lambda: raster_ids(*args, plan=k4.plan), KERNEL_TIMINGS))
    plain_ms = _median(_event_times_ms(lambda: raster_ids_plain(*args), 3, warmup=1))
    walked, pixel_pairs, bins = _walked(k4.seg, k4.nbx, hs, ws)
    counts = _skip_counts(k4, hs, ws)
    ops = _walk_ops(counts, pixel_pairs, IDS_OPS_PER_PAIR)
    # least time: the walk's f32 ops over the sample grid, against the bytes
    # the function must move once: the 20 columns of every walked row (no
    # more of the table), the walked bins' sorted ids and segments read,
    # depth and tid written
    walked_rows = _walked_rows(k4, walked)
    nbytes = walked_rows * VIS_COLS * 4 + walked * 4 + (bins + 1) * 4 + hs * ws * (4 + 4)
    bound_ms, bound_by = _bound(ops, nbytes)
    bound_all = _bound(pixel_pairs * IDS_OPS_PER_PAIR, nbytes)[0]
    _log(f"{label}: raster_ids {ms:.4f} ms (median of {KERNEL_TIMINGS}), plain {plain_ms:.2f} "
         f"ms, bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes: "
         f"{walked_rows} walked rows of {k4.table.shape[0]}; all pairs {bound_all:.4f} ms)")
    _split_log(f"K4 {label}", ms, bound_ms, bound_by, k4.plan)
    out = dict(samples=samples, extent=[ws, hs], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bound_ms_all_pairs=bound_all, max_abs_err=max_abs_err,
               n_pairs=n_pairs, densest=densest, bin_overflow=[big, huge], covered=covered,
               host_syncs=len(syncs), one_piece_bins=one_piece, **_plan_stats(k4.plan))
    _skip_forms(out, f"K4 {label}", lambda: raster_ids(*args, plan=k4.plan), counts,
                breakdown=True)
    _defer_breakdown(out, "main path", f"K4 {label}", lambda: raster_ids(*args, plan=k4.plan))
    if timed:
        table2, setup2 = _twice(k4.table, geo.setup)
        # the raster slot as payload: the tie check finds each winner's twin
        table2[:-1, 19] = torch.arange(table2.shape[0] - 1, dtype=torch.float32,
                                       device=table2.device)

        def twins(op, clear):
            sorted_tris, seg, _nby, nbx, _ = bin_compact(setup2, hs, ws)
            return ((table2, sorted_tris, seg, nbx, hs, ws, op, clear),
                    split_plan(seg, sorted_tris.numel()))

        def after():
            out["chunk_sweep_ms"] = _chunk_sweep(
                f"K4 {label}", lambda plan: raster_ids(*args, plan=plan), k4.seg,
                k4.sorted_tris.numel())
            ties = _check_ties("raster_ids", label, raster_ids, raster_ids_plain, twins,
                               geo.setup.num_triangles, dropped_ok=True)
            out["max_abs_err"] = max(out["max_abs_err"], ties["max_abs_err"])
            out["ms_ties"] = ties["ms"]

        _AFTER.append(after)
    return out


def _check_depth_batch(scene, layout, size: int) -> dict:
    """K6: the four cascades in ONE raster_depth launch, beside the plain
    version (with the main path's split plan and with FORCED_CHUNK) and
    beside four single launches, on the cascade pass's inputs as the
    Renderer's shadow step builds them."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        prepare_depth,
        raster_depth,
        raster_depth_plain,
    )
    from renderer_rs_tpu_torch.renderer.passes import (
        _SHADOW_PIPELINE,
        _shadow_setup,
        shadow_vertex_stage,
    )

    op = _SHADOW_PIPELINE.depth_compare_op
    setups = [
        _shadow_setup(shadow_vertex_stage(scene, layout, m), scene.tris, size)
        for m in scene.csm_matrices
    ]
    k6 = prepare_depth(setups, size, size)
    args = (k6.table, k6.sorted_tris, k6.seg, k6.nbx, size, size, op)
    n_pairs = int(k6.n_pairs)
    per_set = (k6.seg[:, -1] - k6.seg[:, 0]).tolist()
    densest = (k6.seg[:, 1:] - k6.seg[:, :-1]).amax(1).tolist()
    overflow = k6.bin_overflow.tolist()
    _log(f"cascade pass 4 x {size}x{size}: T={layout.num_triangles} "
         f"valid={[int(s.valid.sum()) for s in setups]} bins={k6.seg.shape[1] - 1} per set, "
         f"binned pairs={n_pairs} (per cascade {per_set}) densest bin per cascade {densest} "
         f"bin_overflow [big, huge] per cascade {overflow} table={tuple(k6.table.shape)}")

    before = raster_depth.batched_launches
    depth = raster_depth(*args, plan=k6.plan)
    torch.cuda.synchronize()
    if raster_depth.batched_launches != before + 1:
        raise SystemExit("phase kernels: the N = 4 launch was not counted as batched")
    forced = raster_depth(*args, chunk=FORCED_CHUNK)
    # the plain walk of the cascades takes seconds: it runs once, timed
    depth_p, plain_ms = _timed_once(lambda: raster_depth_plain(*args))
    singles = []
    for setup in setups:
        k1 = prepare_depth([setup], size, size)
        singles.append(raster_depth(k1.table, k1.sorted_tris, k1.seg, k1.nbx, size, size, op)[0])
    torch.cuda.synchronize()
    equal = bool(torch.equal(depth.view(torch.int32), depth_p.view(torch.int32)))
    equal_forced = bool(torch.equal(forced.view(torch.int32), depth_p.view(torch.int32)))
    equal_singles = bool(torch.equal(depth.view(torch.int32),
                                     torch.stack(singles).view(torch.int32)))
    max_abs_err = float((depth - depth_p).abs().max())
    covered = [int((d < 1.0).sum()) for d in depth]
    _log(f"raster_depth N=4 vs plain: depth bit-equal {equal}, with chunk {FORCED_CHUNK} "
         f"{equal_forced} ({_plan_stats(_plan_at(k6, FORCED_CHUNK))}); vs four N=1 launches: "
         f"bit-equal {equal_singles}; max |err| {max_abs_err:.3e}, covered texels per cascade "
         f"{covered}")
    if not (equal and equal_forced and equal_singles and min(covered) > 0
            and bool(torch.isfinite(depth).all())):
        raise SystemExit("phase kernels: the batched raster_depth launch disagrees")
    # the binning, the tables, the plan and the launch must not wait for the
    # device: the frames are host-bound
    syncs = _syncs(lambda: raster_depth(*args, plan=prepare_depth(setups, size, size).plan))
    _log(f"host syncs of prepare_depth (4 cascades: binning, tables, split plan) and the K6 "
         f"launch: {syncs}")
    if syncs:
        raise SystemExit("phase kernels: the cascade pass's binning or K6 launch synchronizes "
                         "the host")

    ms = _median(_event_times_ms(lambda: raster_depth(*args, plan=k6.plan), KERNEL_TIMINGS))
    walked, pixel_pairs, bins = _walked(k6.seg, k6.nbx, size, size)
    ops = pixel_pairs * DEPTH_OPS_PER_PAIR
    nbytes = k6.table.numel() * 4 + walked * 4 + (bins + 4) * 4 + 4 * size * size * 4
    bound_ms, bound_by = _bound(ops, nbytes)
    _log(f"raster_depth N=4: {ms:.4f} ms (median of {KERNEL_TIMINGS}), plain {plain_ms:.2f} ms, "
         f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes)")
    _split_log("K6 cascades", ms, bound_ms, bound_by, k6.plan)
    sweep = _chunk_sweep("K6 cascades", lambda plan: raster_depth(*args, plan=plan), k6.seg,
                         k6.sorted_tris.numel())
    out = {
        "name": "raster_depth_batch",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/raster_depth.cu",
        "replaces": "renderer_rs_tpu/ops/raster_pallas.py:646",
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        **_plan_stats(k6.plan),
        "chunk_sweep_ms": sweep,
    }
    _defer_breakdown(out, "cascades", "K6 cascades", lambda: raster_depth(*args, plan=k6.plan))
    return out


def _check_zplane(scene, layout, size: int, cascades: bool, sun_map: dict | None = None) -> dict:
    """K7: the z-plane form of raster_depth on the sun map's inputs (one
    set) or the four cascades' (one N = 4 launch), beside its plain version
    (bit-equal, with the main path's split plan and with FORCED_CHUNK) and
    beside K1/K6 on the same setups (the same covered texels, depth within
    ZPLANE_VS_BARY: the JAX contract). Given the sun map's entry
    `sun_map`, which the kernels line carries, the device times go there."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        prepare_depth,
        raster_depth,
        raster_depth_plain,
    )
    from renderer_rs_tpu_torch.renderer.passes import (
        _SHADOW_PIPELINE,
        _shadow_setup,
        shadow_vertex_stage,
    )

    op = _SHADOW_PIPELINE.depth_compare_op
    mats = list(scene.csm_matrices) if cascades else [scene.light_space_matrix]
    label = "cascades" if cascades else "sun map"
    setups = [_shadow_setup(shadow_vertex_stage(scene, layout, m), scene.tris, size)
              for m in mats]
    k7 = prepare_depth(setups, size, size, zplane=True)
    args = (k7.table, k7.sorted_tris, k7.seg, k7.nbx, size, size, op)
    n_pairs = int(k7.n_pairs)
    densest = (k7.seg[:, 1:] - k7.seg[:, :-1]).amax(1).tolist()
    _log(f"K7 {label} {len(mats)} x {size}x{size}: binned pairs={n_pairs} densest bin {densest} "
         f"table={tuple(k7.table.shape)}")
    before = raster_depth.zplane_launches
    depth = raster_depth(*args, zplane=True, plan=k7.plan)
    torch.cuda.synchronize()
    if raster_depth.zplane_launches != before + 1:
        raise SystemExit("phase kernels: the z-plane launch was not counted as K7")
    forced = raster_depth(*args, zplane=True, chunk=FORCED_CHUNK)
    # the plain walk of the cascades takes seconds: it runs once, timed
    depth_p, plain_once_ms = _timed_once(lambda: raster_depth_plain(*args, zplane=True))
    k1 = prepare_depth(setups, size, size)
    bary = raster_depth(k1.table, k1.sorted_tris, k1.seg, k1.nbx, size, size, op)
    torch.cuda.synchronize()
    equal = bool(torch.equal(depth.view(torch.int32), depth_p.view(torch.int32)))
    equal_forced = bool(torch.equal(forced.view(torch.int32), depth_p.view(torch.int32)))
    max_abs_err = float((depth - depth_p).abs().max())
    covered = [int((d < 1.0).sum()) for d in depth]
    same_cov = bool(torch.equal(depth < 1.0, bary < 1.0))
    vs_bary = float((depth - bary).abs().max())
    _log(f"K7 {label} vs plain: depth bit-equal {equal}, with chunk {FORCED_CHUNK} "
         f"{equal_forced} ({_plan_stats(_plan_at(k7, FORCED_CHUNK))}), max |err| "
         f"{max_abs_err:.3e}, covered texels {covered}; vs the bary form (K1/K6): same texels "
         f"{same_cov}, max |d| {vs_bary:.3e}, texels differing {int((depth != bary).sum())}")
    if not (equal and equal_forced and min(covered) > 0 and bool(torch.isfinite(depth).all())):
        raise SystemExit(f"phase kernels: the z-plane raster_depth disagrees with its plain "
                         f"version ({label})")
    if not (same_cov and vs_bary <= ZPLANE_VS_BARY):
        raise SystemExit(f"phase kernels: the z-plane depth breaks the JAX contract against "
                         f"the bary form ({label})")
    ms = _median(_event_times_ms(lambda: raster_depth(*args, zplane=True, plan=k7.plan),
                                 KERNEL_TIMINGS))
    plain_ms = plain_once_ms if cascades else _median(
        _event_times_ms(lambda: raster_depth_plain(*args, zplane=True), 3, warmup=1))
    walked, pixel_pairs, bins = _walked(k7.seg, k7.nbx, size, size)
    ops = pixel_pairs * ZPLANE_OPS_PER_PAIR
    nbytes = (k7.table.shape[0] * k7.table.shape[1] * ZPLANE_COLS * 4 + walked * 4
              + (bins + len(mats)) * 4 + len(mats) * size * size * 4)
    bound_ms, bound_by = _bound(ops, nbytes)
    _log(f"K7 {label}: {ms:.4f} ms (median of {KERNEL_TIMINGS}), plain {plain_ms:.2f} ms, "
         f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes)")
    _split_log(f"K7 {label}", ms, bound_ms, bound_by, k7.plan)
    sweep = _chunk_sweep(f"K7 {label}", lambda plan: raster_depth(*args, zplane=True, plan=plan),
                         k7.seg, k7.sorted_tris.numel())
    out = {
        "name": "raster_depth_zplane",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/raster_depth.cu",
        "replaces": "renderer_rs_tpu/ops/raster_pallas.py:234",
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "n_pairs": n_pairs,
        "vs_bary_max_abs": vs_bary,
        **_plan_stats(k7.plan),
        "chunk_sweep_ms": sweep,
    }
    _defer_breakdown(out if sun_map is None else sun_map, label, f"K7 {label}",
                     lambda: raster_depth(*args, zplane=True, plan=k7.plan),
                     "device_ms" if sun_map is None else "device_ms_cascades")
    return out


def _check_probe() -> dict:
    """The gather probe: each body's kernel against its plain version at
    PROBE_CHECK_ITERS iterations (bit-equal), then its plain time at
    PROBE_ITERS iterations; the kernel times come from the probe's own path
    (phase_main_paths)."""
    import torch

    from renderer_rs_tpu_torch.probes.kgather import BODIES, kgather, probe_inputs, run_plain

    slab, p = probe_inputs("cuda")
    equal, plain_ms = {}, 0.0
    for body in BODIES:
        out = kgather(body, slab, p, PROBE_CHECK_ITERS)
        torch.cuda.synchronize()
        ref = run_plain(body, slab, p, PROBE_CHECK_ITERS)
        equal[body] = bool(torch.equal(out.view(torch.int32), ref.view(torch.int32)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_plain(body, slab, p, PROBE_ITERS)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
    _log(f"probe_kgather vs plain at {PROBE_CHECK_ITERS} iterations: bit-equal {equal}; plain, "
         f"the five bodies at {PROBE_ITERS} iterations: {plain_ms:.2f} ms")
    if not all(equal.values()):
        raise SystemExit("phase kernels: probe_kgather disagrees with its plain version")
    # least time of the five launches at PROBE_ITERS: the f32 ops per output
    # and iteration (t_only, g_only: the offset and the sum; g8, g50: 2 per
    # term; msum: 128 compares, multiplies and adds, and the sum) over the
    # card, against the inputs read and the outputs written once
    ops = 16 * 128 * PROBE_ITERS * (2 + 2 + 16 + 100 + 128 * 3 + 1)
    nbytes = len(BODIES) * (128 * 128 * 4 + 16 * 128 * 4 * 2)
    bound_ms, bound_by = _bound(ops, nbytes)
    return {
        "name": "probe_kgather",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/probe_kgather.cu",
        "replaces": "probes/probe_kgather.py:38",
        "max_abs_err": 0.0,
        "ms": None,  # set from the probe's path
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
    }


# the fused shade against its plain version, after the frame's tonemap:
# the largest difference the pair showed on the 1080p headline frame is
# 1.9e-5 (PR 19); a flipped PCF tap or a wrong texel moves a value by 1e-2
# or more. The linear values are only logged: they differ by up to 1.3e-3 on
# 2.3e-5 of them (PR 19), each at a linear value of 1.39 or more, where the
# tonemap flattens.
SHADE_TOL = 1e-4


def _check_shade(scene, layout, kw, cascades: bool = False) -> dict:
    """The fused shade (ops/shade_cuda.py) on the 1080p headline frame's
    own inputs (K2's outputs, the sun map or with `cascades` the four
    [1024,1024] cascades fitted to its camera, the default rates: PCF
    every 4th row, the cube every 2nd) beside its plain version, with the
    host syncs of the launch; its time, the plain version's, that of the
    ATen chain it replaces on the unfused frame (pixel_ray_directions,
    _shade_pixels, the clear colour's upload and both composites), and the
    bound: the bytes a pixel reads and writes once (68 + 16), and the
    cascades read once."""
    import torch

    from renderer_rs_tpu_torch.ops.shade_cuda import shade_fused, shade_fused_plain
    from renderer_rs_tpu_torch.ops.skybox import pixel_ray_directions
    from renderer_rs_tpu_torch.ops.tonemap import apply_tonemap
    from renderer_rs_tpu_torch.renderer import passes as P

    pipeline, params, shading = kw["pipeline"], kw["shadow_params"], kw["shading"]
    geo = P.frame_geometry(scene, layout, pipeline, W, H)
    if cascades:
        # as forward_frame renders them: from the forward stage's world positions
        smap = P.csm_shadow_pass(scene, layout, kw["shadow_map_size"],
                                 world_pos=geo.attr[:, :3])
    else:
        smap = P.shadow_map_pass(scene, layout, kw["shadow_map_size"])
    depth, tri_id, mat_id, lanes, _ = P._fused_raster(scene, layout, geo, pipeline, H, W, 1.0,
                                                      None)
    inv_vp = torch.linalg.inv(scene.camera.view_projection)
    clear = (0.1, 0.1, 0.15, 1.0)
    rates = P.ShadeRates()
    label = "headline with cascades" if cascades else "headline (textured, IBL)"
    if not P._fused_shade_engages(scene, layout, shading, smap, params, rates):
        raise SystemExit(f"phase kernels: the {label} frame does not engage the fused shade")
    inp = P._shade_fused_inputs(scene, layout, smap, params, inv_vp, clear)
    sp, sc = P._pcf_stride(H, True, rates.pcf), P._cube_stride(H, True, rates.cube)
    args = (depth, tri_id, mat_id, lanes, inp, sp, sc)
    if (sp, sc) != (4, 2):
        raise SystemExit(f"phase kernels: the headline rates give strides {(sp, sc)}, not (4, 2)")

    def aten():
        sky = pixel_ray_directions(inv_vp, H, W, 0, H, 1, False)
        color, sky_rgb = P._shade_pixels(scene, layout, shading, lanes, mat_id, shadow_map=smap,
                                         shadow_params=params, depth=depth, tri_id=tri_id,
                                         sky_dirs=sky, rates=rates)
        bg = torch.tensor(clear, dtype=torch.float32, device=depth.device)
        out = torch.where((tri_id >= 0)[..., None], color, bg)
        sky_rgba = torch.cat([sky_rgb, torch.ones_like(sky_rgb[..., :1])], dim=-1)
        return torch.where((depth >= 1.0)[..., None], sky_rgba, out)

    syncs = _syncs(lambda: shade_fused(*args))
    n0 = shade_fused.launches
    got = shade_fused(*args)
    launches = shade_fused.launches - n0
    ref = shade_fused_plain(*args)
    tone = kw["tonemap"]
    d_lin = (got - ref).abs()
    d = (apply_tonemap(got, tone) - apply_tonemap(ref, tone)).abs()
    max_abs_err = float(d.max())
    d_aten = (apply_tonemap(got, tone) - apply_tonemap(aten(), tone)).abs().amax(-1)
    far = d_lin > 1e-4
    finite = bool(torch.isfinite(got).all())
    ms = _median(_event_times_ms(lambda: shade_fused(*args), KERNEL_TIMINGS))
    plain_ms = _median(_event_times_ms(lambda: shade_fused_plain(*args), 3, warmup=1))
    aten_ms = _median(_event_times_ms(aten, 5, warmup=1))
    nbytes = H * W * (68 + 16) + (smap.numel() * 4 if cascades else 0)
    bound_ms, bound_by = _bound(0.0, nbytes)
    _log(f"{label}: shade_fused{' cascade form' if cascades else ''}, strides {(sp, sc)}, "
         f"{launches} launches a call, host syncs {len(syncs)} {syncs}; vs plain after the "
         f"{tone} tonemap max |d| {max_abs_err:.3e}, linear max |d| {float(d_lin.max()):.3e}, "
         f"linear values beyond 1e-4 {int(far.sum())} of {d.numel()} (the least |value| of "
         f"those {float(ref.abs()[far].min()) if bool(far.any()) else None}); vs the ATen "
         f"chain after the tonemap max |d| {float(d_aten.max()):.3e}, pixels beyond 1e-3 "
         f"{int((d_aten > 1e-3).sum())} of {d_aten.numel()}; finite {finite}; {ms:.4f} ms "
         f"(median of {KERNEL_TIMINGS}), plain {plain_ms:.2f} ms, the ATen chain "
         f"{aten_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes:.3e} bytes)")
    if not max_abs_err <= SHADE_TOL or not finite or launches != 2 or syncs:
        raise SystemExit(f"phase kernels: shade_fused on the {label} frame disagrees with its "
                         "plain version, is not finite, syncs the host or is not the "
                         "two-launch pair")
    return {
        "name": "shade_fused",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/shade_fused.cu",
        "replaces": "renderer_rs_tpu/renderer/passes.py:429-1313 (XLA, no Pallas kernel)",
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "aten_ms": aten_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "host_syncs": len(syncs),
    }


def _clipping_scene():
    """A camera on the top of a UV sphere at 1920x1080 (1,154 triangles
    with its floor): its near plane cuts triangles with one and with two
    vertices behind (tests/test_torch_front_end_kernel.py's clipping scene)."""
    import numpy as np

    from renderer_rs_tpu_torch.app.scenes import _camera_ubo
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.resources.material import Material
    from renderer_rs_tpu_torch.scene.camera import Camera, Projection
    from renderer_rs_tpu_torch.utils.meshgen import plane_mesh, uv_sphere_mesh

    cam = Camera(Projection.perspective(math.radians(70), W / H, 0.1, 50.0))
    cam.position = np.array([0.0, 1.0, 0.0], np.float32)
    cam.look_at([0.0, 0.0, -4.0])
    b = SceneBuilder()
    b.add_mesh(uv_sphere_mesh(1.0, 24, 24))
    b.add_mesh(plane_mesh(40.0), material=Material(base_color=(1.0, 0.2, 0.2, 1.0),
                                                   roughness=0.9))
    b.set_camera(_camera_ubo(cam))
    return b.build(device="cuda")


def _headline_orbit_scene(scene, angle: float):
    """The headline scene under its own camera (bench_port/traffic/orbit.json:
    the eye 5 units out and 3 up, looking at the origin, full_scene's lens)
    at `angle`; at 5 pi / 4 the floor's corner 0 alone lies behind the near
    plane, so both floor triangles are cut into quads."""
    import numpy as np

    from renderer_rs_tpu_torch.app.scenes import _camera_ubo, _orbit_camera

    cam = _orbit_camera(W, H, distance=5.0, height_y=3.0, fov=50.0)
    cam.position = np.array([5.0 * math.sin(angle), 3.0, 5.0 * math.cos(angle)], np.float32)
    cam.look_at([0.0, 0.0, 0.0])
    return scene.replace(camera=_camera_ubo(cam).to(scene.device))


def _traced_chain(scene, layout, pipeline, cap):
    """passes.frame_geometry_chain inside a traced frame record, where it
    computes the clip's counters (clip_counts) too."""
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.renderer import passes as P

    profiling.enable_tracing(True)
    try:
        with profiling.frame():
            return P.frame_geometry_chain(scene, layout, pipeline, W, H, cap)
    finally:
        profiling.enable_tracing(False)


def _front_end_diffs(fe, geo, clip) -> tuple[dict, float]:
    """The front end's outputs `fe` against the ATen chain's FrameGeometry
    `geo` and vertex clip positions `clip`: (field -> elements whose bits
    differ, the largest |difference| of the float fields)."""
    import torch

    pairs = {"clip": (fe.clip, clip), "attr": (fe.attr, geo.attr),
             "tri_clip": (fe.tri_clip, geo.tri_clip), "clip_valid": (fe.clip_valid, geo.clip_valid),
             "clip_src": (fe.clip_src, geo.clip_src),
             "clip_overflow": (fe.clip_overflow, geo.clip_overflow),
             "clip_counts": (fe.clip_counts, geo.clip_counts),
             "mat_flat": (fe.mat_flat, geo.mat_flat)}
    pairs.update({f"plane {i}{j}": (fe.clip_planes[i][j], geo.clip_planes[i][j])
                  for i in range(3) for j in range(3)})
    pairs.update({f"setup.{f}": (getattr(fe.setup, f), getattr(geo.setup, f))
                  for f in ("xy", "z", "w", "area2", "valid")})
    diffs, max_abs = {}, 0.0
    for name, (a, b) in pairs.items():
        if a.shape != b.shape or a.dtype != b.dtype:
            diffs[name] = -1
            continue
        fa, fb = (a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.float32 else (a, b)
        diffs[name] = int((fa != fb).sum())
        if a.dtype == torch.float32 and a.numel():
            max_abs = max(max_abs, float((a - b).abs().nan_to_num(0.0).max()))
    return diffs, max_abs


def _device_ms(fn, n: int) -> list[float]:
    """fn's device time in ms, n times: each call queued behind a sleep on
    the stream, so the host's enqueue is done before its first kernel runs
    and the events hold the kernels alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms of the card's clock
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _check_front_end(scene, layout, pipeline) -> dict:
    """The front-end kernels (ops/front_end.py) against the ATen chain
    (passes.frame_geometry_chain: the near clip's plane form, the main
    path's) on the same inputs, every output field bit-equal, the clip's
    counters (clip_overflow, near_clipped) included: on the 1080p headline
    scene with compaction on (the cells' shape: T >= CLIP_COMPACT_MIN_TRIS,
    cap max(128, T/16)), timed, with the launches and host syncs of a call;
    on the headline scene at its own camera, the orbit 5 units out at an
    angle where the near plane cuts both floor triangles, with compaction
    on and at a cap of 1, which overflows; then on a camera whose near
    plane cuts triangles with one and with two vertices behind
    (_clipping_scene) with compaction off and with a cap of 5, which
    overflows. Its ms is the device time of the three launches
    (_device_ms), its wrapper_ms the call with its host side; plain_ms is
    the ATen chain's call; the bound is the bytes of the inputs read once
    and the outputs written once."""
    import torch

    from renderer_rs_tpu_torch.ops.front_end import front_end
    from renderer_rs_tpu_torch.renderer import passes as P

    t = layout.num_triangles
    if t < P.CLIP_COMPACT_MIN_TRIS:
        raise SystemExit(f"phase kernels: the headline scene has {t} triangles, below the "
                         "compaction's minimum")
    cap = max(128, t // P.CLIP_COMPACT_DEN)
    def behind(sc, lay):
        z = P.vertex_stage(sc, lay).clip[sc.tris][..., 2]
        n = (z < 0.0).sum(-1)
        return int((n == 1).sum()), int((n == 2).sum())

    orbit = _headline_orbit_scene(scene, 1.25 * math.pi)
    orbit_one, orbit_two = behind(orbit, layout)
    clip_scene, clip_layout = _clipping_scene()
    one, two = behind(clip_scene, clip_layout)
    if not (one > 5 and two > 0 and orbit_one == 2):
        raise SystemExit(f"phase kernels: the clipping camera cuts {one} triangles with one "
                         f"vertex behind and {two} with two, the headline orbit {orbit_one} "
                         "with one; the check needs > 5, > 0 and 2")
    cases = (("headline, compaction on", scene, layout, cap, 0, 0),
             ("headline orbit 5 out, compaction on", orbit, layout, cap, orbit_one + orbit_two,
              0),
             ("headline orbit 5 out, cap 1 (overflows)", orbit, layout, 1,
              orbit_one + orbit_two, orbit_one - 1),
             ("near plane cuts, no compaction", clip_scene, clip_layout, None, one + two, 0),
             ("near plane cuts, cap 5 (overflows)", clip_scene, clip_layout, 5, one + two,
              one - 5))
    ok, max_abs_err, launches = True, 0.0, {}
    for label, sc, lay, c, cut, overflow in cases:
        n0 = front_end.launches
        fe = front_end(sc, lay, pipeline, W, H, c)
        launches[label] = front_end.launches - n0
        geo = _traced_chain(sc, lay, pipeline, c)
        diffs, err = _front_end_diffs(fe, geo, P.vertex_stage(sc, lay).clip)
        max_abs_err = max(max_abs_err, err)
        bad = {k: v for k, v in diffs.items() if v}
        over, clipped = (int(x) for x in fe.clip_counts)
        _log(f"front_end ({label}): T={lay.num_triangles} slots={fe.setup.num_triangles}, "
             f"{launches[label]} launches, clip_overflow {over}, near_clipped {clipped}, "
             f"valid slots {int(fe.clip_valid.sum())}; vs the ATen chain every field "
             f"bit-equal {not bad}{'' if not bad else f', differing elements {bad}'}")
        ok = (ok and not bad and launches[label] == (2 if c is None else 3)
              and (over, clipped) == (overflow, cut))
    def run():
        return front_end(scene, layout, pipeline, W, H, cap)

    syncs = _syncs(run)
    if not ok or syncs:
        raise SystemExit("phase kernels: the front end disagrees with the ATen chain, "
                         "launches other than 2 (no compaction) or 3, misses the overflow "
                         f"or the cut triangles, or syncs the host ({syncs})")
    ms = _median(_device_ms(run, KERNEL_TIMINGS))
    wrapper_ms = _median(_event_times_ms(run, KERNEL_TIMINGS))
    plain_ms = _median(_event_times_ms(
        lambda: P.frame_geometry_chain(scene, layout, pipeline, W, H, cap), 5, warmup=1))
    v, n = scene.positions.shape[0], t + cap
    k = 6 if not layout.has_textures else 12 if layout.texture_slots[1] else 8
    lanes_in = 3 + 3 + (2 if layout.has_textures else 0) + (4 if k == 12 else 0)
    # read: the vertex lanes, the indices, the object matrices and starts;
    # written: clip positions and attribute rows, and per raster slot
    # tri_clip 48, planes 36, xy 24, z 12, area2 4, valid 1, clip_valid 1, src 8
    nbytes = (v * 4 * (lanes_in + 4 + k) + t * 24 + len(layout.object_ranges) * (128 + 4) + 64
              + n * 134 + 8)
    bound_ms, bound_by = _bound(0.0, nbytes)
    _log(f"front_end (headline, compaction on): {ms:.4f} ms device (median of "
         f"{KERNEL_TIMINGS}, queued behind a sleep), the call {wrapper_ms:.4f} ms, host syncs "
         f"{len(syncs)}; the ATen chain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms by "
         f"{bound_by} ({nbytes:.3e} bytes); max |d| {max_abs_err:.3e}")
    torch.cuda.synchronize()
    return {
        "name": "front_end",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/front_end.cu",
        "replaces": "renderer_rs_tpu/renderer/passes.py:122-202, :1612-1766 (XLA, no Pallas "
                    "kernel)",
        "max_abs_err": max_abs_err,
        "ms": ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "host_syncs": len(syncs),
        "launches_a_call": launches,
    }


def _check_peel(scene, layout, pipeline) -> dict:
    """K5 beside its plain version on the MASK frame's table, with the main
    path's split plan and with FORCED_CHUNK: the layer-0 launch (no floor),
    a launch with the layer-0 depth as every pixel's floor (the whole frame
    peels to its next-nearest fragment), an all-+inf floor (layers 1-3 of
    an alpha-1.0 frame: nothing competes), and the LE and GE tie cases on
    the table with every raster slot twice."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        bin_compact,
        raster_peel,
        raster_peel_plain,
        split_plan,
    )
    from renderer_rs_tpu_torch.renderer.passes import frame_geometry, peel_inputs

    geo = frame_geometry(scene, layout, pipeline, W, H)
    k5 = peel_inputs(scene, layout, geo, H, W)
    base = (k5.table, k5.sorted_tris, k5.seg, k5.nbx, H, W, k5.n_vary, k5.n_flat)
    n_pairs = int(k5.n_pairs)
    densest = int((k5.seg[1:] - k5.seg[:-1]).max())
    big, huge = (int(v) for v in k5.bin_overflow.tolist())
    _log(f"mask frame: T={layout.num_triangles} raster slots={geo.setup.num_triangles} "
         f"bins={k5.seg.numel() - 1} binned pairs={n_pairs} densest bin={densest} "
         f"bin_overflow big {big} huge {huge} table={tuple(k5.table.shape)}; split plan "
         f"{_plan_stats(k5.plan)}, with chunk {FORCED_CHUNK} {_plan_stats(_plan_at(k5, FORCED_CHUNK))}")
    depth0, tid0, _ = raster_peel(*base, None, pipeline.depth_compare_op, plan=k5.plan)
    syncs = _syncs(lambda: raster_peel(*base, None, pipeline.depth_compare_op,
                                       plan=peel_inputs(scene, layout, geo, H, W).plan))
    _log(f"host syncs of peel_inputs (binning, table, split plan) and the K5 launch: {syncs}")
    if syncs:
        raise SystemExit("phase kernels: the MASK frame's binning or K5 launch synchronizes "
                         "the host")
    inf = torch.full_like(depth0, float("inf"))
    floor = torch.where(tid0 >= 0, depth0, inf)
    cases = {"no floor": None, "layer-0 floor": floor, "all +inf floor": inf}
    counts = _skip_counts(k5, H, W)
    max_abs_err, timings, covered, launches, skip = 0.0, {}, {}, {}, {}
    for label, z_floor in cases.items():
        args = (*base, z_floor, pipeline.depth_compare_op)
        err = _against_plain("raster_peel", label, raster_peel, raster_peel_plain, args,
                             k5.plan, lanes=True, extra=SKIP_OFF)
        max_abs_err = max(max_abs_err, err["max_abs_err"])
        hit = err["tid"] >= 0
        covered[label] = int(hit.sum())
        above = bool((err["depth"][hit] > floor[hit]).all()) if z_floor is not None else True
        if not above or (covered[label] > 0) != (z_floor is not inf):
            raise SystemExit(f"phase kernels: raster_peel ({label}) covers {covered[label]} "
                             f"pixels, strictly above the floor {above}")
        ms = _median(_event_times_ms(lambda args=args: raster_peel(*args, plan=k5.plan),
                                     KERNEL_TIMINGS))
        plain_ms = (_median(_event_times_ms(lambda args=args: raster_peel_plain(*args), 3,
                                            warmup=1))
                    if z_floor is not inf else None)
        # least time: the walk's ops (one more compare with a floor) and the
        # winner epilogue's, against the bytes the function must move once:
        # the 19 walk columns of every binned row and the rest of every
        # winning row (no more of the table), the sorted ids, segments, the
        # floor, and depth, tid and lanes written
        walked, pixel_pairs, bins = _walked(k5.seg, k5.nbx, H, W)
        per_pair = PEEL_OPS_PER_PAIR if z_floor is not None else OPS_PER_PAIR
        ops = (_walk_ops(counts, pixel_pairs, per_pair)
               + covered[label] * PEEL_OPS_PER_PIXEL)
        ops_all = pixel_pairs * per_pair + covered[label] * PEEL_OPS_PER_PIXEL
        n_cols = k5.table.shape[1]
        binned_rows = _walked_rows(k5, walked)
        winner_rows = _peel_winner_rows(k5, z_floor, pipeline.depth_compare_op)
        nbytes = (binned_rows * WALK_COLS * 4 + winner_rows * (n_cols - WALK_COLS) * 4
                  + walked * 4 + (bins + 1) * 4
                  + (H * W * 4 if z_floor is not None else 0)
                  + H * W * (4 + 4 + 4 * (k5.n_vary + k5.n_flat)))
        bound_ms, bound_by = _bound(ops, nbytes)
        bound_all = _bound(ops_all, nbytes)[0]
        timings[label] = (ms, plain_ms, bound_ms, bound_by, ops, nbytes, bound_all)
        _log(f"raster_peel ({label}): {ms:.4f} ms (median of {KERNEL_TIMINGS})"
             + ("" if plain_ms is None else f", plain {plain_ms:.2f} ms")
             + f", bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes: "
             f"{binned_rows} binned rows of {k5.table.shape[0]}, {winner_rows} winning rows; "
             f"all pairs {bound_all:.4f} ms)")
        if label != "all +inf floor":
            _split_log(f"K5 {label}", ms, bound_ms, bound_by, k5.plan)
        launches[label] = lambda args=args: raster_peel(*args, plan=k5.plan)
        _skip_forms(skip, f"K5 {label}", launches[label], counts,
                    breakdown=label != "no floor")
    sweep = _chunk_sweep("K5 layer-0 floor",
                         lambda plan: raster_peel(*base, floor, pipeline.depth_compare_op,
                                                  plan=plan),
                         k5.seg, k5.sorted_tris.numel())
    table2, setup2 = _twice(k5.table, geo.setup)

    def twins(op, clear):
        sorted_tris, seg, _nby, nbx, _ = bin_compact(setup2, H, W)
        return ((table2, sorted_tris, seg, nbx, H, W, k5.n_vary, k5.n_flat, None, op, clear),
                split_plan(seg, sorted_tris.numel()))

    ties = _check_ties("raster_peel", "mask frame", raster_peel, raster_peel_plain, twins,
                       geo.setup.num_triangles)
    max_abs_err = max(max_abs_err, ties["max_abs_err"])
    ms, plain_ms, bound_ms, bound_by, _, _, bound_all = timings["layer-0 floor"]
    out = {
        "name": "raster_peel",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/raster_peel.cu",
        "replaces": "renderer_rs_tpu/ops/raster_pallas.py:87",
        "max_abs_err": max_abs_err,
        "ms": ms,  # the floored launch: layers 1-3 of the peel take this form
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "bound_ms_all_pairs": bound_all,
        "ms_no_floor": timings["no floor"][0],
        "bound_ms_no_floor": timings["no floor"][2],
        "ms_inf_floor": timings["all +inf floor"][0],
        "bound_ms_inf_floor": timings["all +inf floor"][2],
        **_plan_stats(k5.plan),
        "chunk_sweep_ms": sweep,
        "ms_ties": ties["ms"],
        "skip": skip["skip"],
    }
    for label, launch in launches.items():
        _defer_breakdown(out, label, f"K5 {label}", launch,
                         "device_ms" if label == "layer-0 floor" else None)
    return out


def _peel_winner_rows(k5, z_floor, compare_op) -> int:
    """The distinct table rows that win a pixel in this K5 launch: the rows
    whose lane columns the function must read."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import _unstitch, _walk_plain

    floor_bins = (None if z_floor is None
                  else _unstitch(z_floor, k5.seg.numel() - 1, k5.nbx, float("inf")))
    _, win, _, _ = _walk_plain(k5.table, k5.sorted_tris, k5.seg, k5.nbx, compare_op, 1.0,
                               floor_bins)
    return int(torch.unique(win[win >= 0]).numel())


def phase_kernels(directory: str) -> tuple[dict, tuple, tuple, tuple]:
    """Every kernel beside its plain version; returns the kernels' entries,
    the headline scene, the glTF headline scene and the many-material scene
    (each (scene, layout, kw)), built once for this phase and the main
    paths; the dancer-class model is written into `directory`."""
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene, full_scene

    scene, layout, kw, _ = blinnphong_scene(W, H, device="cuda", **BLINNPHONG)
    k2 = _check_resolve("blinnphong flagship", scene, layout, kw["pipeline"], timed=True)
    scene, layout, kw, _ = full_scene(W, H, device="cuda", **FULL)
    k1 = _check_depth(scene, layout, kw["shadow_map_size"])
    k7 = _check_zplane(scene, layout, kw["shadow_map_size"], cascades=False)
    k2_pbr = _check_resolve("pbr flagship", scene, layout, kw["pipeline"], timed=False)
    k4 = _check_ids(scene, layout, kw["pipeline"])
    scene, layout, kw, _ = full_scene(W, H, device="cuda", csm=True, **FULL)
    k6 = _check_depth_batch(scene, layout, kw["shadow_map_size"])
    k7_csm = _check_zplane(scene, layout, kw["shadow_map_size"], cascades=True, sun_map=k7)
    k7.update(ms_cascades=k7_csm["ms"], plain_ms_cascades=k7_csm["plain_ms"],
              bound_ms_cascades=k7_csm["bound_ms"], n_pairs_cascades=k7_csm["n_pairs"],
              items_cascades=k7_csm["items"], longest_piece_cascades=k7_csm["longest_piece"],
              chunk_sweep_ms_cascades=k7_csm["chunk_sweep_ms"],
              max_abs_err=max(k7["max_abs_err"], k7_csm["max_abs_err"]),
              vs_bary_max_abs=max(k7["vs_bary_max_abs"], k7_csm["vs_bary_max_abs"]))
    probe = _check_probe()
    headline = scene, layout, kw = _headline_scene()[:3]
    k2_tex = _check_resolve("headline (textured, IBL)", scene, layout, kw["pipeline"], timed=True)
    k2["ms_textured"], k2["plain_ms_textured"] = k2_tex["ms"], k2_tex["plain_ms"]
    k2["bound_ms_textured"] = k2_tex["bound_ms"]
    k2["host_syncs"] = k2["host_syncs"] + k2_pbr["host_syncs"] + k2_tex["host_syncs"]
    k2["cases"] = {"pbr flagship": k2_pbr, "headline (textured, IBL)": k2_tex}
    front = _check_front_end(scene, layout, kw["pipeline"])
    shade = _check_shade(scene, layout, kw)
    csm = _check_shade(*full_scene(W, H, device="cuda", csm=True, **HEADLINE)[:3], cascades=True)
    shade.update({f"{k}_csm": csm[k] for k in ("ms", "plain_ms", "aten_ms", "bound_ms")},
                 max_abs_err=max(shade["max_abs_err"], csm["max_abs_err"]),
                 host_syncs=shade["host_syncs"] + csm["host_syncs"])
    k5 = _check_peel(scene, layout, _mask_pipeline())
    k3 = _check_visibility(scene, layout, kw["pipeline"])
    # the glTF headline frame's own inputs: K1 on its sun map, K2 on its
    # forward pass (12 lanes), each in the plan form and at FORCED_CHUNK
    gltf = scene, layout, kw = _gltf_headline_scene(directory)
    k1_gltf = _check_depth(scene, layout, kw["shadow_map_size"], label="glTF sun map")
    k2_gltf = _check_resolve("glTF headline (dancer-class, textured, .hdr IBL)", scene, layout,
                             kw["pipeline"], timed=True)
    for k, case in ((k1, k1_gltf), (k2, k2_gltf)):
        k.update(ms_gltf=case["ms"], plain_ms_gltf=case["plain_ms"],
                 bound_ms_gltf=case["bound_ms"], max_abs_err=max(k["max_abs_err"],
                                                                 case["max_abs_err"]))
    k2["host_syncs"] += k2_gltf["host_syncs"]
    k2["cases"]["glTF headline"] = k2_gltf
    # (h) the many-material scene's own inputs: K1 on its sun map, K2 on its
    # forward pass (12 lanes), each in the plan form and at FORCED_CHUNK
    many = scene, layout, kw = _many_material_scene()
    k1_many = _check_depth(scene, layout, kw["shadow_map_size"], label="many-material sun map")
    k2_many = _check_resolve("many materials (per-slot fetch)", scene, layout, kw["pipeline"],
                             timed=False)
    for k, case in ((k1, k1_many), (k2, k2_many)):
        k.update(ms_many=case["ms"], bound_ms_many=case["bound_ms"],
                 max_abs_err=max(k["max_abs_err"], case["max_abs_err"]))
    k1["plain_ms_many"] = k1_many["plain_ms"]
    k2["host_syncs"] += k2_many["host_syncs"]
    k2["cases"]["many materials"] = k2_many
    return {"raster_depth": k1, "raster_resolve": k2, "raster_ids": k4,
            "raster_depth_batch": k6, "raster_peel": k5, "raster_visibility": k3,
            "raster_depth_zplane": k7, "probe_kgather": probe, "shade_fused": shade,
            "front_end": front}, \
        headline, gltf, many


def _many_material_scene() -> tuple:
    """Loop (h)'s scene at 1920x1080 (many_material_scene(**MANY)), its
    build timed whole; prints T, the per-texture window atlas's size and
    each atlas's host build time, and fails unless T is within 5% of
    100,000 and the build kept no material atlas (the per-slot path)."""
    import torch

    from renderer_rs_tpu_torch.renderer.scene_build import MATERIAL_ATLAS_BUDGET

    t0 = time.perf_counter()
    scene, layout, kw, build_ms = many_material_scene(W, H, device="cuda", **MANY)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    tex = scene.textures
    n_sets = MANY["grid"] ** 2
    rows = n_sets * MANY["tex_size"] ** 2
    _log(f"(h) many-material scene many_material_scene(W, H, {MANY}): T={layout.num_triangles}, "
         f"{layout.num_objects} draws, texture array {tuple(tex.mips[0].shape)}, {n_sets} "
         f"texture sets x {MANY['tex_size']}² = {rows} level-0 rows against the budget "
         f"{MATERIAL_ATLAS_BUDGET}; per-texture window atlas {tuple(tex.atlas.shape)} "
         f"({tex.atlas.numel() * 4 / 2**30:.3f} GiB); atlas host build ms "
         f"{json.dumps({k: round(v, 1) for k, v in build_ms.items()})}; whole build "
         f"{total_ms:.1f} ms")
    if abs(layout.num_triangles - 100_000) > 5_000:
        raise SystemExit(f"phase kernels: the many-material scene has {layout.num_triangles} "
                         "triangles, not within 5% of 100,000")
    if tex.mat_atlas is not None or tex.mat_atlas_tri is not None or rows <= MATERIAL_ATLAS_BUDGET:
        raise SystemExit("phase kernels: the many-material scene built a material atlas")
    return scene, layout, kw


def _gltf_headline_scene(directory: str) -> tuple:
    """bench.py's gltf_dancer_fps scene on the card: the dancer-class model
    (write_dancer_class_gltf, DANCER) instanced to 100k triangles through
    full_scene(textured=True, gltf=..., hdr=HDR_SKY), timed whole; then
    the stages of its build, each timed once more on its own: the parse
    (GltfDocument.load and every accessor), the image decode
    (_load_textures: PNG decode, the colour slot's sRGB decode), the
    tangent generation (compute_tangents), the resize (the 1024² normal
    map to 256², and set_textures: every model image resized, the mip
    chain), the material atlas, and the IBL chain from the .hdr
    (load_hdr, equirect_to_cubemap, the precompute, finalize)."""
    import torch

    from renderer_rs_tpu_torch.app import scenes
    from renderer_rs_tpu_torch.ops.ibl import equirect_to_cubemap
    from renderer_rs_tpu_torch.renderer.scene_build import (
        _TEXTURE_SLOTS,
        SceneBuilder,
        _resize_bilinear,
        finalize_environment,
    )
    from renderer_rs_tpu_torch.resources.geometry import compute_tangents
    from renderer_rs_tpu_torch.resources.gltf import GltfDocument
    from renderer_rs_tpu_torch.resources.hdr import load_hdr
    from renderer_rs_tpu_torch.resources.model import Model, _load_textures, extract_materials

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    path, write_ms = timed(lambda: write_dancer_class_gltf(directory, **DANCER))
    out, build_ms = timed(lambda: scenes.full_scene(W, H, device="cuda", gltf=path, hdr=HDR_SKY,
                                                    **GLTF_HEADLINE))
    stages = {}

    def parse():
        doc = GltfDocument.load(path)
        return doc, [doc.read_accessor(i) for i in range(len(doc.doc["accessors"]))]

    (doc, (pos, nrm, uv, idx)), stages["parse"] = timed(parse)
    materials = extract_materials(doc)
    images, stages["image decode"] = timed(lambda: _load_textures(doc, materials))
    _, stages["tangents"] = timed(lambda: compute_tangents(pos, nrm, uv, idx.reshape(-1)))
    _, stages["resize 1024² -> 256²"] = timed(lambda: _resize_bilinear(images[2], 256, 256))
    model = Model.load(path)
    scenes._override_degenerate_textures(model)
    builder = SceneBuilder().add_model(model)
    _, stages["set_textures (5 images resized, mips)"] = timed(
        lambda: builder.set_textures(builder._images))
    slots = tuple(any(getattr(m, a) >= 0 for m in builder._materials) for a in _TEXTURE_SLOTS)
    _, stages["material atlases (f32, bf16 trilinear)"] = timed(
        lambda: builder._material_atlases(slots))

    def ibl():
        equirect = torch.from_numpy(load_hdr(HDR_SKY)[::-1].copy()).to("cuda")
        return finalize_environment(scenes._ibl_environment(equirect_to_cubemap(equirect, 64)))

    ibl_ms = [timed(ibl)[1] for _ in range(2)]
    scene, layout, kw, _ = out
    _log(f"glTF headline scene: dancer-class model ({DANCER}) written in {write_ms:.1f} ms; "
         f"full_scene(W, H, {GLTF_HEADLINE}, gltf=, hdr=) built in {build_ms:.1f} ms: "
         f"T={layout.num_triangles}, {layout.num_objects} draws, texture array "
         f"{tuple(scene.textures.mips[0].shape)}, slots {layout.texture_slots}, material atlas "
         f"{tuple(scene.textures.mat_atlas_tri.shape)}; its stages alone (ms): "
         f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}, each atlas's host "
         f"build {json.dumps({k: round(v, 3) for k, v in builder.build_ms.items()})}; the IBL "
         f"chain from the .hdr (load, equirect_to_cubemap 64², precompute, finalize) "
         f"{[round(x, 3) for x in ibl_ms]} ms")
    if layout.num_triangles != 103_682:
        raise SystemExit(f"phase kernels: the glTF headline scene has {layout.num_triangles} "
                         "triangles, not 103,682")
    return scene, layout, kw


def _headline_scene():
    """bench.py's headline scene on the card, with the IBL precompute timed:
    the whole factory, then the precompute alone twice more (the first call
    of a process also pays cuBLAS's and the allocator's start-up)."""
    import torch

    from renderer_rs_tpu_torch.app import scenes
    from renderer_rs_tpu_torch.renderer.scene_build import finalize_environment

    t0 = time.perf_counter()
    out = scenes.full_scene(W, H, device="cuda", **HEADLINE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sky = out[0].environment.skybox_mips[0]
    ms = []
    for _ in range(2):
        t1 = time.perf_counter()
        env = scenes._ibl_environment(sky)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    fin = []
    for _ in range(2):
        t1 = time.perf_counter()
        finalize_environment(env)
        torch.cuda.synchronize()
        fin.append((time.perf_counter() - t1) * 1e3)
    _log(f"headline scene: T={out[1].num_triangles}, built in {build_s:.2f}s; IBL precompute "
         f"(sky mips, irradiance 16², prefilter 32² x 5 x 32 samples, LUT 64² x 256) "
         f"{[round(x, 3) for x in ms]} ms, finalize (SH9, atlases) {[round(x, 3) for x in fin]} "
         f"ms; environment atlas_tri {tuple(out[0].environment.atlas_tri.shape)}")
    return out


def _check_visibility(scene, layout, pipeline) -> dict:
    """K3 beside its plain version on the headline frame's setup, in three
    band forms (K3_BANDS): the whole frame, a contiguous band of 270 rows
    and a pair-interleaved band of 270 rows, each with the main path's split
    plan and with FORCED_CHUNK; on the pair-interleaved band also the tie
    rules on the table with every raster slot twice."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        VIS_COLS,
        bin_compact,
        prepare_visibility,
        raster_visibility,
        raster_visibility_plain,
        split_plan,
    )
    from renderer_rs_tpu_torch.renderer.passes import frame_geometry

    geo = frame_geometry(scene, layout, pipeline, W, H)
    t = layout.num_triangles
    cases, max_abs_err, n_syncs = {}, 0.0, 0
    for label, band in K3_BANDS.items():
        y0, rows = band[0], band[1]
        stride = band[2] if len(band) > 2 else 1
        pair = len(band) > 3 and band[3]

        def prepare(y0=y0, rows=rows, stride=stride, pair=pair):
            return prepare_visibility(geo.setup, rows, W, y0, stride, pair, small_limit=t)

        k3 = prepare()
        args = (k3.table, k3.sorted_tris, k3.seg, k3.nbx, rows, W, y0, stride, pair,
                pipeline.depth_compare_op)
        n_pairs = int(k3.n_pairs)
        densest = int((k3.seg[1:] - k3.seg[:-1]).max())
        big, huge = (int(v) for v in k3.bin_overflow.tolist())
        _log(f"K3 {label} {band}: bins={k3.seg.numel() - 1} binned pairs={n_pairs} densest "
             f"bin={densest} bin_overflow big {big} huge {huge}; split plan "
             f"{_plan_stats(k3.plan)}, with chunk {FORCED_CHUNK} "
             f"{_plan_stats(_plan_at(k3, FORCED_CHUNK))}")
        syncs = _syncs(lambda args=args, prepare=prepare: raster_visibility(
            *args, plan=prepare().plan))
        _log(f"K3 {label}: host syncs of prepare_visibility (binning, table, split plan) and "
             f"the K3 launch: {len(syncs)} {syncs}")
        if syncs:
            raise SystemExit(f"phase kernels: the K3 binning or launch synchronizes the host "
                             f"({label})")
        n_syncs += len(syncs)
        res = _against_plain("raster_visibility", label, raster_visibility,
                             raster_visibility_plain, args, k3.plan, lanes=False,
                             extra=SKIP_OFF)
        max_abs_err = max(max_abs_err, res["max_abs_err"])
        covered = int((res["tid"] >= 0).sum())
        if not covered:
            raise SystemExit(f"phase kernels: raster_visibility covers no pixel ({label})")
        ms = _median(_event_times_ms(lambda args=args, plan=k3.plan: raster_visibility(
            *args, plan=plan), KERNEL_TIMINGS))
        plain_ms = _median(_event_times_ms(lambda args=args: raster_visibility_plain(*args), 3,
                                           warmup=1))
        # least time: the walk's f32 ops over the band's pixels (a bin row
        # wholly in the tile padding below the band is binned but never
        # walked), against the bytes the function must move once: the 20
        # columns of every walked row (no more of the table), the walked
        # bins' sorted ids and segments, and depth, tid, b0, b1 written
        walked, pixel_pairs, bins = _walked(k3.seg, k3.nbx, rows, W)
        counts = _skip_counts(k3, rows, W, (y0, stride, pair))
        ops = _walk_ops(counts, pixel_pairs, OPS_PER_PAIR)
        binned_rows = _walked_rows(k3, walked)
        nbytes = (binned_rows * VIS_COLS * 4 + walked * 4 + (bins + 1) * 4
                  + rows * W * 4 * 4)
        bound_ms, bound_by = _bound(ops, nbytes)
        bound_all = _bound(pixel_pairs * OPS_PER_PAIR, nbytes)[0]
        _log(f"K3 {label}: {ms:.4f} ms (median of {KERNEL_TIMINGS}), plain {plain_ms:.2f} ms, "
             f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes: "
             f"{walked} walked pairs of {n_pairs}, {binned_rows} walked rows of "
             f"{k3.table.shape[0]}; all pairs {bound_all:.4f} ms)")
        _split_log(f"K3 {label}", ms, bound_ms, bound_by, k3.plan)
        cases[label] = dict(band=list(band), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, bound_ms_all_pairs=bound_all, n_pairs=n_pairs, walked_pairs=walked,
                            densest=densest, bin_overflow=[big, huge], covered=covered,
                            host_syncs=len(syncs), **_plan_stats(k3.plan))
        _skip_forms(cases[label], f"K3 {label}",
                    lambda args=args, plan=k3.plan: raster_visibility(*args, plan=plan), counts,
                    breakdown=label == "pair-interleaved band")

        def sweep(case=cases[label], label=label, args=args, k3=k3):
            case["chunk_sweep_ms"] = _chunk_sweep(
                f"K3 {label}", lambda plan: raster_visibility(*args, plan=plan), k3.seg,
                k3.sorted_tris.numel())

        _AFTER.append(sweep)
        _defer_breakdown(cases[label], label, f"K3 {label}",
                         lambda args=args, plan=k3.plan: raster_visibility(*args, plan=plan))
    y0, rows, stride, pair = K3_BANDS["pair-interleaved band"]
    table2, setup2 = _twice(k3.table, geo.setup)

    def twins(op, clear):
        sorted_tris, seg, _nby, nbx, _ = bin_compact(setup2, rows, W, y_offset=y0,
                                                     y_stride=stride, y_pair=pair)
        return ((table2, sorted_tris, seg, nbx, rows, W, y0, stride, pair, op, clear),
                split_plan(seg, sorted_tris.numel()))

    band = cases["contiguous band"]
    out = {
        "name": "raster_visibility",
        "route": "cuda",
        "source": "renderer_rs_tpu_torch/csrc/raster_vis.cu",
        "replaces": "renderer_rs_tpu/ops/raster_pallas.py:180",
        "max_abs_err": max_abs_err,
        "ms": band["ms"],  # one band of the banded main path
        "plain_ms": band["plain_ms"],
        "bound_ms": band["bound_ms"],
        "bound_by": band["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "host_syncs": n_syncs,
        "cases": cases,
    }

    def ties():
        res = _check_ties("raster_visibility", "pair-interleaved band", raster_visibility,
                          raster_visibility_plain, twins, geo.setup.num_triangles)
        out["max_abs_err"] = max(out["max_abs_err"], res["max_abs_err"])
        out["ms_ties"] = res["ms"]

    _AFTER.append(ties)
    return out


def _mask_pipeline():
    """The alpha-cutoff (MASK) pipeline a glTF alphaMode MASK user builds."""
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    return GraphicsPipelineBuilder().alpha_cutoff(CUTOFF).build()


def _zero_launch_counts() -> None:
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        raster_depth,
        raster_ids,
        raster_peel,
        raster_resolve,
        raster_visibility,
    )
    from renderer_rs_tpu_torch.ops.front_end import front_end
    from renderer_rs_tpu_torch.ops.shade_cuda import shade_fused
    from renderer_rs_tpu_torch.probes.kgather import kgather

    raster_depth.launches = raster_depth.batched_launches = raster_depth.zplane_launches = 0
    raster_resolve.launches = raster_ids.launches = raster_peel.launches = 0
    raster_visibility.launches = kgather.launches = shade_fused.launches = 0
    front_end.launches = 0


def _launch_counts() -> dict:
    """Launches per kernel since the last zeroing: of raster_depth's
    launches, K7 counts the z-plane form (one set or N), K6 the bary form
    with N > 1 sets, K1 the rest."""
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        raster_depth,
        raster_ids,
        raster_peel,
        raster_resolve,
        raster_visibility,
    )
    from renderer_rs_tpu_torch.probes.kgather import kgather

    return {
        "raster_depth": (raster_depth.launches - raster_depth.batched_launches
                         - raster_depth.zplane_launches),
        "raster_resolve": raster_resolve.launches,
        "raster_ids": raster_ids.launches,
        "raster_depth_batch": raster_depth.batched_launches,
        "raster_peel": raster_peel.launches,
        "raster_visibility": raster_visibility.launches,
        "raster_depth_zplane": raster_depth.zplane_launches,
        "probe_kgather": kgather.launches,
    }


def _counts(**kw) -> dict:
    return {"raster_depth": 0, "raster_resolve": 0, "raster_ids": 0, "raster_depth_batch": 0,
            "raster_peel": 0, "raster_visibility": 0, "raster_depth_zplane": 0,
            "probe_kgather": 0, **kw}


# each _drive loop's median frame ms, by label
_FRAME_MS: dict[str, float] = {}


def _drive(label: str, renderer, frames: int, expect: dict, before_frame=None,
           shade: int | None = None, front: int | None = None) -> dict:
    """Render `frames` frames with every launch counter zeroed just before
    and read just after; fail unless the counts are `expect`, and unless
    the fused shade launched `shade` times and the front-end kernels
    `front` times where those are given (their counts join the returned
    counts). `renderer` is a Renderer or a callable that renders one frame
    (a presented uint8 image or a frame tensor, [H,W,4])."""
    from renderer_rs_tpu_torch.ops.front_end import front_end
    from renderer_rs_tpu_torch.ops.shade_cuda import shade_fused

    _zero_launch_counts()
    render = renderer if callable(renderer) else renderer.render_frame
    # the loops present every frame with one frame in flight: MAILBOX drops none
    dropped = None if callable(renderer) else renderer.frame_manager.frames_dropped
    frame_ms = []
    img = None
    for i in range(frames):
        t1 = time.perf_counter()
        if before_frame is not None:
            before_frame(i)
        img = render()
        frame_ms.append((time.perf_counter() - t1) * 1e3)
    launches = _launch_counts()
    _FRAME_MS[label] = _median(frame_ms)
    _log(f"main path, {label}: {frames} frames, launches {launches}, "
         f"frame ms median {_median(frame_ms):.3f} (all {[round(x, 3) for x in frame_ms]})")
    if launches != expect:
        raise SystemExit(f"phase main path, {label}: launches {launches}, expected {expect}")
    launches["shade_fused"] = shade_fused.launches
    launches["front_end"] = front_end.launches
    _log(f"main path, {label}: shade_fused launches {shade_fused.launches}, front_end "
         f"launches {front_end.launches}")
    if shade is not None and shade_fused.launches != shade:
        raise SystemExit(f"phase main path, {label}: shade_fused launches "
                         f"{shade_fused.launches}, expected {shade}")
    if front is not None and front_end.launches != front:
        raise SystemExit(f"phase main path, {label}: front_end launches "
                         f"{front_end.launches}, expected {front}")
    if dropped is not None and renderer.frame_manager.frames_dropped != dropped:
        raise SystemExit(f"phase main path, {label}: MAILBOX dropped a frame of a loop that "
                         "presents every frame")
    if img is None or img.shape != (H, W, 4):
        raise SystemExit(f"phase main path, {label}: no frame")
    return launches


def _check_frame(label: str, renderer):
    """A finite frame with covered pixels (from the frame's diagnostics);
    returns the linear frame."""
    import torch

    hdr = renderer.render_frame_hdr()
    finite = bool(torch.isfinite(hdr).all())
    diag = renderer.frame_diagnostics()
    _log(f"{label}: frame {tuple(hdr.shape)} finite {finite}, covered pixels "
         f"{diag['covered_pixels']}, peel_exhausted {diag['peel_exhausted']}, "
         f"clip_overflow {diag['clip_overflow']}, bin_overflow big "
         f"{diag['bin_overflow_big']} huge {diag['bin_overflow_huge']}, "
         f"mean rgb {[round(float(v), 4) for v in hdr[..., :3].mean((0, 1))]}")
    if not finite or diag["covered_pixels"] == 0:
        raise SystemExit(f"phase main path, {label}: frame not finite or empty")
    return hdr


def phase_main_paths(headline: tuple, gltf: tuple, many: tuple) -> dict:
    """Renderer.render_frame at full size on the flagship frames; the
    headline, glTF headline and many-material scenes (scene, layout, kw)
    come built from the kernel phase."""
    import dataclasses

    import torch

    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene, full_scene
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    def make(scene, layout, kw):
        renderer = Renderer(RendererConfig(width=W, height=H), device="cuda", **kw)
        renderer.set_scene(scene, layout)
        return renderer

    by_path = {}
    t0 = time.perf_counter()
    scene, layout, kw, _ = blinnphong_scene(W, H, device="cuda", **BLINNPHONG)
    renderer = make(scene, layout, kw)
    _log(f"blinnphong scene setup {time.perf_counter() - t0:.2f}s")
    for _ in range(2):  # warm-up
        renderer.render_frame()
    by_path["blinnphong"] = _drive(
        "blinnphong", renderer, BP_FRAMES, _counts(raster_resolve=BP_FRAMES),
        front=3 * BP_FRAMES)
    _check_frame("blinnphong", renderer)
    # FLAT shading (the vertex colours): K3 over the whole frame, then the
    # deferred attribute path, no K2
    renderer = make(scene, layout, {**kw, "shading": ShadingModel.FLAT})
    renderer.render_frame()  # warm-up
    by_path["blinnphong_flat"] = _drive(
        "blinnphong, FLAT shading", renderer, FLAT_FRAMES, _counts(raster_visibility=FLAT_FRAMES))
    _check_frame("blinnphong, FLAT", renderer)
    del renderer

    by_path.update(_scan_paths(make))

    t0 = time.perf_counter()
    scene, layout, kw, _ = full_scene(W, H, device="cuda", **FULL)
    _log(f"pbr scene setup {time.perf_counter() - t0:.2f}s")
    warm = make(scene, layout, kw)
    for _ in range(2):  # warm-up on a renderer of its own: loop A starts with no map
        warm.render_frame()
    # loop A, static scene: the first frame renders the shadow map, the
    # others reuse it
    renderer = make(scene, layout, kw)
    by_path["pbr_static"] = _drive(
        "pbr loop A (static scene)", renderer, PBR_FRAMES,
        _counts(raster_depth=1, raster_resolve=PBR_FRAMES), front=3 * PBR_FRAMES)
    hdr_1x = _check_frame("pbr", renderer)

    # loop B, moving sun: a new direction and light matrix every frame
    by_path["pbr_moving_sun"] = _drive(
        "pbr loop B (moving sun)", renderer, PBR_FRAMES,
        _counts(raster_depth=PBR_FRAMES, raster_resolve=PBR_FRAMES),
        before_frame=lambda i: _move_sun(renderer, i), front=3 * PBR_FRAMES)
    _check_frame("pbr, sun moved", renderer)

    # MSAA 4x on the static PBR scene: the 1x frame, the ids-only sample
    # pass on K4 and the resolve, every frame; the shadow map once
    msaa_kw = {**kw, "pipeline": dataclasses.replace(kw["pipeline"], msaa_samples=MSAA)}
    warm = make(scene, layout, msaa_kw)
    for _ in range(2):
        warm.render_frame()
    renderer = make(scene, layout, msaa_kw)
    by_path["pbr_msaa4"] = _drive(
        f"pbr msaa{MSAA} (static scene)", renderer, MSAA_FRAMES,
        _counts(raster_depth=1, raster_resolve=MSAA_FRAMES, raster_ids=MSAA_FRAMES))
    # the MSAA frame has no diagnostics (as in the reference): it must be
    # finite and differ from the 1x frame on edge pixels only
    hdr = renderer.render_frame_hdr()
    changed = float(((hdr - hdr_1x).abs().amax(-1) > 1e-5).float().mean())
    _log(f"pbr msaa{MSAA}: frame {tuple(hdr.shape)} finite {bool(torch.isfinite(hdr).all())}, "
         f"pixels differing from the 1x frame {changed:.4%}, max |d| "
         f"{float((hdr - hdr_1x).abs().max()):.4f}")
    if not (bool(torch.isfinite(hdr).all()) and 0.001 < changed < 0.2):
        raise SystemExit("phase main path, msaa: the resolved frame is not finite, or does "
                         "not differ from the 1x frame on edges only")

    # CSM, static scene: four cascades in ONE raster_depth launch, kept
    t0 = time.perf_counter()
    scene, layout, kw, _ = full_scene(W, H, device="cuda", csm=True, **FULL)
    _log(f"csm scene setup {time.perf_counter() - t0:.2f}s")
    warm = make(scene, layout, kw)
    for _ in range(2):
        warm.render_frame()
    renderer = make(scene, layout, kw)
    by_path["csm_static"] = _drive(
        "csm (static scene)", renderer, CSM_FRAMES,
        _counts(raster_depth_batch=1, raster_resolve=CSM_FRAMES), front=3 * CSM_FRAMES)
    _check_frame("csm", renderer)

    # CSM with the cascades refitted to a moving sun every frame
    by_path["csm_moving_sun"] = _drive(
        "csm (cascades refitted every frame)", renderer, CSM_FRAMES,
        _counts(raster_depth_batch=CSM_FRAMES, raster_resolve=CSM_FRAMES),
        before_frame=lambda i: _refit_cascades(renderer, i), front=3 * CSM_FRAMES)
    _check_frame("csm, sun moved", renderer)

    # the same, the cascades in the z-plane form: one batched K7 a frame
    plane = make(scene, layout, {**kw, "z_form": "plane"})
    plane.render_frame()  # warm-up
    by_path["csm_plane_moving_sun"] = _drive(
        "csm, z-plane form (cascades refitted every frame)", plane, PLANE_FRAMES,
        _counts(raster_depth_zplane=PLANE_FRAMES, raster_resolve=PLANE_FRAMES),
        before_frame=lambda i: _refit_cascades(plane, i))
    _check_frame("csm, z-plane form", plane)
    _check_plane_vs_bary("csm, z-plane form", plane)

    # the textured frame: K2 with the uv and tangent lanes, then the atlas
    # fetch and TBN mapping; the shadow map once
    t0 = time.perf_counter()
    scene, layout, kw, _ = full_scene(W, H, device="cuda", textured=True, **FULL)
    _log(f"textured scene setup {time.perf_counter() - t0:.2f}s")
    for label, pipeline, frames, expect in (
        ("textured (static scene)", kw["pipeline"], TEX_FRAMES,
         _counts(raster_depth=1, raster_resolve=TEX_FRAMES)),
        # the MASK frame: the 4-layer depth peel on K5, no K2 launch
        (f"textured MASK, alpha_cutoff({CUTOFF}) (static scene)", _mask_pipeline(), MASK_FRAMES,
         _counts(raster_depth=1, raster_peel=4 * MASK_FRAMES)),
    ):
        pkw = {**kw, "pipeline": pipeline}
        warm = make(scene, layout, pkw)
        for _ in range(2):
            warm.render_frame()
        renderer = make(scene, layout, pkw)
        key = "textured" if pipeline is kw["pipeline"] else "textured_mask"
        by_path[key] = _drive(label, renderer, frames, expect)
        _check_frame(label.split(" (")[0], renderer)
    del scene, renderer, warm
    by_path.update(_headline_paths(make, *headline))
    by_path.update(_blend_stencil_msaa_paths(*headline))
    # (f) the glTF headline frame: one K1 in all, one K2 a frame
    scene, layout, kw = gltf
    warm = make(scene, layout, kw)
    for _ in range(2):
        warm.render_frame()
    renderer = make(scene, layout, kw)
    by_path["gltf_headline"] = _drive(
        "(f) glTF headline (dancer-class x6, textured, .hdr IBL; static scene)", renderer,
        GLTF_FRAMES, _counts(raster_depth=1, raster_resolve=GLTF_FRAMES))
    _check_frame("glTF headline", renderer)
    del scene, renderer, warm
    by_path.update(_shade_paths(make, headline, many))
    by_path.update(_frame_loop_paths(make, headline, many))
    by_path.update(_rhi_paths(make, headline))
    by_path.update(_sharded_paths(headline))
    return by_path


def _shade_paths(make, headline: tuple, many: tuple) -> dict:
    """Loops (g)-(j) at 1920x1080 through Renderer.render_frame, each with
    one K1 in all: (g) the headline scene with its environment set without
    finalize, the exact map-sampling IBL, one K2 a frame; (h) the
    many-material scene, the per-slot fetch, one K2 a frame; (i) the
    headline frame's rate variant light="yhalf" and the exact reference
    pcf="full", cube="full", one K2 a frame; (j) the
    headline frame supersampled, MSAA 4x with msaa_mode="super", one K2 at
    3840x2160 a frame and no K4. Then the drift table."""
    import dataclasses

    import torch

    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.renderer.passes import ShadeRates

    by_path = {}

    def loop(key, label, scene, layout, kw, frames, warmups=2):
        warm = make(scene, layout, kw)
        for _ in range(warmups):
            warm.render_frame()
        renderer = make(scene, layout, kw)
        by_path[key] = _drive(label, renderer, frames,
                              _counts(raster_depth=1, raster_resolve=frames))
        if kw["pipeline"].msaa_samples == 1:
            _check_frame(label.split(" (")[0], renderer)
        return renderer

    t0 = time.perf_counter()
    g_scene, g_layout, g_kw, _ = full_scene(W, H, device="cuda", finalize=False, **HEADLINE)
    env = g_scene.environment
    _log(f"(g) headline scene with the environment set without finalize: built in "
         f"{time.perf_counter() - t0:.2f}s; irradiance_sh {env.irradiance_sh}, atlas "
         f"{env.atlas}, atlas_tri {env.atlas_tri}")
    if env.atlas is not None or env.irradiance_mips is None:
        raise SystemExit("phase main path, (g): the environment was finalized")
    loop("exact_ibl", "(g) headline, exact map-sampling IBL (environment not finalized; "
         "static scene)", g_scene, g_layout, g_kw, EXACT_IBL_FRAMES)
    del g_scene, env
    loop("many_materials", "(h) many materials, per-slot fetch (256 texture sets; static "
         "scene)", *many, MANY_FRAMES)
    scene, layout, kw = headline
    for key, rates in (("rates_light_yhalf", dict(light="yhalf")),
                       ("rates_exact", EXACT_RATES)):
        loop(key, f"(i) headline, ShadeRates({rates}) (static scene)", scene, layout,
             {**kw, "shade_rates": ShadeRates(**rates)}, RATE_FRAMES)
    super_kw = {**kw, "pipeline": dataclasses.replace(kw["pipeline"], msaa_samples=MSAA),
                "msaa_mode": "super"}
    label = f"(j) headline msaa{MSAA}, msaa_mode='super' (K2 at {W * 2}x{H * 2}; static scene)"
    hdr = loop("msaa_super", label, scene, layout, super_kw, SUPERSAMPLE_FRAMES,
               warmups=1).render_frame_hdr()
    # the supersampled frame has no diagnostics (as in the reference): it
    # must be finite and covered
    _log(f"{label}: frame {tuple(hdr.shape)} finite {bool(torch.isfinite(hdr).all())}, mean rgb "
         f"{[round(float(v), 4) for v in hdr[..., :3].mean((0, 1))]}")
    if not (bool(torch.isfinite(hdr).all()) and tuple(hdr.shape) == (H, W, 4)):
        raise SystemExit(f"phase main path, {label}: the frame is not finite")
    _drift_table(make, scene, layout, kw)
    return by_path


def _drift_table(make, scene, layout, kw) -> None:
    """Each shade-rate variant of RATE_VARIANTS against the exact reference
    (EXACT_RATES) on the headline frame at 1920x1080 on the card: mean, p99
    and max of |d| over the tonemapped [H,W,4] frame (probe_quality.py's
    measure). The default rates must meet the JAX package's gate
    (DRIFT_GATE); the others are printed."""
    import numpy as np

    from renderer_rs_tpu_torch.renderer.passes import ShadeRates

    def frame(rates):
        return make(scene, layout, {**kw, "shade_rates": ShadeRates(**rates)}) \
            .render_frame_hdr().cpu().numpy()

    ref = frame(EXACT_RATES)
    rows = {}
    for name, rates in RATE_VARIANTS.items():
        err = np.abs(frame(rates) - ref)
        rows[name] = {"mean": float(err.mean()), "p99": float(np.quantile(err, 0.99)),
                      "max": float(err.max()),
                      "rgb_p99": float(np.quantile(err[..., :3], 0.99))}
        rows[name]["accept"] = rows[name]["p99"] < DRIFT_GATE[0] and \
            rows[name]["mean"] < DRIFT_GATE[1]
    _log("drift table, headline frame 1920x1080 on the card, each variant against the exact "
         f"reference ShadeRates({EXACT_RATES}); |d| of the tonemapped [H,W,4] frame; gate p99 < "
         f"{DRIFT_GATE[0]}, mean < {DRIFT_GATE[1]}:")
    for name, r in rows.items():
        _log(f"  {name:14s} mean {r['mean']:.6f}  p99 {r['p99']:.6f}  max {r['max']:.4f}  "
             f"rgb p99 {r['rgb_p99']:.6f}  accept {r['accept']}")
    _log("drift table JSON " + json.dumps(rows))
    if not rows["default"]["accept"]:
        raise SystemExit("phase main path, drift table: the default rates miss the gate")


class _Records(logging.Handler):
    """The messages logged to a logger while attached."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _frame_loop_paths(make, headline: tuple, many: tuple) -> dict:
    """Loops (k)-(o) at 1920x1080: the app loop with the scripted orbit and
    fly cameras, the resize, validation mode, the MAILBOX present and the
    geometry forms."""
    by_path = _app_loop_paths(headline)
    by_path["resize"] = _resize_path(headline)
    by_path.update(_validation_path(make, headline))
    by_path["mailbox"] = _mailbox_path(make, headline)
    by_path.update(_geometry_form_paths(make, headline, many))
    return by_path


def _hold_k2(label: str, scene, layout, pipeline, width: int, height: int, forms=None) -> dict:
    """K2 beside its plain version on one frame's inputs (the main path's
    split plan, FORCED_CHUNK and the skip off), under the geometry forms
    `forms`; returns _against_plain's result and the binning's overflow."""
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        prepare_resolve,
        raster_resolve,
        raster_resolve_plain,
    )
    from renderer_rs_tpu_torch.renderer.passes import GeometryForms, frame_geometry

    forms = forms or GeometryForms()
    geo = frame_geometry(scene, layout, pipeline, width, height, forms)
    k2 = prepare_resolve(geo.setup, height, width, geo.attr, scene.tris, geo.clip_src,
                         geo.clip_planes, geo.mat_flat, small_limit=layout.num_triangles,
                         cap_big=forms.cap_big)
    res = _against_plain(
        "raster_resolve", label, raster_resolve, raster_resolve_plain,
        (k2.table, k2.sorted_tris, k2.seg, k2.nbx, height, width, k2.n_vary, k2.n_flat,
         pipeline.depth_compare_op), k2.plan, lanes=True, extra=SKIP_OFF)
    res["bin_overflow"] = k2.bin_overflow.tolist()
    if not bool((res["tid"] >= 0).any()):
        raise SystemExit(f"phase main path, {label}: raster_resolve covers no pixel")
    return res


def _app_loop_paths(headline: tuple) -> dict:
    """(k) python -m renderer_rs_tpu_torch.app.main in-process on the
    headline scene at 1920x1080, APP_FRAMES frames under --orbit and then
    --fly, --log given and a callable sink: one K1 in all and one K2 a
    frame, every frame distinct; the app's FrameStats summary line printed.
    Then K2 held to its plain version on an orbit frame's inputs."""
    import torch

    from renderer_rs_tpu_torch.app.main import main as app_main

    by_path = {}
    argv = ["--scene", "full", "--textured", "--width", str(W), "--height", str(H),
            "--frames", str(APP_FRAMES), "--log", "info,renderer_rs_tpu_torch=info"]
    app_log = logging.getLogger("renderer_rs_tpu_torch.app")
    for mode in ("orbit", "fly"):
        hashes, presented = [], []

        def sink(frame, n, hashes=hashes, presented=presented):
            presented.append(time.perf_counter())
            hashes.append(hashlib.sha1(frame.tobytes()).hexdigest())

        records = _Records()
        app_log.addHandler(records)
        _zero_launch_counts()
        t0 = time.perf_counter()
        try:
            rc = app_main(argv + [f"--{mode}"], device="cuda", sink=sink)
        finally:
            app_log.removeHandler(records)
        secs = time.perf_counter() - t0
        launches = _launch_counts()
        frame_ms = [(b - a) * 1e3 for a, b in zip(presented, presented[1:])]
        summary = [m for m in records.messages if "steady-state" in m]
        label = f"(k) app.main --{mode}, headline scene, {APP_FRAMES} frames"
        _FRAME_MS[label] = _median(frame_ms)
        _log(f"main path, {label}: rc {rc} in {secs:.2f}s (the scene build included), launches "
             f"{launches}, frame ms between presents median {_median(frame_ms):.3f} (all "
             f"{[round(x, 3) for x in frame_ms]}), distinct frames {len(set(hashes))} of "
             f"{len(hashes)}; the app's stats: {summary}")
        if rc != 0 or launches != _counts(raster_depth=1, raster_resolve=APP_FRAMES):
            raise SystemExit(f"phase main path, {label}: rc {rc}, launches {launches}")
        if len(hashes) != APP_FRAMES or len(set(hashes)) != APP_FRAMES or not summary:
            raise SystemExit(f"phase main path, {label}: the frames are not {APP_FRAMES} "
                             "distinct ones, or the app logged no frame statistics")
        by_path[f"app_{mode}"] = launches
    # an orbit frame's inputs: the headline scene under the app's scripted
    # orbit camera after 12 frames
    scene, layout, kw = headline
    _hold_k2("(k) orbit frame 12", _orbit_scene(headline, 12), layout, kw["pipeline"], W, H)
    torch.cuda.synchronize()
    return by_path


def _orbit_scene(headline: tuple, frames: int):
    """The headline scene under the app's scripted orbit camera (app.main
    --orbit) after `frames` frames of 1/60 s."""
    import copy

    from renderer_rs_tpu_torch.app.main import apply_camera_input, inject_scripted_events
    from renderer_rs_tpu_torch.platform.input import InputState
    from renderer_rs_tpu_torch.resources.ubo import CameraUbo
    from renderer_rs_tpu_torch.scene.camera import OrbitController

    scene, _, kw = headline
    camera = copy.deepcopy(kw["camera"])
    ctl = OrbitController()
    ctl.sync_with_camera(camera, (0.0, 0.0, 0.0))
    inp = InputState()
    for f in range(frames):
        inp.begin_frame()
        inject_scripted_events(inp, "orbit", f)
        apply_camera_input(inp, "orbit", ctl, camera, 1.0 / 60.0)
    return scene.replace(camera=CameraUbo.create(
        camera.view_matrix(), camera.projection_matrix(), camera.position).to(scene.device))


def _resize_path(headline: tuple) -> dict:
    """(l) The headline frame at 1920x1080, then resize(1280, 720), then
    resize(1920, 1080), one presented frame at each: each bit-equal (the
    uint8 frame and the linear one) to a fresh Renderer's at that extent in
    this process; the sun map is kept across the resizes (no K1)."""
    import numpy as np
    import torch

    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    scene, layout, kw = headline

    def fresh(w, h):
        r = Renderer(RendererConfig(width=w, height=h), device="cuda", **kw)
        r.set_scene(scene, layout)
        return r

    renderer = fresh(W, H)
    renderer.render_frame()  # warm-up: the sun map
    _zero_launch_counts()
    got, frame_ms = [], []
    for i, (w, h) in enumerate(RESIZE_EXTENTS):
        if i:
            renderer.resize(w, h)
        t1 = time.perf_counter()
        img = renderer.render_frame().copy()
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        got.append((w, h, img, renderer.render_frame_hdr()))
    launches = _launch_counts()
    equal = []
    for w, h, img, hdr in got:
        ref = fresh(w, h)
        equal.append((bool(np.array_equal(img, ref.render_frame())),
                      bool(torch.equal(hdr.view(torch.int32),
                                       ref.render_frame_hdr().view(torch.int32)))))
    label = "(l) headline, resize 1920x1080 -> 1280x720 -> 1920x1080"
    _log(f"main path, {label}: frame ms after each resize {[round(x, 3) for x in frame_ms]}, "
         f"launches {launches}, shapes {[g[2].shape for g in got]}, (uint8, linear) bit-equal "
         f"to a fresh Renderer's {equal}; swapchain {renderer.swapchain.extent}, depth buffer "
         f"{renderer.depth_buffer.extent}")
    if launches != _counts(raster_resolve=2 * len(RESIZE_EXTENTS)):
        raise SystemExit(f"phase main path, {label}: launches {launches} (the sun map must be "
                         "kept across resizes)")
    if not all(a and b for a, b in equal) or any(g[2].shape != (g[1], g[0], 4) for g in got):
        raise SystemExit(f"phase main path, {label}: a resized frame differs from a fresh "
                         "Renderer's")
    return launches


def _validation_path(make, headline: tuple) -> dict:
    """(m) The headline frame under RendererConfig(enable_validation=True):
    the bind-time sweep timed, then VALIDATION_FRAMES frames beside as many
    of a normal-mode Renderer; no finding. Then one NaN normal: exactly one
    bind-time ERROR finding."""
    import torch

    import renderer_rs_tpu_torch.core.validation as validation
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    scene, layout, kw = headline
    validation.reset_findings()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checked = Renderer(RendererConfig(width=W, height=H, enable_validation=True), device="cuda",
                       **kw)
    checked.set_scene(scene, layout)
    bind_ms = (time.perf_counter() - t0) * 1e3
    normal = make(scene, layout, kw)
    for r in (checked, normal):
        r.render_frame()  # warm-up: the sun map
    by_path = {
        "validation": _drive("(m) headline, validation mode", checked, VALIDATION_FRAMES,
                             _counts(raster_resolve=VALIDATION_FRAMES)),
        "validation_normal": _drive("(m) headline, normal mode", normal, VALIDATION_FRAMES,
                                    _counts(raster_resolve=VALIDATION_FRAMES)),
    }
    clean = (validation.findings(validation.SEVERITY_ERROR),
             validation.findings(validation.SEVERITY_VERBOSE))
    normals = scene.normals.clone()
    normals[normals.shape[0] // 2, 1] = float("nan")
    checked.set_scene(scene.replace(normals=normals), layout)
    bad = validation.findings(validation.SEVERITY_ERROR) - clean[0]
    _log(f"(m) validation mode: bind-time sweep {bind_ms:.2f} ms; frame ms median "
         f"{_FRAME_MS['(m) headline, validation mode']:.3f} vs normal mode "
         f"{_FRAME_MS['(m) headline, normal mode']:.3f}; findings (ERROR, VERBOSE) on the clean "
         f"scene {clean}; one NaN normal: {bad} ERROR finding(s) at bind")
    validation.reset_findings()
    if clean != (0, 1) or bad != 1:
        raise SystemExit("phase main path, (m): validation mode's findings are wrong")
    return by_path


def _mailbox_path(make, headline: tuple) -> dict:
    """(n) MAILBOX present: two render_frame(present=False), then one
    render_frame(); the acquired slots stay in step with the frame queue.
    Whether the newest frame had finished by the present is the card's
    timing: frames_dropped is printed."""
    renderer = make(*headline)
    renderer.render_frame()  # warm-up: the sun map
    _zero_launch_counts()
    renderer.render_frame(present=False)
    renderer.render_frame(present=False)
    fm = renderer.frame_manager
    pending = len(renderer._pending_slots)
    img = renderer.render_frame()
    launches = _launch_counts()
    _log(f"main path, (n) MAILBOX: present mode {fm.present_mode}, pending "
         f"slots {pending} after two present=False, then {len(renderer._pending_slots)} with "
         f"{fm.in_flight} in flight; frames_dropped {fm.frames_dropped}, retired unpresented "
         f"{fm.frames_retired_unpresented}; launches {launches}")
    if not (fm.present_mode == "mailbox" and pending == 2 and img is not None
            and len(renderer._pending_slots) == fm.in_flight
            and launches == _counts(raster_resolve=3)):
        raise SystemExit("phase main path, (n): the MAILBOX present lost its slots")
    renderer.wait_idle()
    return launches


def _geometry_form_paths(make, headline: tuple, many: tuple) -> dict:
    """(o) The geometry forms at 1920x1080: vstage "batch" against "loop"
    on the headline and the many-material frames (frame ms taking turns,
    peak device memory, the share of equal ids, the frame bar between
    them); clip_compact=0 on the headline frame (bit-equal to the default
    where clip_overflow is 0); cap_big=T on the shade-once MSAA 4x headline
    frame (K4 at 3840x2160) and the supersampled one (K2 at 3840x2160),
    each kernel held to its plain version under the raised cap, and the
    stitched bands' footprint share under it."""
    import dataclasses

    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_ids, raster_ids, raster_ids_plain
    from renderer_rs_tpu_torch.renderer.passes import (
        GeometryForms,
        forward_frame,
        frame_geometry,
    )

    by_path = {}
    for key, label, (scene, layout, kw) in (("headline", "headline", headline),
                                            ("many", "(h) many materials", many)):
        renderers = {form: make(scene, layout, {**kw, "geometry_forms": GeometryForms(vstage=form)})
                     for form in ("loop", "batch")}
        peak = {}
        for form, r in renderers.items():
            r.render_frame()  # warm-up: the sun map
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            r.render_frame_hdr()
            peak[form] = (torch.cuda.max_memory_allocated() - base) / 2**30
        _zero_launch_counts()
        ms = {form: [] for form in renderers}
        for _ in range(FORMS_FRAMES):
            for form, r in renderers.items():
                t1 = time.perf_counter()
                r.render_frame()
                ms[form].append((time.perf_counter() - t1) * 1e3)
        launches = _launch_counts()
        outs = {form: forward_frame(scene, layout, kw["pipeline"], kw["shading"], W, H,
                                    tonemap=kw["tonemap"], shadow_map_size=kw["shadow_map_size"],
                                    shadow_params=kw["shadow_params"], return_ids=True,
                                    geometry_forms=GeometryForms(vstage=form))
                for form in renderers}
        (lo, lo_ids), (hi, hi_ids) = outs["loop"], outs["batch"]
        alike = float((lo_ids == hi_ids).float().mean())
        err = (hi - lo).abs()
        off = float((err > 2e-3 + 2e-3 * lo.abs()).float().mean())
        for form in renderers:
            _FRAME_MS[f"(o) {label}, vstage={form}"] = _median(ms[form])
        _log(f"main path, (o) {label}, vstage loop vs batch ({len(layout.object_ranges)} "
             f"objects), taking turns: frame ms median loop {_median(ms['loop']):.3f}, batch "
             f"{_median(ms['batch']):.3f} (all {json.dumps({f: [round(x, 3) for x in v] for f, v in ms.items()})}); "
             f"peak device memory of a frame above the scene, GiB {json.dumps({f: round(v, 3) for f, v in peak.items()})}; "
             f"launches {launches}; equal ids {alike:.4%}; frame bar: values off "
             f"{off:.4%}, max |d| {float(err.max()):.3e}")
        if launches != _counts(raster_resolve=2 * FORMS_FRAMES):
            raise SystemExit(f"phase main path, (o) {label}: launches {launches}")
        if not (bool(torch.isfinite(hi).all()) and alike >= VSTAGE_IDS_ALIKE
                and off < 2e-3 and float(err.max()) < 0.05):
            raise SystemExit(f"phase main path, (o) {label}: the batched vertex stage's frame "
                             "is not finite, its ids differ or it is off the frame bar")
        by_path[f"vstage_{key}"] = launches
        del renderers, outs, lo, hi, lo_ids, hi_ids, err

    scene, layout, kw = headline
    pipeline, shading = kw["pipeline"], kw["shading"]
    common = dict(tonemap=kw["tonemap"], shadow_map_size=kw["shadow_map_size"],
                  shadow_params=kw["shadow_params"])
    # clip_compact=0: the exact [2T] near-clip layout
    exact = GeometryForms(clip_compact=0)
    frames = [forward_frame(scene, layout, pipeline, shading, W, H, return_depth=True,
                            return_ids=True, diagnostics=True, geometry_forms=forms, **common)
              for forms in (GeometryForms(), exact)]
    overflow = int(frames[0][3]["clip_overflow"])
    same = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
            for a, b in zip(frames[0][:3], frames[1][:3])]
    del frames
    renderer = make(scene, layout, {**kw, "geometry_forms": exact})
    renderer.render_frame()  # warm-up: the sun map
    by_path["clip_compact_0"] = _drive("(o) headline, clip_compact=0 (2T raster slots)", renderer,
                                       FORMS_FRAMES, _counts(raster_resolve=FORMS_FRAMES))
    _log(f"(o) clip_compact=0: the default's clip_overflow {overflow}; (frame, depth, ids) "
         f"bit-equal to the default {same}; raster slots {2 * layout.num_triangles}")
    if overflow == 0 and not all(same):
        raise SystemExit("phase main path, (o) clip_compact=0: the exact layout's frame differs "
                         "from the compacted one with no overflow")
    del renderer

    # cap_big = T at the 3840x2160 sample extent: K4 (shade-once MSAA 4x)
    # and K2 (supersampled), each against its plain version under the cap
    t = layout.num_triangles
    raised = GeometryForms(cap_big=t)
    msaa = dataclasses.replace(pipeline, msaa_samples=MSAA)
    sub = dataclasses.replace(pipeline, msaa_samples=1)
    ws, hs = W * SX, H * SY
    geo = frame_geometry(scene, layout, sub, W, H).at_extent(sub, ws, hs)
    overflow = {}
    for name, cap in (("default", None), ("cap_big=T", t)):
        k4 = prepare_ids(geo.setup, hs, ws, geo.clip_src, small_limit=t, id_bound=t, cap_big=cap)
        overflow[name] = k4.bin_overflow.tolist()
    res = _against_plain("raster_ids", f"msaa{MSAA} sample pass, cap_big={t}", raster_ids,
                         raster_ids_plain, (k4.table, k4.sorted_tris, k4.seg, k4.nbx, hs, ws,
                                            sub.depth_compare_op), k4.plan, lanes=False,
                         extra=SKIP_OFF)
    k4_ms = _median(_event_times_ms(lambda: raster_ids(
        k4.table, k4.sorted_tris, k4.seg, k4.nbx, hs, ws, sub.depth_compare_op, plan=k4.plan),
        KERNEL_TIMINGS))
    _log(f"(o) K4 at {ws}x{hs}: bin_overflow [big, huge] default {overflow['default']}, "
         f"cap_big={t} {overflow['cap_big=T']}; covered {int((res['tid'] >= 0).sum())}; "
         f"raster_ids under the raised cap {k4_ms:.4f} ms (median of {KERNEL_TIMINGS}), "
         f"binned pairs {int(k4.n_pairs)}")
    if overflow["cap_big=T"][0] != 0:
        raise SystemExit("phase main path, (o) cap_big=T: the sample pass still overflows")
    del geo, k4, res
    hi = _hold_k2(f"(o) supersampled {ws}x{hs}, cap_big={t}", scene, layout, sub, ws, hs, raised)
    default_hi = _hold_k2(f"(o) supersampled {ws}x{hs}, default cap", scene, layout, sub, ws, hs)
    _log(f"(o) K2 at {ws}x{hs}: bin_overflow default {default_hi['bin_overflow']}, cap_big={t} "
         f"{hi['bin_overflow']}")
    if hi["bin_overflow"][0] != 0:
        raise SystemExit("phase main path, (o) cap_big=T: the supersampled frame still overflows")
    del hi, default_hi
    for key, label, pipe, extra, expect in (
        ("msaa4_cap_big", f"(o) headline msaa{MSAA} shade-once, cap_big={t}", msaa, {},
         _counts(raster_resolve=FORMS_FRAMES, raster_ids=FORMS_FRAMES)),
        ("msaa_super_cap_big", f"(o) headline msaa{MSAA} supersampled, cap_big={t}", msaa,
         {"msaa_mode": "super"}, _counts(raster_resolve=FORMS_FRAMES)),
    ):
        renderer = make(scene, layout, {**kw, "pipeline": pipe, "geometry_forms": raised, **extra})
        renderer.render_frame()  # warm-up: the sun map
        by_path[key] = _drive(label, renderer, FORMS_FRAMES, expect)
        del renderer
    agree = _check_band_stitch(f"(o) 4 contiguous bands of the supersampled frame, cap_big={t}",
                               scene, layout, {**kw, "pipeline": sub}, False, width=ws,
                               height=hs, forms=raised)
    share = float(agree.reshape(H, SY, W, SX).all(dim=3).all(dim=1).float().mean())
    _log(f"(o) cap_big={t}: the stitched bands' footprint share {share:.4%} (loop (c) prints "
         "it under the default cap)")
    return by_path


def _frame_drift(out, ref) -> dict:
    """|d| of a frame against the reference frame: the share of values off
    2e-3 + 2e-3|ref|, max, p99, p99.5, median and mean."""
    import torch

    err = (out - ref).abs().flatten()
    q = torch.quantile(err.double(), torch.tensor([0.5, 0.99, 0.995], dtype=torch.float64,
                                                  device=err.device))
    return {"off": float((err > 2e-3 + 2e-3 * ref.abs().flatten()).double().mean()),
            "max": float(err.max()), "median": float(q[0]), "p99": float(q[1]),
            "p995": float(q[2]), "mean": float(err.double().mean())}


def _rhi_paths(make, headline: tuple) -> dict:
    """(q) The RHI on the card: Device() picks cuda:0 (its score printed);
    every tensor of the headline scene through Buffer.upload_via_staging,
    back bit-equal; the IBL precompute recorded with CommandBuffer.dispatch
    and run by execute_dispatches, bit-equal to the direct calls; the
    headline scene through save_scene and load_scene, its frame bit-equal
    to the frame before (one K1 and one K2); then app.main for APP_X11_FRAMES
    frames at 1920x1080 into an X11 window of the server double, where
    libX11 is installed on the host (the X11 path is host-only; its absence
    is printed)."""
    import ctypes.util

    import torch

    from renderer_rs_tpu_torch.app.main import main as app_main
    from renderer_rs_tpu_torch.ops.ibl import brdf_lut, irradiance_map, prefilter_map
    from renderer_rs_tpu_torch.platform.x11_server_double import X11ServerDouble
    from renderer_rs_tpu_torch.renderer.checkpoint import _flatten, load_scene, save_scene
    from renderer_rs_tpu_torch.resources.texture import CubeMap
    from renderer_rs_tpu_torch.rhi.buffer import Buffer, BufferUsage
    from renderer_rs_tpu_torch.rhi.command import CommandBuffer
    from renderer_rs_tpu_torch.rhi.device import Device

    def bits(x):
        return x.view(torch.int16) if x.dtype == torch.bfloat16 else x

    scene, layout, kw = headline
    by_path = {}
    dev = Device()
    _log(f"(q) Device(): {dev.primary} of {len(dev.devices)} card(s), score {dev.score} "
         f"({_CARD})")
    if dev.primary != torch.device("cuda", 0):
        raise SystemExit(f"phase main path, (q): Device() chose {dev.primary}")
    leaves = _flatten(scene)
    hosts = [t.cpu() for _, t in leaves]
    t0 = time.perf_counter()
    bufs = [Buffer.new_with_data(BufferUsage.VERTEX, h).upload_via_staging(h) for h in hosts]
    dev.wait_idle()
    secs = time.perf_counter() - t0
    same = all(b.data.device == dev.primary and torch.equal(bits(b.data), bits(t))
               for b, (_, t) in zip(bufs, leaves))
    nbytes = sum(b.size_bytes for b in bufs)
    _log(f"(q) {len(leaves)} scene tensors, {nbytes / 1e6:.1f} MB, through "
         f"Buffer.upload_via_staging in {secs * 1e3:.1f} ms: bit-equal {same}")
    if not same:
        raise SystemExit("phase main path, (q): a staged upload differs from the scene tensor")
    sky = scene.environment.skybox_mips[0]
    mips = CubeMap.from_faces(sky, generate_mips=True).mips
    cb = CommandBuffer().begin()
    cb.dispatch(irradiance_map, sky, 16)
    cb.dispatch(prefilter_map, mips, 32, 5, 32)
    cb.dispatch(brdf_lut, 64, 256, 64, "cuda")
    cb.end()
    t0 = time.perf_counter()
    got = cb.execute_dispatches()
    dev.wait_idle()
    secs = time.perf_counter() - t0
    want = [irradiance_map(sky, 16), prefilter_map(mips, 32, 5, 32), brdf_lut(64, 256, 64, "cuda")]
    same = (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and all(torch.equal(a, b) for a, b in zip(got[1], want[1])))
    env = scene.environment
    as_built = (torch.equal(got[0], env.irradiance_mips[0]) and torch.equal(got[2], env.brdf_lut)
                and all(torch.equal(a, b) for a, b in zip(got[1], env.prefiltered_mips)))
    _log(f"(q) the IBL precompute as {len(cb.dispatches)} dispatches in {secs * 1e3:.1f} ms: "
         f"bit-equal to the direct calls {same}, to the scene's own maps {as_built}")
    if not same:
        raise SystemExit("phase main path, (q): execute_dispatches differs from the direct calls")
    before = make(scene, layout, kw).render_frame_hdr()
    with tempfile.TemporaryDirectory() as directory:
        path = os.path.join(directory, "headline.npz")
        t0 = time.perf_counter()
        save_scene(path, scene, layout)
        t1 = time.perf_counter()
        loaded, loaded_layout = load_scene(path, scene)
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    renderer = make(loaded, loaded_layout, kw)
    _zero_launch_counts()
    after = renderer.render_frame_hdr()
    by_path["checkpoint"] = launches = _launch_counts()
    same = bool(torch.equal(after, before)) and loaded_layout == layout
    _log(f"(q) save_scene {(t1 - t0):.2f}s ({size / 1e6:.1f} MB, {len(leaves)} leaves), "
         f"load_scene {(t2 - t1):.2f}s; the reloaded scene's frame bit-equal {same}, launches "
         f"{launches}")
    if not same or launches != _counts(raster_depth=1, raster_resolve=1):
        raise SystemExit("phase main path, (q): the checkpoint round trip changed the frame")
    if ctypes.util.find_library("X11") is None:
        _log("(q) app.main into an X11 window: not run, libX11 is not installed on this host "
             "(the window is host-only; no kernel or device path is skipped)")
        return by_path
    argv = ["--scene", "full", "--textured", "--width", str(W), "--height", str(H),
            "--frames", str(APP_X11_FRAMES)]
    with X11ServerDouble() as srv:
        _zero_launch_counts()
        t0 = time.perf_counter()
        rc = app_main(argv + ["--display", srv.display], device="cuda")
        secs = time.perf_counter() - t0
        launches = _launch_counts()
        rows = sum(p["height"] for p in srv.put_images if p["width"] == W)
        destroyed = len(srv.destroyed)
    _log(f"(q) app.main ran {APP_X11_FRAMES} frames at {W}x{H} into an X11 window of the server "
         f"double (libX11 found): rc {rc} in {secs:.2f}s (the scene build included), "
         f"{rows} of {APP_X11_FRAMES * H} rows blitted, window destroyed {destroyed}, launches "
         f"{launches}")
    if (rc != 0 or rows != APP_X11_FRAMES * H or destroyed != 1
            or launches != _counts(raster_depth=1, raster_resolve=APP_X11_FRAMES)):
        raise SystemExit("phase main path, (q): the app's X11 window loop failed")
    by_path["x11_app"] = launches
    return by_path


def _sequential_bands(scenes, layout, pipeline, shading, width, height, mesh, interleaved, kw,
                      return_ids=False):
    """Loop (r)'s sequential reference of render_frame_sharded: per frame,
    one forward_frame(band=band_spec(k, ...)) per shard of the mesh, one
    after another on the caller's stream, each band's rows put in place by
    band_rows: [F, H*sy, W*sx, 4] in frame row order (and the source ids,
    [F, H, W], with return_ids)."""
    import torch

    from renderer_rs_tpu_torch.parallel import band_rows, band_spec
    from renderer_rs_tpu_torch.renderer.passes import MSAA_GRIDS, forward_frame

    n_rows = mesh.shape["rows"]
    sx, sy = MSAA_GRIDS.get(pipeline.msaa_samples, (1, 1))
    band_h = height * sy // n_rows
    frames, ids = [], []
    for scene in scenes:
        frame = torch.empty((height * sy, width * sx, 4), device=scene.device)
        if return_ids:
            ids.append(torch.full((height, width), -2, dtype=torch.int32, device=scene.device))
        for k in range(n_rows):
            spec = band_spec(k, n_rows, band_h, interleaved)
            rows = band_rows(spec, device=scene.device)
            band = forward_frame(scene, layout, pipeline, shading, width, height, band=spec,
                                 return_ids=return_ids, **kw)
            if return_ids:
                band, ids[-1][rows] = band
            frame[rows] = band
        frames.append(frame)
    return (torch.stack(frames), torch.stack(ids)) if return_ids else torch.stack(frames)


def _shard_case(label: str, scenes, placed, layout, pipeline, shading, width, height, mesh,
                interleaved: bool, kw: dict, expect: dict):
    """One case of loop (r): the concurrent frame (render_frame_sharded on
    `placed`, unshard_rows, and resolve_msaa under MSAA) once with every
    launch counter zeroed just before and read just after (they must be
    `expect`), bit-equal to the sequential reference on `scenes`; then
    SHARD_PAIRS interleaved pairs of the two, timed on the host clock to a
    synchronize. Returns (launches, the frames, the two closures)."""
    import torch

    from renderer_rs_tpu_torch.parallel import render_frame_sharded, resolve_msaa, unshard_rows

    n_rows, samples = mesh.shape["rows"], pipeline.msaa_samples

    def concurrent():
        out = render_frame_sharded(placed, layout, pipeline, shading, width, height, mesh,
                                   interleaved=interleaved, **kw)
        return resolve_msaa(unshard_rows(out, n_rows, interleaved), samples)

    def sequential():
        return resolve_msaa(_sequential_bands(scenes, layout, pipeline, shading, width, height,
                                              mesh, interleaved, kw), samples)

    concurrent(), sequential()  # warm-up
    torch.cuda.synchronize()
    _zero_launch_counts()
    got = concurrent()
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = sequential()
    equal = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
    ms = {"concurrent": [], "sequential": []}
    for _ in range(SHARD_PAIRS):
        for name, fn in (("concurrent", concurrent), ("sequential", sequential)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    for name, xs in ms.items():
        _FRAME_MS[f"(r) {label}, {name}"] = _median(xs)
    _log(f"main path, (r) {label}: mesh {mesh.shape} on {[str(d) for d in mesh.devices[0]]}..., "
         f"frames {tuple(got.shape)}, launches {launches}, bit-equal to the sequential "
         f"reference {equal}, finite {bool(torch.isfinite(got).all())}; frame ms over "
         f"{SHARD_PAIRS} interleaved pairs: concurrent median {_median(ms['concurrent']):.3f} "
         f"(min {min(ms['concurrent']):.3f}, max {max(ms['concurrent']):.3f}), sequential "
         f"median {_median(ms['sequential']):.3f} (min {min(ms['sequential']):.3f}, max "
         f"{max(ms['sequential']):.3f})")
    if launches != expect:
        raise SystemExit(f"phase main path, (r) {label}: launches {launches}, expected {expect}")
    if not (equal and bool(torch.isfinite(got).all())):
        raise SystemExit(f"phase main path, (r) {label}: the concurrent frames differ from the "
                         "sequential reference")
    return launches, got, concurrent, sequential


def _shard_profile(label: str, concurrent, sequential, n_shards: int) -> None:
    """Loop (r)'s profile, queued for after the main paths (a profiler
    session slows the process's later launches): SHARD_PROFILED calls of
    each form under torch.profiler. The device busy share (the union of
    kernels, copies and sets over the host wall time of the frames), and
    for the concurrent form the share of that time in which kernels of two
    or more shard streams (those that ran K3's resolve pass) were in flight
    at once; each concurrent frame's K3 must have run on n_shards distinct
    streams."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, fn in (("concurrent", concurrent), ("sequential", sequential)):
        fn()
        torch.cuda.synchronize()
        # torch.profiler on the card has lost device events: one session of
        # three calls (~34,000 kernels) recorded none, another 10 of its 12
        # K3 passes. A session profiles SHARD_PROFILED calls, and one whose
        # K3 passes are not all there is taken again, up to
        # SHARD_PROFILE_TRIES sessions
        for attempt in range(1, SHARD_PROFILE_TRIES + 1):
            with tempfile.TemporaryDirectory() as tmp:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(SHARD_PROFILED):
                        fn()
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                trace = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(trace)
                with open(trace) as fh:
                    events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"
                              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
            k3 = sorted((e for e in events if e["cat"] == "kernel"
                         and "raster_vis_resolve" in e["name"]), key=lambda e: e["ts"])
            if len(k3) == SHARD_PROFILED * n_shards:
                break
            _log(f"(r) {label}, {name}: profiler session {attempt} recorded {len(k3)} K3 "
                 f"resolve passes of {SHARD_PROFILED * n_shards}, {len(events)} device events")
        busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in events])
        shard_streams = {_stream_of(e) for e in k3}
        per_stream = {}
        for e in events:
            if e["cat"] == "kernel" and _stream_of(e) in shard_streams:
                per_stream.setdefault(_stream_of(e), []).append((e["ts"], e["ts"] + e["dur"]))
        overlap = _overlap_us([_merged(v) for v in per_stream.values()])
        _log(f"(r) {label}, {name}, {SHARD_PROFILED} call(s) under torch.profiler: wall "
             f"{wall_us / 1e3:.3f} ms, device busy share {busy / wall_us:.4f}, share of wall time "
             f"with kernels of >= 2 shard streams in flight {overlap / wall_us:.4f}; K3 launches "
             f"{len(k3)} on {len(shard_streams)} streams, kernels and copies {len(events)}")
        if len(k3) != SHARD_PROFILED * n_shards:
            raise SystemExit(f"(r) {label}, {name}: {len(k3)} K3 resolve passes profiled, "
                             f"expected {SHARD_PROFILED * n_shards}")
        # a call's shards end before the next call's begin (the caller's
        # stream waits for them, the next shards for the caller's stream),
        # so the K3 passes in time order come in calls of n_shards
        distinct = [len({_stream_of(e) for e in k3[i:i + n_shards]})
                    for i in range(0, len(k3), n_shards)]
        if name == "concurrent" and distinct != [n_shards] * SHARD_PROFILED:
            raise SystemExit(f"(r) {label}: the shards of a call ran on {distinct} streams, "
                             f"not {n_shards} distinct ones")


def _stream_of(event) -> tuple:
    """(device, stream) of a kernel event of a torch.profiler chrome trace."""
    return event["args"].get("device"), event["args"]["stream"]


def _merged(intervals):
    """Sorted, disjoint union of [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_us(intervals) -> float:
    return sum(b - a for a, b in _merged(intervals))


def _overlap_us(streams) -> float:
    """The time in which two or more of the streams (each a disjoint
    interval list) are busy at once."""
    edges = sorted((t, d) for ivs in streams for a, b in ivs for t, d in ((a, 1), (b, -1)))
    total, active, last = 0.0, 0, None
    for t, d in edges:
        if active >= 2:
            total += t - last
        active += d
        last = t
    return total


# loop (r)'s profiles, taken by phase_shard_profiles after phase_breakdown
_SHARD_PROFILES: list = []


def phase_shard_profiles() -> None:
    for args in _SHARD_PROFILES:
        _shard_profile(*args)
    _SHARD_PROFILES.clear()


def _sharded_paths(headline: tuple) -> dict:
    """(r) render_frame_sharded (a host thread and a CUDA stream per shard,
    the bands enqueued in turn) against the smoke's sequential reference (one
    forward_frame(band=...) per shard on the default stream, stitched by
    band_rows), every case bit for bit: (1) the headline frame on a (1, 4)
    mesh on cuda:0, contiguous and pair-interleaved (one K3 and one K1 per
    shard), its source ids equal to the whole frame's and its colours
    within FRAME_BAR of the whole frame at the exact rates; (2) the
    orbit camera's first two views on a (2, 2) mesh through
    shard_scene_batch; (3) the dry run's flagship frame at 256x256 (one K3
    and one K6 per shard), and the same under MSAA 4x on the supersampled
    rows, unshard_rows and resolve_msaa. Timed in interleaved pairs; each
    case's profile is queued. Where the host has two cards or more, (1)
    and (2) again on a mesh of distinct cards, bit-equal to the one-card
    frames."""
    import dataclasses

    import torch

    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.parallel import make_device_mesh, shard_scene_batch
    from renderer_rs_tpu_torch.renderer.passes import ShadeRates, forward_frame

    by_path, frames = {}, {}
    scene, layout, kw = headline
    args = (layout, kw["pipeline"], kw["shading"], W, H)
    fkw = dict(tonemap=kw["tonemap"], shadow_map_size=kw["shadow_map_size"],
               shadow_params=kw["shadow_params"])
    one_card = make_device_mesh(N_BANDS, frame_axis=1, devices=["cuda:0"] * N_BANDS)
    views = [_orbit_scene(headline, n) for n in (1, 2)]
    two_by_two = make_device_mesh(4, devices=["cuda:0"] * 4)
    per_shard = _counts(raster_depth=N_BANDS, raster_visibility=N_BANDS)
    # (1) the headline frame on cuda:0 x 4
    whole, whole_ids = forward_frame(scene, *args, return_ids=True,
                                     shade_rates=ShadeRates(**EXACT_RATES), **fkw)
    for interleaved in (False, True):
        label = "headline, 1x4 on cuda:0, " + ("pair-interleaved" if interleaved else "contiguous")
        key = "r_headline_interleaved" if interleaved else "r_headline"
        by_path[key], got, conc, seq = _shard_case(label, [scene], [scene], *args, one_card,
                                                   interleaved, fkw, per_shard)
        frames[key] = got
        _, ids = _sequential_bands([scene], *args, one_card, interleaved, fkw, return_ids=True)
        drift = _frame_drift(got[0], whole)
        ids_equal = bool(torch.equal(ids[0], whole_ids))
        _log(f"(r) {label}: stitched ids equal to the whole frame's {ids_equal}; colours against "
             f"the whole frame at the exact rates: {drift}")
        if not (ids_equal and drift["off"] < FRAME_BAR[0]
                and drift["max"] < FRAME_BAR[1]):
            raise SystemExit(f"phase main path, (r) {label}: the stitched frame's ids or colours "
                             "differ from the whole frame's")
        _SHARD_PROFILES.append((label, conc, seq, N_BANDS))
    # (2) two orbit views of one layout, placed by shard_scene_batch
    label = "orbit views 1 and 2, 2x2 on cuda:0 through shard_scene_batch"
    placed = shard_scene_batch(views, two_by_two)
    if any(p[row[0]] is not v for p, v, row in zip(placed, views, two_by_two.devices)):
        raise SystemExit("phase main path, (r): shard_scene_batch copied a scene already there")
    by_path["r_orbit_views"], got, conc, seq = _shard_case(
        label, views, placed, *args, two_by_two, True, fkw, per_shard)
    frames["r_orbit_views"] = got
    if torch.equal(got[0], got[1]):
        raise SystemExit(f"phase main path, (r) {label}: the two views rendered alike")
    _SHARD_PROFILES.append((label, conc, seq, 4))
    # (3) the flagship frame of the dry run, 1x and MSAA 4x
    t0 = time.perf_counter()
    f_scene, f_layout, f_kw, _ = full_scene(FLAGSHIP_SIZE, FLAGSHIP_SIZE, device="cuda",
                                            **FLAGSHIP)
    _log(f"(r) flagship scene: T={f_layout.num_triangles}, built in "
         f"{time.perf_counter() - t0:.2f}s")
    f_fkw = dict(tonemap="aces", shadow_map_size=256, shadow_params=f_kw["shadow_params"])
    flagship = [f_scene, f_scene]
    for samples in (1, MSAA):
        pipeline = dataclasses.replace(f_kw["pipeline"], msaa_samples=samples)
        label = f"flagship {FLAGSHIP_SIZE}x{FLAGSHIP_SIZE}, 2x2 on cuda:0" + (
            f", msaa{samples} supersampled" if samples > 1 else "")
        launches, got, _, _ = _shard_case(
            label, flagship, shard_scene_batch(flagship, two_by_two), f_layout, pipeline,
            f_kw["shading"], FLAGSHIP_SIZE, FLAGSHIP_SIZE, two_by_two, True, f_fkw,
            _counts(raster_depth_batch=4, raster_visibility=4))
        by_path["r_flagship" if samples == 1 else "r_flagship_msaa4"] = launches
        _log(f"(r) {label}: mean rgb {[round(float(v), 4) for v in got[..., :3].mean((0, 1, 2))]}")
    # the cross-card run
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        _log("loop (r) cross-card: not run, 1 card")
        return by_path
    cards = [f"cuda:{i % n_cards}" for i in range(4)]
    for key, mesh, scenes, interleaved in (
            ("r_headline_interleaved", make_device_mesh(4, frame_axis=1, devices=cards),
             [scene], True),
            ("r_orbit_views", make_device_mesh(4, devices=cards), views, True)):
        label = f"cross-card {key[2:]}, {mesh.shape} on {cards}"
        by_path[f"{key}_cross_card"], got, conc, seq = _shard_case(
            label, scenes, shard_scene_batch(scenes, mesh), *args, mesh, interleaved, fkw,
            per_shard)
        equal = bool(torch.equal(got.view(torch.int32), frames[key].view(torch.int32)))
        _log(f"loop (r) cross-card: {label} bit-equal to the one-card frames {equal}")
        if not equal:
            raise SystemExit(f"phase main path, (r) {label}: differs from the one-card frames")
        _SHARD_PROFILES.append((label, conc, seq, 4))
    return by_path


def _transparent_layer(scene, device: str):
    """The translucent surfaces composited over the headline frame: the
    transparent golden's textured checker quad (tests/test_golden.py:128-145)
    and three more overlapping quads at other depths, two untextured, one
    standing through a sphere of the grid and the floor; the headline
    camera and lights, PBR under alpha_blend."""
    import math

    from renderer_rs_tpu_torch.mathx import quat_from_axis_angle
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.resources.material import Material
    from renderer_rs_tpu_torch.resources.ubo import SceneUbo
    from renderer_rs_tpu_torch.scene.transform import Transform
    from renderer_rs_tpu_torch.utils import meshgen

    upright = quat_from_axis_angle([1.0, 0.0, 0.0], math.pi / 2)  # plane_mesh faces +Z
    b = SceneBuilder()
    b.set_textures([meshgen.checkerboard_image(64, squares=4)], size=64)
    for pos, size, mat in (
        ([0.0, 1.2, 1.2], 2.4, Material(base_color=(1.0, 0.6, 0.3, 0.55), roughness=0.4,
                                        base_color_texture=0)),
        ([-1.2, 0.6, 0.4], 1.6, Material(base_color=(0.9, 0.1, 0.1, 0.4), roughness=0.3)),
        ([0.8, 0.9, 0.8], 1.8, Material(base_color=(0.2, 0.4, 1.0, 0.5), roughness=0.6,
                                        metallic=0.3, base_color_texture=0)),
        ([0.4, 0.5, 2.0], 1.2, Material(base_color=(0.1, 0.9, 0.3, 0.35), roughness=0.5)),
    ):
        b.add_mesh(meshgen.plane_mesh(size, uv_scale=1.0),
                   Transform().with_position(pos).with_rotation(upright), mat)
    b.set_camera(scene.camera)
    b.set_lights(scene.lights)
    b.set_scene_ubo(SceneUbo.create(ambient_color=(0.3, 0.3, 0.3)))
    return b.build(device=device)


def _transparent_reach(t_scene, t_layout, pipeline, depth):
    """The pixels some translucent fragment reaches and passes the depth
    test at: the transparent pass's setup rasterized on the scan against the
    opaque depth, depth writes off (every fragment tests the opaque depth)."""
    import dataclasses

    from renderer_rs_tpu_torch.ops.clip import clip_triangles_near
    from renderer_rs_tpu_torch.ops.raster import gather_triangle_clip, rasterize, setup_triangles
    from renderer_rs_tpu_torch.renderer.passes import vertex_stage

    tri_clip, valid, _, _ = clip_triangles_near(
        gather_triangle_clip(vertex_stage(t_scene, t_layout).clip, t_scene.tris))
    pipe = dataclasses.replace(pipeline, depth_write_enable=False)
    setup = setup_triangles(tri_clip, W, H, pipe, tri_valid=valid)
    return rasterize(setup, H, W, pipe, depth_init=depth).covered


def _blend_stencil_msaa_paths(scene, layout, kw) -> dict:
    """The paths of the transparent pass, the supersampling MSAA branch, the
    stencil state machine and point/line primitives at 1920x1080, each
    with its launch counters zeroed just before and read just after:
    (a) the headline frame with return_depth (one K1 sun map, one K2) and
    transparent_pass over it (PBR, the sun map's shadow term), then ACES;
    (b) the headline scene under MSAA 4x with return_depth, the
    supersampling branch (one K1, one K2 at 3840x2160, no K4); (c) the same
    through render_frame_sharded as four bands of the supersampled frame on
    cuda:0, contiguous and pair-interleaved, unshard_rows and resolve_msaa
    (four K3 and four K1 a frame); (d) the spinning cube with a two-sided
    stencil through rendering=RenderingConfig(stencil=...), on the scan;
    (e) a LINE_STRIP and a POINT_LIST draw, FLAT, on the scan."""
    import dataclasses

    import numpy as np
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        prepare_resolve,
        raster_resolve,
        raster_resolve_plain,
    )
    from renderer_rs_tpu_torch.ops.tonemap import apply_tonemap
    from renderer_rs_tpu_torch.parallel import (
        make_device_mesh,
        render_frame_sharded,
        resolve_msaa,
        unshard_rows,
    )
    from renderer_rs_tpu_torch.renderer.passes import (
        ShadingModel,
        forward_frame,
        frame_geometry,
        shadow_map_pass,
        transparent_pass,
    )

    by_path = {}
    pipeline, shading = kw["pipeline"], kw["shading"]
    common = dict(tonemap="none", shadow_map_size=kw["shadow_map_size"],
                  shadow_params=kw["shadow_params"])

    # (a) transparency over the headline frame
    t_scene, t_layout = _transparent_layer(scene, "cuda")
    t_ms = []

    def transparent_frame(timed=False):
        smap = shadow_map_pass(scene, layout, kw["shadow_map_size"])
        color, depth = forward_frame(scene, layout, pipeline, shading, W, H, shadow_map=smap,
                                     return_depth=True, **common)
        if timed:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        out = transparent_pass(color, depth, t_scene, t_layout, pipeline, W, H,
                               shading=ShadingModel.PBR, shadow_map=smap,
                               shadow_params=kw["shadow_params"],
                               light_space_matrix=scene.light_space_matrix)
        if timed:
            torch.cuda.synchronize()
            t_ms.append((time.perf_counter() - t1) * 1e3)
        return color, depth, out, apply_tonemap(out, "aces")

    transparent_frame()  # warm-up
    by_path["transparent"] = _drive(
        "headline + transparent pass (PBR, 4 quads)", lambda: transparent_frame(True)[3],
        TRANSPARENT_FRAMES, _counts(raster_depth=TRANSPARENT_FRAMES,
                                    raster_resolve=TRANSPARENT_FRAMES))
    color, depth, out, final = transparent_frame()
    geo = frame_geometry(scene, layout, pipeline, W, H)
    k2 = prepare_resolve(geo.setup, H, W, geo.attr, scene.tris, geo.clip_src, geo.clip_planes,
                         geo.mat_flat, small_limit=layout.num_triangles)
    k2_depth = raster_resolve(k2.table, k2.sorted_tris, k2.seg, k2.nbx, H, W, k2.n_vary,
                              k2.n_flat, pipeline.depth_compare_op, plan=k2.plan)[0]
    reach = _transparent_reach(t_scene, t_layout, pipeline, depth)
    untouched = bool(torch.equal(out[~reach].view(torch.int32), color[~reach].view(torch.int32)))
    depth_same = bool(torch.equal(depth.view(torch.int32), k2_depth.view(torch.int32)))
    changed = float((out != color).any(-1).float().mean())
    _log(f"transparent pass: ms median {_median(t_ms):.3f} (all {[round(x, 3) for x in t_ms]}); "
         f"return_depth bit-equal to K2's depth {depth_same}; reached pixels "
         f"{float(reach.float().mean()):.4%}, changed {changed:.4%}, unreached pixels equal to "
         f"the opaque frame {untouched}; finite {bool(torch.isfinite(final).all())}")
    if not (depth_same and untouched and bool(torch.isfinite(final).all())
            and 0.01 < changed <= float(reach.float().mean())):
        raise SystemExit("phase main path, transparent: depth, untouched pixels or the "
                         "composite are wrong")
    del color, depth, out, final, geo, k2

    # (b) the supersampling branch: MSAA 4x with return_depth
    msaa = dataclasses.replace(pipeline, msaa_samples=MSAA)
    sub = dataclasses.replace(pipeline, msaa_samples=1)
    sx, sy = 2, 2

    def supersampled():
        return forward_frame(scene, layout, msaa, shading, W, H, return_depth=True,
                             **{**common, "tonemap": kw["tonemap"]})

    supersampled()  # warm-up
    by_path["supersampled_msaa4"] = _drive(
        f"headline msaa{MSAA} supersampled (return_depth)", lambda: supersampled()[0],
        SUPERSAMPLE_FRAMES, _counts(raster_depth=SUPERSAMPLE_FRAMES,
                                    raster_resolve=SUPERSAMPLE_FRAMES))
    ss, ss_depth = supersampled()
    smap = shadow_map_pass(scene, layout, kw["shadow_map_size"])
    _, hi_depth, diag = forward_frame(scene, layout, sub, shading, W * sx, H * sy,
                                      shadow_map=smap, return_depth=True, diagnostics=True,
                                      **common)
    # K2 at the sample extent beside its plain version on the same table,
    # with the main path's split plan, FORCED_CHUNK and the skip off
    hi_geo = frame_geometry(scene, layout, sub, W * sx, H * sy)
    hi_k2 = prepare_resolve(hi_geo.setup, H * sy, W * sx, hi_geo.attr, scene.tris,
                            hi_geo.clip_src, hi_geo.clip_planes, hi_geo.mat_flat,
                            small_limit=layout.num_triangles)
    hi_res = _against_plain(
        "raster_resolve", f"msaa{MSAA} supersampled {W * sx}x{H * sy}", raster_resolve,
        raster_resolve_plain, (hi_k2.table, hi_k2.sorted_tris, hi_k2.seg, hi_k2.nbx, H * sy,
                               W * sx, hi_k2.n_vary, hi_k2.n_flat, sub.depth_compare_op),
        hi_k2.plan, lanes=True, extra=SKIP_OFF)
    if not (bool(torch.equal(hi_res["depth"], hi_depth)) and bool((hi_res["tid"] >= 0).any())):
        raise SystemExit("phase main path, supersampled msaa: the frame's depth is not K2's "
                         "at the sample extent")
    del hi_geo, hi_k2, hi_res
    min_ok = bool(torch.equal(ss_depth, hi_depth.reshape(H, sy, W, sx).amin(dim=(1, 3))))
    _log(f"supersampled msaa{MSAA}: frame finite {bool(torch.isfinite(ss).all())}, depth = min "
         f"over each 2x2 footprint of K2's {W * sx}x{H * sy} depth {min_ok}; that binning's "
         f"bin_overflow [big, huge] {diag['bin_overflow'].tolist()} (dropped triangles, as in "
         f"the reference: ROADMAP Queue 3 item 5)")
    if not (min_ok and bool(torch.isfinite(ss).all())):
        raise SystemExit("phase main path, supersampled msaa: the resolved depth or frame is wrong")
    del hi_depth

    # (c) render_frame_sharded with MSAA 4x on four bands of the supersampled frame
    mesh = make_device_mesh(N_BANDS, frame_axis=1, devices=["cuda:0"] * N_BANDS)
    for interleaved in (False, True):
        label = "sharded msaa4, " + ("pair-interleaved" if interleaved else "contiguous")

        def render(interleaved=interleaved):
            out = render_frame_sharded([scene], layout, msaa, shading, W, H, mesh,
                                       tonemap=kw["tonemap"],
                                       shadow_map_size=kw["shadow_map_size"],
                                       shadow_params=kw["shadow_params"],
                                       interleaved=interleaved)
            return resolve_msaa(unshard_rows(out, N_BANDS, interleaved), MSAA)[0]

        render()  # warm-up
        by_path["sharded_msaa4_interleaved" if interleaved else "sharded_msaa4"] = _drive(
            label, render, SHARDED_MSAA_FRAMES,
            _counts(raster_depth=N_BANDS * SHARDED_MSAA_FRAMES,
                    raster_visibility=N_BANDS * SHARDED_MSAA_FRAMES))
        got = render()
        # ids and depth at the sample extent, where no binning overflowed;
        # the colour drift bar over the pixels whose whole sample footprint
        # rasterized the same (a triangle the big-class cap drops from one
        # side and not the other is the binning's, not the shading's)
        agree = _check_band_stitch(label, scene, layout, {**kw, "pipeline": sub}, interleaved,
                                   width=W * sx, height=H * sy)
        same = agree.reshape(H, sy, W, sx).all(dim=3).all(dim=1)
        d = (got - ss)[same][..., :3].abs().flatten()
        p99 = float(d.kthvalue(math.ceil(0.99 * d.numel())).values)
        _log(f"{label}: resolved stitch vs the supersampled frame over the {float(same.float().mean()):.4%} "
             f"of pixels whose footprint rasterized alike, rgb: mean |d| {float(d.mean()):.3e}, "
             f"p99 {p99:.3e}, max {float(d.max()):.3e}; over all pixels: max "
             f"{float((got - ss).abs().max()):.3e}")
        if float(same.float().mean()) < MSAA_STITCH_ALIKE:
            raise SystemExit(f"phase main path, {label}: fewer than {MSAA_STITCH_ALIKE:.0%} of "
                             "the pixels' footprints rasterized alike in the bands and the frame")
        if not (bool(torch.isfinite(got).all()) and p99 < BAND_DRIFT_P99):
            raise SystemExit(f"phase main path, {label}: the resolved stitch drifts from the "
                             "supersampled frame beyond p99 0.01")
    del ss, ss_depth, got

    # (d) two-sided stencil on the spinning cube
    by_path["cube_stencil"] = _stencil_cube_path()
    # (e) a LINE_STRIP and a POINT_LIST draw
    by_path.update(_topology_paths())
    return by_path


def _stencil_rendering(width: int, height: int):
    """The cube's two-sided stencil: front faces count (INCREMENT), back
    faces stamp 200 through a low-nibble write mask, depth fails INVERT."""
    from renderer_rs_tpu_torch.rhi.rendering import (
        RenderingConfig,
        StencilAttachment,
        StencilFaceState,
        StencilOp,
    )

    return RenderingConfig(width=width, height=height, stencil=StencilAttachment(
        clear_stencil=3, reference=9, compare="greater_or_equal",
        pass_op=StencilOp.INCREMENT_AND_CLAMP, depth_fail_op=StencilOp.INVERT,
        back=StencilFaceState(reference=200, compare="always", pass_op=StencilOp.REPLACE,
                              write_mask=0x0F)))


def _stencil_cube(device: str, width: int, height: int):
    """The cube scene, built once; returns angle -> forward_frame's (out,
    stencil, ids) of the cube turned by `angle` under the two-sided stencil."""
    import dataclasses

    from renderer_rs_tpu_torch.app.scenes import cube_scene
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.rhi.pipeline import CullMode

    scene, layout, kw, animate = cube_scene(width, height, device=device)
    pipe = dataclasses.replace(kw["pipeline"], cull_mode=CullMode.NONE)

    def frame(angle: float):
        return forward_frame(animate(scene, angle, 1.0 / 60.0), layout, pipe, kw["shading"],
                             width, height, rendering=_stencil_rendering(width, height),
                             return_stencil=True, return_ids=True)

    return frame


def _stencil_cube_path() -> dict:
    """The spinning cube (no culling, so both facings draw) with the
    two-sided stencil at 1920x1080: no raster kernel (the scan); the
    stencil buffer bit-equal to the port's cpu run of the same call."""
    import torch

    frames = iter(range(STENCIL_FRAMES))
    frame = _stencil_cube("cuda", W, H)
    frame(0.0)  # warm-up
    launches = _drive("spinning cube, two-sided stencil",
                      lambda: frame((next(frames) + 1) / 60.0)[0], STENCIL_FRAMES, _counts())
    out, sbuf, ids = frame(0.5)
    ref_out, ref_sbuf, ref_ids = _stencil_cube("cpu", W, H)(0.5)
    equal = bool(torch.equal(sbuf.cpu(), ref_sbuf))
    ids_diff = int((ids.cpu() != ref_ids).sum())
    values = torch.unique(ref_sbuf).tolist()
    _log(f"spinning cube stencil: cuda vs cpu stencil bit-equal {equal}, values {values}, ids "
         f"differing {ids_diff}, frame max |d| {float((out.cpu() - ref_out).abs().max()):.3e}")
    if not (equal and len(values) >= 3 and bool(torch.isfinite(out).all())):
        raise SystemExit("phase main path, stencil: the stencil buffer on cuda differs from the "
                         "cpu run, or the state machine wrote too little")
    return launches


def _topology_scene(topology_name: str, device: str):
    """TOPOLOGY_VERTICES vertices on a spiral in NDC (identity camera),
    coloured per vertex, drawn as `topology_name` through expand_topology."""
    import numpy as np

    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.resources.model import Mesh
    from renderer_rs_tpu_torch.rhi.pipeline import PrimitiveTopology
    from renderer_rs_tpu_torch.rhi.vertex import expand_topology

    n = TOPOLOGY_VERTICES
    a = np.linspace(0.0, 6.0 * np.pi, n, dtype=np.float32)
    r = np.linspace(0.15, 0.9, n, dtype=np.float32)
    pos = np.stack([r * np.cos(a), r * np.sin(a), np.linspace(0.2, 0.8, n, dtype=np.float32)], -1)
    rng = np.random.default_rng(5)
    mesh = Mesh(positions=pos.astype(np.float32),
                normals=np.tile(np.float32([[0, 0, 1]]), (n, 1)),
                tex_coords=np.zeros((n, 2), np.float32),
                tangents=np.tile(np.float32([[1, 0, 0, 1]]), (n, 1)),
                indices=expand_topology(np.arange(n), getattr(PrimitiveTopology,
                                                              topology_name)).reshape(-1),
                colors=rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32))
    return SceneBuilder().add_mesh(mesh).build(device=device)


def _topology_frame(topology_name: str, device: str, width: int, height: int):
    """The draw's scene, built once; returns a callable that renders it
    through forward_frame (FLAT) and gives (out, ids)."""
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    from renderer_rs_tpu_torch.rhi.pipeline import CullMode, GraphicsPipelineBuilder, PrimitiveTopology

    scene, layout = _topology_scene(topology_name, device)
    pipe = (GraphicsPipelineBuilder().topology(getattr(PrimitiveTopology, topology_name))
            .cull_mode(CullMode.NONE).line_width(2.0).build())
    return lambda: forward_frame(scene, layout, pipe, ShadingModel.FLAT, width, height,
                                 return_ids=True)


def _topology_paths() -> dict:
    """A LINE_STRIP of TOPOLOGY_VERTICES - 1 segments and a POINT_LIST of
    TOPOLOGY_VERTICES points through forward_frame, FLAT, at 1920x1080: no
    raster kernel (the scan); covered and finite."""
    import torch

    by_path = {}
    # the strip's three turns run ~9 NDC units long: ~2 W pixels at width 2
    for name, least in (("LINE_STRIP", 2 * W), ("POINT_LIST", TOPOLOGY_VERTICES - 4)):
        frame = _topology_frame(name, "cuda", W, H)
        frame()  # warm-up
        by_path[name.lower()] = _drive(f"{name} (FLAT, {TOPOLOGY_VERTICES} vertices)",
                                       lambda frame=frame: frame()[0], TOPOLOGY_FRAMES,
                                       _counts())
        out, ids = frame()
        covered = int((ids >= 0).sum())
        _log(f"{name}: covered pixels {covered}, primitives hit "
             f"{int(torch.unique(ids[ids >= 0]).numel())}, finite {bool(torch.isfinite(out).all())}")
        if not (covered >= least and bool(torch.isfinite(out).all())):
            raise SystemExit(f"phase main path, {name}: the draw is not covered or not finite")
    return by_path


def _check_plane_vs_bary(label: str, renderer) -> None:
    """The renderer's current frame with its shadow pass in the plane form
    against the same frame in the bary form: winner ids exact, colours
    within PLANE_DRIFT (see there)."""
    import torch

    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    args = (renderer._scene, renderer._layout, renderer.pipeline, renderer.shading, W, H)
    kw = dict(tonemap=renderer.tonemap, shadow_map_size=renderer.shadow_map_size,
              shadow_params=renderer.shadow_params, return_ids=True)
    plane, plane_ids = forward_frame(*args, z_form="plane", **kw)
    bary, bary_ids = forward_frame(*args, z_form="bary", **kw)
    err = (plane - bary).abs()
    off = float((err > 2e-3 + 2e-3 * bary.abs()).float().mean())
    ids_equal = bool(torch.equal(plane_ids, bary_ids))
    _log(f"{label} vs the bary form, same scene: winner ids equal {ids_equal}, max |d| "
         f"{float(err.max()):.3e}, values off the frame bar {off:.4%}, pixels changed "
         f"{int((err.amax(-1) > 0).sum())}")
    if not (ids_equal and off < PLANE_DRIFT[0] and float(err.max()) < PLANE_DRIFT[1]):
        raise SystemExit(f"phase main path, {label}: the plane-form frame drifts from the "
                         "bary-form frame beyond the bar")


def _scan_paths(make) -> dict:
    """The scan rasterizer's scenes on the card: the Hello Triangle at
    800x600 through app.main, and the spinning cube at 1920x1080 through
    the Renderer; neither launches a raster kernel."""
    import tempfile

    import numpy as np

    from renderer_rs_tpu_torch.app.main import main as app_main
    from renderer_rs_tpu_torch.app.scenes import cube_scene
    from renderer_rs_tpu_torch.utils.image_io import read_png

    by_path = {}
    with tempfile.TemporaryDirectory() as out:
        argv = ["--scene", "triangle", "--width", "800", "--height", "600", "--frames",
                str(TRIANGLE_FRAMES), "--out", out]
        app_main(argv[:6] + ["--frames", "1"], device="cuda")  # warm-up, no PNGs
        _zero_launch_counts()
        t0 = time.perf_counter()
        rc = app_main(argv, device="cuda")
        secs = time.perf_counter() - t0
        launches = _launch_counts()
        img = read_png(os.path.join(out, f"frame_{TRIANGLE_FRAMES - 1:05d}.png"))
    bg = np.array([89, 89, 108, 255], np.uint8)  # sRGB of the clear (0.1, 0.1, 0.15)
    covered = int((img != bg).any(-1).sum())
    apex, left, right = img[160, 400, :3], img[445, 210, :3], img[445, 590, :3]
    _log(f"main path, hello triangle 800x600 via app.main: {TRIANGLE_FRAMES} frames in "
         f"{secs:.3f}s, rc {rc}, launches {launches}, covered {covered} (expected 60000), "
         f"apex {apex.tolist()}, bottom-left {left.tolist()}, bottom-right {right.tolist()}")
    if not (rc == 0 and launches == _counts() and img.shape == (600, 800, 4)
            and covered == 60000 and apex.argmax() == 0 and left.argmax() == 1
            and right.argmax() == 2):
        raise SystemExit("phase main path, hello triangle: wrong launches or picture")
    by_path["triangle"] = launches

    scene, layout, kw, animate = cube_scene(W, H, device="cuda")
    renderer = make(scene, layout, kw)
    first = renderer.render_frame().copy()  # warm-up, t = 0
    by_path["cube"] = _drive(
        "spinning cube (animated)", renderer, CUBE_FRAMES, _counts(),
        before_frame=lambda i: renderer.update_scene(
            animate(renderer._scene, (i + 1) / 60.0, 1.0 / 60.0)))
    _check_frame("cube", renderer)
    moved = float((renderer.last_frame != first).any(-1).mean())
    _log(f"cube: pixels changed since t = 0: {moved:.4%}")
    if not 0.001 < moved < 0.5:
        raise SystemExit("phase main path, cube: the animation did not turn the cube")
    return by_path


def phase_probe() -> tuple[dict, dict]:
    """The gather probe's own path: probes.kgather.run for the five bodies
    at PROBE_ITERS iterations; returns the launch counts and µs per
    iteration."""
    from renderer_rs_tpu_torch.probes.kgather import BODIES, run

    _zero_launch_counts()
    us = {body: run(body, PROBE_ITERS) for body in BODIES}
    launches = _launch_counts()
    _log(f"probe_kgather, us per iteration at {PROBE_ITERS} iterations (median of 5): "
         f"{json.dumps(us)}; launches {launches}")
    if launches != _counts(probe_kgather=6 * len(BODIES)):
        raise SystemExit(f"phase probe: launches {launches}")
    return launches, us


def _headline_paths(make, scene, layout, kw) -> dict:
    """The headline frame through Renderer.render_frame, and through the
    MSAA 4x resolve (bench.py's msaa4 frame), then the same scene as four
    row bands through render_frame_sharded, contiguous and
    pair-interleaved; then the bands' stitched ids and depth against the
    frame's, and their colours."""
    import dataclasses

    import torch

    from renderer_rs_tpu_torch.parallel import make_device_mesh, render_frame_sharded, unshard_rows
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8

    by_path = {}
    warm = make(scene, layout, kw)
    for _ in range(2):
        warm.render_frame()
    renderer = make(scene, layout, kw)
    by_path["headline"] = _drive(
        "headline (textured, IBL; static scene)", renderer, HEADLINE_FRAMES,
        _counts(raster_depth=1, raster_resolve=HEADLINE_FRAMES), shade=2 * HEADLINE_FRAMES,
        front=3 * HEADLINE_FRAMES)
    full = _check_frame("headline", renderer)
    # bench.py's MSAA 4x frame (bench.py:236-248): the headline scene
    # through the shade-once resolve, K4 on the 3840x2160 sample pass
    msaa_kw = {**kw, "pipeline": dataclasses.replace(kw["pipeline"], msaa_samples=MSAA)}
    warm = make(scene, layout, msaa_kw)
    for _ in range(2):
        warm.render_frame()
    msaa = make(scene, layout, msaa_kw)
    label = f"headline msaa{MSAA} (textured, IBL; static scene)"
    by_path["headline_msaa4"] = _drive(
        label, msaa, HEADLINE_MSAA_FRAMES,
        _counts(raster_depth=1, raster_resolve=HEADLINE_MSAA_FRAMES,
                raster_ids=HEADLINE_MSAA_FRAMES), front=3 * HEADLINE_MSAA_FRAMES)
    hdr = msaa.render_frame_hdr()
    changed = float(((hdr - full).abs().amax(-1) > 1e-5).float().mean())
    _log(f"{label}: frame {tuple(hdr.shape)} finite {bool(torch.isfinite(hdr).all())}, pixels "
         f"differing from the 1x frame {changed:.4%}, max |d| {float((hdr - full).abs().max()):.4f}")
    if not (bool(torch.isfinite(hdr).all()) and 0.001 < changed < 0.2):
        raise SystemExit(f"phase main path, {label}: the resolved frame is not finite, or does "
                         "not differ from the 1x frame on edges only")
    del msaa, warm
    # the headline scene with its sun map in the z-plane form under a moving
    # sun: one K7 and one K2 a frame
    plane = make(scene, layout, {**kw, "z_form": "plane"})
    plane.render_frame()  # warm-up
    by_path["headline_plane_moving_sun"] = _drive(
        "headline, z-plane form (moving sun)", plane, PLANE_FRAMES,
        _counts(raster_depth_zplane=PLANE_FRAMES, raster_resolve=PLANE_FRAMES),
        before_frame=lambda i: _move_sun(plane, i))
    _check_frame("headline, z-plane form", plane)
    _check_plane_vs_bary("headline, z-plane form", plane)
    del plane
    mesh = make_device_mesh(N_BANDS, frame_axis=1, devices=["cuda:0"] * N_BANDS)
    for interleaved in (False, True):
        label = "banded, " + ("pair-interleaved" if interleaved else "contiguous")

        def render(interleaved=interleaved):
            out = render_frame_sharded(
                [scene], layout, kw["pipeline"], kw["shading"], W, H, mesh,
                tonemap=kw["tonemap"], shadow_map_size=kw["shadow_map_size"],
                shadow_params=kw["shadow_params"], interleaved=interleaved)
            return framebuffer_to_u8(unshard_rows(out, N_BANDS, interleaved)[0])

        for _ in range(2):  # warm-up
            render()
        key = "banded_interleaved" if interleaved else "banded"
        by_path[key] = _drive(label, render, BAND_FRAMES,
                              _counts(raster_depth=N_BANDS * BAND_FRAMES,
                                      raster_visibility=N_BANDS * BAND_FRAMES))
        out = unshard_rows(render_frame_sharded(
            [scene], layout, kw["pipeline"], kw["shading"], W, H, mesh, tonemap=kw["tonemap"],
            shadow_map_size=kw["shadow_map_size"], shadow_params=kw["shadow_params"],
            interleaved=interleaved), N_BANDS, interleaved)[0]
        d = (out - full)[..., :3].abs().flatten()
        p99 = float(d.kthvalue(math.ceil(0.99 * d.numel())).values)
        _log(f"{label}: stitched frame vs the headline frame, rgb: mean |d| {float(d.mean()):.3e}, "
             f"p99 {p99:.3e}, max {float(d.max()):.3e}, finite "
             f"{bool(torch.isfinite(out).all())}")
        if not (bool(torch.isfinite(out).all()) and p99 < BAND_DRIFT_P99):
            raise SystemExit(f"phase main path, {label}: the stitched frame drifts from the "
                             "headline frame beyond p99 0.01")
        _check_band_stitch(label, scene, layout, kw, interleaved)
    return by_path


def _check_band_stitch(label, scene, layout, kw, interleaved, width=W, height=H, forms=None):
    """The bands' winner source ids, each band from forward_frame(band=...)
    with render_frame_sharded's band_spec and stitched by band_rows, against
    the whole frame's from forward_frame; and the bands' K3 depth against
    the frame's K2 depth on the same setup. Both must be equal wherever
    neither side's binning dropped a triangle (bin_overflow 0). Each band's
    K3 launch is held against its plain version on the band's own table
    (the split plan, FORCED_CHUNK, the skip off), overflow or not. Returns
    the [height, width] mask of pixels whose ids and depth agree. forms
    (a GeometryForms) goes to every frame, band and binning."""
    import torch

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        prepare_resolve,
        prepare_visibility,
        raster_resolve,
        raster_visibility,
        raster_visibility_plain,
    )
    from renderer_rs_tpu_torch.parallel import band_rows, band_spec
    from renderer_rs_tpu_torch.renderer.passes import GeometryForms, forward_frame, frame_geometry

    forms = forms or GeometryForms()
    pipeline, t = kw["pipeline"], layout.num_triangles
    common = dict(tonemap=kw["tonemap"], shadow_map_size=kw["shadow_map_size"],
                  shadow_params=kw["shadow_params"], return_ids=True, diagnostics=True,
                  geometry_forms=forms)
    _, ids, diag = forward_frame(scene, layout, pipeline, kw["shading"], width, height,
                                 **common)
    overflow = [diag["bin_overflow"].tolist()]
    geo = frame_geometry(scene, layout, pipeline, width, height, forms)
    k2 = prepare_resolve(geo.setup, height, width, geo.attr, scene.tris, geo.clip_src, geo.clip_planes,
                         geo.mat_flat, small_limit=t, cap_big=forms.cap_big)
    depth = raster_resolve(k2.table, k2.sorted_tris, k2.seg, k2.nbx, height, width, k2.n_vary,
                           k2.n_flat, pipeline.depth_compare_op)[0]
    band_h = height // N_BANDS
    got_ids, got_depth = torch.full_like(ids, -2), torch.full_like(depth, -2.0)
    for k in range(N_BANDS):
        spec = band_spec(k, N_BANDS, band_h, interleaved)
        _, b_ids, b_diag = forward_frame(scene, layout, pipeline, kw["shading"], width,
                                         height, band=spec, **common)
        rows = band_rows(spec, device=ids.device)
        got_ids[rows] = b_ids
        y0, stride, pair = spec[0], spec[2] if len(spec) > 2 else 1, len(spec) > 3
        k3 = prepare_visibility(geo.setup, band_h, width, y0, stride, pair, small_limit=t,
                                cap_big=forms.cap_big)
        got_depth[rows] = _against_plain(
            "raster_visibility", f"{label}, band {k}", raster_visibility,
            raster_visibility_plain, (k3.table, k3.sorted_tris, k3.seg, k3.nbx, band_h, width,
                                      y0, stride, pair, pipeline.depth_compare_op),
            k3.plan, lanes=False, extra=SKIP_OFF)["depth"]
        overflow.append(b_diag["bin_overflow"].tolist())
        _log(f"{label}, band {k} {spec}: binned pairs {int(k3.n_pairs)}, densest bin "
             f"{int((k3.seg[1:] - k3.seg[:-1]).max())}, covered {int(b_diag['covered_pixels'])}")
    clean = all(o == [0, 0] for o in overflow)
    agree = (got_ids == ids) & (got_depth.view(torch.int32) == depth.view(torch.int32))
    ids_equal = bool(torch.equal(got_ids, ids))
    depth_equal = bool(torch.equal(got_depth.view(torch.int32), depth.view(torch.int32)))
    _log(f"{label}: stitched ids (forward_frame) equal {ids_equal}, depth (K3 vs K2) bit-equal "
         f"{depth_equal}, pixels differing {int((~agree).sum())}; bin_overflow [big, huge] "
         f"frame then bands {overflow}")
    if clean and not (ids_equal and depth_equal):
        raise SystemExit(f"phase main path, {label}: the stitched bands' ids or depth differ "
                         "from the whole frame's")
    return agree


def render_transparent_golden(device: str):
    """tests/test_golden.py::_render_transparent through the port: the
    160x120 IBL full_scene (2,000-triangle budget, 256² sun map) with
    return_depth, then the golden's textured translucent checker quad
    through transparent_pass (Blinn-Phong, unit ambient), then ACES and the
    uint8 encode."""
    import math

    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.mathx import quat_from_axis_angle
    from renderer_rs_tpu_torch.ops.shadow import ShadowParams
    from renderer_rs_tpu_torch.ops.tonemap import apply_tonemap
    from renderer_rs_tpu_torch.renderer.passes import forward_frame, transparent_pass
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.resources.material import Material
    from renderer_rs_tpu_torch.resources.ubo import SceneUbo
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.scene.transform import Transform
    from renderer_rs_tpu_torch.utils import meshgen
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8

    w, h = 160, 120
    scene, layout, kw, _ = full_scene(w, h, tri_budget=2000, device=device)
    pipeline = GraphicsPipelineBuilder().build()
    color, depth = forward_frame(scene, layout, pipeline, kw["shading"], w, h, tonemap="none",
                                 shadow_map_size=256,
                                 shadow_params=kw.get("shadow_params") or ShadowParams(),
                                 return_depth=True)
    trans = SceneBuilder()
    trans.set_textures([meshgen.checkerboard_image(64, squares=4)], size=64)
    trans.add_mesh(
        meshgen.plane_mesh(2.4, uv_scale=1.0),
        Transform().with_position([0.0, 1.2, 1.2]).with_rotation(
            quat_from_axis_angle([1.0, 0.0, 0.0], math.pi / 2)),
        Material(base_color=(1.0, 0.6, 0.3, 0.55), roughness=0.4, base_color_texture=0),
    )
    trans.set_camera(scene.camera)
    trans.set_scene_ubo(SceneUbo.create(ambient_color=(1.0, 1.0, 1.0)))
    t_scene, t_layout = trans.build(device=device)
    out = transparent_pass(color, depth, t_scene, t_layout, pipeline, w, h)
    return framebuffer_to_u8(apply_tonemap(out, "aces"))


def _golden_check(name: str, got) -> None:
    import numpy as np

    from renderer_rs_tpu_torch.utils.image_io import read_png

    golden = read_png(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "tests", "goldens", f"{name}_160x120.png"))
    diff = np.abs(golden.astype(np.int32) - got.astype(np.int32))
    mean, frac_big = float(diff.mean()), float((diff.max(-1) > 8).mean())
    _log(f"{name} 160x120 vs golden: mean |diff| {mean:.4f}, pixels off by >8: {frac_big:.4%}")
    if not (mean < 1.0 and frac_big < 0.005):
        raise SystemExit(f"phase small reference: the {name} frame differs from the golden image")


def phase_small_reference() -> None:
    """160x120 frames on the card against the repo's golden images, and the
    shadow-mapped PBR frames (single map, cascades, MSAA 4x) on the card
    against the port's frames on the CPU."""
    import dataclasses

    import numpy as np

    from renderer_rs_tpu_torch.app.scenes import (
        blinnphong_scene,
        cube_scene,
        full_scene,
        gltf_pbr_scene,
        triangle_scene,
    )
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    def render(factory, device, hdr=False, msaa=1, mask=False, **scene_kw):
        scene, layout, kw, _ = factory(160, 120, device=device, **scene_kw)
        if "shadow_map_size" in kw:
            kw["shadow_map_size"] = 256
        kw["pipeline"] = dataclasses.replace(kw["pipeline"], msaa_samples=msaa,
                                             alpha_cutoff=CUTOFF if mask else None)
        renderer = Renderer(RendererConfig(width=160, height=120), device=device, **kw)
        renderer.set_scene(scene, layout)
        return renderer.render_frame_hdr().cpu().numpy() if hdr else renderer.render_frame()

    _golden_check("triangle", render(triangle_scene, "cuda"))
    _golden_check("cube", render(cube_scene, "cuda"))
    _golden_check("blinnphong", render(blinnphong_scene, "cuda"))
    _golden_check("gltf-pbr", render(gltf_pbr_scene, "cuda"))
    # cuda vs cpu on the PBR frame, with the single map, with four cascades
    # and with MSAA 4x. The PCF compares are hard and the two devices'
    # matmuls round apart, so single taps may flip: >= 99.5% of the values
    # within 2e-3 + 2e-3*|ref|, and none off by more than one tap of the sun
    # term after ACES (0.15)
    for label, extra in (("single map", {}), ("csm", dict(csm=True)),
                         (f"msaa{MSAA}", dict(msaa=MSAA)), ("textured", dict(textured=True)),
                         ("textured MASK", dict(textured=True, mask=True))):
        got = render(full_scene, "cuda", hdr=True, **SMALL_FULL, **extra)
        ref = render(full_scene, "cpu", hdr=True, **SMALL_FULL, **extra)
        err = np.abs(got - ref)
        off = float((err > 2e-3 + 2e-3 * np.abs(ref)).mean())
        _log(f"full_scene(160, 120, tri_budget=2000, ibl=False) {label}, cuda vs cpu: max |d| "
             f"{err.max():.3e}, values off the bar {off:.4%}, mean {got[..., :3].mean():.4f} "
             f"vs {ref[..., :3].mean():.4f}")
        if not (np.isfinite(got).all() and off < 0.005 and err.max() < 0.15):
            raise SystemExit(f"phase small reference: the PBR frame ({label}) on cuda differs "
                             "from the cpu frame")
    _cutout_check()
    _ibl_small_check()
    _blend_stencil_msaa_small_checks()
    _gltf_small_checks()
    _shade_paths_small_checks()
    _frame_loop_small_checks()


def _shade_paths_small_checks() -> None:
    """Phase 5's checks of loops (g)-(j): each new shade path on the card
    against the port's own frame on the cpu at 160x128 (a 256² sun map),
    within the PBR frame bar of the IBL checks (<= 0.5% of values off
    2e-3 + 2e-3|ref|, max < 0.15: single PCF taps may flip between the
    devices), winner ids compared: (g) the headline scene with its
    environment not finalized (the exact IBL), (h) the many-material scene
    (4x4 spheres, 32² images) with the material atlases' budget lowered
    below its 16 sets (the per-slot fetch), every ShadeRates variant of the
    drift table and the exact reference on the headline scene (128 rows:
    the y-half rates engage, y-quarter falls back to y-half), and
    msaa_mode="super" (MSAA 4x) at 64x48."""
    import dataclasses

    import numpy as np

    import renderer_rs_tpu_torch.renderer.scene_build as scene_build
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.renderer.passes import ShadeRates, forward_frame

    w, h = 160, 128

    def frame(made, width=w, height=h, rates=None, msaa=1, msaa_mode="resolve"):
        scene, layout, kw = made[:3]
        out = forward_frame(scene, layout, dataclasses.replace(kw["pipeline"], msaa_samples=msaa),
                            kw["shading"], width, height, tonemap=kw["tonemap"],
                            shadow_map_size=256, shadow_params=kw["shadow_params"],
                            shade_rates=ShadeRates(**(rates or {})), msaa_mode=msaa_mode,
                            return_ids=msaa == 1)
        out, ids = out if msaa == 1 else (out, None)
        return out.cpu().numpy(), None if ids is None else ids.cpu()

    def check(label, got, ref):
        (got, got_ids), (ref, ref_ids) = got, ref
        err = np.abs(got - ref)
        off = float((err > 2e-3 + 2e-3 * np.abs(ref)).mean())
        ids = "" if ref_ids is None else (
            f", winner ids differing {int((got_ids != ref_ids).sum())} of "
            f"{int((ref_ids >= 0).sum())} covered")
        _log(f"{label} cuda vs cpu: max |d| {err.max():.3e}, values off the bar {off:.4%}{ids}")
        if not (np.isfinite(got).all() and off < 0.005 and err.max() < 0.15):
            raise SystemExit(f"phase small reference: {label} on cuda differs from the cpu frame")

    def scenes(factory, **kw):
        return {dev: factory(w, h, device=dev, **kw) for dev in ("cuda", "cpu")}

    made = scenes(full_scene, tri_budget=2000, textured=True, finalize=False)
    check("(g) full_scene(160, 128, tri_budget=2000, textured=True, finalize=False)",
          frame(made["cuda"]), frame(made["cpu"]))
    budget = scene_build.MATERIAL_ATLAS_BUDGET
    small_many = dict(grid=4, tex_size=32, shadow_map_size=256)
    scene_build.MATERIAL_ATLAS_BUDGET = small_many["grid"] ** 2 * small_many["tex_size"] ** 2 - 1
    try:
        made = scenes(many_material_scene, **small_many)
    finally:
        scene_build.MATERIAL_ATLAS_BUDGET = budget
    if made["cuda"][0].textures.mat_atlas is not None:
        raise SystemExit("phase small reference: the small many-material scene built a "
                         "material atlas under the lowered budget")
    check(f"(h) many_material_scene(160, 128, {small_many}), budget lowered (per-slot)",
          frame(made["cuda"]), frame(made["cpu"]))
    made = scenes(full_scene, tri_budget=2000, textured=True)
    for name, rates in {**RATE_VARIANTS, "exact reference": EXACT_RATES}.items():
        check(f"(i) full_scene(160, 128, tri_budget=2000, textured=True), ShadeRates({rates}) "
              f"[{name}]", frame(made["cuda"], rates=rates), frame(made["cpu"], rates=rates))
    made = {dev: full_scene(64, 48, tri_budget=2000, textured=True, device=dev)
            for dev in ("cuda", "cpu")}
    check(f"(j) full_scene(64, 48, tri_budget=2000, textured=True), msaa{MSAA} "
          "msaa_mode='super'", frame(made["cuda"], 64, 48, msaa=MSAA, msaa_mode="super"),
          frame(made["cpu"], 64, 48, msaa=MSAA, msaa_mode="super"))


def _frame_loop_small_checks() -> None:
    """Phase 5's checks of loops (k)-(o) at 160x128 on the card against the
    port on the cpu: (k) app.main --orbit on the small headline scene, 3
    frames, each within the golden bar; (l) a frame after resize(96, 64)
    within the PBR bar of the checks above; (m) validation mode's findings
    on one NaN normal equal; (o) the frame under vstage="batch",
    shadow_vstage="world", clip_compact=0 and cap_big=0 within the PBR bar,
    winner ids compared."""
    import numpy as np

    import renderer_rs_tpu_torch.core.validation as validation
    from renderer_rs_tpu_torch.app.main import main as app_main
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.passes import GeometryForms, forward_frame
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    w, h = 160, 128
    small = ["--scene", "full", "--textured", "--tris", "2000", "--width", str(w), "--height",
             str(h), "--frames", "3", "--orbit"]
    frames = {}
    for dev in ("cuda", "cpu"):
        frames[dev] = []
        app_main(small, device=dev, sink=lambda f, n, out=frames[dev]: out.append(f))
    for i, (got, ref) in enumerate(zip(frames["cuda"], frames["cpu"])):
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        off = float((diff.max(-1) > 8).mean())
        _log(f"(k) app.main --orbit at {w}x{h}, frame {i} cuda vs cpu: mean |d| "
             f"{diff.mean():.4f}, pixels off by > 8 {off:.4%}")
        if not (len(frames["cuda"]) == 3 and diff.mean() < 1.0 and off < 0.005):
            raise SystemExit("phase small reference: the orbit app's frame on cuda differs from "
                             "the cpu's")

    def pbr_bar(label, got, ref):
        err = np.abs(got - ref)
        off = float((err > 2e-3 + 2e-3 * np.abs(ref)).mean())
        _log(f"{label} cuda vs cpu: max |d| {err.max():.3e}, values off the bar {off:.4%}")
        if not (np.isfinite(got).all() and off < 0.005 and err.max() < 0.15):
            raise SystemExit(f"phase small reference: {label} on cuda differs from the cpu")

    made = {dev: full_scene(w, h, tri_budget=2000, textured=True, device=dev)
            for dev in ("cuda", "cpu")}
    resized, findings, forms_out = {}, {}, {}
    forms = GeometryForms(vstage="batch", shadow_vstage="world", clip_compact=0, cap_big=0)
    for dev, (scene, layout, kw, _) in made.items():
        kw = {**kw, "shadow_map_size": 256}
        r = Renderer(RendererConfig(width=w, height=h), device=dev, **kw)
        r.set_scene(scene, layout)
        r.render_frame()
        r.resize(96, 64)
        r.render_frame()
        resized[dev] = r.render_frame_hdr().cpu().numpy()
        validation.reset_findings()
        v = Renderer(RendererConfig(width=w, height=h, enable_validation=True), device=dev, **kw)
        normals = scene.normals.clone()
        normals[5, 0] = float("nan")
        v.set_scene(scene.replace(normals=normals), layout)
        v.render_frame()
        findings[dev] = validation.findings(validation.SEVERITY_ERROR)
        validation.reset_findings()
        out, ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], w, h,
                                 tonemap=kw["tonemap"], shadow_map_size=256,
                                 shadow_params=kw["shadow_params"], return_ids=True,
                                 geometry_forms=forms)
        forms_out[dev] = (out.cpu().numpy(), ids.cpu())
    pbr_bar(f"(l) full_scene({w}, {h}, tri_budget=2000, textured=True) resized to 96x64",
            resized["cuda"], resized["cpu"])
    _log(f"(m) validation findings on one NaN normal (ERROR), cuda {findings['cuda']}, cpu "
         f"{findings['cpu']}")
    if findings["cuda"] != findings["cpu"] or findings["cuda"] < 1:
        raise SystemExit("phase small reference: validation findings differ between the devices")
    ids_diff = int((forms_out["cuda"][1] != forms_out["cpu"][1]).sum())
    _log(f"(o) {forms}: winner ids differing {ids_diff} of "
         f"{int((forms_out['cpu'][1] >= 0).sum())} covered")
    if ids_diff:
        raise SystemExit(f"phase small reference: (o) under {forms} the winner ids on cuda "
                         "differ from the cpu's")
    pbr_bar(f"(o) full_scene({w}, {h}, tri_budget=2000, textured=True) under {forms}",
            forms_out["cuda"][0], forms_out["cpu"][0])


def _gltf_small_checks() -> None:
    """The full_hdr golden on the card (tests/test_golden.py's recipe:
    full_scene(160, 120, tri_budget=2000, hdr=<the sky asset>), a 256² sun
    map, ACES) under the golden bar; then the small glTF frame,
    full_scene(160, 120, tri_budget=8, textured=True, gltf=textured_quad.glb,
    hdr=...) (4 quads + the floor: the scan), on cuda against the same frame
    on the cpu, within the frame bar (tests/test_torch_frame.py: <= 0.2% of
    values off 2e-3 + 2e-3|ref|, max < 0.05)."""
    import numpy as np

    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8

    def frame(device, **scene_kw):
        scene, layout, kw, _ = full_scene(160, 120, hdr=HDR_SKY, device=device, **scene_kw)
        return forward_frame(scene, layout, kw["pipeline"], kw["shading"], 160, 120,
                             tonemap=kw["tonemap"], shadow_map_size=256,
                             shadow_params=kw["shadow_params"], return_ids=True)

    _golden_check("full_hdr", framebuffer_to_u8(frame("cuda", tri_budget=2000)[0]))
    small = dict(tri_budget=8, textured=True, gltf=os.path.join(ASSETS, "textured_quad.glb"))
    (got, got_ids), (ref, ref_ids) = frame("cuda", **small), frame("cpu", **small)
    got, ref = got.cpu().numpy(), ref.numpy()
    err = np.abs(got - ref)
    off = float((err > 2e-3 + 2e-3 * np.abs(ref)).mean())
    _log(f"glTF frame full_scene(160, 120, tri_budget=8, textured=True, gltf=textured_quad.glb, "
         f"hdr=) cuda vs cpu: max |d| {err.max():.3e}, values off the bar {off:.4%}, winner ids "
         f"differing {int((got_ids.cpu() != ref_ids).sum())}, covered {int((ref_ids >= 0).sum())}")
    if not (np.isfinite(got).all() and off < 0.002 and err.max() < 0.05):
        raise SystemExit("phase small reference: the glTF frame on cuda differs from the cpu frame")


def _blend_stencil_msaa_small_checks() -> None:
    """Phase 5's checks of the transparent pass, the stencil, points and
    lines, the scan's alpha coverage callback and the supersampling
    branch, on small inputs: the transparent golden on the card (its golden
    bar), then cuda against cpu: the cube's two-sided stencil buffer
    bit-equal, the LINE_STRIP and POINT_LIST frames (ids exact), the
    alpha-cutout stack under FLAT, as a band and in MSAA 4x's sample pass
    (ids exact), and the supersampled MSAA 4x frame with return_depth."""
    import dataclasses

    import numpy as np
    import torch

    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    from renderer_rs_tpu_torch.rhi.pipeline import CullMode, GraphicsPipelineBuilder

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    try:
        from _torch_port import alpha_cutout_scene
    finally:
        sys.path.pop(0)

    def bar(label, got, ref, max_err=0.05):
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        err = np.abs(got - ref)
        off = float((err > 2e-3 + 2e-3 * np.abs(ref)).mean())
        _log(f"{label}, cuda vs cpu: max |d| {err.max():.3e}, values off the bar {off:.4%}")
        if not (np.isfinite(got).all() and off < 0.005 and err.max() < max_err):
            raise SystemExit(f"phase small reference: {label} on cuda differs from the cpu")

    _golden_check("transparent", render_transparent_golden("cuda"))
    out, sbuf, ids = _stencil_cube("cuda", 160, 120)(0.5)
    ref_out, ref_sbuf, ref_ids = _stencil_cube("cpu", 160, 120)(0.5)
    _log(f"cube stencil 160x120: stencil bit-equal {bool(torch.equal(sbuf.cpu(), ref_sbuf))}, "
         f"ids equal {bool(torch.equal(ids.cpu(), ref_ids))}")
    if not (torch.equal(sbuf.cpu(), ref_sbuf) and torch.equal(ids.cpu(), ref_ids)):
        raise SystemExit("phase small reference: the stencil frame on cuda differs from the cpu")
    bar("cube stencil 160x120", out, ref_out)
    for name in ("LINE_STRIP", "POINT_LIST"):
        (out, ids), (ref_out, ref_ids) = (_topology_frame(name, d, 160, 120)()
                                          for d in ("cuda", "cpu"))
        if not torch.equal(ids.cpu(), ref_ids):
            raise SystemExit(f"phase small reference: the {name} ids on cuda differ from the cpu")
        bar(f"{name} 160x120", out, ref_out)
    # the alpha-cutout stack on the scan's coverage callback
    mask = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).alpha_cutoff(CUTOFF).build()
    for label, shading, kwargs, scale in (("FLAT", ShadingModel.FLAT, {}, 1),
                                          ("band (20, 40)", ShadingModel.PBR,
                                           dict(band=(20, 40)), 1),
                                          (f"msaa{MSAA} sample pass", ShadingModel.PBR,
                                           dict(ids_only=True), 2)):
        res = {}
        for device in ("cuda", "cpu"):
            scene, layout = alpha_cutout_scene(128, 96, device=device)
            res[device] = forward_frame(scene, layout, mask, shading, 128 * scale, 96 * scale,
                                        **(kwargs if "ids_only" in kwargs
                                           else dict(kwargs, return_ids=True)))
        ids_c = res["cuda"] if "ids_only" in kwargs else res["cuda"][1]
        ids_r = res["cpu"] if "ids_only" in kwargs else res["cpu"][1]
        _log(f"alpha-cutout {label}: ids cuda vs cpu equal {bool(torch.equal(ids_c.cpu(), ids_r))},"
             f" covered {float((ids_r >= 0).float().mean()):.4%}")
        if not torch.equal(ids_c.cpu(), ids_r):
            raise SystemExit(f"phase small reference: the alpha-cutout {label} ids differ")
        if "ids_only" not in kwargs:
            bar(f"alpha-cutout {label}", res["cuda"][0], res["cpu"][0])
    # the supersampling branch: MSAA 4x with return_depth on the small PBR frame
    res = {}
    for device in ("cuda", "cpu"):
        scene, layout, kw, _ = full_scene(160, 120, device=device, **SMALL_FULL)
        res[device] = forward_frame(
            scene, layout, dataclasses.replace(kw["pipeline"], msaa_samples=MSAA), kw["shading"],
            160, 120, return_depth=True, tonemap=kw["tonemap"], shadow_map_size=256,
            shadow_params=kw["shadow_params"])
    depth_err = float((res["cuda"][1].cpu() - res["cpu"][1]).abs().max())
    _log(f"supersampled msaa{MSAA} 160x120 with return_depth: depth max |d| cuda vs cpu "
         f"{depth_err:.3e}")
    if depth_err > 1e-6:
        raise SystemExit("phase small reference: the supersampled depth on cuda differs")
    bar(f"supersampled msaa{MSAA} 160x120", res["cuda"][0], res["cpu"][0], max_err=0.15)


def _ibl_small_check() -> None:
    """The IBL frames full and full_textured at 160x120 (tests/test_golden.py's
    recipe: a 256² sun map) on cuda against their goldens and against the
    cpu frames; then full_textured as 4 bands, contiguous and pair-
    interleaved, on cuda: stitched ids equal to the frame's, colours within
    the bar (120 rows: exact rates on both sides)."""
    import numpy as np
    import torch

    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.parallel import (
        band_rows,
        band_spec,
        make_device_mesh,
        render_frame_sharded,
        unshard_rows,
    )
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8

    def frame(device, textured, **extra):
        scene, layout, kw, _ = full_scene(160, 120, tri_budget=2000, textured=textured,
                                          device=device)
        out = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 160, 120,
                            tonemap=kw["tonemap"], shadow_map_size=256,
                            shadow_params=kw["shadow_params"], **extra)
        return out, (scene, layout, kw)

    for name, textured in (("full", False), ("full_textured", True)):
        got, _ = frame("cuda", textured)
        ref, _ = frame("cpu", textured)
        _golden_check(name, framebuffer_to_u8(got))
        got, ref = got.cpu().numpy(), ref.numpy()
        err = np.abs(got - ref)
        off = float((err > 2e-3 + 2e-3 * np.abs(ref)).mean())
        _log(f"{name} 160x120 (IBL), cuda vs cpu: max |d| {err.max():.3e}, values off the bar "
             f"{off:.4%}")
        if not (np.isfinite(got).all() and off < 0.005 and err.max() < 0.15):
            raise SystemExit(f"phase small reference: the {name} IBL frame on cuda differs from "
                             "the cpu frame")
    (full, full_ids), (scene, layout, kw) = frame("cuda", True, return_ids=True)
    mesh = make_device_mesh(N_BANDS, frame_axis=1, devices=["cuda:0"] * N_BANDS)
    band_h = 120 // N_BANDS
    for interleaved in (False, True):
        out = unshard_rows(render_frame_sharded(
            [scene], layout, kw["pipeline"], kw["shading"], 160, 120, mesh,
            tonemap=kw["tonemap"], shadow_map_size=256, shadow_params=kw["shadow_params"],
            interleaved=interleaved), N_BANDS, interleaved)[0]
        ids = torch.full_like(full_ids, -2)
        for k in range(N_BANDS):
            spec = band_spec(k, N_BANDS, band_h, interleaved)
            _, band_ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 160, 120,
                                        tonemap=kw["tonemap"], shadow_map_size=256,
                                        shadow_params=kw["shadow_params"], band=spec,
                                        return_ids=True)
            ids[band_rows(spec, device=ids.device)] = band_ids
        err = (out - full).abs()
        off = float((err > 2e-3 + 2e-3 * full.abs()).float().mean())
        ids_equal = bool(torch.equal(ids, full_ids))
        _log(f"full_textured 160x120 as {N_BANDS} {'interleaved' if interleaved else 'contiguous'} "
             f"bands on cuda: stitched ids equal {ids_equal}, max |d| {float(err.max()):.3e}, "
             f"values off the bar {off:.4%}")
        if not (ids_equal and off < 0.002 and float(err.max()) < 0.05):
            raise SystemExit("phase small reference: the stitched bands differ from the frame")


def _cutout_check() -> None:
    """The alpha-cutout stack at 128x96 (3 cutout quads over a floor, and
    the 6-layer aligned stack that exhausts the 4-layer peel), built by the
    port's SceneBuilder, on cuda against cpu: the frame within the bar,
    equal peel_exhausted, winner ids compared."""
    import numpy as np

    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame

    # the test stack's builder lives with the port's test helpers (no JAX there)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _torch_port import alpha_cutout_scene
    from renderer_rs_tpu_torch.rhi.pipeline import CullMode, GraphicsPipelineBuilder

    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).alpha_cutoff(CUTOFF).build()
    for layers, dx in ((3, 0.15), (6, 0.0)):
        res = {}
        for device in ("cuda", "cpu"):
            scene, layout = alpha_cutout_scene(128, 96, layers=layers, dx=dx, device=device)
            out, ids, diag = forward_frame(scene, layout, pipe, ShadingModel.PBR, 128, 96,
                                           return_ids=True, diagnostics=True)
            res[device] = (out.cpu().numpy(), ids.cpu().numpy(), int(diag["peel_exhausted"]))
        (got, gids, gex), (ref, rids, rex) = res["cuda"], res["cpu"]
        err = np.abs(got - ref)
        off = float((err > 2e-3 + 2e-3 * np.abs(ref)).mean())
        _log(f"alpha-cutout stack ({layers} layers, dx {dx}) 128x96, cuda vs cpu: max |d| "
             f"{err.max():.3e}, values off the bar {off:.4%}, winner ids differing "
             f"{int((gids != rids).sum())}, covered {int((rids >= 0).sum())}, peel_exhausted "
             f"{gex} vs {rex}")
        if not (np.isfinite(got).all() and off < 0.005 and err.max() < 0.15 and gex == rex):
            raise SystemExit("phase small reference: the alpha-cutout frame on cuda differs from "
                             "the cpu frame")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import renderer_rs_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.perf_counter()
    phase_versions()
    phase_build()
    with tempfile.TemporaryDirectory() as directory:  # the dancer-class model
        kernels, headline, gltf, many = phase_kernels(directory)
    by_path = phase_main_paths(headline, gltf, many)
    by_path["probe"], us = phase_probe()
    kernels["probe_kgather"]["us_per_iteration"] = us
    # the probe's run: one launch of each body at PROBE_ITERS
    kernels["probe_kgather"]["ms"] = sum(us.values()) * PROBE_ITERS / 1e3
    phase_small_reference()
    phase_after()
    phase_breakdown()
    phase_shard_profiles()
    for name, k in kernels.items():
        k["max_abs_err"] = max(k["max_abs_err"], _MAX_ABS_ERR.get(name, 0.0))
        # the fused shade is counted on the _drive loops alone
        k["launches"] = sum(path.get(name, 0) for path in by_path.values())
        k["launches_by_path"] = {label: path[name] for label, path in by_path.items()
                                 if name in path}
        if k["launches"] == 0:
            raise SystemExit(f"kernel {name} was launched by no main path")
    _log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
