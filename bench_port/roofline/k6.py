"""K6: the four cascades' depth-only maps in one launch of K1's kernel
(csrc/raster_depth.cu over N = 4 sets): depth a texel of each cascade,
counted as k1.py counts one map, over the cascades the reference fits to
the frame's camera."""

KERNELS = ("raster_depth_kernel", "depth_keys_kernel")


def work(geometry):
    from bench_port.roofline import work_of

    s = geometry.cascade_size
    return work_of([(setup, s, s, 0, s) for setup in geometry.cascades()], out_bytes_per_pixel=4)
