"""K1: the depth-only sun map (csrc/raster_depth.cu): depth a texel."""

KERNELS = ("raster_depth_kernel", "depth_keys_kernel")


def work(geometry):
    from bench_port.roofline import work_of

    s = geometry.shadow_size
    return work_of([(setup, s, s, 0, s) for setup in geometry.shadow()], out_bytes_per_pixel=4)
