"""K2: the fused frame's visibility with its winner resolve
(csrc/raster_resolve.cu on the shared walk): depth and triangle id a pixel
over the whole frame."""

KERNELS = ("split_keys_init", "split_walk", "raster_resolve_pass")


def work(geometry):
    w, h = geometry.width, geometry.height
    from bench_port.roofline import work_of

    return work_of([(geometry.view(), w, h, 0, h)], out_bytes_per_pixel=8)
