"""The plain reference frame: a rasterizer from the pipeline's rules (raster.py) and
the frame from its formulas (render.py), importing nothing of the program."""
