"""Scene recipes, one file each (``recipes/<name>.py``), named by a
configuration's ``recipe`` key and found by that name. A recipe turns a
configuration and a seed into the raw inputs, and builds both sides from
them:

- ``inputs(cfg, seed)``: the raw inputs (arrays and numbers), the same for
  the same seed;
- ``Program(cfg, inputs, state, devices)``: the system under test set up
  with the traffic's first state; ``.frame(state)`` renders one traffic
  state and returns its uint8 [H, W, 4] image on the host;
  ``.diagnostics()``, ``.close()``; ``TRACE_MARKER``: the device kernel
  each traced frame runs once;
- ``Reference(cfg, inputs, device, control=False)``: the plain frame of
  the same inputs, ``.frame(state)`` likewise, ``.geometry(state)`` the
  raster inputs the kernel rooflines count (``roofline/``).

A traffic state (``traffic.py``) holds the camera's ``eye`` and ``target``
and the sun's direction, and whether the sun moved (``sun_moves``).
"""
