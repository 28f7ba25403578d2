"""K6's roofline share (%): the least time the card could take for the
kernel's work of a traced frame, the four cascades (roofline/k6.py), over
the kernel's device time per traced frame."""


def read(run):
    return run["roofline"]("k6")
