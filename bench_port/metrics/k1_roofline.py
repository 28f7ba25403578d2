"""K1's roofline share (%): the least time the card could take for the
kernel's work of a traced frame (roofline/k1.py) over the kernel's device
time per traced frame."""


def read(run):
    return run["roofline"]("k1")
