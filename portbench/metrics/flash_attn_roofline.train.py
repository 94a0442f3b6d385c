"""flash_attn_roofline.train: % of the roofline of a step's flash forward and
backward launches (one each an AVT-h layer), causal pairs only."""
from portbench.harness import readers


def read(run):
    return readers.flash_roofline(run, backward=True)
