"""packed_attn_roofline.train: % of the roofline of a step's packed forward and
backward launches (one each a ViT block)."""
from portbench.harness import readers


def read(run):
    return readers.packed_roofline(run, backward=True)
