"""packed_attn_roofline.serve: % of the roofline of a request's packed forward
launches (one a ViT block)."""
from portbench.harness import readers


def read(run):
    return readers.packed_roofline(run, backward=False)
