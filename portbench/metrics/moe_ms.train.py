"""moe_ms.train: device ms a step of the activities launched under the port's
span avt.moe (the forward of each MoE layer's FFN: the router, the dispatch,
the held experts' grouped products, the shared experts and the combine;
their backward runs outside it)."""
from portbench.harness import spans


def read(run):
    return spans.device_ms(run, "avt.moe")
