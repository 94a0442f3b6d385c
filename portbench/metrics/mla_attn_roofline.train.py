"""mla_attn_roofline.train: % of the roofline of a step's flash forward and
backward launches at two head widths (one each a decoder layer: the latent
attention's keys of 192 and values of 128), causal pairs only, from
work/mla_attention.py; nothing for a family without such launches."""
from portbench.harness import readers
from portbench.harness.roofline import ITEMSIZE, bound_s
from portbench.work import mla_attention


def read(run):
    fam = run.cell.family
    if run.profile is None or not hasattr(fam, "mla_call"):
        return None
    bound = 0.0
    for clips in run.unit_clips:
        call = fam.mla_call(run.cell.cfg, run.cell.traffic, run.mode, clips)
        if call is None:
            return None
        *shape, dtype = call
        work = [w(*shape, ITEMSIZE[dtype], True) for w in (mla_attention.forward_work,
                                                            mla_attention.backward_work)]
        bound += fam.layers(run.cell.cfg) * sum(bound_s(*x, dtype) for x in work)
    took = (run.profile.op_s("avt_tpu_torch::flash_attention")
            or run.profile.kernel_s(readers.FLASH_FWD))
    took += (run.profile.op_s("avt_tpu_torch::flash_attention_bwd")
             or run.profile.kernel_s(readers.FLASH_BWD))
    return 100.0 * bound / took if took > 0 else None
