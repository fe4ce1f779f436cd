"""The temporal attention's share of its roofline: the least time of the
work of every ``e3d::temporal_attn`` call in the traced slice
(``counts_vda.temporal_attn_work``, from the shapes it was called with:
(B*T, S, 3, H, D) and T) over the device time of the kernels those calls
launched, in percent."""

from h100_bench import counts, counts_vda


def _work(args, run):
    bt, s, _, h, d = (int(x) for x in args["Input Dims"][0])
    try:
        frames = int(args["Concrete Inputs"][1])
    except (KeyError, IndexError, ValueError, TypeError):
        frames = int(run.config["window"])
    return counts_vda.temporal_attn_work(bt, s, h, d, frames)


def read(run):
    if run.trace is None:
        return None
    return counts.roofline_share(run.trace.op_calls("e3d::temporal_attn"),
                                 _work, run)
