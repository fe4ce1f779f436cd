"""Kernel K1's share of its roofline: the least time of the work of every
``e3d::flash_attn_fwd`` call in the traced slice (``counts``, from the
shapes it was called with) over the device time of the kernels those
calls launched, in percent."""

from h100_bench import counts


def _work(args, run):
    b, n, h, d = (int(x) for x in args["Input Dims"][0])
    return counts.attn_fwd_work(b, n, h, d)


def read(run):
    if run.trace is None:
        return None
    return counts.roofline_share(run.trace.op_calls("e3d::flash_attn_fwd"),
                                 _work, run)
