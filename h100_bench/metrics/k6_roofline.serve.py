"""Kernel K6's share of its roofline: the least time of the bytes of every
``e3d::lerp_resize`` call in the traced slice (its input read and output
written once; the output size is the call's, else the DPT head's resize
of that input in ``counts.dpt_resizes``) over the device time of the
kernels those calls launched, in percent."""

from h100_bench import counts


def _work(args, run):
    b, c, h, w = (int(x) for x in args["Input Dims"][0])
    try:
        h2, w2 = (int(x) for x in args["Concrete Inputs"][1:3])
    except (KeyError, ValueError, TypeError):
        sizes = {r[2:4]: r[4:6] for r in counts.dpt_resizes(
            run.config, run.net_hw, b)}
        h2, w2 = sizes[(h, w)]
    dtype = str(args.get("Input type", [""])[0]).lower()
    elem = 2 if "bfloat16" in dtype or "half" in dtype else 4
    return counts.resize_work(b, c, h, w, h2, w2, elem)


def read(run):
    if run.trace is None:
        return None
    return counts.roofline_share(run.trace.op_calls("e3d::lerp_resize"),
                                 _work, run)
