"""The served step's share of the card's bf16 peak: the counted forward
operations (``counts.forward_flops``) of the frames completed in the
window before the traced slice, over those seconds times 989 TFLOP/s, in
percent."""

from h100_bench import counts


def read(run):
    pre = run.extra.get("pre")
    if not pre or not pre["frames"]:
        return None
    flops = counts.forward_flops(run.config, run.net_hw)
    return (100.0 * flops * pre["frames"]
            / (pre["seconds"] * counts.PEAK_BF16_FLOPS))
